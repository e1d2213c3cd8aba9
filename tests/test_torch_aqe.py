"""Adaptive query execution: equivalence vs the static path + rule units.

The contract mirrors the optimizer matrix (tests/test_etl_optimizer.py): for
ANY plan, results under ``RDT_ETL_AQE=1`` must equal ``=0`` row-for-row
(after a canonical sort — partition structure and row order are NOT part of
the result, and AQE deliberately changes both), and the report's
``aqe_broadcast``/``aqe_split``/``aqe_coalesced`` columns must say exactly
which rule fired. A threshold knob of 0 must disable its rule.

The port's twin of ``tests/test_aqe.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import numpy as np
import pandas as pd
import pytest

from raydp_tpu_torch.etl import functions as F
from raydp_tpu_torch.etl import optimizer as O


@pytest.fixture(scope="module")
def session():
    import raydp_tpu_torch

    s = raydp_tpu_torch.init("pytest_aqe", num_executors=2, executor_cores=1,
                       executor_memory="512MB")
    yield s
    raydp_tpu_torch.stop()


@pytest.fixture(scope="module")
def big(session):
    """Wide-ish frame: int key, string key, two payloads."""
    rng = np.random.RandomState(0)
    n = 6000
    pdf = pd.DataFrame({
        "k": rng.randint(0, 40, n),
        "s": [f"tag{i % 23}" for i in range(n)],
        "a": rng.randint(0, 1000, n).astype(np.int64),
        "b": rng.randint(0, 7, n),
    })
    return session.createDataFrame(pdf, num_partitions=4)


def both_paths(monkeypatch, session, make_df, sort_cols):
    """Action under AQE off and on; assert row-identical; return reports."""
    outs, reports = {}, {}
    for env in ("0", "1"):
        monkeypatch.setenv("RDT_ETL_AQE", env)
        session.engine.reset_shuffle_stage_report()
        outs[env] = (make_df().to_pandas().sort_values(sort_cols)
                     .reset_index(drop=True))
        reports[env] = session.engine.shuffle_stage_report()
    monkeypatch.delenv("RDT_ETL_AQE", raising=False)
    pd.testing.assert_frame_equal(outs["0"], outs["1"])
    assert all(r.get("aqe_broadcast", 0) == 0
               and r.get("aqe_split", 0) == 0
               and r.get("aqe_coalesced", 0) == 0
               for r in reports["0"]), reports["0"]
    return outs["1"], reports


def _aqe(reports, col):
    return sum(r.get(col, 0) for r in reports["1"])


def _stages(reports):
    return [r["stage"] for r in reports["1"]]


# ==== rule (a): broadcast-hash join ================================================
def test_broadcast_join_int_keys_both_orders(monkeypatch, session, big):
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(40), "label": np.arange(40) * 3}),
        num_partitions=2)
    # small side on the right: pre-shuffle broadcast, no shuffle stage at all
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(dim, on="k").select("k", "a", "label"),
        ["k", "a"])
    assert _aqe(reports, "aqe_broadcast") >= 1
    assert "join-left" not in _stages(reports)
    assert "join-right" not in _stages(reports)
    assert (out["label"] == out["k"] * 3).all()
    # small side on the left: the left-broadcast gating (inner join) applies
    out, reports = both_paths(
        monkeypatch, session,
        lambda: dim.join(big, on="k").select("k", "a", "label"),
        ["k", "a"])
    assert _aqe(reports, "aqe_broadcast") >= 1
    assert (out["label"] == out["k"] * 3).all()


def test_broadcast_join_string_keys(monkeypatch, session, big):
    dim = session.createDataFrame(
        pd.DataFrame({"s": [f"tag{i}" for i in range(23)],
                      "slab": np.arange(23)}),
        num_partitions=2)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(dim, on="s").select("s", "a", "slab"),
        ["s", "a"])
    assert _aqe(reports, "aqe_broadcast") >= 1
    assert len(out) == 6000


def test_broadcast_join_left_outer(monkeypatch, session, big):
    # right side broadcasts under "left outer" (streamed-left rows each
    # appear once, so unmatched left rows survive exactly once)
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(20), "label": np.arange(20) * 2}),
        num_partitions=2)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(dim, on="k", how="left outer")
        .select("k", "a", "label"),
        ["k", "a"])
    assert _aqe(reports, "aqe_broadcast") >= 1
    assert out["label"].isna().any()  # keys 20..39 have no match


def test_full_outer_join_never_broadcasts(monkeypatch, session, big):
    # neither side may broadcast a full outer join: the broadcast side's
    # unmatched rows would be emitted once per probe partition
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(50), "label": np.arange(50)}),
        num_partitions=2)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(dim, on="k", how="full outer")
        .select("k", "a", "label"),
        ["k", "a", "label"])
    assert _aqe(reports, "aqe_broadcast") == 0
    assert {"join-left", "join-right"} <= set(_stages(reports))


def test_postmap_broadcast_converts_planned_shuffle_join(monkeypatch,
                                                         session, big):
    """The fallback form: the small (left) side is an aggregation — no
    static estimate exists — so its map stage runs, the measured bytes
    reveal the small side, and the RIGHT side's planned shuffle is dropped
    (no join-right stage) in favor of streaming its partitions."""
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(40), "lab": np.arange(40) * 2}),
        num_partitions=2)
    small_agg = dim.groupBy("k").agg(F.count("lab").alias("c"))
    # keep the big side above the broadcast threshold so only the post-map
    # left conversion can fire
    monkeypatch.setenv("RDT_AQE_BROADCAST_MAX", "20000")
    out, reports = both_paths(
        monkeypatch, session,
        lambda: small_agg.join(big, on="k").select("k", "a", "c"),
        ["k", "a"])
    monkeypatch.delenv("RDT_AQE_BROADCAST_MAX", raising=False)
    assert _aqe(reports, "aqe_broadcast") >= 1
    assert "join-left" in _stages(reports)      # the measured map stage
    assert "join-right" not in _stages(reports)  # the saved shuffle
    assert (out["c"] == 1).all()


def test_broadcast_threshold_zero_disables(monkeypatch, session, big):
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(40), "label": np.arange(40)}),
        num_partitions=2)
    monkeypatch.setenv("RDT_AQE_BROADCAST_MAX", "0")
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(dim, on="k").select("k", "a", "label"),
        ["k", "a"])
    monkeypatch.delenv("RDT_AQE_BROADCAST_MAX", raising=False)
    assert _aqe(reports, "aqe_broadcast") == 0
    assert {"join-left", "join-right"} <= set(_stages(reports))


def test_measured_bytes_overrule_a_lying_estimate(monkeypatch, session, big):
    """A threshold tighter than the small side's ACTUAL bytes: the estimate
    admits the side, the materialized measurement rejects it, and the join
    falls back to the bucketed path — correct either way."""
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(40), "label": np.arange(40)}),
        num_partitions=2)
    monkeypatch.setenv("RDT_AQE_BROADCAST_MAX", "64")  # nothing fits 64 bytes
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(dim, on="k").select("k", "a", "label"),
        ["k", "a"])
    monkeypatch.delenv("RDT_AQE_BROADCAST_MAX", raising=False)
    assert _aqe(reports, "aqe_broadcast") == 0
    assert len(out) == 6000


# ==== rule (b): skew splitting =====================================================
def _skewed_frame(session, rows=24_000, parts=4):
    """~50% hot key, rest unique, unique rows FIRST per chunk so the
    cardinality guard picks row-wise partials and the skew reaches the
    reduce side (grouped partials would collapse the hot key map-side)."""
    rng = np.random.RandomState(5)
    per = rows // parts
    chunks = []
    nxt = 1
    for _ in range(parts):
        nu = per // 2
        ks = np.concatenate([np.arange(nxt, nxt + nu) * 7 + 3,
                             np.zeros(per - nu, dtype=np.int64)])
        nxt += nu
        chunks.append(pd.DataFrame(
            {"k": ks, "v": rng.randint(0, 1000, per).astype(np.int64)}))
    return session.createDataFrame(pd.concat(chunks).reset_index(drop=True),
                                   num_partitions=parts)


def test_skew_split_decomposable_groupagg(monkeypatch, session):
    df = _skewed_frame(session)
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")  # drop the split floor
    monkeypatch.setenv("RDT_AQE_SKEW_FACTOR", "2")
    out, reports = both_paths(
        monkeypatch, session,
        lambda: df.groupBy("k").agg(F.sum("v").alias("sv"),
                                    F.count("v").alias("n"),
                                    F.mean("v").alias("mv")),
        ["k"])
    monkeypatch.delenv("RDT_AQE_COALESCE_MIN", raising=False)
    monkeypatch.delenv("RDT_AQE_SKEW_FACTOR", raising=False)
    assert _aqe(reports, "aqe_split") >= 1
    # integer sum/count bit-identical; the mean column compared by
    # assert_frame_equal's float equality (same partial tree depth per key
    # is NOT guaranteed, but both_paths already passed — merge order for
    # int inputs is exact in float64 here)
    assert len(out) == 12_000 + 1


def test_skew_split_fallback_aggs_dont_split(monkeypatch, session):
    """Non-decomposable aggs take the single-phase path where a key's rows
    must all reach one task: rule (b) must NOT fire, results identical."""
    df = _skewed_frame(session, rows=8000)
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")
    monkeypatch.setenv("RDT_AQE_SKEW_FACTOR", "2")
    out, reports = both_paths(
        monkeypatch, session,
        lambda: df.groupBy("k").agg(F.stddev("v").alias("sd")),
        ["k"])
    monkeypatch.delenv("RDT_AQE_COALESCE_MIN", raising=False)
    monkeypatch.delenv("RDT_AQE_SKEW_FACTOR", raising=False)
    assert _aqe(reports, "aqe_split") == 0
    assert _stages(reports) == ["groupagg"]


def test_skew_split_join_probe_side(monkeypatch, session):
    """A skewed probe (left) side splits across join tasks, each probing
    the same right bucket; the concat of splits is the bucket's join."""
    df = _skewed_frame(session, rows=16_000)
    dim_keys = np.concatenate([[0], np.arange(1, 8001) * 7 + 3])
    dim = session.createDataFrame(
        pd.DataFrame({"k": dim_keys, "lab": dim_keys * 5}),
        num_partitions=2)
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")
    monkeypatch.setenv("RDT_AQE_SKEW_FACTOR", "2")
    # force the bucketed path (no broadcast) so the probe-split is what runs
    monkeypatch.setenv("RDT_AQE_BROADCAST_MAX", "0")
    out, reports = both_paths(
        monkeypatch, session,
        lambda: df.join(dim, on="k").select("k", "v", "lab"),
        ["k", "v"])
    for k in ("RDT_AQE_COALESCE_MIN", "RDT_AQE_SKEW_FACTOR",
              "RDT_AQE_BROADCAST_MAX"):
        monkeypatch.delenv(k, raising=False)
    assert _aqe(reports, "aqe_split") >= 1
    assert (out["lab"] == out["k"] * 5).all()
    assert len(out) == 16_000


def test_skew_split_gated_off_for_right_emitting_joins(monkeypatch, session):
    """A right/full-outer (or right semi/anti) join may NOT split its probe
    side: every split probes the WHOLE right bucket, so a right-side row
    that survives on its own (unmatched outer row, semi/anti hit) would be
    emitted once per split. The gate mirrors BROADCAST_RIGHT_JOIN_TYPES —
    and both_paths' row-identity assertion is the regression: without the
    gate, unmatched right rows appear k times under AQE."""
    df = _skewed_frame(session, rows=16_000)
    # right side has keys the skewed left never produces → unmatched rows
    dim_keys = np.concatenate([[0], np.arange(1, 2001) * 7 + 3,
                               np.arange(1, 101) * 1_000_003 + 11])
    dim = session.createDataFrame(
        pd.DataFrame({"k": dim_keys, "lab": dim_keys * 5}),
        num_partitions=2)
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")
    monkeypatch.setenv("RDT_AQE_SKEW_FACTOR", "2")
    monkeypatch.setenv("RDT_AQE_BROADCAST_MAX", "0")  # force the bucketed path
    out, reports = both_paths(
        monkeypatch, session,
        lambda: df.join(dim, on="k", how="right outer")
        .select("k", "v", "lab"),
        ["k", "v", "lab"])
    for k in ("RDT_AQE_COALESCE_MIN", "RDT_AQE_SKEW_FACTOR",
              "RDT_AQE_BROADCAST_MAX"):
        monkeypatch.delenv(k, raising=False)
    assert _aqe(reports, "aqe_split") == 0
    # the 100 never-matching right keys survive exactly once each
    assert int(out["v"].isna().sum()) == 100


def test_skew_factor_zero_disables(monkeypatch, session):
    df = _skewed_frame(session, rows=8000)
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")
    monkeypatch.setenv("RDT_AQE_SKEW_FACTOR", "0")
    _, reports = both_paths(
        monkeypatch, session,
        lambda: df.groupBy("k").agg(F.sum("v").alias("sv")),
        ["k"])
    monkeypatch.delenv("RDT_AQE_COALESCE_MIN", raising=False)
    monkeypatch.delenv("RDT_AQE_SKEW_FACTOR", raising=False)
    assert _aqe(reports, "aqe_split") == 0


# ==== rule (c): tiny-partition coalescing ==========================================
def test_repartition_coalescing(monkeypatch, session, big):
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.repartition(8).select("k", "a"),
        ["k", "a"])
    assert _aqe(reports, "aqe_coalesced") >= 1
    assert len(out) == 6000


def test_groupagg_and_distinct_coalescing(monkeypatch, session, big):
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.groupBy("k", "b").agg(F.sum("a").alias("sa")),
        ["k", "b"])
    assert _aqe(reports, "aqe_coalesced") >= 1
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.select("k", "b").distinct(),
        ["k", "b"])
    assert _aqe(reports, "aqe_coalesced") >= 1


def test_coalesce_min_zero_disables(monkeypatch, session, big):
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")
    _, reports = both_paths(
        monkeypatch, session,
        lambda: big.repartition(8).select("k", "a"),
        ["k", "a"])
    monkeypatch.delenv("RDT_AQE_COALESCE_MIN", raising=False)
    assert _aqe(reports, "aqe_coalesced") == 0


def test_consolidate_off_disables_index_rules(monkeypatch, session, big):
    """Legacy per-bucket blobs carry no size index: rules (b)/(c) must not
    fire, results identical (the kill switch is read per action)."""
    monkeypatch.setenv("RDT_SHUFFLE_CONSOLIDATE", "0")
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.repartition(8).select("k", "a"),
        ["k", "a"])
    monkeypatch.delenv("RDT_SHUFFLE_CONSOLIDATE", raising=False)
    assert _aqe(reports, "aqe_coalesced") == 0
    assert _aqe(reports, "aqe_split") == 0
    assert len(out) == 6000


# ==== master switch + edge cases ===================================================
def test_master_switch_off_disables_everything(monkeypatch, session, big):
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(40), "label": np.arange(40)}),
        num_partitions=2)
    monkeypatch.setenv("RDT_ETL_AQE", "0")
    session.engine.reset_shuffle_stage_report()
    big.join(dim, on="k").select("k", "label").to_pandas()
    big.repartition(8).to_pandas()
    reports = session.engine.shuffle_stage_report()
    monkeypatch.delenv("RDT_ETL_AQE", raising=False)
    assert all(r["aqe_broadcast"] == 0 and r["aqe_split"] == 0
               and r["aqe_coalesced"] == 0 for r in reports), reports


def test_empty_frame_edges(monkeypatch, session, big):
    empty = session.createDataFrame(
        pd.DataFrame({"k": np.array([], dtype=np.int64),
                      "label": np.array([], dtype=np.int64)}),
        num_partitions=1)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: big.join(empty, on="k").select("k", "a", "label"),
        ["k", "a"])
    assert len(out) == 0
    out, _ = both_paths(
        monkeypatch, session,
        lambda: empty.groupBy("k").agg(F.count("label").alias("n")),
        ["k"])
    assert len(out) == 0


def test_one_bucket_edge(monkeypatch, session):
    """A single reduce bucket can neither coalesce nor be 'skewed' (no
    median to compare against) — the rules must be clean no-ops."""
    rng = np.random.RandomState(1)
    pdf = pd.DataFrame({"k": rng.randint(0, 5, 500),
                        "v": rng.randint(0, 10, 500)})
    df = session.createDataFrame(pdf, num_partitions=1)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: df.repartition(1).select("k", "v"),
        ["k", "v"])
    assert len(out) == 500
    assert _aqe(reports, "aqe_split") == 0
    assert _aqe(reports, "aqe_coalesced") == 0


def test_estimate_plan_bytes_units():
    from raydp_tpu_torch.etl import plan as P
    from raydp_tpu_torch.runtime.object_store import ObjectRef

    mem = P.InMemory([ObjectRef(id="a" * 32, size=100),
                      ObjectRef(id="b" * 32, size=200)], schema=None)
    assert O.estimate_plan_bytes(mem) == 300
    # row-preserving wrappers pass through; aggregations are unknowable
    assert O.estimate_plan_bytes(P.Limit(mem, 5)) == 300
    assert O.estimate_plan_bytes(
        P.GroupAgg(mem, ["k"], [("v", "sum", "s")])) is None
    rs = P.RangeScan(0, 1000, num_partitions=2)
    est = O.estimate_plan_bytes(rs)
    assert est is not None and est >= 8000
