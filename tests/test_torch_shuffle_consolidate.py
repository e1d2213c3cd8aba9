"""Consolidated shuffle fast path: on/off equivalence + control-plane drop.

The contract (mirror of test_etl_optimizer.py's matrix): for EVERY shuffle
flavor, ``RDT_SHUFFLE_CONSOLIDATE=1`` (all buckets of a map task in ONE blob,
read back by byte range) must produce row-for-row identical results to ``=0``
(one blob per bucket), while the stage ledger's ``meta_rpcs`` counter strictly
drops — fewer store control-plane calls is the whole point of the path.

The port's twin of ``tests/test_shuffle_consolidate.py``: its cases, data,
sizes and assertions, run against ``raydp_tpu_torch``, whose copies of these
planes they guard against drift.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from raydp_tpu_torch.etl import functions as F
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.etl.expressions import col
from raydp_tpu_torch.runtime.object_store import ObjectRef, get_client


@pytest.fixture(scope="module")
def session():
    """Module-scoped session: the matrix shares one 2-executor gang."""
    import raydp_tpu_torch

    s = raydp_tpu_torch.init("pytest_consol", num_executors=2, executor_cores=1,
                       executor_memory="512MB")
    yield s
    raydp_tpu_torch.stop()


@pytest.fixture(scope="module")
def wide(session):
    """Integer payloads only, so every flavor compares bit-exact."""
    rng = np.random.RandomState(3)
    n = 2400
    pdf = pd.DataFrame({
        "k": rng.randint(0, 11, n),
        "a": rng.randint(0, 1000, n).astype(np.int64),
        "d": rng.randint(0, 5, n),
        "s": [f"tag{i % 7}" for i in range(n)],
    })
    return session.createDataFrame(pdf, num_partitions=4)


def both_modes(monkeypatch, session, make, sort_cols):
    """Run ``make()`` with consolidation off then on; assert identical
    results; return the per-mode stage reports. Pipelining is pinned OFF:
    this matrix measures the consolidated CONTROL plane, and a pipelined
    stage overlaps map and reduce tasks on one executor, double-counting
    their shared per-process RPC-delta windows — the meta_rpcs
    strictly-drop assertion would turn timing-dependent
    (tests/test_shuffle_pipeline.py owns the pipelined matrix)."""
    outs, reports = {}, {}
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "0")
    for env in ("0", "1"):
        monkeypatch.setenv("RDT_SHUFFLE_CONSOLIDATE", env)
        session.engine.reset_shuffle_stage_report()
        out = make()
        if sort_cols:
            out = out.sort_values(sort_cols).reset_index(drop=True)
        outs[env] = out
        reports[env] = session.engine.shuffle_stage_report()
    monkeypatch.delenv("RDT_SHUFFLE_CONSOLIDATE", raising=False)
    pd.testing.assert_frame_equal(outs["0"], outs["1"])
    # every shuffle stage carries the flag for its mode, and batching +
    # single-seal map outputs strictly shrink the control plane
    assert reports["0"] and reports["1"]
    assert all(not r["consolidated"] for r in reports["0"]), reports["0"]
    assert all(r["consolidated"] for r in reports["1"]), reports["1"]
    meta0 = sum(r["meta_rpcs"] for r in reports["0"])
    meta1 = sum(r["meta_rpcs"] for r in reports["1"])
    assert 0 < meta1 < meta0, (meta0, meta1)
    return outs["1"], reports


# ==== equivalence matrix ===========================================================
def test_groupagg_partial_consolidated(monkeypatch, session, wide):
    out, _ = both_modes(
        monkeypatch, session,
        lambda: wide.groupBy("k").agg(F.sum("a").alias("sa"),
                                      F.count("a").alias("n"),
                                      F.min("d").alias("mn")).to_pandas(),
        ["k"])
    assert len(out) == 11


def test_groupagg_single_phase_consolidated(monkeypatch, session, wide):
    # optimizer off: the naive single-phase shuffle, full rows crossing
    monkeypatch.setenv("RDT_ETL_OPTIMIZER", "0")
    out, reports = both_modes(
        monkeypatch, session,
        lambda: wide.groupBy("k").agg(F.sum("a").alias("sa")).to_pandas(),
        ["k"])
    monkeypatch.delenv("RDT_ETL_OPTIMIZER", raising=False)
    assert [r["stage"] for r in reports["1"]] == ["groupagg"]
    assert len(out) == 11


def test_join_both_sides_consolidated(monkeypatch, session, wide):
    # AQE off: this test pins the BUCKETED shuffle-join's consolidated
    # format (with it on, the tiny dim side broadcasts and neither side
    # shuffles at all — covered by tests/test_aqe.py instead)
    monkeypatch.setenv("RDT_ETL_AQE", "0")
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(11), "label": np.arange(11) * 3}),
        num_partitions=2)
    out, reports = both_modes(
        monkeypatch, session,
        lambda: wide.join(dim, on="k").select("k", "a", "label").to_pandas(),
        ["k", "a"])
    assert {r["stage"] for r in reports["1"]} == {"join-left", "join-right"}
    assert (out["label"] == out["k"] * 3).all()


def test_window_consolidated(monkeypatch, session, wide):
    from raydp_tpu_torch.etl.window import Window

    w = Window.partitionBy("k").orderBy("a")
    out, _ = both_modes(
        monkeypatch, session,
        lambda: (wide.withColumn("rn", F.row_number().over(w))
                 .select("k", "a", "rn").to_pandas()),
        ["k", "a", "rn"])
    assert out["rn"].min() == 1


def test_distinct_consolidated(monkeypatch, session, wide):
    out, _ = both_modes(
        monkeypatch, session,
        lambda: wide.select("k", "d").distinct().to_pandas(),
        ["k", "d"])
    assert len(out) == len(out.drop_duplicates())


def test_repartition_consolidated(monkeypatch, session, wide):
    both_modes(monkeypatch, session,
               lambda: wide.repartition(6).to_pandas(),
               ["k", "a", "d", "s"])


def test_sort_range_consolidated(monkeypatch, session, wide):
    out, reports = both_modes(
        monkeypatch, session,
        lambda: wide.sort("k", ("a", "descending")).to_pandas()
        .reset_index(drop=True),
        None)  # sort output order IS the result; no canonical re-sort
    assert [r["stage"] for r in reports["1"]] == ["sort-range"]
    assert (out["k"].values[:-1] <= out["k"].values[1:]).all()


def test_random_shuffle_consolidated(monkeypatch, session, wide):
    def shuffled():
        eng = session.engine
        refs, schema, _ = eng.materialize(wide._plan)
        client = get_client()
        try:
            out_refs, rows = eng.random_shuffle_refs(refs, schema, seed=7)
            try:
                tables = [client.get(r) for r in out_refs]
                return pa.concat_tables(
                    tables, promote_options="permissive").to_pandas()
            finally:
                client.free(out_refs)
        finally:
            client.free(refs)

    out, reports = both_modes(monkeypatch, session, shuffled,
                              ["k", "a", "d", "s"])
    assert [r["stage"] for r in reports["1"]] == ["random-shuffle"]
    assert len(out) == 2400


def test_string_keys_and_empty_buckets_consolidated(monkeypatch, session,
                                                    wide):
    """String-keyed groupby at low cardinality leaves most buckets empty —
    the consolidated index must round-trip empty bucket streams too."""
    out, _ = both_modes(
        monkeypatch, session,
        lambda: wide.groupBy("s").agg(F.count("a").alias("n")).to_pandas(),
        ["s"])
    assert len(out) == 7 and out["n"].sum() == 2400


def test_consolidated_report_columns(monkeypatch, session, wide):
    """The ledger carries the new control-plane columns on every entry, and
    the consolidated map stage seals ONE blob per map task."""
    monkeypatch.setenv("RDT_SHUFFLE_CONSOLIDATE", "1")
    session.engine.reset_shuffle_stage_report()
    wide.groupBy("k").agg(F.sum("a").alias("sa")).to_pandas()
    report = session.engine.shuffle_stage_report()
    monkeypatch.delenv("RDT_SHUFFLE_CONSOLIDATE", raising=False)
    for entry in report:
        assert {"meta_rpcs", "fetch_rpcs", "consolidated"} <= set(entry)
        assert entry["meta_rpcs"] > 0
        # single-machine pool: every read is a local shm slice, no payload
        # fetch RPC ever fires
        assert entry["fetch_rpcs"] == 0


# ==== unit level ===================================================================
def test_range_ref_source_reads_consolidated_blob():
    """A hand-built consolidated blob (back-to-back IPC streams) decodes
    bucket-exact through RangeRefSource, and the 0-part case shares
    ArrowRefSource's schema fallback."""
    from raydp_tpu_torch.runtime import object_store as os_mod

    srv = os_mod.ObjectStoreServer("sessconsol01")
    cli = os_mod.ObjectStoreClient(srv, "sessconsol01")
    cli._arena_probed = True
    cli._arena = None
    old = os_mod._client
    os_mod.set_client(cli)
    try:
        buckets = [pa.table({"x": list(range(i * 3, i * 3 + 3))})
                   for i in range(3)] + [pa.table({"x": pa.array([], pa.int64())})]
        sink = pa.BufferOutputStream()
        index = []
        for b in buckets:
            start = sink.tell()
            with pa.ipc.new_stream(sink, b.schema) as w:
                w.write_table(b)
            index.append((int(start), int(sink.tell() - start), b.num_rows))
        ref = cli.put_raw(memoryview(sink.getvalue()))
        for b, (off, size, rows) in zip(buckets, index):
            got = T.RangeRefSource([(ref, off, size)]).load()
            assert got.equals(b) and got.num_rows == rows
        # concat across ranges behaves like ArrowRefSource concat
        all_rows = T.RangeRefSource(
            [(ref, off, size) for off, size, _ in index]).load()
        assert all_rows.column("x").to_pylist() == list(range(9))

        schema = buckets[0].schema.serialize().to_pybytes()
        empty_range = T.RangeRefSource([], schema=schema).load()
        empty_arrow = T.ArrowRefSource([], schema=schema).load()
        assert empty_range.equals(empty_arrow)
        with pytest.raises(ValueError):
            T.RangeRefSource([]).load()
    finally:
        os_mod.set_client(old)
        srv.shutdown()


def test_patch_and_input_ids_cover_range_sources():
    """Lineage ref surgery must reach RangeRefSource parts and a join's
    right_parts — offsets survive the swap (reruns are byte-identical)."""
    old = [ObjectRef(id=f"{i:032x}", size=100) for i in range(3)]
    new = ObjectRef(id="f" * 32, size=100)
    task = T.Task(
        task_id="t",
        source=T.RangeRefSource([(old[0], 0, 10), (old[1], 10, 20)]),
        steps=[T.HashJoinStep([], ["k"], ["k"],
                              right_parts=[(old[2], 5, 7)])])
    assert sorted(T.task_input_ids(task)) == sorted(r.id for r in old)

    patched = T.patch_task_refs(task, {old[0].id: new, old[2].id: new})
    assert patched.source.parts[0] == (new, 0, 10)
    assert patched.source.parts[1] == (old[1], 10, 20)
    assert patched.steps[0].right_parts == [(new, 5, 7)]
    # no-match mapping returns the identical task object
    assert T.patch_task_refs(task, {"e" * 32: new}) is task


def test_bucket_source_mixes_legacy_and_consolidated():
    """A stage whose maps disagree on the format (e.g. recovery reran a
    producer under a flipped env) still builds one coherent reader: legacy
    refs normalize to full-blob ranges."""
    from raydp_tpu_torch.etl.engine import Engine

    ref = ObjectRef(id="a" * 32, size=64)
    triple = (ObjectRef(id="b" * 32, size=256), 32, 16)
    src = Engine._bucket_source([ref, triple], None)
    assert isinstance(src, T.RangeRefSource)
    assert src.parts == [(ref, 0, 64), triple]
    legacy = Engine._bucket_source([ref], None)
    assert isinstance(legacy, T.ArrowRefSource) and legacy.refs == [ref]


def test_gather_buckets_transposes_consolidated_results():
    from raydp_tpu_torch.etl.engine import Engine, _ActionTemps

    cref = ObjectRef(id="c" * 32, size=300)
    legacy = [ObjectRef(id=f"{i:031x}d", size=10) for i in range(2)]
    results = [
        {"consolidated_ref": cref,
         "bucket_index": [(0, 100, 5), (100, 200, 7)]},
        {"bucket_refs": legacy},
    ]
    temps = _ActionTemps()
    buckets = Engine._gather_buckets(results, 2, temps)
    assert buckets[0] == [(cref, 0, 100), legacy[0]]
    assert buckets[1] == [(cref, 100, 200), legacy[1]]
    # ONE temp for the consolidated blob, one per legacy bucket
    assert [r.id for r in temps] == [cref.id] + [r.id for r in legacy]
