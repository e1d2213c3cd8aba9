"""Logical-plan optimizer: equivalence vs the naive path + rule unit tests.

The contract: for ANY plan, ``collect()`` under ``RDT_ETL_OPTIMIZER=1`` must
equal ``=0`` row-for-row (after a canonical sort — bucket concat order is not
part of the result), and the engine's shuffled-byte counters must strictly
drop where a rule should fire.

The port's twin of ``tests/test_etl_optimizer.py``: its cases, data, sizes
and assertions, run against ``raydp_tpu_torch``, whose copies of these
planes they guard against drift.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from raydp_tpu_torch.etl import functions as F
from raydp_tpu_torch.etl import optimizer as O
from raydp_tpu_torch.etl import plan as P
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.etl.expressions import col, substitute_columns


@pytest.fixture(scope="module")
def session():
    """Module-scoped session override: these ~12 tests share one 2-executor
    gang instead of paying ~9s of bring-up each — the tier-1 870s window is
    a shared budget, and plans/frames are immutable so reuse is safe."""
    import raydp_tpu_torch

    s = raydp_tpu_torch.init("pytest_opt", num_executors=2, executor_cores=1,
                       executor_memory="512MB")
    yield s
    raydp_tpu_torch.stop()


@pytest.fixture(scope="module")
def wide(session):
    """Null-heavy wide frame: key + 6 columns, several dtypes."""
    rng = np.random.RandomState(0)
    n = 2000
    pdf = pd.DataFrame({
        "k": rng.randint(0, 9, n),
        "a": rng.randint(0, 1000, n).astype(np.int64),
        "b": rng.random_sample(n),
        "s": [f"tag{i % 13}" for i in range(n)],
        "c": rng.randint(0, 50, n).astype(float),
        "d": rng.randint(0, 7, n),
        "e": rng.random_sample(n),
    })
    pdf.loc[rng.rand(n) < 0.15, "b"] = np.nan
    pdf.loc[rng.rand(n) < 0.1, "c"] = np.nan
    return session.createDataFrame(pdf, num_partitions=4)


def both_paths(monkeypatch, session, make_df, sort_cols, approx=False):
    """collect() under optimizer off and on; assert equal; return reports."""
    outs, reports = {}, {}
    for env in ("0", "1"):
        monkeypatch.setenv("RDT_ETL_OPTIMIZER", env)
        session.engine.reset_shuffle_stage_report()
        outs[env] = (make_df().to_pandas().sort_values(sort_cols)
                     .reset_index(drop=True))
        reports[env] = session.engine.shuffle_stage_report()
    monkeypatch.delenv("RDT_ETL_OPTIMIZER", raising=False)
    if approx:
        pd.testing.assert_frame_equal(outs["0"], outs["1"], check_exact=False)
    else:
        pd.testing.assert_frame_equal(outs["0"], outs["1"])
    return outs["1"], reports


def _bytes(report):
    return sum(r["bytes_shuffled"] for r in report)


# ==== equivalence matrix ===========================================================
def test_groupagg_matrix_equivalent_and_fewer_bytes(monkeypatch, session, wide):
    out, reports = both_paths(
        monkeypatch, session,
        lambda: wide.groupBy("k").agg(
            F.sum("a").alias("sa"), F.mean("b").alias("mb"),
            F.count("a").alias("n"), F.min("c").alias("mn"),
            F.max("a").alias("mx")),
        ["k"], approx=True)
    assert len(out) == 9
    # partial aggregation + pruning must strictly shrink the shuffle
    assert _bytes(reports["1"]) < _bytes(reports["0"])
    assert [r["stage"] for r in reports["1"]] == ["groupagg-partial"]
    assert (sum(r["rows_shuffled"] for r in reports["1"])
            < sum(r["rows_shuffled"] for r in reports["0"]))
    # the in/out split shows the map-side reduction: every input row enters
    # the stage, roughly keys×maps partial rows leave it
    stage = reports["1"][0]
    assert stage["rows_in"] == 2000
    assert stage["rows_shuffled"] < stage["rows_in"]
    assert 0 < stage["bytes_shuffled"] < stage["bytes_in"]


def test_groupagg_nondecomposable_falls_back(monkeypatch, session, wide):
    out, reports = both_paths(
        monkeypatch, session,
        lambda: wide.groupBy("k").agg(F.stddev("a").alias("sd"),
                                      F.count_distinct("d").alias("cd")),
        ["k"], approx=True)
    assert [r["stage"] for r in reports["1"]] == ["groupagg"]
    # projection pruning still narrows the shuffle even without partials
    assert _bytes(reports["1"]) < _bytes(reports["0"])


def test_join_projected_equivalent_and_fewer_bytes(monkeypatch, session, wide):
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(9), "label": [f"L{i}" for i in range(9)],
                      "extra": np.arange(9) * 2.0}),
        num_partitions=2)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: wide.join(dim, on="k").select("k", "a", "label"),
        ["k", "a"])
    assert set(out.columns) == {"k", "a", "label"}
    assert _bytes(reports["1"]) < _bytes(reports["0"])


def test_filter_pushdown_through_project_rename_union(monkeypatch, session,
                                                      wide):
    def make():
        u = wide.select("k", "a").union(wide.select("k", "a"))
        return (u.withColumnRenamed("a", "aa")
                .filter(col("aa") % 3 == 0)
                .filter(col("k") > 2))

    out, _ = both_paths(monkeypatch, session, make, ["k", "aa"])
    assert (out["aa"] % 3 == 0).all() and (out["k"] > 2).all()


def test_window_then_groupby_composition(monkeypatch, session, wide):
    from raydp_tpu_torch.etl.window import Window

    w = Window.partitionBy("k").orderBy("a")

    def make():
        return (wide.withColumn("rn", F.row_number().over(w))
                .filter(col("rn") <= 5)
                .groupBy("k").agg(F.sum("a").alias("sa"),
                                  F.count("rn").alias("n")))

    out, _ = both_paths(monkeypatch, session, make, ["k"])
    assert (out["n"] <= 5).all()


def test_groupagg_high_cardinality_rowwise_partials(monkeypatch, session):
    """Near-unique keys: the sampled guard must emit row-wise partials (no
    per-map hash pass, rows shuffled == rows in) and still merge exactly —
    the committed bench recorded +47% wall on 100k-cardinality keys when
    partials were grouped unconditionally."""
    rng = np.random.RandomState(4)
    n = 3000
    pdf = pd.DataFrame({"k": rng.permutation(n),
                        "v": rng.randint(0, 100, n).astype(np.int64),
                        "f": rng.randint(0, 9, n).astype(float)})
    df = session.createDataFrame(pdf, num_partitions=3)
    out, reports = both_paths(
        monkeypatch, session,
        lambda: df.groupBy("k").agg(F.sum("v").alias("s"),
                                    F.mean("f").alias("m"),
                                    F.count("v").alias("n")),
        ["k"])
    assert len(out) == n and (out["n"] == 1).all()
    stage = reports["1"][0]
    assert stage["stage"] == "groupagg-partial"
    # unique keys: nothing to collapse, so the guard passes rows through 1:1
    assert stage["rows_shuffled"] == stage["rows_in"] == n


def test_rowwise_partials_match_grouped_partials():
    """The two partial representations must merge to the same result: a raw
    row is a group of size 1 (types widened identically via the probe)."""
    t = pa.table({"k": list(range(6)),
                  "v": pa.array([1, None, 3, 4, None, 6], pa.int32()),
                  "b": [True, False, None, True, True, False]})
    partials, merges = T.decompose_aggs(
        [("v", "sum", "s"), ("v", "mean", "m"), ("v", "count", "n"),
         ("b", "sum", "bs")])
    step = T.GroupAggPartialStep(["k"], partials)
    grouped = step.run(t)            # 6 rows < 256 → grouped path
    rowwise = step._rowwise(t)
    merge = T.GroupAggMergeStep(["k"], merges)
    a = merge.run(grouped).sort_by("k")
    b = merge.run(rowwise).sort_by("k")
    assert a.equals(b), (a.to_pylist(), b.to_pylist())


def test_distinct_and_limit_composition(monkeypatch, session, wide):
    out, _ = both_paths(
        monkeypatch, session,
        lambda: wide.select("k", "d").distinct(),
        ["k", "d"])
    assert len(out) == len(out.drop_duplicates())

    both_paths(monkeypatch, session,
               lambda: wide.select("k", "a").limit(7), ["k", "a"])


def test_sort_with_pruned_payload(monkeypatch, session, wide):
    both_paths(monkeypatch, session,
               lambda: wide.select("k", "a", "b").sort(
                   "k", ("a", "descending")),
               ["k", "a"], approx=True)


def test_null_heavy_mean_sum_count(monkeypatch, session):
    pdf = pd.DataFrame({
        "k": [1, 1, 2, 2, 3, 3] * 50,
        "v": ([None, None, 1.0, None, 2.0, 3.0] * 50),
    })
    df = session.createDataFrame(pdf, num_partitions=3)
    # approx: float partials sum in a different order than one-pass
    # aggregation, so the last ulp may differ (bit-identity holds for ints)
    out, _ = both_paths(
        monkeypatch, session,
        lambda: df.groupBy("k").agg(F.mean("v").alias("m"),
                                    F.sum("v").alias("s"),
                                    F.count("v").alias("n")),
        ["k"], approx=True)
    row = out.set_index("k")
    assert pd.isna(row.loc[1, "m"]) and row.loc[1, "n"] == 0
    assert row.loc[2, "m"] == 1.0 and row.loc[2, "n"] == 50  # nulls skipped
    assert row.loc[3, "m"] == 2.5 and row.loc[3, "n"] == 100


def test_filter_does_not_commute_with_sample(monkeypatch, session, wide):
    """Sample draws are positional: sinking a filter below sample would pick
    a DIFFERENT random row set. The optimizer must keep the filter above."""
    out, _ = both_paths(
        monkeypatch, session,
        lambda: wide.sample(0.5, seed=11).filter(col("k") > 4)
                    .select("k", "a"),
        ["k", "a"])
    assert (out["k"] > 4).all()
    a, b = wide.randomSplit([0.5, 0.5], seed=5)
    both_paths(monkeypatch, session,
               lambda: a.filter(col("d") < 3).select("k", "d"), ["k", "d"])


def test_filter_stack_order_preserved_guard_predicate(monkeypatch, session):
    """An earlier filter may GUARD a later one (b != 0 before a/b): Arrow
    kernels raise eagerly instead of yielding null, so the optimizer must
    never reorder stacked filters (code-review finding: the leapfrogged
    divide crashed with ArrowInvalid where the naive path returned rows)."""
    df = session.createDataFrame(
        pd.DataFrame({"a": [10, 20, 30, 40], "b": [0, 2, 0, 4]}),
        num_partitions=2)
    out, _ = both_paths(
        monkeypatch, session,
        lambda: df.filter(col("b") != 0).filter((col("a") / col("b")) > 6),
        ["a", "b"])
    assert out["a"].tolist() == [20, 40]


def test_hash_buckets_nested_column_falls_back():
    """Non-dictionary-encodable key columns (nested types) must take the
    per-row fallback, not crash (code-review finding: dead except clause)."""
    t = pa.table({"k": pa.array([[1, 2], [1, 2], [3]]), "v": [1, 2, 3]})
    buckets = T.hash_buckets(t, ["k"], 4)
    assert sum(b.num_rows for b in buckets) == 3
    # equal nested keys land in the same bucket
    homes = [i for i, b in enumerate(buckets)
             if [1, 2] in b.column("k").to_pylist()]
    assert len(homes) == 1


def test_window_chain_stays_one_shuffle(monkeypatch, session, wide):
    from raydp_tpu_torch.etl.window import Window

    w = Window.partitionBy("k").orderBy("a")

    def make():
        return (wide.withColumn("rn", F.row_number().over(w))
                .withColumn("prev", F.lag("a", 1, -1).over(w))
                .select("k", "a", "rn", "prev"))

    out, reports = both_paths(monkeypatch, session, make, ["k", "a"])
    # same-spec windows collapse into ONE shuffle on both paths — a prune
    # Project inserted between them would split the chain
    assert [r["stage"] for r in reports["1"]] == ["window"]
    assert [r["stage"] for r in reports["0"]] == ["window"]
    assert _bytes(reports["1"]) < _bytes(reports["0"])


# ==== regressions ==================================================================
def test_negative_zero_groupby_single_key_row(monkeypatch, session):
    df = session.createDataFrame(
        pd.DataFrame({"k": [0.0, -0.0, 1.0, -0.0, 0.0],
                      "v": [1, 2, 3, 4, 5]}), num_partitions=2)
    for env in ("0", "1"):
        monkeypatch.setenv("RDT_ETL_OPTIMIZER", env)
        out = df.groupBy("k").agg(F.sum("v").alias("sv")).to_pandas()
        assert len(out) == 2, out
        assert sorted(out["sv"]) == [3, 12]
    assert df.dropDuplicates(["k"]).count() == 2


def test_negative_zero_hash_buckets_agree():
    t = pa.table({"k": pa.array([0.0, -0.0], pa.float64())})
    buckets = T.hash_buckets(t, ["k"], 16)
    nonempty = [i for i, b in enumerate(buckets) if b.num_rows]
    assert len(nonempty) == 1 and buckets[nonempty[0]].num_rows == 2


def test_string_and_dictionary_keys_hash_equal():
    strings = pa.array(["x", "y", None, "x", "z"])
    plain = pa.table({"k": strings, "v": [1, 2, 3, 4, 5]})
    as_dict = pa.table({"k": strings.dictionary_encode(),
                        "v": [1, 2, 3, 4, 5]})
    nb = 8
    for b_plain, b_dict in zip(T.hash_buckets(plain, ["k"], nb),
                               T.hash_buckets(as_dict, ["k"], nb)):
        assert b_plain.column("v").to_pylist() == \
            b_dict.column("v").to_pylist()


def test_single_pass_bucketing_matches_filter_loop():
    rng = np.random.RandomState(2)
    t = pa.table({"k": rng.randint(0, 100, 500), "v": np.arange(500)})
    bucket = np.asarray(t.column("k")) % 7
    got = T.split_by_bucket(t, bucket.astype(np.int64), 7)
    for b in range(7):
        expect = t.filter(pa.array(bucket == b))
        assert got[b].equals(expect)
    assert sum(g.num_rows for g in got) == 500


def test_round_robin_and_random_buckets_exhaustive():
    t = pa.table({"v": np.arange(101)})
    rr = T.round_robin_buckets(t, 4, start=2)
    assert sum(b.num_rows for b in rr) == 101
    assert pa.concat_tables(rr).sort_by("v").equals(t)
    rb = T.random_buckets(t, 4, seed=9)
    assert sum(b.num_rows for b in rb) == 101
    assert pa.concat_tables(rb).sort_by("v").equals(t)
    # determinism: a recomputed map task lands rows identically
    rb2 = T.random_buckets(t, 4, seed=9)
    for x, y in zip(rb, rb2):
        assert x.equals(y)


# ==== optimizer rule unit tests (pure plan level) ==================================
def test_references_walks_expression_trees():
    from raydp_tpu_torch.etl.expressions import when
    e = (col("a") + col("b") * 2).alias("x")
    assert e.references() == {"a", "b"}
    w = when(col("p") > 0, col("q")).otherwise(col("r"))
    assert w.references() == {"p", "q", "r"}
    assert substitute_columns(w, {"p": "pp"}).references() == {"pp", "q", "r"}


def test_prune_pushes_columns_into_parquet_scan():
    scan = P.ParquetScan(["f.parquet"])
    plan = P.GroupAgg(scan, ["k"], [("v", "sum", "sv")])
    opt = O.prune_columns(plan, None)
    assert isinstance(opt.child, P.ParquetScan)
    assert opt.child.columns == ["k", "v"]


def test_prune_inserts_post_read_project_for_csv():
    scan = P.CsvScan(["f.csv"])
    plan = P.GroupAgg(scan, ["k"], [("v", "sum", "sv")])
    opt = O.prune_columns(plan, None)
    assert isinstance(opt.child, P.Project)
    assert [n for n, _ in opt.child.columns] == ["k", "v"]


def test_filter_sinks_below_rename_with_rewritten_names():
    plan = P.Filter(P.Rename(P.CsvScan(["f.csv"]), {"old": "new"}),
                    col("new") > 3)
    opt = O.push_filters(plan)
    assert isinstance(opt, P.Rename)
    assert isinstance(opt.child, P.Filter)
    assert opt.child.predicate.references() == {"old"}


def test_filter_sinks_below_union_and_passthrough_project():
    proj = P.Project(P.CsvScan(["f.csv"]), [("k", col("k")), ("v", col("v"))])
    plan = P.Filter(P.Union([proj, proj]), col("k") > 0)
    opt = O.push_filters(plan)
    assert isinstance(opt, P.Union)
    for inp in opt.inputs:
        assert isinstance(inp, P.Project)
        assert isinstance(inp.child, P.Filter)


def test_filter_stays_above_computed_projection():
    proj = P.Project(P.CsvScan(["f.csv"]), [("x", col("a") + 1)])
    plan = P.Filter(proj, col("x") > 0)
    opt = O.push_filters(plan)
    assert isinstance(opt, P.Filter)  # cannot sink below the computation


def test_optimizer_disabled_is_identity(monkeypatch):
    monkeypatch.setenv("RDT_ETL_OPTIMIZER", "0")
    plan = P.GroupAgg(P.ParquetScan(["f.parquet"]), ["k"],
                      [("v", "sum", "sv")])
    assert O.optimize(plan) is plan
    monkeypatch.setenv("RDT_ETL_OPTIMIZER", "1")
    assert O.optimize(plan) is not plan


def test_decompose_aggs_shares_partials():
    partials, merges = T.decompose_aggs(
        [("v", "mean", "m"), ("v", "sum", "s"), ("v", "count", "n"),
         ("w", "min", "lo")])
    # mean shares its sum partial with sum() and its count with count()
    assert len(partials) == 3
    kinds = {out: kind for out, kind, _ in merges}
    assert kinds == {"m": "mean", "s": "sum", "n": "sum", "lo": "min"}
    with pytest.raises(ValueError):
        T.decompose_aggs([("v", "stddev", "x")])
