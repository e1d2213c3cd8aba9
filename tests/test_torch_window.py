"""Window functions (Spark parity surface: row_number/rank/dense_rank/
lag/lead + aggregates over a partition). Evaluation is distributed — rows
hash-shuffle by partition key and each bucket evaluates its whole partitions.

The port's twin of ``tests/test_window.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import numpy as np
import pandas as pd

from raydp_tpu_torch.etl import functions as F
from raydp_tpu_torch.etl.window import Window
from tests.torch_fixtures import session  # noqa: F401


def _events(session, n=2000, users=13, parts=4):
    rng = np.random.RandomState(0)
    pdf = pd.DataFrame({
        "user": rng.randint(0, users, n),
        "ts": rng.permutation(n),
        "amount": rng.rand(n).round(4),
    })
    return pdf, session.createDataFrame(pdf, num_partitions=parts)


def test_row_number(session):
    pdf, df = _events(session)
    w = Window.partitionBy("user").orderBy("ts")
    out = df.withColumn("rn", F.row_number().over(w)).to_pandas()
    exp = pdf.copy()
    exp["rn"] = exp.sort_values("ts").groupby("user").cumcount() + 1
    merged = out.sort_values(["user", "ts"]).reset_index(drop=True)
    expected = exp.sort_values(["user", "ts"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(merged, expected, check_dtype=False)


def test_rank_and_dense_rank_with_ties(session):
    rng = np.random.RandomState(1)
    pdf = pd.DataFrame({
        "k": rng.randint(0, 5, 600),
        "score": rng.randint(0, 10, 600),  # heavy ties
    })
    df = session.createDataFrame(pdf, num_partitions=4)
    w = Window.partitionBy("k").orderBy("score")
    out = (df.withColumn("r", F.rank().over(w))
             .withColumn("dr", F.dense_rank().over(w)).to_pandas())
    exp = pdf.copy()
    exp["r"] = exp.groupby("k")["score"].rank(method="min").astype(int)
    exp["dr"] = exp.groupby("k")["score"].rank(method="dense").astype(int)
    key = ["k", "score", "r", "dr"]
    pd.testing.assert_frame_equal(
        out[key].sort_values(key).reset_index(drop=True),
        exp[key].sort_values(key).reset_index(drop=True), check_dtype=False)


def test_lag_lead(session):
    pdf, df = _events(session, n=500, users=7)
    w = Window.partitionBy("user").orderBy("ts")
    out = (df.withColumn("prev", F.lag("amount", 1, -1.0).over(w))
             .withColumn("next", F.lead("amount", 1).over(w))
             .to_pandas().sort_values(["user", "ts"]).reset_index(drop=True))
    exp = pdf.sort_values(["user", "ts"]).reset_index(drop=True)
    g = exp.groupby("user")["amount"]
    exp["prev"] = g.shift(1).fillna(-1.0)
    exp["next"] = g.shift(-1)
    pd.testing.assert_frame_equal(out, exp, check_dtype=False)


def test_aggregate_over_partition(session):
    pdf, df = _events(session, n=800, users=9)
    w = Window.partitionBy("user")
    out = (df.withColumn("total", F.sum("amount").over(w))
             .withColumn("n", F.count("amount").over(w))
             .to_pandas())
    exp_total = pdf.groupby("user")["amount"].sum()
    exp_n = pdf.groupby("user")["amount"].count()
    for u in exp_total.index:
        rows = out[out["user"] == u]
        np.testing.assert_allclose(rows["total"], exp_total[u], rtol=1e-9)
        assert (rows["n"] == exp_n[u]).all()


def test_global_window_no_partition(session):
    pdf, df = _events(session, n=300, users=3)
    w = Window.orderBy("ts")
    out = df.withColumn("rn", F.row_number().over(w)).to_pandas()
    assert sorted(out["rn"]) == list(range(1, 301))
    # row numbers follow the global ts order
    assert (out.sort_values("ts")["rn"].to_numpy() == np.arange(1, 301)).all()


def test_window_replaces_existing_column(session):
    pdf, df = _events(session, n=200, users=4)
    w = Window.partitionBy("user").orderBy("ts")
    out = df.withColumn("amount2", F.lag("amount").over(w)) \
            .withColumn("amount2", F.lead("amount").over(w)).to_pandas()
    assert "amount2" in out.columns
    assert list(out.columns).count("amount2") == 1


def test_window_requires_order(session):
    import pytest

    with pytest.raises(ValueError, match="orderBy"):
        F.row_number().over(Window.partitionBy("user"))


def test_count_star_and_empty_bucket_types(session):
    """count("*") over a partition (the Spark-standard spelling) and string
    min over few distinct keys (some hash buckets empty — the empty-bucket
    output type must match the non-empty buckets)."""
    pdf = pd.DataFrame({
        "k": [1, 1, 2] * 50,
        "name": ["bb", "aa", "cc"] * 50,
        "v": list(range(150)),
    })
    df = session.createDataFrame(pdf, num_partitions=3)
    out = (df.withColumn("n", F.count("*").over(Window.partitionBy("k")))
             .withColumn("lo", F.min("name").over(Window.partitionBy("k")))
             .to_pandas())
    assert set(out[out["k"] == 1]["n"]) == {100}
    assert set(out[out["k"] == 2]["n"]) == {50}
    assert set(out[out["k"] == 1]["lo"]) == {"aa"}
    assert set(out[out["k"] == 2]["lo"]) == {"cc"}
    # integer sum keeps integer dtype even with empty buckets around
    out2 = df.withColumn("t", F.sum("v").over(Window.partitionBy("k")))
    assert pd.api.types.is_integer_dtype(out2.to_pandas()["t"])


def test_chained_window_columns_no_reexecution(session):
    """Chaining window columns must derive the schema statically — listing
    columns between the two withColumn calls must not execute the first
    window's shuffle."""
    pdf, df = _events(session, n=300, users=4)
    w = Window.partitionBy("user").orderBy("ts")
    one = df.withColumn("rn", F.row_number().over(w))
    # schema known without running the plan
    assert one._schema is not None
    assert one.columns == ["user", "ts", "amount", "rn"]
    both = one.withColumn("prev", F.lag("amount").over(w))
    assert both._schema is not None
    out = both.to_pandas()
    assert {"rn", "prev"} <= set(out.columns)


def test_running_aggregate_with_order(session):
    """Spark's default frame WITH orderBy is unboundedPreceding..currentRow:
    sum over an ordered window is a RUNNING sum, and order-key ties share
    the frame (RANGE semantics) — verified against a pandas expanding sum
    with tie correction."""
    pdf = pd.DataFrame({
        "k": [1, 1, 1, 1, 2, 2, 2],
        "ts": [1, 2, 2, 3, 1, 2, 3],   # a tie at (k=1, ts=2)
        "x": [10.0, 20.0, 30.0, 40.0, 1.0, 2.0, 3.0],
    })
    df = session.createDataFrame(pdf, num_partitions=3)
    w = Window.partitionBy("k").orderBy("ts")
    out = (df.withColumn("run", F.sum("x").over(w))
             .withColumn("n", F.count("*").over(w))
             .to_pandas().sort_values(["k", "ts", "x"]).reset_index(drop=True))
    # k=1: rows ts=1→10; the ts=2 PEERS both see 10+20+30=60; ts=3→100
    assert out[out["k"] == 1]["run"].tolist() == [10.0, 60.0, 60.0, 100.0]
    assert out[out["k"] == 1]["n"].tolist() == [1, 3, 3, 4]
    assert out[out["k"] == 2]["run"].tolist() == [1.0, 3.0, 6.0]


def test_same_spec_windows_one_shuffle(session):
    """Adjacent window columns over the same partition keys must collapse to
    ONE shuffle: the compiled plan's map stage runs once."""
    pdf, df = _events(session, n=400, users=5)
    w = Window.partitionBy("user").orderBy("ts")
    both = (df.withColumn("rn", F.row_number().over(w))
              .withColumn("prev", F.lag("amount").over(w)))
    engine = session.engine
    from raydp_tpu_torch.etl import tasks as T
    tasks, _ = engine._compile(both._plan, temps=[])
    # every reduce task carries BOTH window steps (one shuffle, chained eval)
    for t in tasks:
        kinds = [type(s).__name__ for s in t.steps]
        assert kinds.count("WindowStep") == 2, kinds
    out = both.to_pandas()
    exp = pdf.sort_values("ts").groupby("user").cumcount() + 1
    got = out.sort_values(["user", "ts"]).reset_index(drop=True)["rn"]
    assert got.tolist() == exp.loc[
        pdf.sort_values(["user", "ts"]).index].tolist()


def test_split_shards_fallback_shuffle_varies(session):
    """The more-ranks-than-blocks shard fallback must honor shuffle/seed:
    different seeds give different rank assignments, same seed is stable,
    and every variant keeps the equal-share invariant."""
    from raydp_tpu_torch.data import from_frame

    ds = from_frame(_events(session, n=1000, users=3, parts=2)[1])
    a = ds.split_shards(world_size=5, shuffle=True, seed=1)
    b = ds.split_shards(world_size=5, shuffle=True, seed=1)
    c = ds.split_shards(world_size=5, shuffle=True, seed=2)
    assert a == b
    assert a != c
    for plans in (a, c):
        counts = [sum(n for _, _, n in p) for p in plans]
        assert counts == [200] * 5


def test_running_aggregate_ignores_nulls(session):
    """Spark ignores nulls inside the frame: a null row takes the prior
    running value (not null), an all-null prefix stays null, and a null tie
    peer does not poison the tie group."""
    pdf = pd.DataFrame({
        "k": [1, 1, 1, 2, 2, 2, 2],
        "ts": [1, 2, 3, 1, 2, 2, 3],
        "x": [None, None, 5.0, 10.0, None, 20.0, 30.0],
    })
    df = session.createDataFrame(pdf, num_partitions=2)
    w = Window.partitionBy("k").orderBy("ts")
    out = (df.withColumn("run", F.sum("x").over(w))
             .withColumn("avg", F.mean("x").over(w))
             .to_pandas().sort_values(["k", "ts", "x"], na_position="first")
             .reset_index(drop=True))
    k1 = out[out["k"] == 1]
    assert pd.isna(k1["run"].iloc[0]) and pd.isna(k1["run"].iloc[1])
    assert k1["run"].iloc[2] == 5.0
    k2 = out[out["k"] == 2]["run"].tolist()
    # ties at ts=2 (one null, one 20.0) both see 10+20=30
    assert k2 == [10.0, 30.0, 30.0, 60.0]
    assert out[out["k"] == 2]["avg"].tolist() == [10.0, 15.0, 15.0, 20.0]
