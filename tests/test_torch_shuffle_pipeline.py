"""Pipelined (push-based) shuffle: on/off equivalence + the AQE rule.

The contract (mirror of test_shuffle_consolidate.py's matrix): for EVERY
shuffle flavor, ``RDT_SHUFFLE_PIPELINE=1`` (reduce tasks dispatched
concurrently with the map stage, consuming seal notifications through
``tasks.StreamingRangeSource``) must produce row-for-row identical results
to ``=0`` (the barrier mode), with the stage ledger's ``pipelined`` flag
marking the mode. The AQE interaction rule is pinned explicitly: **AQE
wins** — a stage AQE may re-plan (groupagg/join/distinct/repartition) runs
in barrier mode whenever ``RDT_ETL_AQE`` is on, while never-re-planned
stages (window, sort-range, random-shuffle) pipeline regardless; and
``RDT_SHUFFLE_CONSOLIDATE=0`` cleanly disables pipelining (the mode needs
the consolidated per-bucket index).

The port's twin of ``tests/test_shuffle_pipeline.py``: its cases, data,
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
from raydp_tpu_torch.runtime.object_store import ObjectRef, get_client


@pytest.fixture(scope="module")
def session():
    """Module-scoped session: the matrix shares one 2-executor gang."""
    import raydp_tpu_torch

    s = raydp_tpu_torch.init("pytest_pipeline", num_executors=2, executor_cores=1,
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
    """Run ``make()`` with pipelining off then on (AQE pinned off so the
    AQE-capable flavors actually engage it); assert identical results;
    return the per-mode stage reports."""
    outs, reports = {}, {}
    monkeypatch.setenv("RDT_ETL_AQE", "0")
    for env in ("0", "1"):
        monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", env)
        session.engine.reset_shuffle_stage_report()
        out = make()
        if sort_cols:
            out = out.sort_values(sort_cols).reset_index(drop=True)
        outs[env] = out
        reports[env] = session.engine.shuffle_stage_report()
    monkeypatch.delenv("RDT_SHUFFLE_PIPELINE", raising=False)
    monkeypatch.delenv("RDT_ETL_AQE", raising=False)
    pd.testing.assert_frame_equal(outs["0"], outs["1"])
    assert reports["0"] and reports["1"]
    assert all(not r["pipelined"] for r in reports["0"]), reports["0"]
    assert all(r["pipelined"] for r in reports["1"]), reports["1"]
    return outs["1"], reports


# ==== equivalence matrix ===========================================================
def test_groupagg_partial_pipelined(monkeypatch, session, wide):
    out, _ = both_modes(
        monkeypatch, session,
        lambda: wide.groupBy("k").agg(F.sum("a").alias("sa"),
                                      F.count("a").alias("n"),
                                      F.min("d").alias("mn")).to_pandas(),
        ["k"])
    assert len(out) == 11


def test_groupagg_single_phase_pipelined(monkeypatch, session, wide):
    # optimizer off: the naive single-phase shuffle, full rows crossing
    monkeypatch.setenv("RDT_ETL_OPTIMIZER", "0")
    out, reports = both_modes(
        monkeypatch, session,
        lambda: wide.groupBy("k").agg(F.sum("a").alias("sa")).to_pandas(),
        ["k"])
    monkeypatch.delenv("RDT_ETL_OPTIMIZER", raising=False)
    assert [r["stage"] for r in reports["1"]] == ["groupagg"]
    assert len(out) == 11


def test_join_both_orders_pipelined(monkeypatch, session, wide):
    dim = session.createDataFrame(
        pd.DataFrame({"k": np.arange(11), "label": np.arange(11) * 3}),
        num_partitions=2)
    out, reports = both_modes(
        monkeypatch, session,
        lambda: wide.join(dim, on="k").select("k", "a", "label").to_pandas(),
        ["k", "a"])
    assert {r["stage"] for r in reports["1"]} == {"join-left", "join-right"}
    assert (out["label"] == out["k"] * 3).all()
    # the other order: the streamed side is the BUILD side this time
    out2, _ = both_modes(
        monkeypatch, session,
        lambda: dim.join(wide.select("k", "a"), on="k")
        .select("k", "a", "label").to_pandas(),
        ["k", "a"])
    assert (out2["label"] == out2["k"] * 3).all()


def test_window_pipelined(monkeypatch, session, wide):
    from raydp_tpu_torch.etl.window import Window

    w = Window.partitionBy("k").orderBy("a")
    out, _ = both_modes(
        monkeypatch, session,
        lambda: (wide.withColumn("rn", F.row_number().over(w))
                 .select("k", "a", "rn").to_pandas()),
        ["k", "a", "rn"])
    assert out["rn"].min() == 1


def test_distinct_pipelined(monkeypatch, session, wide):
    out, _ = both_modes(
        monkeypatch, session,
        lambda: wide.select("k", "d").distinct().to_pandas(),
        ["k", "d"])
    assert len(out) == len(out.drop_duplicates())


def test_repartition_pipelined(monkeypatch, session, wide):
    both_modes(monkeypatch, session,
               lambda: wide.repartition(6).to_pandas(),
               ["k", "a", "d", "s"])


def test_sort_range_pipelined(monkeypatch, session, wide):
    out, reports = both_modes(
        monkeypatch, session,
        lambda: wide.sort("k", ("a", "descending")).to_pandas()
        .reset_index(drop=True),
        None)  # sort output order IS the result; no canonical re-sort
    assert [r["stage"] for r in reports["1"]] == ["sort-range"]
    assert (out["k"].values[:-1] <= out["k"].values[1:]).all()


def test_random_shuffle_pipelined(monkeypatch, session, wide):
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


def test_string_keys_and_empty_buckets_pipelined(monkeypatch, session, wide):
    """String-keyed groupby at low cardinality leaves most buckets empty —
    a streamed read must round-trip empty bucket streams too."""
    out, _ = both_modes(
        monkeypatch, session,
        lambda: wide.groupBy("s").agg(F.count("a").alias("n")).to_pandas(),
        ["s"])
    assert len(out) == 7 and out["n"].sum() == 2400


def test_cascaded_same_label_stages_no_self_wait(monkeypatch, session,
                                                 wide):
    """Regression (review-reproduced): a.join(b).join(c) runs the
    "join-left" label TWICE in one action; the consumed-stream bookkeeping
    must key on the unique stream stage_key, not the label — a label lookup
    handed the outer cascaded map stage its OWN record and its thread
    blocked on a done event only it could set (300 s stall; results were
    correct, just 2000× slower than barrier)."""
    import time

    dim_b = session.createDataFrame(
        pd.DataFrame({"k": np.arange(11), "y": np.arange(11) * 2}),
        num_partitions=2)
    dim_c = session.createDataFrame(
        pd.DataFrame({"k": np.arange(11), "z": np.arange(11) * 3}),
        num_partitions=2)
    t0 = time.monotonic()
    out, reports = both_modes(
        monkeypatch, session,
        lambda: (wide.select("k", "a").join(dim_b, on="k")
                 .join(dim_c, on="k").to_pandas()),
        ["k", "a"])
    assert time.monotonic() - t0 < 60, \
        "cascaded pipelined stages stalled (self-wait regression)"
    assert [r["stage"] for r in reports["1"]].count("join-left") == 2
    assert (out["y"] == out["k"] * 2).all() and \
        (out["z"] == out["k"] * 3).all()


# ==== the pinned interaction rules =================================================
def test_consolidate_off_disables_pipelining(monkeypatch, session, wide):
    """RDT_SHUFFLE_CONSOLIDATE=0 cleanly no-ops pipelining (the mode needs
    the consolidated per-bucket index): results stay correct and the stage
    runs barrier, unpipelined."""
    monkeypatch.setenv("RDT_ETL_AQE", "0")
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "1")
    monkeypatch.setenv("RDT_SHUFFLE_CONSOLIDATE", "0")
    session.engine.reset_shuffle_stage_report()
    out = wide.groupBy("k").agg(F.sum("a").alias("sa")).to_pandas()
    report = session.engine.shuffle_stage_report()
    assert len(out) == 11
    assert report and all(not r["pipelined"] and not r["consolidated"]
                          for r in report), report


def test_aqe_wins_rule_pinned(monkeypatch, session, wide):
    """The documented AQE interaction rule: with RDT_ETL_AQE on (the
    default), stages AQE may re-plan (groupagg/join/distinct/repartition —
    post-map broadcast, skew split, and coalescing need the full map-size
    picture) run BARRIER even with pipelining on; never-re-planned stages
    (window, sort-range, random-shuffle) pipeline regardless."""
    from raydp_tpu_torch.etl.window import Window

    monkeypatch.setenv("RDT_ETL_AQE", "1")
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "1")
    session.engine.reset_shuffle_stage_report()
    wide.groupBy("k").agg(F.sum("a").alias("sa")).to_pandas()
    wide.select("k", "d").distinct().to_pandas()
    wide.sort("k").to_pandas()
    w = Window.partitionBy("k").orderBy("a")
    wide.withColumn("rn", F.row_number().over(w)).select("k", "rn") \
        .to_pandas()
    by_stage = {r["stage"]: r["pipelined"]
                for r in session.engine.shuffle_stage_report()}
    assert by_stage["groupagg-partial"] is False
    assert by_stage["distinct"] is False
    assert by_stage["sort-range"] is True
    assert by_stage["window"] is True


def test_pipelined_report_columns(monkeypatch, session, wide):
    """A pipelined stage's ledger entry carries the overlap columns; a
    barrier stage reports the neutral values."""
    monkeypatch.setenv("RDT_ETL_AQE", "0")
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "1")
    session.engine.reset_shuffle_stage_report()
    wide.repartition(6).to_pandas()
    (entry,) = session.engine.shuffle_stage_report()
    assert entry["pipelined"] is True
    assert entry["overlap_s"] >= 0.0
    assert entry["first_reduce_fetch_s"] is not None \
        and entry["first_reduce_fetch_s"] >= 0.0
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "0")
    session.engine.reset_shuffle_stage_report()
    wide.repartition(6).to_pandas()
    (entry,) = session.engine.shuffle_stage_report()
    assert entry["pipelined"] is False
    assert entry["overlap_s"] == 0.0
    assert entry["first_reduce_fetch_s"] is None


def test_persist_recipes_resolve_streaming_sources(monkeypatch, session,
                                                   wide):
    """cache() recover recipes must NOT bake in streaming sources — the
    seal-stream ledger closes with the action, so a recipe kept in
    streaming form would be permanently unreadable. Proven by wiping every
    executor block cache and reading the frame back through its recipes."""
    from raydp_tpu_torch.runtime import get_runtime

    monkeypatch.setenv("RDT_ETL_AQE", "0")
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "1")
    session.engine.reset_shuffle_stage_report()
    cached = wide.groupBy("k").agg(F.sum("a").alias("sa")).persist()
    try:
        assert any(r["pipelined"]
                   for r in session.engine.shuffle_stage_report())
        # cache()'s success path skips the usual temps free, but the seal
        # streams must still close with the action (an unclosed stage
        # would leak in the head ledger for the session lifetime)
        assert not get_runtime().store_server._streams._stages, \
            "persist() leaked seal-stream ledger entries"
        base = session.engine.collect(cached._plan) \
            .sort_by([("k", "ascending")])
        import cloudpickle
        for blob in cached._plan.recover_tasks:
            task = cloudpickle.loads(blob)
            assert not T.stream_sources_of(task), \
                "recover recipe still holds a streaming source"
        for h in session.executors:
            h.drop_block_prefix("block_")
        got = session.engine.collect(cached._plan) \
            .sort_by([("k", "ascending")])
        assert got.equals(base)
    finally:
        cached.unpersist()


# ==== unit level ===================================================================
def _ledger_server():
    from raydp_tpu_torch.runtime import object_store as os_mod

    srv = os_mod.ObjectStoreServer("sesspipe00001")
    cli = os_mod.ObjectStoreClient(srv, "sesspipe00001")
    cli._arena_probed = True
    cli._arena = None
    return os_mod, srv, cli


def test_streaming_source_orders_by_map_id_not_arrival():
    """Seals arriving out of map order (map 1 before map 0) must still
    concatenate in MAP order — the barrier mode's row order."""
    os_mod, srv, cli = _ledger_server()
    old = os_mod._client
    os_mod.set_client(cli)
    try:
        def consolidated(tbls):
            sink = pa.BufferOutputStream()
            index = []
            for b in tbls:
                start = sink.tell()
                with pa.ipc.new_stream(sink, b.schema) as w:
                    w.write_table(b)
                index.append((int(start), int(sink.tell() - start),
                              b.num_rows))
            return cli.put_raw(memoryview(sink.getvalue())), index

        # two maps × two buckets; publish map 1 FIRST
        r1, i1 = consolidated([pa.table({"x": [10]}), pa.table({"x": [11]})])
        r0, i0 = consolidated([pa.table({"x": [0]}), pa.table({"x": [1]})])
        cli.stream_begin("st1", 2)
        cli.stream_publish("st1", 1, 1, r1.id, r1.size, i1)
        cli.stream_publish("st1", 0, 1, r0.id, r0.size, i0)
        got = T.StreamingRangeSource("st1", bucket=1, num_maps=2).load()
        assert got.column("x").to_pylist() == [1, 11]
        stats = T.StreamingRangeSource("st1", bucket=0, num_maps=2)
        assert stats.load().column("x").to_pylist() == [0, 10]
        assert stats.stream_stats["rounds"] >= 1
    finally:
        os_mod.set_client(old)
        srv.shutdown()


def test_streaming_source_aborts_fast_on_unknown_and_aborted_stage():
    from raydp_tpu_torch.runtime.object_store import ShuffleStreamAborted

    os_mod, srv, cli = _ledger_server()
    old = os_mod._client
    os_mod.set_client(cli)
    try:
        with pytest.raises(ShuffleStreamAborted):
            T.StreamingRangeSource("never-began", 0, 2).load()
        cli.stream_begin("st2", 2)
        cli.stream_abort("st2", "map stage died: boom")
        with pytest.raises(ShuffleStreamAborted, match="boom"):
            T.StreamingRangeSource("st2", 0, 2).load()
        cli.stream_begin("st3", 2)
        cli.stream_close(["st3"])
        with pytest.raises(ShuffleStreamAborted, match="closed"):
            T.StreamingRangeSource("st3", 0, 2).load()
    finally:
        os_mod.set_client(old)
        srv.shutdown()


def test_stream_ledger_long_poll_completes_on_publish_and_timeout():
    """The long-poll half of the metadata plane: a poll with nothing new
    returns a deferred reply, completed by the NEXT publish; an idle poll
    completes empty when its timeout lapses (the lazy sweeper)."""
    import threading
    import time

    from raydp_tpu_torch.runtime.object_store import ObjectStoreServer
    from raydp_tpu_torch.runtime.rpc import DeferredReply

    srv = ObjectStoreServer("sesspipe00002")
    try:
        srv.stream_begin("stA", 1)
        res = srv.stream_poll("stA", 0, {}, timeout_s=30.0)
        assert isinstance(res, DeferredReply)
        assert not res.future.done()
        threading.Timer(0.05, lambda: srv.stream_publish(
            "stA", 0, 1, "a" * 32, 64, [(0, 64, 1)])).start()
        out = res.future.result(timeout=5)
        assert out["events"] == [(0, 1, "a" * 32, 64, 0, 64)]
        assert out["expected"] == 1 and out["aborted"] is None
        # already-known events return immediately (no deferred reply)
        out2 = srv.stream_poll("stA", 0, {}, timeout_s=30.0)
        assert out2["events"] and not isinstance(out2, DeferredReply)
        # nothing newer: the timeout sweeper completes the wait empty
        t0 = time.monotonic()
        res3 = srv.stream_poll("stA", 0, {0: 1}, timeout_s=0.2)
        assert isinstance(res3, DeferredReply)
        out3 = res3.future.result(timeout=5)
        assert out3["events"] == [] and out3["aborted"] is None
        assert time.monotonic() - t0 >= 0.15
    finally:
        srv.shutdown()


def test_stream_ledger_generations_supersede():
    """A re-seal (regenerated producer) under the same map_id with gen+1
    supersedes: a reducer that consumed gen 1 sees gen 2; one that never
    fetched sees only the latest."""
    from raydp_tpu_torch.runtime.object_store import ObjectStoreServer

    srv = ObjectStoreServer("sesspipe00003")
    try:
        srv.stream_begin("stB", 1)
        srv.stream_publish("stB", 0, 1, "a" * 32, 64, [(0, 64, 1)])
        srv.stream_publish("stB", 0, 2, "b" * 32, 64, [(0, 64, 1)])
        out = srv.stream_poll("stB", 0, {}, timeout_s=0)
        assert out["events"] == [(0, 2, "b" * 32, 64, 0, 64)]
        out2 = srv.stream_poll("stB", 0, {0: 1}, timeout_s=0)
        assert out2["events"] == [(0, 2, "b" * 32, 64, 0, 64)]
        out3 = srv.stream_poll("stB", 0, {0: 2}, timeout_s=0)
        assert out3["events"] == []
        # a stale generation arriving late never downgrades the ledger
        srv.stream_publish("stB", 0, 1, "a" * 32, 64, [(0, 64, 1)])
        out4 = srv.stream_poll("stB", 0, {0: 1}, timeout_s=0)
        assert out4["events"] == [(0, 2, "b" * 32, 64, 0, 64)]
    finally:
        srv.shutdown()


def test_streaming_source_keeps_decoded_portion_across_reseal():
    """A re-sealed generation of a portion the reducer ALREADY decoded is
    kept, not refetched (reruns are byte-identical — the test uses
    different bytes purely to observe which copy was used), and the newer
    generation is adopted so the superseded event stops coming back."""
    import threading
    import time as _t

    os_mod, srv, cli = _ledger_server()
    old = os_mod._client
    os_mod.set_client(cli)
    try:
        def consolidated(tbls):
            sink = pa.BufferOutputStream()
            index = []
            for b in tbls:
                start = sink.tell()
                with pa.ipc.new_stream(sink, b.schema) as w:
                    w.write_table(b)
                index.append((int(start), int(sink.tell() - start),
                              b.num_rows))
            return cli.put_raw(memoryview(sink.getvalue())), index

        r0a, i0a = consolidated([pa.table({"x": [1]})])
        r0b, i0b = consolidated([pa.table({"x": [99]})])   # the "re-seal"
        r1, i1 = consolidated([pa.table({"x": [2]})])
        cli.stream_begin("stD", 2)
        cli.stream_publish("stD", 0, 1, r0a.id, r0a.size, i0a)

        out = {}

        def run():
            out["t"] = T.StreamingRangeSource("stD", 0, 2,
                                              poll_timeout_s=2.0).load()

        th = threading.Thread(target=run)
        th.start()
        _t.sleep(0.3)  # let it decode map 0's gen-1 portion
        cli.stream_publish("stD", 0, 2, r0b.id, r0b.size, i0b)  # re-seal
        cli.stream_publish("stD", 1, 1, r1.id, r1.size, i1)
        th.join(timeout=10)
        assert not th.is_alive()
        # map 0's DECODED gen-1 portion was kept; map order preserved
        assert out["t"].column("x").to_pylist() == [1, 2]
    finally:
        os_mod.set_client(old)
        srv.shutdown()


def test_resolve_stream_sources_rewrites_to_ranges():
    ref = ObjectRef(id="c" * 32, size=128)

    def resolver(stage_key, bucket):
        assert stage_key == "stC"
        return [(ref, bucket * 10, 10)]

    task = T.Task(
        task_id="t",
        source=T.StreamingRangeSource("stC", 2, 3),
        steps=[T.HashJoinStep([], ["k"], ["k"],
                              right_stream=T.StreamingRangeSource(
                                  "stC", 1, 3))])
    out = T.resolve_stream_sources(task, resolver)
    assert isinstance(out.source, T.RangeRefSource)
    assert out.source.parts == [(ref, 20, 10)]
    assert out.steps[0].right_stream is None
    assert out.steps[0].right_parts == [(ref, 10, 10)]
    assert not T.stream_sources_of(out)
    # a task with no streaming sources returns identity
    plain = T.Task(task_id="p", source=T.ArrowRefSource([ref]))
    assert T.resolve_stream_sources(plain, resolver) is plain
