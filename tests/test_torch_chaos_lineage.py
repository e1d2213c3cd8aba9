"""Chaos matrix, its lineage half: seeded fault injection
(raydp_tpu_torch/faults.py) against the lineage-recovery plane, proving
*byte-identical* action results under failures — not merely "it eventually
returned something".

- executor killed mid-groupagg (between partial and merge)  → task retry
- shuffle bucket blob dropped before the reduce stage       → lineage rebuild
  (and the same schedule with recovery disabled must raise StageError,
  proving the injection actually bites)
- crash during cache() materialization                      → lineage rebuild
  of lost cached blocks on read
- the recovery plane's units, and the store-orphan audits of failed
  actions, persists and shuffle writes

Every schedule is pinned with ``nth=`` + a ``once=`` sentinel file, so the
injection is deterministic per session AND observable (the test asserts the
sentinel exists — a schedule that never fired would silently test nothing).

The port's twin of the estimator-free cases of ``tests/test_chaos.py``
up to its store-orphan audits, with its data, sizes and assertions;
``test_torch_chaos_streams.py`` holds the rest. The estimator and serving
legs are twinned in ``test_torch_serve_faults.py`` and
``test_torch_serve_admission.py``.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import raydp_tpu_torch
from raydp_tpu_torch.etl import functions as F
from raydp_tpu_torch.etl.engine import StageError
from raydp_tpu_torch.runtime.object_store import ObjectRef


def _ipc_bytes(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def _session(app):
    return raydp_tpu_torch.init(app, num_executors=2, executor_cores=1,
                          executor_memory="512MB")


def _frame(s, n=4000):
    rng = np.random.RandomState(0)
    pdf = pd.DataFrame({
        "k": rng.randint(0, 50, n),
        # integer aggregates only: bit-identical under any partial/merge
        # order (float partials may differ in the last ulp)
        "v": rng.randint(0, 1000, n).astype(np.int64),
    })
    return s.createDataFrame(pdf, num_partitions=4)


def _run_groupagg(app):
    """One full session running the canonical two-phase groupagg; returns
    (result ipc bytes, row count, engine shuffle-stage report). The table is
    canonicalized by sorting on the group key before serializing: pyarrow's
    hash aggregation is threaded, so groupagg ROW ORDER is unspecified even
    between two fault-free runs (like Spark's) — the byte-identity contract
    is over the relation, each value bit-exact."""
    s = _session(app)
    try:
        df = _frame(s)
        out = df.groupBy("k").agg(F.sum("v").alias("s"),
                                  F.count("v").alias("n"))
        n = s.engine.count(out._plan)
        table = s.engine.collect(out._plan).sort_by([("k", "ascending")])
        return _ipc_bytes(table), n, s.engine.shuffle_stage_report()
    finally:
        raydp_tpu_torch.stop()


def test_executor_crash_mid_groupagg_byte_identical(tmp_path, monkeypatch):
    """An injected transient raise on the first task AND an executor crash on
    its 3rd task (the merge stage, after the 2 map tasks) — task retry with
    backoff must deliver the exact fault-free bytes."""
    base, base_n, _ = _run_groupagg("chaos-crash-base")

    raise_s = str(tmp_path / "raise.sentinel")
    crash_s = str(tmp_path / "crash.sentinel")
    monkeypatch.setenv(
        "RDT_FAULTS",
        f"executor.run_task:raise:nth=1:once={raise_s};"
        f"executor.run_task:crash:nth=3:once={crash_s}")
    got, got_n, _ = _run_groupagg("chaos-crash")
    assert os.path.exists(raise_s), "injected raise never fired"
    assert os.path.exists(crash_s), "injected crash never fired"
    assert got_n == base_n
    assert got == base


def test_dropped_shuffle_bucket_lineage_recovery(tmp_path, monkeypatch):
    """A shuffle bucket blob silently dropped after the map stage (the
    store-host-died model): the reduce stage hits ObjectLostError, the engine
    re-executes the producer from the lineage ledger, re-homes the blob,
    patches the consumer refs, and the action result is byte-identical. The
    stage report records the regenerated intermediate."""
    base, base_n, _ = _run_groupagg("chaos-drop-base")

    sent = str(tmp_path / "drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.write:drop:nth=2:once={sent}")
    got, got_n, report = _run_groupagg("chaos-drop")
    assert os.path.exists(sent), "injected drop never fired"
    assert got_n == base_n
    assert got == base
    assert sum(e.get("regenerated", 0) for e in report) >= 1, report
    assert sum(e.get("recovered", 0) for e in report) >= 1, report


def test_dropped_consolidated_map_blob_recovery(tmp_path, monkeypatch):
    """Consolidated shuffle path (explicitly pinned on): a map task's output
    is ONE blob holding every bucket, so ``shuffle.write:drop`` must target
    that single consolidated oid — and one regenerated producer restores all
    B buckets at once. The reduce stage hits ObjectLostError on its byte
    range, lineage reruns the producer (byte-identical, so the bucket index
    still addresses the fresh blob), and the action result matches the
    fault-free run exactly with the recovery surfaced in the ledger."""
    monkeypatch.setenv("RDT_SHUFFLE_CONSOLIDATE", "1")
    base, base_n, base_report = _run_groupagg("chaos-consol-base")
    assert all(e["consolidated"] for e in base_report), base_report

    sent = str(tmp_path / "consol-drop.sentinel")
    # bucket=3 would pick bucket 3 of a legacy map output; the consolidated
    # map has exactly one blob, so the victim index wraps onto it
    monkeypatch.setenv("RDT_FAULTS",
                       f"shuffle.write:drop:nth=2:bucket=3:once={sent}")
    got, got_n, report = _run_groupagg("chaos-consol-drop")
    assert os.path.exists(sent), "injected drop never fired"
    assert got_n == base_n
    assert got == base
    entries = [e for e in report if e.get("recovered", 0) >= 1]
    assert entries, report
    # the regenerated producer is a consolidated map task: ONE blob rebuilt
    # brings back every bucket, so a single recovery event suffices
    assert all(e["consolidated"] for e in entries)
    assert sum(e.get("regenerated", 0) for e in report) >= 1, report


def test_straggler_speculation_composes_with_lineage_recovery(tmp_path,
                                                              monkeypatch):
    """A seeded one-executor straggler (every task entering executor 0 sleeps
    at entry) COMBINED with a dropped shuffle blob in the same action:
    speculative backup tasks and lineage recovery must compose — results
    byte-identical to the fault-free run, the drop recovered through the
    ledger, at least one backup fired, and the store object count back at
    its pre-action value (no orphans from won/lost speculation races; the
    losers land late and free through the late-result path, so the audit
    polls). The drop is pinned to nth=1: the fast executor's first map
    write, deterministically a WINNING attempt's blob — the delayed
    executor's first write trails it by the full injected delay."""
    from raydp_tpu_torch.runtime.object_store import get_client

    base, _, _ = _run_groupagg("chaos-straggler-base")

    sent = str(tmp_path / "straggler-drop.sentinel")
    victim = "rdt-executor-chaos-straggler-0"
    monkeypatch.setenv(
        "RDT_FAULTS",
        f"executor.run_task:delay:ms=600:match={victim}|;"
        f"shuffle.write:drop:nth=1:once={sent}")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.25")
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.15")
    s = _session("chaos-straggler")
    try:
        client = get_client()
        df = _frame(s)
        before = client.stats()["num_objects"]
        out = df.groupBy("k").agg(F.sum("v").alias("s"),
                                  F.count("v").alias("n"))
        table = s.engine.collect(out._plan).sort_by([("k", "ascending")])
        report = s.engine.shuffle_stage_report()
        assert os.path.exists(sent), "injected drop never fired"
        assert _ipc_bytes(table) == base
        assert sum(e.get("recovered", 0) for e in report) >= 1, report
        assert sum(e.get("regenerated", 0) for e in report) >= 1, report
        assert sum(e.get("speculated", 0) for e in report) >= 1, report
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.25)
        after = client.stats()["num_objects"]
        assert after == before, (
            f"speculation races orphaned {after - before} store objects")
    finally:
        raydp_tpu_torch.stop()


def test_dropped_bucket_without_recovery_raises_stage_error(tmp_path,
                                                            monkeypatch):
    """Same drop schedule with lineage recovery disabled: the action must
    fail with StageError — proving the injection bites and the green run
    above is the recovery's doing, not an accident of scheduling."""
    sent = str(tmp_path / "drop-off.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.write:drop:nth=2:once={sent}")
    monkeypatch.setenv("RDT_LINEAGE_RECOVERY", "0")
    s = _session("chaos-drop-off")
    try:
        df = _frame(s)
        out = df.groupBy("k").agg(F.sum("v").alias("s"))
        with pytest.raises(StageError):
            s.engine.collect(out._plan)
        assert os.path.exists(sent), "injected drop never fired"
    finally:
        raydp_tpu_torch.stop()


def test_cache_crash_then_lineage_rebuild(tmp_path, monkeypatch):
    """Executor crash during cache() materialization: the cache stage retries
    onto the surviving/restarted executor, and blocks the crashed executor
    already cached are rebuilt from their lineage recipes on read — collect
    equals the fault-free run exactly."""
    from raydp_tpu_torch.etl.expressions import col

    def run(app):
        s = _session(app)
        try:
            cached = _frame(s).withColumn("v2", col("v") * 2).persist()
            assert cached.count() == 4000
            table = s.engine.collect(cached._plan)
            return _ipc_bytes(table)
        finally:
            raydp_tpu_torch.stop()

    base = run("chaos-cache-clean")
    sent = str(tmp_path / "cache-crash.sentinel")
    monkeypatch.setenv("RDT_FAULTS",
                       f"executor.run_task:crash:nth=2:once={sent}")
    got = run("chaos-cache-crash")
    assert os.path.exists(sent), "injected crash never fired"
    assert got == base


def test_cache_recover_recipes_survive_bucket_drop(tmp_path, monkeypatch):
    """A shuffle bucket dropped while persist() materializes: the cache
    stage recovers in-flight, and — the regression this pins — the persisted
    frame's recovery RECIPES must reference the regenerated blob, not the
    dead id (recipes are serialized after the stage, patched). Proven by
    wiping every executor cache afterwards and reading the frame back
    through lineage."""
    import time

    base, base_n, _ = _run_groupagg("chaos-recipe-base")

    sent = str(tmp_path / "recipe-drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.write:drop:nth=2:once={sent}")
    s = _session("chaos-recipe")
    try:
        df = _frame(s)
        cached = df.groupBy("k").agg(F.sum("v").alias("s"),
                                     F.count("v").alias("n")).persist()
        assert os.path.exists(sent), "injected drop never fired"
        assert sum(e.get("regenerated", 0)
                   for e in s.engine.shuffle_stage_report()) >= 1

        # wipe every cache (crash-restart); reads must rebuild via recipes
        for h in s.executors:
            try:
                h.call("crash")
            except Exception:
                pass
        deadline = time.time() + 60
        got_n = None
        while time.time() < deadline:
            try:
                got_n = s.engine.count(cached._plan)
                break
            except Exception:
                time.sleep(0.5)
        assert got_n == base_n
        table = s.engine.collect(cached._plan).sort_by([("k", "ascending")])
        assert _ipc_bytes(table) == base
    finally:
        raydp_tpu_torch.stop()


def test_free_late_result_runs_off_callback_thread_unit():
    """The drain-abandonment callback fires on the executor connection's RPC
    read loop; its drop_blocks is a synchronous call over that SAME
    connection, so doing the work inline would block the only thread able to
    deliver the response — the callback must hand off and return at once."""
    import threading
    from concurrent.futures import Future

    from raydp_tpu_torch.etl.engine import ExecutorPool

    release = threading.Event()
    dropped = threading.Event()

    class _Handle:
        def drop_blocks(self, keys, if_stamp=None):
            assert release.wait(5), "free thread never reached drop_blocks"
            assert keys == ["blk"]
            # the straggler's own generation stamp rides along, so the
            # executor only drops OUR stale entry, never a recovery
            # resubmit's fresh block cached under the same key
            assert if_stamp == "gen0"
            dropped.set()

    pool = ExecutorPool.__new__(ExecutorPool)
    pool.by_name = {"ex0": _Handle()}
    fut = Future()
    fut.set_result({"executor": "ex0", "cache_key": "blk",
                    "cache_stamp": "gen0"})

    t0 = time.monotonic()
    pool._free_late_result(fut)  # simulating the read-loop's callback call
    assert time.monotonic() - t0 < 1.0, \
        "callback blocked on the executor RPC instead of handing off"
    assert not dropped.is_set()
    release.set()
    assert dropped.wait(5), "handed-off free never ran"


def test_block_cache_stamp_conditioned_drop_unit():
    """A drain-abandoned CACHE straggler's deferred drop must not delete the
    live block a recovery resubmit cached under the same key: the drop is
    conditioned on the straggler's own generation stamp."""
    from raydp_tpu_torch.etl.executor import BlockCache

    tbl = pa.table({"a": [1]})
    cache = BlockCache()
    cache.put("blk", tbl, stamp="old-gen")
    # the resubmit lands first, overwriting with a fresh generation
    cache.put("blk", tbl, stamp="new-gen")
    assert cache.drop(["blk"], if_stamp="old-gen") == 0
    assert cache.get("blk") is not None, "live resubmit block was dropped"
    # the straggler's drop DOES work when its generation is still current
    assert cache.drop(["blk"], if_stamp="new-gen") == 1
    assert cache.get("blk") is None
    # a lineage-rebuilt block (get_block re-put, no stamp) is also immune
    cache.put("blk", tbl)
    assert cache.drop(["blk"], if_stamp="old-gen") == 0
    # unconditional drops (persist sweeps) behave as before
    assert cache.drop(["blk"]) == 1


def test_patch_task_refs_surgery_unit():
    """Ref surgery (what recovery uses to point consumers at regenerated
    blobs) must reach every ref a task can hold — ArrowRefSource,
    HashJoinStep right side, a CachedSource's nested recovery task — and
    leave untouched tasks identity-equal. task_input_ids is the audit of the
    same traversal."""
    from raydp_tpu_torch.etl import tasks as T
    from raydp_tpu_torch.runtime.object_store import ObjectRef

    old = [ObjectRef(id=f"{i:032x}") for i in range(3)]
    new = ObjectRef(id="f" * 32)
    inner = T.Task(task_id="inner", source=T.ArrowRefSource([old[2]]))
    task = T.Task(
        task_id="outer",
        source=T.ArrowRefSource([old[0]]),
        steps=[T.HashJoinStep([old[1]], ["k"], ["k"]),
               T.CachedSource("key", recover=inner)])
    assert sorted(T.task_input_ids(task)) == sorted(r.id for r in old)

    patched = T.patch_task_refs(task, {old[0].id: new, old[2].id: new})
    ids = T.task_input_ids(patched)
    assert ids.count(new.id) == 2 and old[1].id in ids
    assert old[0].id not in ids and old[2].id not in ids
    # no-match mapping returns the identical object (no useless copies)
    assert T.patch_task_refs(task, {"e" * 32: new}) is task


def test_note_recovery_attribution_unit():
    """Recovery accounting must land on the entry of the stage that produced
    the lost blobs — not "the most recent entry with this label": concurrent
    actions interleave same-label entries in the engine deque, and one action
    can run the same label twice (two joins, two groupbys)."""
    import collections
    import threading

    from raydp_tpu_torch.etl.engine import Engine, _ActionTemps, _Producer

    eng = Engine.__new__(Engine)
    eng._report_lock = threading.Lock()
    eng._stage_reports = collections.deque(maxlen=256)
    eng.tenant = "unit"

    def record(temps, label, ref_id):
        prod = _Producer(b"", [ref_id], label)
        temps.lineage[ref_id] = prod
        eng._record_stage(label, [{"num_rows": 1, "ref": ObjectRef(id=ref_id)}],
                          2, temps)
        return prod

    temps_a, temps_b = _ActionTemps(), _ActionTemps()
    prod_a = record(temps_a, "groupagg", "a" * 32)
    record(temps_b, "groupagg", "b" * 32)  # concurrent action, newer entry
    prod_a2 = record(temps_a, "groupagg", "c" * 32)  # same label, 2nd stage

    eng._note_recovery(prod_a, 3, temps_a)  # A's FIRST stage recovers
    report = eng.shuffle_stage_report()
    assert [e["regenerated"] for e in report] == [3, 0, 0], report
    assert [e["recovered"] for e in report] == [1, 0, 0], report
    eng._note_recovery(prod_a2, 2, temps_a)  # A's second stage, own entry
    assert [e["regenerated"] for e in eng.shuffle_stage_report()] == [3, 0, 2]

    # a label the action never recorded gets its own bare entry, and a
    # second recovery of the same label accumulates there (no duplicates)
    mat = _Producer(b"", ["d" * 32], "materialize")
    eng._note_recovery(mat, 1, temps_a)
    eng._note_recovery(mat, 2, temps_a)
    mats = [e for e in eng.shuffle_stage_report()
            if e["stage"] == "materialize"]
    assert len(mats) == 1
    assert mats[0]["regenerated"] == 3 and mats[0]["recovered"] == 2


def test_ref_patches_transitive_collapse_unit():
    """A second-generation loss (A regenerated as B, then B lost and
    regenerated as C) must leave ref_patches mapping A → C: cache() recover
    recipes are serialized through this map, and a recipe pointing at the
    freed intermediate B would be permanently unrecoverable (a later action
    has no lineage for B)."""
    from raydp_tpu_torch.etl.engine import _ActionTemps

    a, b, c = ("a" * 32, "b" * 32, "c" * 32)
    temps = _ActionTemps()
    temps.apply_patches({a: ObjectRef(id=b)})
    temps.apply_patches({b: ObjectRef(id=c)})
    assert temps.ref_patches[a].id == c
    assert temps.ref_patches[b].id == c


def test_expand_lost_dead_host_unit(monkeypatch):
    """The multi-loss probe must share the read path's loss criterion: a
    reported-lost blob the store table still lists means its payload host is
    unreachable (purge_host lags a node death), so every ledgered candidate
    homed there is equally lost — while a head-local loss stays blob-specific
    and blobs on live hosts are left alone."""
    from raydp_tpu_torch.etl import engine as E
    from raydp_tpu_torch.etl import tasks as T

    # candidate inputs of the one unfinished task; L* are the reported losses
    c_dead, c_live, c_freed, c_head = ("c1" * 16, "c2" * 16, "c3" * 16,
                                       "c4" * 16)
    l_node, l_head = "f1" * 16, "f2" * 16
    locs = {l_node: "node-a", l_head: "head",  # table still lists both
            c_dead: "node-a", c_live: "node-b", c_head: "head"}
    # c_freed absent: freed/purged — lost via the plain presence check

    class _StubClient:
        def locations(self, refs):
            return {r.id: locs[r.id] for r in refs if r.id in locs}

    monkeypatch.setattr(E, "get_client", lambda: _StubClient())

    temps = E._ActionTemps()
    for cid in (c_dead, c_live, c_freed, c_head):
        temps.lineage[cid] = E._Producer(b"", [cid], "groupagg")
    task = T.Task(task_id="t0", source=T.ArrowRefSource(
        [ObjectRef(id=i) for i in (c_dead, c_live, c_freed, c_head)]))

    lost = E.Engine._expand_lost([l_node, l_head], [task], [None], temps)
    # node-a listed a blob whose read failed => node-a is dead => c_dead
    # joins; c_freed is absent from the table; head and node-b stay put
    assert lost == {l_node, l_head, c_dead, c_freed}


def test_failed_action_leaves_no_orphaned_store_objects():
    """Regression for the temps/abort lifecycle: an action that dies mid-map
    stage (a deterministic app error in ONE partition while the siblings'
    shuffle buckets are already written) must drain in-flight tasks and free
    every intermediate — the store object count returns to its pre-action
    value."""
    from raydp_tpu_torch.etl.expressions import udf
    from raydp_tpu_torch.runtime.object_store import get_client

    s = _session("chaos-orphans")
    try:
        rng = np.random.RandomState(1)
        vals = rng.randint(0, 100, 4000)
        vals[3600] = 777  # the poison pill lives in the LAST partition only
        pdf = pd.DataFrame({"k": rng.randint(0, 10, 4000), "v": vals})
        df = s.createDataFrame(pdf, num_partitions=4)

        client = get_client()
        before = client.stats()["num_objects"]

        @udf("int")
        def poison(v):
            if v == 777:
                raise ValueError("poison pill")
            return int(v)

        out = df.withColumn("p", poison("v")).groupBy("k").agg(
            F.sum("p").alias("s"))
        with pytest.raises(StageError):
            s.engine.collect(out._plan)

        after = client.stats()["num_objects"]
        assert after == before, (
            f"failed action leaked {after - before} store objects")
    finally:
        raydp_tpu_torch.stop()


def test_failed_persist_leaves_no_cached_blocks():
    """Regression for the executor-RAM half of the abort contract: when
    persist() dies on one partition, the sibling partitions have already
    stored their tables in executor block caches — beyond the store-count
    audit above. The abort must sweep those blocks from every executor, or
    each retried persist of a failing plan pins more partition tables in the
    unbounded BlockCache."""
    from raydp_tpu_torch.etl.expressions import udf
    from raydp_tpu_torch.runtime.object_store import get_client

    s = _session("chaos-persist-abort")
    try:
        rng = np.random.RandomState(3)
        vals = rng.randint(0, 100, 4000)
        vals[3600] = 777  # poison only the LAST partition
        pdf = pd.DataFrame({"k": rng.randint(0, 10, 4000), "v": vals})
        df = s.createDataFrame(pdf, num_partitions=4)

        client = get_client()
        before = client.stats()["num_objects"]
        blocks_before = {h.name: set(h.list_blocks()) for h in s.executors}

        @udf("int")
        def poison(v):
            if v == 777:
                raise ValueError("poison pill")
            return int(v)

        with pytest.raises(StageError):
            df.withColumn("p", poison("v")).persist()

        assert client.stats()["num_objects"] == before
        for h in s.executors:
            assert set(h.list_blocks()) == blocks_before[h.name], (
                f"aborted persist left cached blocks on {h.name}")
    finally:
        raydp_tpu_torch.stop()


def test_shuffle_write_raise_after_put_leaves_no_orphans(tmp_path,
                                                        monkeypatch):
    """An injected raise at shuffle.write fires AFTER the task's bucket blobs
    hit the store; the retry writes fresh copies, so the executor must free
    the first set — the action succeeds and the store count returns to its
    pre-action value (plus nothing: collect holds no refs at the end)."""
    from raydp_tpu_torch.runtime.object_store import get_client

    sent = str(tmp_path / "wraise.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.write:raise:nth=1:once={sent}")
    s = _session("chaos-wraise")
    try:
        df = _frame(s)
        client = get_client()
        before = client.stats()["num_objects"]
        out = df.groupBy("k").agg(F.sum("v").alias("s"))
        table = s.engine.collect(out._plan)
        assert table.num_rows > 0
        assert os.path.exists(sent), "injected shuffle.write raise never fired"
        after = client.stats()["num_objects"]
        assert after == before, (
            f"retried shuffle write leaked {after - before} store objects")
    finally:
        raydp_tpu_torch.stop()


