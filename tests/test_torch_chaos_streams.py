"""Chaos matrix, its streaming half: seeded fault injection
(raydp_tpu_torch/faults.py) against pipelined shuffles, adaptive execution
(broadcast joins, skew splits), the elastic pool, spilled blobs, tenants
sharing a pool and continuous pipelines, proving *byte-identical* results
under failures.

Every schedule is pinned with ``nth=`` + a ``once=`` sentinel file, so the
injection is deterministic per session AND observable (the test asserts the
sentinel exists — a schedule that never fired would silently test nothing).

The port's twin of the estimator-free cases of ``tests/test_chaos.py``
after its store-orphan audits, with its data, sizes and assertions;
``test_torch_chaos_lineage.py`` holds the ones before. One case has no
twin: in ``test_scale_down_drain_crash_races_pipelined_stream`` the
retiring executor can die between sealing a map task's consolidated blob
(owned by the session's master) and replying, and nothing then frees that
blob. Its zero-orphan check failed 1 time in 80 loaded runs of the port
(and 1 in 24 of the reference), so it cannot hold in every run.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa

import raydp_tpu_torch
from raydp_tpu_torch.etl import functions as F


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


# ==== pipelined shuffle under chaos ==============================================
def _run_groupagg_pipelined(app, pipeline="1"):
    """The canonical groupagg with AQE pinned off so the pipelined mode
    actually engages (the AQE-wins rule barriers AQE-capable stages);
    ``pipeline="0"`` is the fault-free BARRIER baseline the pipelined chaos
    legs compare byte-identical against."""
    os.environ["RDT_ETL_AQE"] = "0"
    os.environ["RDT_SHUFFLE_PIPELINE"] = pipeline
    try:
        return _run_groupagg(app)
    finally:
        os.environ.pop("RDT_ETL_AQE", None)
        os.environ.pop("RDT_SHUFFLE_PIPELINE", None)


def test_pipelined_stale_range_regenerates_and_reseals(tmp_path,
                                                       monkeypatch):
    """Chaos leg (a): a map blob dropped AFTER its seal notification but
    BEFORE the reducer's fetch — ``shuffle.write:drop`` frees the
    consolidated blob executor-side, yet the winning result still reaches
    the driver, which publishes the seal; the streaming reducer's fetch of
    the now-stale range hits ObjectLostError, rides the existing lineage
    path (regenerate producer → RE-SEAL under the same map_id, next
    generation → resubmit), and the result is byte-identical to a
    fault-free BARRIER run."""
    base, base_n, _ = _run_groupagg_pipelined("chaos-pipe-base",
                                              pipeline="0")

    sent = str(tmp_path / "pipe-drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.write:drop:nth=2:once={sent}")
    got, got_n, report = _run_groupagg_pipelined("chaos-pipe-drop")
    assert os.path.exists(sent), "injected drop never fired"
    assert got_n == base_n
    assert got == base
    assert any(e["pipelined"] for e in report), report
    assert sum(e.get("recovered", 0) for e in report) >= 1, report
    assert sum(e.get("regenerated", 0) for e in report) >= 1, report


def test_pipelined_speculation_losers_never_seal(tmp_path, monkeypatch):
    """Chaos leg (b): speculation loser seals racing the winner. A seeded
    one-executor straggler forces backup map tasks; only the FIRST
    finisher's result reaches the driver, so only the winner's blob is ever
    published to the seal stream — no duplicate bucket rows — and the
    losers' blobs free through the late-result path (store count back to
    the pre-action baseline)."""
    from raydp_tpu_torch.runtime.object_store import get_client

    base, _, _ = _run_groupagg_pipelined("chaos-pipe-spec-base",
                                         pipeline="0")

    app = "chaos-pipe-spec"
    victim = f"rdt-executor-{app}-0"
    monkeypatch.setenv("RDT_FAULTS",
                       f"executor.run_task:delay:ms=600:match={victim}|")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.25")
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.15")
    monkeypatch.setenv("RDT_ETL_AQE", "0")
    monkeypatch.setenv("RDT_SHUFFLE_PIPELINE", "1")
    s = _session(app)
    try:
        client = get_client()
        df = _frame(s)
        before = client.stats()["num_objects"]
        out = df.groupBy("k").agg(F.sum("v").alias("s"),
                                  F.count("v").alias("n"))
        table = s.engine.collect(out._plan).sort_by([("k", "ascending")])
        report = s.engine.shuffle_stage_report()
        assert _ipc_bytes(table) == base, \
            "a loser's seal leaked duplicate bucket rows"
        assert any(e["pipelined"] for e in report), report
        assert sum(e.get("speculated", 0) for e in report) >= 1, report
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.2)
        after = client.stats()["num_objects"]
        assert after == before, (
            f"pipelined speculation races orphaned {after - before} blobs")
    finally:
        raydp_tpu_torch.stop()


def test_pipelined_streamed_fetch_drop_recovery(tmp_path, monkeypatch):
    """Chaos leg (c): pipelining + ``shuffle.fetch:drop`` — the drop fires
    INSIDE a streaming reducer's fetch round (frees the backing blob, then
    the typed loss), mid-stream with other portions already decoded; the
    regenerated producer re-seals and the resubmitted reducer re-reads the
    whole bucket byte-identical to a fault-free barrier run."""
    base, base_n, _ = _run_groupagg_pipelined("chaos-pipe-fdrop-base",
                                              pipeline="0")

    sent = str(tmp_path / "pipe-fdrop.sentinel")
    monkeypatch.setenv("RDT_FAULTS",
                       f"shuffle.fetch:drop:nth=2:once={sent}")
    got, got_n, report = _run_groupagg_pipelined("chaos-pipe-fdrop")
    assert os.path.exists(sent), "injected streamed-fetch drop never fired"
    assert got_n == base_n
    assert got == base
    assert any(e["pipelined"] for e in report), report
    assert sum(e.get("recovered", 0) for e in report) >= 1, report


# ==== adaptive execution under chaos =============================================
def _run_broadcast_join(app):
    """One session running the canonical broadcast join (small dim side →
    AQE replicates it, neither side shuffles); returns (result ipc bytes,
    row count, report)."""
    s = _session(app)
    try:
        rng = np.random.RandomState(2)
        n = 4000
        big = s.createDataFrame(
            pd.DataFrame({"k": rng.randint(0, 30, n),
                          "v": rng.randint(0, 1000, n).astype(np.int64)}),
            num_partitions=4)
        dim = s.createDataFrame(
            pd.DataFrame({"k": np.arange(30),
                          "lab": (np.arange(30) * 3).astype(np.int64)}),
            num_partitions=2)
        out = big.join(dim, on="k").select("k", "v", "lab")
        n_rows = s.engine.count(out._plan)
        table = s.engine.collect(out._plan).sort_by(
            [("k", "ascending"), ("v", "ascending")])
        return _ipc_bytes(table), n_rows, s.engine.shuffle_stage_report()
    finally:
        raydp_tpu_torch.stop()


def test_dropped_broadcast_replica_blob_recovery(tmp_path, monkeypatch):
    """A broadcast side's store blob silently dropped before any executor
    fetched its replica (``shuffle.fetch:drop`` — the first RANGED read in
    an executor is a broadcast fetch, since a pre-shuffle broadcast join has
    no other ranged reads): the probe task hits ObjectLostError, lineage
    regenerates the small side's producer (ledgered under join-broadcast),
    the BroadcastJoinStep's parts are patched to the fresh blob (a new
    broadcast-cache key, so no executor probes stale bytes), and the join
    result is byte-identical. The report shows both the broadcast AND the
    recovery."""
    base, base_n, base_rep = _run_broadcast_join("chaos-bcast-base")
    assert sum(e.get("aqe_broadcast", 0) for e in base_rep) >= 1, base_rep

    sent = str(tmp_path / "bcast-drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.fetch:drop:nth=1:once={sent}")
    got, got_n, report = _run_broadcast_join("chaos-bcast-drop")
    assert os.path.exists(sent), "injected broadcast-replica drop never fired"
    assert got_n == base_n
    assert got == base
    assert sum(e.get("aqe_broadcast", 0) for e in report) >= 1, report
    assert sum(e.get("recovered", 0) for e in report) >= 1, report
    assert sum(e.get("regenerated", 0) for e in report) >= 1, report


def _run_skew_groupagg(app):
    """One session running a skew-split groupby (hot key ~50%, unique-first
    chunks so row-wise partials carry the skew to the reduce side)."""
    s = _session(app)
    try:
        rng = np.random.RandomState(9)
        rows, parts = 16_000, 4
        per = rows // parts
        chunks, nxt = [], 1
        for _ in range(parts):
            nu = per // 2
            ks = np.concatenate([np.arange(nxt, nxt + nu) * 7 + 3,
                                 np.zeros(per - nu, dtype=np.int64)])
            nxt += nu
            chunks.append(pd.DataFrame(
                {"k": ks, "v": rng.randint(0, 1000, per).astype(np.int64)}))
        df = s.createDataFrame(pd.concat(chunks).reset_index(drop=True),
                               num_partitions=parts)
        out = df.groupBy("k").agg(F.sum("v").alias("sv"),
                                  F.count("v").alias("n"))
        table = s.engine.collect(out._plan).sort_by([("k", "ascending")])
        return _ipc_bytes(table), s.engine.shuffle_stage_report()
    finally:
        raydp_tpu_torch.stop()


def test_dropped_split_read_source_mid_skew_recovery(tmp_path, monkeypatch):
    """A map blob dropped exactly when a SPLIT task's ranged read touches it
    (``shuffle.fetch:drop:nth=1`` — the split stage issues the first ranged
    reads of the action): lineage regenerates the map producer, the split
    task's RangeRefSource is patched (offsets survive: reruns are
    byte-identical), and the re-planned aggregation is byte-identical with
    both the split and the recovery in the ledger."""
    monkeypatch.setenv("RDT_AQE_COALESCE_MIN", "0")
    monkeypatch.setenv("RDT_AQE_SKEW_FACTOR", "2")
    base, base_rep = _run_skew_groupagg("chaos-skew-base")
    assert sum(e.get("aqe_split", 0) for e in base_rep) >= 1, base_rep

    sent = str(tmp_path / "split-drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"shuffle.fetch:drop:nth=1:once={sent}")
    got, report = _run_skew_groupagg("chaos-skew-drop")
    assert os.path.exists(sent), "injected split-read drop never fired"
    assert got == base
    assert sum(e.get("aqe_split", 0) for e in report) >= 1, report
    assert sum(e.get("recovered", 0) for e in report) >= 1, report


def test_broadcast_speculation_losers_leave_no_orphans(tmp_path,
                                                       monkeypatch):
    """The no-orphan store-count contract with BROADCAST replicas in the
    race: a seeded one-executor straggler makes the broadcast side's
    materialize tasks speculate; the losing copy's blob is a duplicate
    broadcast replica that reaches no caller and must free through the
    loser-drain path — after the action settles, the store count returns to
    its pre-action baseline and the result matches a straggler-free run."""
    from raydp_tpu_torch.runtime.object_store import get_client

    base, base_n, _ = _run_broadcast_join("chaos-bcast-spec-base")

    app = "chaos-bcast-spec"
    victim = f"rdt-executor-{app}-0"
    monkeypatch.setenv("RDT_FAULTS",
                       f"executor.run_task:delay:ms=600:match={victim}|")
    monkeypatch.setenv("RDT_SPECULATION", "1")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.5")
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.2")
    s = _session(app)
    try:
        rng = np.random.RandomState(2)
        n = 4000
        big = s.createDataFrame(
            pd.DataFrame({"k": rng.randint(0, 30, n),
                          "v": rng.randint(0, 1000, n).astype(np.int64)}),
            num_partitions=4)
        dim = s.createDataFrame(
            pd.DataFrame({"k": np.arange(30),
                          "lab": (np.arange(30) * 3).astype(np.int64)}),
            num_partitions=2)
        client = get_client()
        before = client.stats()["num_objects"]
        out = big.join(dim, on="k").select("k", "v", "lab")
        n_rows = s.engine.count(out._plan)
        table = s.engine.collect(out._plan).sort_by(
            [("k", "ascending"), ("v", "ascending")])
        report = s.engine.shuffle_stage_report()
        assert n_rows == base_n
        assert _ipc_bytes(table) == base
        assert sum(e.get("aqe_broadcast", 0) for e in report) >= 1, report
        # losing duplicates land late and free through the loser path:
        # poll the store audit back to the pre-action baseline
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.2)
        orphans = client.stats()["num_objects"] - before
        assert orphans == 0, (
            f"broadcast speculation races orphaned {orphans} store objects")
    finally:
        raydp_tpu_torch.stop()


# ==== elastic pool under chaos ===================================================
def _session3(app):
    return raydp_tpu_torch.init(app, num_executors=3, executor_cores=1,
                          executor_memory="512MB")


def _collect_groupagg_during_retire(app, victim_suffix="-2",
                                    retire_after_s=0.4):
    """Start the canonical groupagg on a background thread, retire one
    executor mid-action, join, and return (ipc bytes, report, session-level
    facts). The session is fully torn down before returning."""
    from raydp_tpu_torch.runtime.object_store import get_client

    s = _session3(app)
    try:
        df = _frame(s)
        client = get_client()
        before = client.stats()["num_objects"]
        out = df.groupBy("k").agg(F.sum("v").alias("s"),
                                  F.count("v").alias("n"))
        box = {}

        def run():
            try:
                box["table"] = s.engine.collect(out._plan) \
                    .sort_by([("k", "ascending")])
            except Exception as e:  # noqa: BLE001 - asserted below
                box["error"] = e

        t = threading.Thread(target=run)
        t.start()
        time.sleep(retire_after_s)
        victim = f"rdt-executor-{app}{victim_suffix}"
        s.retire_executor(victim)
        t.join(timeout=300)
        assert not t.is_alive(), "action wedged across the retirement"
        if "error" in box:
            raise box["error"]
        # store-count audit: the drain + recovery leave zero orphans
        # (late losers/regenerations free asynchronously: poll)
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.25)
        orphans = client.stats()["num_objects"] - before
        return (_ipc_bytes(box["table"]), s.engine.shuffle_stage_report(),
                {"orphans": orphans, "pool": len(s.executors),
                 "survivors": [h.name for h in s.executors]})
    finally:
        raydp_tpu_torch.stop()


def test_scale_down_races_lineage_recovery(tmp_path, monkeypatch):
    """Chaos leg: a graceful scale-down races an in-flight
    lineage recovery round. A dropped map blob forces recovery while every
    task is slowed enough that the retirement lands mid-action: the drain
    takes the retiring executor out of rotation, its in-flight tasks finish
    or re-queue, and the recovery round re-runs producers on the shrunken
    pool — byte-identical to a fault-free FIXED-pool run, zero orphaned
    store objects, recovery surfaced in the ledger."""
    s = _session3("chaos-scaledown-base")
    try:
        df = _frame(s)
        out = df.groupBy("k").agg(F.sum("v").alias("s"),
                                  F.count("v").alias("n"))
        base = _ipc_bytes(s.engine.collect(out._plan)
                          .sort_by([("k", "ascending")]))
    finally:
        raydp_tpu_torch.stop()

    sent = str(tmp_path / "scaledown-drop.sentinel")
    monkeypatch.setenv(
        "RDT_FAULTS",
        "executor.run_task:delay:ms=250;"
        f"shuffle.write:drop:nth=2:once={sent}")
    got, report, facts = _collect_groupagg_during_retire("chaos-scaledown")
    assert os.path.exists(sent), "injected drop never fired"
    assert got == base
    assert facts["pool"] == 2, facts
    assert facts["orphans"] == 0, (
        f"scale-down racing recovery orphaned {facts['orphans']} objects")
    assert sum(e.get("recovered", 0) for e in report) >= 1, report
    assert sum(e.get("regenerated", 0) for e in report) >= 1, report


# ==== multi-tenant overload robustness =======================================

def _wide_pdf(n=16000):
    rng = np.random.RandomState(0)
    return pd.DataFrame({"k": rng.randint(0, 50, n),
                         "v": rng.randint(0, 1000, n).astype(np.int64)})


def test_spilled_blob_file_lost_mid_join_recovers(tmp_path, monkeypatch):
    """Chaos leg: a spilled shuffle
    blob's DISK FILE is deleted mid-join (``store.spill:drop`` — the
    lost-disk model). The reduce side's transparent fault-in misses the
    file, ``_fault_in`` surfaces the typed ``ObjectLostError``, lineage
    recovery regenerates the map blob — byte-identical to a spill-free
    fault-free run, zero orphans. Parquet inputs keep the store holding
    ONLY intermediates, so every spill victim is lineage-recoverable."""
    from raydp_tpu_torch import config as cfg

    monkeypatch.setenv("RDT_ETL_AQE", "0")  # a broadcast join skips spill
    rng = np.random.RandomState(0)
    for side, col in (("L", "v"), ("R", "w")):
        for i in range(2):
            pdf = pd.DataFrame(
                {"k": rng.randint(0, 200, 6000),
                 col: rng.randint(0, 1000, 6000).astype(np.int64)})
            pdf.to_parquet(str(tmp_path / f"{side}{i}.parquet"))

    def run(app, budget=None):
        from raydp_tpu_torch.runtime.object_store import get_client

        s = raydp_tpu_torch.init(
            app, num_executors=2, executor_cores=1, executor_memory="512MB",
            configs={cfg.SPILL_BUDGET_KEY: str(budget)} if budget else None)
        try:
            client = get_client()
            before = client.stats()["num_objects"]
            dfl = s.read.parquet([str(tmp_path / "L0.parquet"),
                                  str(tmp_path / "L1.parquet")])
            dfr = s.read.parquet([str(tmp_path / "R0.parquet"),
                                  str(tmp_path / "R1.parquet")])
            out = dfl.join(dfr, on="k")
            table = s.engine.collect(out._plan).sort_by(
                [("k", "ascending"), ("v", "ascending"), ("w", "ascending")])
            deadline = time.time() + 30
            while time.time() < deadline \
                    and client.stats()["num_objects"] != before:
                time.sleep(0.2)
            report = s.engine.shuffle_stage_report()
            return (_ipc_bytes(table),
                    client.stats()["num_objects"] - before, report)
        finally:
            raydp_tpu_torch.stop()

    base, orphans0, _ = run("spill-join-base")
    assert orphans0 == 0

    sent = str(tmp_path / "spill-drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS", f"store.spill:drop:nth=1:once={sent}")
    got, orphans, report = run("spill-join-chaos", budget=250_000)
    assert os.path.exists(sent), "store.spill drop never fired"
    assert got == base, "recovered join diverged from the fault-free run"
    assert orphans == 0, f"spill-loss recovery orphaned {orphans} objects"
    assert sum(e.get("recovered", 0) for e in report) >= 1, report
    assert sum(e.get("regenerated", 0) for e in report) >= 1, report


def test_flood_and_interactive_tenants_share_pool(tmp_path, monkeypatch):
    """Fairness chaos leg: a flooding tenant (a wide, per-map-delayed
    groupagg) and an interactive tenant (the canonical small groupagg)
    share ONE pool via two engines. The interactive action completes while
    the flood still has queued work (bounded latency — it never waits out
    the flood's queue), both tenants' results are byte-identical to
    uncontended runs, the per-tenant columns surface in load() and the
    stage report, and the store audit shows zero orphans."""
    from raydp_tpu_torch.etl.engine import Engine

    # uncontended baselines (fault-free, fixed pool)
    s = _session3("chaos-fair-base")
    try:
        small = _frame(s)
        out_s = small.groupBy("k").agg(F.sum("v").alias("s"),
                                       F.count("v").alias("n"))
        base_small = _ipc_bytes(s.engine.collect(out_s._plan)
                                .sort_by([("k", "ascending")]))
        wide = s.createDataFrame(_wide_pdf(), num_partitions=48)
        out_w = wide.groupBy("k").agg(F.sum("v").alias("s"),
                                      F.count("v").alias("n"))
        base_wide = _ipc_bytes(s.engine.collect(out_w._plan)
                               .sort_by([("k", "ascending")]))
    finally:
        raydp_tpu_torch.stop()

    # contended run: per-map delay stretches the flood (48 delayed maps
    # over 12 slots = several waves) so the interactive action demonstrably
    # overlaps it
    monkeypatch.setenv("RDT_FAULTS",
                       "executor.run_task:delay:ms=200:match=|mt-")
    s = _session3("chaos-fair")
    try:
        from raydp_tpu_torch.runtime.object_store import get_client
        client = get_client()
        small = _frame(s)
        out_s = small.groupBy("k").agg(F.sum("v").alias("s"),
                                       F.count("v").alias("n"))
        # the flood is a SECOND tenant on the same pool: a second engine
        # over the session's executors, wide input (16 delayed maps)
        flood_eng = Engine(s.engine.pool,
                           shuffle_partitions=s.engine.shuffle_partitions,
                           owner=s.engine.owner, tenant="flood")
        wide = s.createDataFrame(_wide_pdf(), num_partitions=48)
        out_w = wide.groupBy("k").agg(F.sum("v").alias("s"),
                                      F.count("v").alias("n"))
        before = client.stats()["num_objects"]
        box = {}

        def flood():
            try:
                box["wide"] = _ipc_bytes(flood_eng.collect(out_w._plan)
                                         .sort_by([("k", "ascending")]))
            except Exception as e:  # noqa: BLE001 - asserted below
                box["error"] = e

        t = threading.Thread(target=flood)
        t.start()
        deadline = time.time() + 30
        while time.time() < deadline \
                and (s.engine.pool.load()["tenants"]
                     .get("flood", {}).get("queued", 0)) < 4:
            time.sleep(0.02)  # the flood has saturated + queued
        t0 = time.monotonic()
        got_small = _ipc_bytes(s.engine.collect(out_s._plan)
                               .sort_by([("k", "ascending")]))
        inter_wall = time.monotonic() - t0
        load_at_finish = s.engine.pool.load()
        t.join(timeout=300)
        assert "error" not in box, box.get("error")
        # bounded latency: the interactive action finished while the flood
        # still had queued work — it shared slots instead of queueing behind
        flood_row = load_at_finish["tenants"].get("flood", {})
        assert flood_row.get("queued", 0) > 0, load_at_finish
        assert inter_wall < 20.0, f"interactive starved: {inter_wall:.1f}s"
        # per-tenant observability: both tenants' dispatch counts surface,
        # and the stage report carries the tenant column
        tenants = load_at_finish["tenants"]
        assert tenants[s.master_name]["dispatched"] >= 1
        assert tenants["flood"]["dispatched"] >= 1
        rep = s.engine.shuffle_stage_report() + \
            flood_eng.shuffle_stage_report()
        assert {e["tenant"] for e in rep} >= {s.master_name, "flood"}
        # accepted results byte-identical to the uncontended runs
        assert got_small == base_small
        assert box["wide"] == base_wide
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.25)
        orphans = client.stats()["num_objects"] - before
        assert orphans == 0, f"contended run orphaned {orphans} objects"
    finally:
        raydp_tpu_torch.stop()


# ---------------------------------------------------------------------------
# continuous pipelines: the streaming fault matrix
# ---------------------------------------------------------------------------

def _run_stream_windows(app, epochs=5, rows=1200):
    """One full session driving a windowed continuous pipeline; returns
    (list of (start, end, window ipc bytes), epoch result bytes, report).
    Window tables are already key-sorted by the pipeline (the groupagg
    row-order caveat of _run_groupagg, handled once in _merge_window)."""
    from raydp_tpu_torch import stream
    from raydp_tpu_torch.etl.expressions import col

    def make(epoch):
        rng = np.random.RandomState(epoch)
        return pa.table({
            "k": rng.randint(0, 16, rows),
            "v": rng.randint(0, 1000, rows).astype(np.int64),
        })

    s = _session(app)
    try:
        from raydp_tpu_torch.runtime.object_store import get_client
        client = get_client()
        before = client.stats()["num_objects"]
        pipe = stream.read_stream(
            stream.SyntheticSource(make, max_epochs=epochs)).transform(
            lambda df: df.filter(col("v") % 7 != 0)).window(
            size=3, slide=1, keys=["k"], aggs={"v": ["sum", "count"]})
        wins, epochs_b = [], []
        for er in pipe.epochs():
            epochs_b.append(_ipc_bytes(er.table()))
            wins.extend((w.start, w.end, _ipc_bytes(w.table))
                        for w in er.windows)
        rep = pipe.report()
        pipe.close()
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.25)
        orphans = client.stats()["num_objects"] - before
        return wins, epochs_b, rep, orphans
    finally:
        raydp_tpu_torch.stop()


def test_stream_executor_crash_mid_epoch_byte_identical(tmp_path,
                                                        monkeypatch):
    """An executor crash in the middle of an epoch's engine action: the
    lineage plane re-runs the lost tasks INSIDE the epoch (the stream layer
    never notices), and every epoch result and window merge is
    byte-identical to the fault-free run with zero orphans."""
    base_w, base_e, _, orphans0 = _run_stream_windows("stream-crash-base")
    assert orphans0 == 0

    crash_s = str(tmp_path / "stream-crash.sentinel")
    monkeypatch.setenv(
        "RDT_FAULTS", f"executor.run_task:crash:nth=4:once={crash_s}")
    got_w, got_e, rep, orphans = _run_stream_windows("stream-crash")
    assert os.path.exists(crash_s), "injected crash never fired"
    assert got_e == base_e, "epoch results diverged after the crash"
    assert got_w == base_w, "window results diverged after the crash"
    assert orphans == 0, f"crash replay orphaned {orphans} store objects"


def test_stream_epoch_drop_replays_exactly_once(tmp_path, monkeypatch):
    """The stream's own fault site: ``stream.epoch:drop`` loses a freshly
    sealed epoch's partial blobs post-commit (the store-host-died model for
    streams). The window merges spanning the lost epoch must re-derive it
    from the source journal — results byte-identical to the unfaulted run,
    each epoch contributing exactly once, zero orphans."""
    base_w, base_e, base_rep, _ = _run_stream_windows("stream-drop-base")
    assert base_rep["replays"] == 0

    sent = str(tmp_path / "stream-drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS",
                       f"stream.epoch:drop:nth=2:once={sent}")
    got_w, got_e, rep, orphans = _run_stream_windows("stream-drop")
    assert os.path.exists(sent), "injected drop never fired"
    assert rep["replays"] >= 1, "the lost epoch was never replayed"
    assert got_w == base_w, "window results diverged after the drop"
    assert got_e == base_e
    assert orphans == 0, f"epoch replay orphaned {orphans} store objects"
