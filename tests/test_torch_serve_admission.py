"""Serving and pool admission under load and scale changes, on real
executors: four of ``tests/test_chaos.py``'s legs with the same
assertions, through the port's serving plane (``serve/replica.py``,
``serve/servable.py``, ``serve/rollout.py`` on a port ETL session's
executors, serving on the CPU) and its pool (admission, ``etl/autoscale.py``,
a graceful drain).

- ``test_rollout_canary_latency_regression_rolls_back``: a canary stalled
  700 ms a predict is judged on the p99 arm and rolled back mid-traffic;
  zero dropped, answers bitwise a rollout-free run's, a
  ``rollout_rollback`` event and a blackbox bundle.
- ``test_serving_overload_burst_sheds_typed``: a burst past
  ``RDT_SERVE_MAX_QUEUE`` sheds with the typed ``ServingOverloaded``; the
  accepted requests are bitwise an uncontended run's and the dispatcher
  serves on.
- ``test_admission_composes_with_autoscale_and_drain``: a second action
  parks at the pool's admission, the autoscaler grows the pool, an
  executor drains mid-flood; both results bitwise uncontended runs', no
  orphan in the store.
- ``test_scale_down_races_live_serving_replica``: the executor of a live
  replica is retired mid-burst; the replica re-homes onto a survivor, zero
  dropped, answers bitwise a fixed pool's.

These are the twins of the reference legs that fail in some loaded test
runs (the p99 rollback, the admission leg and the scale-down race), kept in
one file so that ``--dist loadfile`` runs them on one worker, one after
another. Knobs and fault specs are set before each session starts, so its
executors inherit them, and restored when it stops.
"""

import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import raydp_tpu_torch
from raydp_tpu_torch.etl import functions as F

from tests.test_torch_serve_faults import (
    SESSION, fit_and_export, guard_traffic, linear_rows, rows,
)


def _ipc_bytes(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def _frame(s, n=4000):
    rng = np.random.RandomState(0)
    pdf = pd.DataFrame({
        "k": rng.randint(0, 50, n),
        # integer aggregates only: bit-identical under any partial/merge
        # order (float partials may differ in the last ulp)
        "v": rng.randint(0, 1000, n).astype(np.int64),
    })
    return s.createDataFrame(pdf, num_partitions=4)


def _wide_pdf(n=16000):
    rng = np.random.RandomState(0)
    return pd.DataFrame({"k": rng.randint(0, 50, n),
                         "v": rng.randint(0, 1000, n).astype(np.int64)})


def _groupagg(df):
    return df.groupBy("k").agg(F.sum("v").alias("s"),
                               F.count("v").alias("n"))


def _collect_sorted(s, out) -> bytes:
    return _ipc_bytes(s.engine.collect(out._plan)
                      .sort_by([("k", "ascending")]))


def test_rollout_canary_latency_regression_rolls_back(tmp_path):
    """A canary whose every predict is stalled by a seeded
    ``serve.predict:delay`` (replica-id match ``-v2-`` pins the injection
    to the canary group alone) is judged unhealthy on the p99 arm and
    AUTO-ROLLS-BACK mid-traffic: zero dropped requests, results
    byte-identical to a rollout-free run, and the postmortem artifacts — a
    ``rollout_rollback`` event plus a flight-recorder blackbox bundle — are
    present. The delay rule has no once= sentinel (it must fire on every
    canary call to regress the p99 window); the ``"p99"`` rollback reason
    is the proof the injection bit."""
    import os

    from raydp_tpu_torch import metrics
    from raydp_tpu_torch.runtime import head as head_mod
    from raydp_tpu_torch.serve import ServingSession

    x, pdf = linear_rows()
    dir_v1 = str(tmp_path / "guard-v1")
    dir_v2 = str(tmp_path / "guard-v2")
    results, reports = {}, {}
    outcome = None

    for mode in ("clean", "rollout"):
        with pytest.MonkeyPatch.context() as mp:
            if mode == "rollout":
                # EVERY canary predict (replica ids guard-v2-r*) stalls
                # 700ms — a pure latency regression (no errors): only the
                # p99 arm can catch it (set BEFORE init so executors
                # inherit it)
                mp.setenv("RDT_FAULTS",
                          "serve.predict:delay:ms=700:match=-v2-")
            mp.setenv("RDT_SERVE_BATCH_TIMEOUT_MS", "10")
            mp.setenv("RDT_SERVE_HEDGE", "0")
            s = raydp_tpu_torch.init(f"serve_rollout_{mode}", **SESSION)
            try:
                if mode == "clean":
                    est = fit_and_export(s, pdf, dir_v1)
                    # the canary is the SAME weights exported again:
                    # responses must be byte-identical whichever version
                    # answers, so the identity assert covers requests
                    # served mid-ramp too
                    est.export_serving(dir_v2)
                srv = ServingSession(dir_v1, session=s, name="guard",
                                     device="cpu")
                try:
                    got = []
                    t = threading.Thread(target=guard_traffic,
                                         args=(srv, x, 120, got))
                    t.start()
                    try:
                        if mode == "rollout":
                            outcome = srv.rollout(
                                dir_v2, tag="regressed", initial_weight=0.5,
                                steps=[0.5, 1.0], step_s=20.0,
                                min_samples=6, p99_factor=2.0,
                                timeout=120.0)
                    finally:
                        t.join(timeout=180.0)
                    assert not t.is_alive(), "traffic thread hung"
                    results[mode] = np.concatenate(got)
                    reports[mode] = srv.serving_report()
                    if mode == "rollout":
                        # postmortem artifacts, checked while the session
                        # (and its session_dir) is live
                        kinds = [e["kind"] for e in metrics.events()]
                        assert "rollout_rollback" in kinds, kinds
                        bb_dir = os.path.join(
                            head_mod.get_runtime().session_dir, "blackbox")
                        bundles = [f for f in os.listdir(bb_dir)
                                   if f.startswith("blackbox-rollout-guard")
                                   and f.endswith(".json")]
                        assert bundles, "rollback wrote no blackbox bundle"
                finally:
                    srv.close()
            finally:
                raydp_tpu_torch.stop()

    # the guard judged the latency regression, not an error burst
    assert outcome["outcome"] == "rolled_back", outcome
    assert "p99" in outcome["reason"], outcome
    # zero dropped: every seeded request completed, none failed terminally
    assert reports["rollout"]["failed"] == 0, reports["rollout"]
    assert len(results["rollout"]) == len(results["clean"]) == 240
    # byte-identical to the rollout-free run: neither the canary detour nor
    # the rollback re-home may leak into the numbers
    assert np.array_equal(results["clean"], results["rollout"])
    # the canary group is gone: the primary (v1) is the only live version
    # and no replica still carries the canary's bundle
    rep = reports["rollout"]
    assert rep["servable"]["version"] == 1, rep["servable"]
    assert [vr["version"] for vr in rep["versions"]] == [1], rep["versions"]
    assert all(r["version"] == 1 for r in rep["replicas"]), rep["replicas"]


def test_serving_overload_burst_sheds_typed(tmp_path, monkeypatch):
    """A burst far past RDT_SERVE_MAX_QUEUE against a deliberately slowed
    replica sheds with the typed retriable ServingOverloaded — the
    dispatcher stays alive (accepted requests all complete, a post-burst
    request is served), accepted results are byte-identical to an
    uncontended run, and the report shows failed == shed only."""
    from raydp_tpu_torch import metrics
    from raydp_tpu_torch.serve import ServingOverloaded, ServingSession

    x, pdf = linear_rows(256)
    export_dir = str(tmp_path / "overload-servable")

    monkeypatch.setenv("RDT_SERVE_BATCH_TIMEOUT_MS", "5")
    # armed BEFORE init so the spawned executors (where serve.predict
    # fires) inherit the delay; it slows every replica apply by 120ms,
    # which cannot change the numbers — only the queue dynamics
    monkeypatch.setenv("RDT_FAULTS", "serve.predict:delay:ms=120")
    s = raydp_tpu_torch.init("serve_overload", **SESSION)
    try:
        fit_and_export(s, pdf, export_dir)

        # uncontended reference predictions (shedding off)
        monkeypatch.setenv("RDT_SERVE_MAX_QUEUE", "0")
        with ServingSession(export_dir, session=s, name="ref",
                            num_replicas=1, device="cpu") as ref:
            expect = [ref.predict(rows(x, i, 2), timeout=60.0)
                      for i in range(0, 64, 2)]

        # overload run: the same slow replicas + a tight queue bound
        monkeypatch.setenv("RDT_SERVE_MAX_QUEUE", "6")
        srv = ServingSession(export_dir, session=s, name="overload",
                             num_replicas=1, device="cpu")
        try:
            accepted, shed = [], 0
            for i in range(0, 64, 2):
                try:
                    accepted.append((i // 2,
                                     srv.predict_async(rows(x, i, 2))))
                except ServingOverloaded:
                    shed += 1
            assert shed >= 1, "burst never shed"
            assert len(accepted) >= 6
            for idx, fut in accepted:
                got = fut.result(timeout=120.0)
                assert np.array_equal(got, expect[idx]), idx
            rep = srv.serving_report()
            assert rep["shed"] == shed
            assert rep["failed"] == rep["shed"], rep  # failed == shed ONLY
            # the dispatcher survived the burst: a fresh request serves
            tail = srv.predict(rows(x, 0, 2), timeout=60.0)
            assert np.array_equal(tail, expect[0])
            assert "overload_shed" in [e["kind"] for e in metrics.events()]
        finally:
            srv.close()
    finally:
        raydp_tpu_torch.stop()


def test_admission_composes_with_autoscale_and_drain(tmp_path, monkeypatch):
    """A flooding tenant pushes the pool backlog past RDT_POOL_MAX_QUEUED
    so a second action PARKS at admission; the autoscaler (armed, fast
    cadence) sees the parked demand and grows the pool; a concurrent
    graceful drain retires an executor mid-flood. Both actions complete
    byte-identical to uncontended baselines, the parked action was admitted
    (never rejected), and the store audit shows zero orphans."""
    from raydp_tpu_torch import metrics
    from raydp_tpu_torch.runtime.object_store import get_client

    s = raydp_tpu_torch.init("chaos-admit-base", **SESSION)
    try:
        base_small = _collect_sorted(s, _groupagg(_frame(s)))
        wide = s.createDataFrame(_wide_pdf(), num_partitions=48)
        base_wide = _collect_sorted(s, _groupagg(wide))
    finally:
        raydp_tpu_torch.stop()

    monkeypatch.setenv("RDT_POOL_MAX_QUEUED", "8")
    monkeypatch.setenv("RDT_ADMIT_TIMEOUT_S", "120")
    monkeypatch.setenv("RDT_POOL_SCALE_INTERVAL_S", "0.2")
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0.3")
    monkeypatch.setenv("RDT_POOL_IDLE_S", "60")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0.5")
    monkeypatch.setenv("RDT_FAULTS",
                       "executor.run_task:delay:ms=200:match=|mt-")
    s = raydp_tpu_torch.init("chaos-admit", num_executors=3,
                             executor_cores=1, executor_memory="512MB")
    try:
        client = get_client()
        auto = s.autoscale(min_size=1, max_size=4)
        out = _groupagg(_frame(s))
        wide = s.createDataFrame(_wide_pdf(), num_partitions=48)
        out_w = _groupagg(wide)
        before = client.stats()["num_objects"]
        box = {}

        def flood():
            try:
                box["wide"] = _collect_sorted(s, out_w)
            except Exception as e:  # noqa: BLE001 - asserted below
                box["flood_error"] = e

        def late():
            try:
                box["small"] = _collect_sorted(s, out)
            except Exception as e:  # noqa: BLE001 - asserted below
                box["late_error"] = e

        tf = threading.Thread(target=flood)
        tf.start()
        deadline = time.time() + 30
        while time.time() < deadline \
                and s.engine.pool.load()["queued"] <= 8:
            time.sleep(0.02)  # flood backlog past the admission bound
        tl = threading.Thread(target=late)
        tl.start()
        # the late action parks at admission (visible in load())
        deadline = time.time() + 20
        parked_seen = 0
        while time.time() < deadline:
            parked_seen = max(parked_seen, s.engine.pool.load()["parked"])
            if parked_seen:
                break
            time.sleep(0.02)
        # concurrent drain while the flood runs and the late action parks
        s.retire_executor(s.executors[-1].name)
        tf.join(timeout=300)
        tl.join(timeout=300)
        assert not tf.is_alive() and not tl.is_alive(), "an action hung"
        assert "flood_error" not in box, box.get("flood_error")
        assert "late_error" not in box, box.get("late_error")
        assert parked_seen > 0, "late action never parked at admission"
        assert box["wide"] == base_wide
        assert box["small"] == base_small
        # the autoscaler grew for the parked/queued demand. It appends a
        # grow's event only after the executors it spawned joined the pool,
        # and the two actions can finish on them first: stop it (its thread
        # finishes the decision in flight, bounded) before reading its record
        auto.stop()
        assert any(e["direction"] == "up" for e in auto.events), auto.events
        deadline = time.time() + 30
        while time.time() < deadline \
                and client.stats()["num_objects"] != before:
            time.sleep(0.25)
        orphans = client.stats()["num_objects"] - before
        assert orphans == 0, f"admission+scale+drain orphaned {orphans}"
        snap = metrics.snapshot()["counters"]
        assert snap.get("pool_admission_parked_total", {}), snap
        assert not snap.get("pool_admission_rejects_total", {}), \
            "the parked action was rejected instead of admitted"
    finally:
        raydp_tpu_torch.stop()


def test_scale_down_races_live_serving_replica(tmp_path):
    """The executor hosting a live serving replica is retired mid-burst.
    In-flight dispatches re-route through the hedge path, the background
    reload routes through the pool's LIVE-member view and re-homes the
    replica onto a survivor — zero dropped requests, results
    byte-identical to a fault-free fixed-pool run."""
    from raydp_tpu_torch.serve import ServingSession

    x, pdf = linear_rows()
    export_dir = str(tmp_path / "scale-servable")
    results, reports = {}, {}

    for mode in ("clean", "retire"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RDT_SERVE_BATCH_TIMEOUT_MS", "10")
            s = raydp_tpu_torch.init(f"serve_scale_{mode}", num_executors=3,
                                     executor_cores=1,
                                     executor_memory="512MB")
            try:
                if mode == "clean":
                    fit_and_export(s, pdf, export_dir)
                srv = ServingSession(export_dir, session=s, name="scalesrv",
                                     device="cpu")
                try:
                    futs = [srv.predict_async(rows(x, i, 2))
                            for i in range(0, 64, 2)]
                    if mode == "retire":
                        # replica scalesrv-r0 lives on executor 0: retire
                        # it with the burst in flight
                        s.retire_executor(
                            f"rdt-executor-serve_scale_{mode}-0")
                    burst = [f.result(timeout=120.0) for f in futs]
                    tail = [srv.predict(rows(x, 64 + i, 1), timeout=120.0)
                            for i in range(16)]
                    results[mode] = np.concatenate(burst + tail)
                    # the re-homed replica's background reload may still be
                    # loading on the survivor: poll until it is back in
                    # rotation
                    deadline = time.time() + 60
                    while True:
                        reports[mode] = srv.serving_report()
                        if all(r["ready"] for r in reports[mode]["replicas"]) \
                                or time.time() > deadline:
                            break
                        time.sleep(0.25)
                finally:
                    srv.close()
            finally:
                raydp_tpu_torch.stop()

    assert reports["retire"]["failed"] == 0, reports["retire"]
    assert len(results["retire"]) == len(results["clean"]) == 80
    assert np.array_equal(results["clean"], results["retire"])
    # the replica re-homed off the retired executor onto a survivor
    r0 = next(r for r in reports["retire"]["replicas"]
              if r["replica"] == "scalesrv-r0")
    assert r0["executor"] != "rdt-executor-serve_scale_retire-0", r0
    assert r0["ready"], r0
