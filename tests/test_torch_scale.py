"""Elastic executor pool: graceful drain, elastic membership,
restart re-admission, and the autoscale controller.

Units run against stub executor handles (no runtime) and pin the
driver-side contracts: a draining executor takes no new dispatch, a member
added mid-stage is used at once, pool-wide busy/queued signals reconcile,
and ``retire_executor`` runs drain → re-home → remove → reap in order.
Integration legs run real sessions; the chaos composition (scale-down
racing recovery / pipelined streams / serving) lives in tests/test_chaos.py.

The port's twin of ``tests/test_scale.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift; the chaos legs are in
``test_torch_chaos_streams.py``. One case has no twin:
``test_fair_share_tracks_weights`` reads the weighted 3:1 split after the
heavy tenant's thread joins, and the gate bounds in-flight counts, not
dispatch rates. On a loaded host the light tenant dispatches uncontested
in the heavy tenant's tail, and the two tenants' dispatch loops, starved
of CPU, set the split: 0.40-0.59 at the heavy tenant's last dispatch
across 180 runs in 12 concurrent processes, against the case's 0.55.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from raydp_tpu_torch import metrics
from raydp_tpu_torch.etl.engine import Engine, ExecutorPool

from tests.test_torch_scheduler import StubExecutor, _payloads, _tasks


# ==== elastic membership units ================================================

def test_draining_executor_gets_no_new_dispatch(monkeypatch):
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name="a")
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b])
    assert pool.begin_drain("a")
    out = pool.run_tasks(_tasks(4), payloads=_payloads(4))
    assert all(r is not None for r in out)
    assert len(a.submits) == 0, "draining executor received new work"
    assert len(b.submits) == 4
    # draining is also invisible to locality preference
    pool.cancel_drain("a")
    pool.begin_drain("a")
    pool.run_tasks(_tasks(2), preferred=["a", "a"], payloads=_payloads(2))
    assert len(a.submits) == 0


def test_begin_drain_refuses_last_live_executor():
    a = StubExecutor(name="a")
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b])
    assert pool.begin_drain("a")
    with pytest.raises(ValueError):
        pool.begin_drain("b")
    # and double-drain of one executor is a no-op, not an error
    assert pool.begin_drain("a") is False


def test_add_executor_mid_stage_is_dispatched(monkeypatch):
    """Membership is read per dispatch pass: an executor the autoscaler
    admits while a stage is running absorbs queued tasks immediately."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    slow = StubExecutor(name="slow", latency=0.15)
    pool = ExecutorPool([slow])
    fast = StubExecutor(name="fast", latency=0.005)
    done = {}

    def run():
        done["out"] = pool.run_tasks(_tasks(8), max_inflight_per_executor=1,
                                     payloads=_payloads(8))

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.05)
    pool.add_executor(fast)
    t.join(timeout=30)
    assert not t.is_alive()
    assert all(r is not None for r in done["out"])
    assert len(fast.submits) >= 3, "mid-stage member was never dispatched"


def test_remove_executor_mid_flight_retries_on_survivor(monkeypatch):
    """An abrupt removal (no drain) leaves in-flight attempts failing; the
    retry machinery lands them on the surviving member."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    from raydp_tpu_torch.runtime.rpc import ConnectionLost

    a = StubExecutor(name="a")
    a.script = [(0.05, lambda fut: fut.set_exception(
        ConnectionLost("killed mid-flight")))] * 2
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b])
    removed = {}

    def run():
        removed["out"] = pool.run_tasks(_tasks(4),
                                        max_inflight_per_executor=2,
                                        payloads=_payloads(4))

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.02)
    assert pool.remove_executor("a") is a
    t.join(timeout=30)
    assert not t.is_alive()
    assert all(r is not None for r in removed["out"])
    assert pool.by_name.get("a") is None
    assert [h.name for h in pool.executors] == ["b"]


def test_pool_busy_and_demand_reconcile(monkeypatch):
    """load() exposes the autoscaler's signals and every exit path of
    run_tasks reconciles them back to zero."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    slow = StubExecutor(name="slow", latency=0.2)
    pool = ExecutorPool([slow])
    seen = {}

    def run():
        pool.run_tasks(_tasks(6), max_inflight_per_executor=2,
                       payloads=_payloads(6))

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        load = pool.load()
        if load["busy"] > 0 and load["queued"] > 0:
            seen["load"] = load
            break
        time.sleep(0.01)
    t.join(timeout=30)
    assert seen, "never observed a busy+queued pool mid-stage"
    assert seen["load"]["busy"] <= 2
    assert seen["load"]["queued"] >= 1
    after = pool.load()
    assert after["busy"] == 0 and after["queued"] == 0, after
    assert pool.wait_idle("slow", timeout=1.0)


def test_mark_up_readmission_symmetry():
    """A down-marked executor that answers again re-enters placement at
    once, with the executor_up flight-recorder event mirroring the
    executor_down it balances (the restarted-mid-action re-admission)."""
    metrics.reset()
    a = StubExecutor(name="a")
    pool = ExecutorPool([a, StubExecutor(name="b")])
    ident = pool._idents[0]
    pool._mark_down(ident, "a")
    assert pool._is_down(ident)
    pool._mark_up(ident, "a")
    assert not pool._is_down(ident)
    pool._mark_up(ident, "a")  # idempotent: no second event
    kinds = [e["kind"] for e in metrics.events()]
    assert kinds.count("executor_down") == 1
    assert kinds.count("executor_up") == 1
    snap = metrics.snapshot()["counters"]
    assert snap["sched_executor_up_total"] == {"a": 1}


def test_down_executor_readmitted_within_action(monkeypatch):
    """Satellite: a restarting executor whose submits fail is marked down,
    but once its address answers again the SAME stage routes work back to
    it instead of finishing the action on the shrunken remainder."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    metrics.reset()
    a = StubExecutor(name="a")
    a.script = ["connlost"]  # first submit refused (restart in flight)
    b = StubExecutor(name="b", latency=0.3)
    pool = ExecutorPool([a, b])
    # drop the down TTL so the restarted executor is probed inside this
    # stage rather than 10s later
    monkeypatch.setattr("raydp_tpu_torch.etl.engine._DOWN_TTL_S", 0.2)
    out = pool.run_tasks(_tasks(6), max_inflight_per_executor=1,
                         payloads=_payloads(6))
    assert all(r is not None for r in out)
    assert len(a.submits) >= 1, "restarted executor was never re-admitted"
    kinds = [e["kind"] for e in metrics.events()]
    assert "executor_down" in kinds and "executor_up" in kinds


# ==== retire_executor (drain protocol) units =================================

def _engine(pool):
    return Engine(pool, shuffle_partitions=4)


def test_retire_executor_drain_rehome_reap_order(monkeypatch):
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name="a")
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b])
    eng = _engine(pool)
    calls = []
    out = eng.retire_executor(
        "a",
        rehome=lambda name: calls.append(("rehome", name)) or 7,
        reap=lambda h: calls.append(("reap", h.name)))
    assert calls == [("rehome", "a"), ("reap", "a")]
    assert out == {"executor": "a", "quiesced": True, "rehomed": 7,
                   "pool_size": 1}
    assert [h.name for h in pool.executors] == ["b"]
    with pytest.raises(KeyError):
        eng.retire_executor("a")


def test_retire_executor_rehome_knob_off(monkeypatch):
    monkeypatch.setenv("RDT_DRAIN_REHOME", "0")
    pool = ExecutorPool([StubExecutor(name="a"), StubExecutor(name="b")])
    eng = _engine(pool)
    calls = []
    out = eng.retire_executor("a", rehome=lambda n: calls.append(n) or 3)
    assert calls == [], "RDT_DRAIN_REHOME=0 still re-homed"
    assert out["rehomed"] == 0


def test_retire_executor_waits_for_inflight(monkeypatch):
    """The drain quiesce point: retire blocks until the victim's in-flight
    task completes (pool-wide busy hits zero), and the task's result is
    kept — drained, never dropped."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    slow = StubExecutor(name="slow", latency=0.4)
    fast = StubExecutor(name="fast")
    pool = ExecutorPool([slow, fast])
    eng = _engine(pool)
    done = {}

    def run():
        done["out"] = pool.run_tasks(_tasks(1), preferred=["slow"],
                                     payloads=_payloads(1))

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.1)  # the task is in flight on `slow`
    t0 = time.monotonic()
    out = eng.retire_executor("slow")
    assert out["quiesced"] is True
    assert time.monotonic() - t0 >= 0.2, "drain did not wait for in-flight"
    t.join(timeout=10)
    assert done["out"][0] is not None


def test_retire_executor_failed_rehome_abandons(monkeypatch):
    """A re-home failure degrades to abandonment (lineage rebuilds on
    read), never fails the retirement."""
    pool = ExecutorPool([StubExecutor(name="a"), StubExecutor(name="b")])
    eng = _engine(pool)

    def boom(name):
        raise RuntimeError("re-home exploded")

    out = eng.retire_executor("a", rehome=boom)
    assert out["rehomed"] == 0
    assert [h.name for h in pool.executors] == ["b"]


def test_retire_last_executor_refused():
    pool = ExecutorPool([StubExecutor(name="only")])
    eng = _engine(pool)
    with pytest.raises(ValueError):
        eng.retire_executor("only")
    # the refusal leaves it dispatchable
    assert pool.run_tasks(_tasks(1), payloads=_payloads(1))[0] is not None


def test_retire_records_drain_event_and_counters():
    metrics.reset()
    pool = ExecutorPool([StubExecutor(name="a"), StubExecutor(name="b")])
    _engine(pool).retire_executor("a")
    kinds = [e["kind"] for e in metrics.events()]
    assert "executor_drain" in kinds
    snap = metrics.snapshot()
    assert snap["counters"]["pool_drains_total"] == {"": 1}
    assert snap["gauges"]["pool_size"] == {"": 1}


# ==== autoscale controller units =============================================

class _FakeSession:
    """Session stand-in the controller drives: grow/shrink calls recorded,
    a real ExecutorPool supplies load()."""

    def __init__(self, pool):
        self.engine = SimpleNamespace(pool=pool)
        self.grown = 0
        self.retired = []

    def _grow_executor(self):
        h = StubExecutor(name=f"new-{self.grown}")
        self.grown += 1
        self.engine.pool.add_executor(h)
        return h

    def _shrink_candidate(self):
        names = [h.name for h in self.engine.pool.executors]
        return names[-1] if len(names) > 1 else None

    def retire_executor(self, name):
        self.retired.append(name)
        self.engine.pool.remove_executor(name)


def _autoscaler(sess, **kw):
    from raydp_tpu_torch.etl.autoscale import PoolAutoscaler
    return PoolAutoscaler(sess, **kw)


def test_autoscaler_grows_on_sustained_queue(monkeypatch):
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0")
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    auto = _autoscaler(sess, min_size=1, max_size=3)
    pool._demand_delta(5)  # queued demand, nothing in flight
    auto._tick()  # window (0s) satisfied at once: grow
    assert sess.grown == 1
    assert [e["direction"] for e in auto.events] == ["up"]
    assert len(pool.executors) == 2
    pool._demand_delta(-5)


def test_autoscaler_spike_does_not_thrash(monkeypatch):
    """Hysteresis: a queue spike shorter than RDT_POOL_SCALE_UP_S never
    grows, and after a scale event the cooldown blocks the next decision."""
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "30")
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    auto = _autoscaler(sess, min_size=1, max_size=3)
    pool._demand_delta(5)
    auto._tick()
    auto._tick()
    assert sess.grown == 0, "a short spike grew the pool"
    pool._demand_delta(-5)
    # cooldown: force an event, then make the pool look grow-worthy
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "60")
    auto._note("up", 1, "test")
    pool._demand_delta(5)
    auto._tick()
    auto._tick()
    assert sess.grown == 0, "cooldown was ignored"
    pool._demand_delta(-5)


def test_autoscaler_shrinks_idle_pool_to_min(monkeypatch):
    monkeypatch.setenv("RDT_POOL_IDLE_S", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0")
    pool = ExecutorPool([StubExecutor(name="e0"), StubExecutor(name="e1"),
                         StubExecutor(name="e2")])
    sess = _FakeSession(pool)
    auto = _autoscaler(sess, min_size=1, max_size=3)
    for _ in range(6):
        auto._tick()
    assert sess.retired == ["e2", "e1"]
    assert len(pool.executors) == 1, "shrank past min or not at all"


def test_autoscaler_respects_max(monkeypatch):
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0")
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    auto = _autoscaler(sess, min_size=1, max_size=2)
    pool._demand_delta(50)
    for _ in range(6):
        auto._tick()
    assert len(pool.executors) == 2, "grew past max"
    pool._demand_delta(-50)


def test_autoscaler_requires_sane_bounds():
    pool = ExecutorPool([StubExecutor(name="e0")])
    with pytest.raises(ValueError):
        _autoscaler(_FakeSession(pool))  # RDT_POOL_MAX default 0 < min


# ==== live integration =======================================================

def _ipc_bytes(table):
    import pyarrow as pa
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def test_session_retire_executor_live():
    """End-to-end drain on a real 3-executor session: persisted blocks
    re-home onto survivors, results stay byte-identical, the store ends at
    its pre-drain object count, and the process is reaped."""
    import raydp_tpu_torch
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.runtime.object_store import get_client

    s = raydp_tpu_torch.init("scale-retire", num_executors=3, executor_cores=1,
                       executor_memory="512MB")
    try:
        rng = np.random.RandomState(0)
        pdf = pd.DataFrame({"k": rng.randint(0, 50, 4000),
                            "v": rng.randint(0, 1000, 4000).astype(np.int64)})
        df = s.createDataFrame(pdf, num_partitions=4)
        out = df.groupBy("k").agg(F.sum("v").alias("s"))
        base = _ipc_bytes(s.engine.collect(out._plan)
                          .sort_by([("k", "ascending")]))
        cached = df.persist()
        assert cached.count() == 4000
        before = get_client().stats()["num_objects"]

        victim = s.executors[-1].name
        # the drain inventory: what the retiring executor uniquely holds
        info = s.executors[-1].call("drain_info")
        assert info["executor"] == victim
        frame = list(s._cached_frames.values())[0]
        victims_blocks = {k for k, owner in zip(frame.cache_keys,
                                                frame.executors)
                          if owner == victim}
        assert victims_blocks <= set(info["blocks"])

        size = s.retire_executor(victim)
        assert size == 2 and len(s.executors) == 2
        assert victim not in {h.name for h in s.executors}
        # no cached partition still claims the retiree (all re-homed)
        frame_id = list(s._cached_frames)[0]
        assert victim not in s._cached_frames[frame_id].executors
        # the re-homed blocks really live on the survivors
        for h in s.executors:
            for key, owner in zip(s._cached_frames[frame_id].cache_keys,
                                  s._cached_frames[frame_id].executors):
                if owner == h.name:
                    assert h.call("has_block", key)

        got = _ipc_bytes(s.engine.collect(out._plan)
                         .sort_by([("k", "ascending")]))
        assert got == base
        assert cached.count() == 4000
        assert get_client().stats()["num_objects"] == before, \
            "drain leaked store objects"
    finally:
        raydp_tpu_torch.stop()


def test_session_autoscale_grow_and_shrink_live(monkeypatch):
    """The recorded-bench shape at test scale: a queued burst grows the
    pool within RDT_POOL_MAX, the idle window drains it back to min, and
    every action succeeds with identical results."""
    import raydp_tpu_torch
    from raydp_tpu_torch.etl import functions as F

    monkeypatch.setenv("RDT_POOL_SCALE_INTERVAL_S", "0.2")
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0.4")
    monkeypatch.setenv("RDT_POOL_IDLE_S", "1.5")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "1.0")
    monkeypatch.setenv("RDT_FAULTS", "executor.run_task:delay:ms=400")
    s = raydp_tpu_torch.init("scale-auto", num_executors=1, executor_cores=1,
                       executor_memory="512MB")
    try:
        auto = s.autoscale(min_size=1, max_size=3)
        rng = np.random.RandomState(0)
        pdf = pd.DataFrame({"k": rng.randint(0, 50, 8000),
                            "v": rng.randint(0, 1000, 8000).astype(np.int64)})
        df = s.createDataFrame(pdf, num_partitions=8)
        out = df.groupBy("k").agg(F.sum("v").alias("s"))
        results, errs = [], []

        def run():
            try:
                results.append(_ipc_bytes(
                    s.engine.collect(out._plan)
                    .sort_by([("k", "ascending")])))
            except Exception as e:  # noqa: BLE001 - assert below
                errs.append(e)

        threads = [threading.Thread(target=run) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        assert any(e["direction"] == "up" for e in auto.events), \
            "queued burst never grew the pool"
        deadline = time.time() + 30
        while time.time() < deadline and len(s.executors) > 1:
            time.sleep(0.3)
        assert len(s.executors) == 1, "idle pool never drained back to min"
        assert any(e["direction"] == "down" for e in auto.events)
        assert len(set(results)) == 1, "burst results diverged"
    finally:
        raydp_tpu_torch.stop()


# ==== multi-tenant fair sharing / admission / backpressure ========

def test_fair_gate_unit():
    """The deficit-weighted dispatch gate, driven by hand-set pool state:
    the least-served tenant always passes; a tenant past weight x the
    minimum contending share is held; no contention = no gate."""
    pool = ExecutorPool([StubExecutor(name="a")])
    # no other tenant with queued work: always allowed
    assert pool._fair_ok("flood")
    with pool._lock:
        pool._tenant_weight.update({"flood": 1.0, "inter": 1.0})
        pool._tenant_busy.update({"flood": 5, "inter": 3})
        pool._tenant_demand.update({"flood": 100, "inter": 10})
    assert not pool._fair_ok("flood"), "over-served tenant not held"
    assert pool._fair_ok("inter"), "least-served tenant was held"
    # weighted: inter at weight 3 may run 3x flood's share
    with pool._lock:
        pool._tenant_weight["inter"] = 3.0
        pool._tenant_busy.update({"flood": 2, "inter": 6})
    assert pool._fair_ok("flood") and pool._fair_ok("inter")
    with pool._lock:
        pool._tenant_busy.update({"flood": 3, "inter": 5})
    assert not pool._fair_ok("flood")
    # the contender going fully idle (demand == busy) lifts the gate
    with pool._lock:
        pool._tenant_demand["inter"] = 5
    assert pool._fair_ok("flood")


def test_fair_share_interactive_not_starved(monkeypatch):
    """A flooding tenant with hundreds of queued tasks shares the pool with
    an interactive tenant: the interactive stage's handful of tasks
    completes in bounded time instead of waiting out the flood's queue."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    pool = ExecutorPool([StubExecutor(name="e0", latency=0.01),
                         StubExecutor(name="e1", latency=0.01)])
    done = {}

    def flood():
        done["flood"] = pool.run_tasks(
            _tasks(300), max_inflight_per_executor=2,
            payloads=_payloads(300), tenant="flood")

    t = threading.Thread(target=flood)
    t.start()
    deadline = time.monotonic() + 5
    while pool.load()["queued"] < 50 and time.monotonic() < deadline:
        time.sleep(0.01)  # the flood is saturating the pool
    t0 = time.monotonic()
    out = pool.run_tasks(_tasks(8), max_inflight_per_executor=2,
                         payloads=_payloads(8), tenant="interactive")
    wall = time.monotonic() - t0
    t.join(timeout=60)
    assert all(r is not None for r in out)
    assert all(r is not None for r in done["flood"])
    # 8 tasks x 10ms on a fair half of 4 slots is ~40ms; without the gate
    # they would wait out ~300 queued flood tasks (~1.5s+)
    assert wall < 1.0, f"interactive tenant starved ({wall:.2f}s)"
    tenants = pool.load()["tenants"]
    assert tenants["interactive"]["dispatched"] == 8
    assert tenants["flood"]["busy"] == 0 and tenants["flood"]["queued"] == 0


def test_tenant_load_reconciles_on_every_exit_path(monkeypatch):
    """The exit-path matrix: success, stage failure (abort contract),
    speculation losers, and a mid-stage abrupt removal each reconcile the
    per-tenant busy/demand maps to zero — no phantom per-tenant load."""
    from raydp_tpu_torch.runtime.rpc import RemoteError

    def assert_clean(pool):
        load = pool.load()
        for tenant, row in load["tenants"].items():
            assert row["busy"] == 0, (tenant, load)
            assert row["demand"] == 0, (tenant, load)
        with pool._lock:
            assert pool._tenant_busy == {}, pool._tenant_busy
            assert pool._tenant_demand == {}, pool._tenant_demand
            assert pool._tenant_weight == {}, pool._tenant_weight
            assert pool._parked_by_tenant == {}

    # success path
    monkeypatch.setenv("RDT_SPECULATION", "0")
    pool = ExecutorPool([StubExecutor(name="a")])
    pool.run_tasks(_tasks(4), payloads=_payloads(4), tenant="ok")
    assert_clean(pool)

    # stage failure -> abort contract (no-retry app error)
    bad = StubExecutor(name="bad")
    bad.script = [(0.01, lambda fut: fut.set_exception(
        RemoteError("ValueError", "boom", "<tb>")))]
    pool = ExecutorPool([bad])
    with pytest.raises(Exception):
        pool.run_tasks(_tasks(3), payloads=_payloads(3), tenant="aborts")
    assert_clean(pool)

    # speculation loser: the straggler's duplicate completes AFTER the
    # stage returns; its busy decrement must still reconcile
    monkeypatch.setenv("RDT_SPECULATION", "1")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.5")
    monkeypatch.setenv("RDT_SPECULATION_MULTIPLIER", "1.1")
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.05")
    slow = StubExecutor(name="slow", latency=0.8)
    fast = StubExecutor(name="fast", latency=0.01)
    pool = ExecutorPool([slow, fast])
    out = pool.run_tasks(_tasks(6), max_inflight_per_executor=2,
                         payloads=_payloads(6), tenant="spec")
    assert all(r is not None for r in out)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with pool._lock:
            if not pool._tenant_busy:
                break
        time.sleep(0.05)  # losers land asynchronously
    assert_clean(pool)

    # mid-stage drain + abrupt removal racing a running stage
    monkeypatch.setenv("RDT_SPECULATION", "0")
    a = StubExecutor(name="a", latency=0.05)
    b = StubExecutor(name="b", latency=0.05)
    pool = ExecutorPool([a, b])
    box = {}

    def run():
        box["out"] = pool.run_tasks(_tasks(12), max_inflight_per_executor=2,
                                    payloads=_payloads(12), tenant="drain")

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.05)
    pool.begin_drain("a")
    pool.remove_executor("a")
    t.join(timeout=60)
    assert all(r is not None for r in box["out"])
    assert_clean(pool)


def test_admission_parks_then_rejects_typed(monkeypatch):
    """Over RDT_POOL_MAX_QUEUED the call parks (demand visible to the
    autoscaler) and past RDT_ADMIT_TIMEOUT_S fails with the typed no-retry
    AdmissionRejected — reconciling all load on the way out."""
    from raydp_tpu_torch.etl.engine import AdmissionRejected

    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_POOL_MAX_QUEUED", "10")
    monkeypatch.setenv("RDT_ADMIT_TIMEOUT_S", "0.4")
    metrics.reset()
    pool = ExecutorPool([StubExecutor(name="e0", latency=0.05)])

    def flood():
        pool.run_tasks(_tasks(40), max_inflight_per_executor=2,
                       payloads=_payloads(40), tenant="flood")

    t = threading.Thread(target=flood)
    t.start()
    deadline = time.monotonic() + 5
    while pool.load()["queued"] < 11 and time.monotonic() < deadline:
        time.sleep(0.01)
    seen = {}

    def late():
        t0 = time.monotonic()
        try:
            pool.run_tasks(_tasks(4), payloads=_payloads(4), tenant="late")
        except AdmissionRejected as e:
            seen["err"] = e
            seen["wall"] = time.monotonic() - t0

    lt = threading.Thread(target=late)
    lt.start()
    time.sleep(0.1)
    load = pool.load()
    assert load["parked"] == 4, load  # parked demand is visible
    assert load["queued"] >= 11      # ... and counted in the autoscale signal
    # a PARKED tenant is not a fair-share contender: the running flood
    # keeps its full in-flight cap instead of being serialized to one
    # task for the whole park (which would also keep the backlog from
    # ever draining)
    assert load["tenants"]["flood"]["busy"] == 2, load
    assert pool._fair_ok("flood")
    lt.join(timeout=30)
    t.join(timeout=60)
    assert isinstance(seen.get("err"), AdmissionRejected), seen
    assert seen["wall"] >= 0.35
    assert_events = [e["kind"] for e in metrics.events()]
    assert "admission_reject" in assert_events
    snap = metrics.snapshot()["counters"]
    assert snap["pool_admission_parked_total"] == {"late": 1}
    assert snap["pool_admission_rejects_total"] == {"late": 1}
    with pool._lock:
        assert pool._parked_by_tenant == {}
        assert pool._tenant_demand == {}


def test_admission_empty_backlog_always_admits(monkeypatch):
    """A single action larger than the bound runs on an idle pool — the
    bound protects against a backlog, it never wedges a lone big stage."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_POOL_MAX_QUEUED", "5")
    monkeypatch.setenv("RDT_ADMIT_TIMEOUT_S", "0.2")
    pool = ExecutorPool([StubExecutor(name="e0")])
    out = pool.run_tasks(_tasks(30), payloads=_payloads(30), tenant="big")
    assert all(r is not None for r in out)


def test_admission_parked_action_admitted_when_backlog_drains(monkeypatch):
    """The park is a wait, not a rejection: once the running backlog
    drains under the bound the parked action dispatches and completes."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_POOL_MAX_QUEUED", "10")
    monkeypatch.setenv("RDT_ADMIT_TIMEOUT_S", "30")
    pool = ExecutorPool([StubExecutor(name="e0", latency=0.01)])

    def flood():
        pool.run_tasks(_tasks(30), max_inflight_per_executor=2,
                       payloads=_payloads(30), tenant="flood")

    t = threading.Thread(target=flood)
    t.start()
    deadline = time.monotonic() + 5
    while pool.load()["queued"] < 11 and time.monotonic() < deadline:
        time.sleep(0.005)
    out = pool.run_tasks(_tasks(4), payloads=_payloads(4), tenant="late")
    t.join(timeout=60)
    assert all(r is not None for r in out)


def test_admission_fifo_first_parked_first_admitted(monkeypatch):
    """Freed backlog admits parked actions in PARK ORDER:
    four actions park behind a synthetic flood; when the flood drains, they
    must admit first-parked-first — not in whichever order their poll loops
    happened to wake (the pre-FIFO race)."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_POOL_MAX_QUEUED", "10")
    monkeypatch.setenv("RDT_ADMIT_TIMEOUT_S", "30")
    pool = ExecutorPool([StubExecutor(name="e0")])
    flood = 20
    with pool._lock:
        pool._demand += flood
    order = []

    def admit(tag):
        # the real callers register demand before _admit and release after
        with pool._lock:
            pool._demand += 4
        pool._admit(tag, 4)
        order.append(tag)
        with pool._lock:
            pool._demand -= 4

    threads = []
    for tag in ("first", "second", "third", "fourth"):
        t = threading.Thread(target=admit, args=(tag,))
        t.start()
        threads.append(t)
        # park order IS ticket order: wait until THIS one is parked before
        # starting the next
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with pool._lock:
                if pool._parked_by_tenant.get(tag):
                    break
            time.sleep(0.005)
    with pool._lock:
        assert pool._park_queue == sorted(pool._park_queue)
        assert len(pool._park_queue) == 4
        pool._demand -= flood  # the flood drains: the whole backlog frees
    for t in threads:
        t.join(timeout=30)
    assert order == ["first", "second", "third", "fourth"]
    with pool._lock:
        assert pool._park_queue == []
        assert pool._parked_by_tenant == {}
        pool._demand = 0


def test_admission_fifo_newcomer_queues_behind_parked(monkeypatch):
    """A fresh arrival that WOULD fit must still queue behind an
    already-parked action instead of jumping it (first parked, first
    admitted covers admission order, not just wakeup order)."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    monkeypatch.setenv("RDT_POOL_MAX_QUEUED", "10")
    monkeypatch.setenv("RDT_ADMIT_TIMEOUT_S", "30")
    pool = ExecutorPool([StubExecutor(name="e0")])
    with pool._lock:
        pool._demand += 12   # flood: backlog 12 > 10 parks anything
    order = []

    def admit(tag, n):
        with pool._lock:
            pool._demand += n
        pool._admit(tag, n)
        order.append(tag)
        with pool._lock:
            pool._demand -= n

    big = threading.Thread(target=admit, args=("big", 8))
    big.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with pool._lock:
            if pool._parked_by_tenant.get("big"):
                break
        time.sleep(0.005)
    # drain the flood to 5: big still cannot fit (5+8 > 10) but a small
    # newcomer WOULD (5+2 <= 10) — pre-FIFO it would jump straight past
    # the parked big action; now it must park behind it
    with pool._lock:
        pool._demand -= 7
    small = threading.Thread(target=admit, args=("small", 2))
    small.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with pool._lock:
            if pool._parked_by_tenant.get("small"):
                break
        time.sleep(0.005)
    with pool._lock:
        assert pool._parked_by_tenant.get("small") == 2, \
            "the fitting newcomer jumped the parked queue"
        assert order == []
        pool._demand -= 5  # now the flood is gone: both admit, in order
    big.join(timeout=30)
    small.join(timeout=30)
    assert order == ["big", "small"]
    with pool._lock:
        assert pool._park_queue == [] and pool._parked_by_tenant == {}
        pool._demand = 0


def test_backpressure_pauses_and_resumes_dispatch(monkeypatch):
    """A host above the store high-watermark takes no dispatch until it
    drops below the low-watermark; with every host paused, tasks wait
    (graceful degradation) and complete once pressure lifts."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    metrics.reset()
    pressure = {"hostA": 2.0}
    a = StubExecutor(name="a")
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b], hosts_by_name={"a": "hostA", "b": "hostB"})
    pool.pressure_provider = lambda: dict(pressure)
    out = pool.run_tasks(_tasks(6), payloads=_payloads(6))
    assert all(r is not None for r in out)
    assert len(a.submits) == 0, "dispatched to a backpressured host"
    assert len(b.submits) == 6
    assert pool.load()["backpressured_hosts"] == ["hostA"]

    # every host over the watermark: dispatch pauses, then resumes when
    # pressure drops (the cache TTL is 0.5s; drop it via a fresh eval)
    pressure["hostB"] = 2.0
    pool._pressure_cache = None
    box = {}

    def run():
        box["out"] = pool.run_tasks(_tasks(2), payloads=_payloads(2))

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.3)
    assert "out" not in box, "dispatch proceeded under full backpressure"
    pressure.update({"hostA": 0.5, "hostB": 0.5})
    pool._pressure_cache = None
    t.join(timeout=30)
    assert all(r is not None for r in box["out"])
    kinds = [e["kind"] for e in metrics.events()]
    assert "backpressure" in kinds
    snap = metrics.snapshot()["counters"]
    assert snap["pool_backpressure_total"]["hostA"] >= 1


def test_backpressure_fails_closed_on_stats_error(monkeypatch):
    """A transient pressure-provider failure (an overloaded store head is
    exactly when stats() times out) must KEEP the previous pause state,
    never fail open and resume dispatch to an over-watermark host."""
    monkeypatch.setenv("RDT_SPECULATION", "0")
    pressure = {"hostA": 2.0}
    a = StubExecutor(name="a")
    b = StubExecutor(name="b")
    pool = ExecutorPool([a, b], hosts_by_name={"a": "hostA", "b": "hostB"})
    calls = {"n": 0}

    def provider():
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("stats timed out")
        return dict(pressure)

    pool.pressure_provider = provider
    assert pool.load()["backpressured_hosts"] == ["hostA"]  # tripped
    pool._pressure_cache = None  # force a re-evaluation: provider now fails
    out = pool.run_tasks(_tasks(4), payloads=_payloads(4))
    assert all(r is not None for r in out)
    assert len(a.submits) == 0, "stats failure fail-opened backpressure"
    assert pool.load()["backpressured_hosts"] == ["hostA"]
    assert calls["n"] >= 2


# ==== predictive sizing + parked-demand cooldown pierce ===========


def _park(pool, n, tenant="t"):
    with pool._lock:
        pool._parked_by_tenant[tenant] = \
            pool._parked_by_tenant.get(tenant, 0) + n
    pool._demand_delta(n)


def _unpark(pool, n, tenant="t"):
    with pool._lock:
        pool._parked_by_tenant[tenant] -= n
        if pool._parked_by_tenant[tenant] <= 0:
            del pool._parked_by_tenant[tenant]
    pool._demand_delta(-n)


def test_parked_demand_pierces_cooldown(monkeypatch):
    """The post-shrink cooldown must not delay a grow when admission has
    PARKED demand: parked actions cannot run until capacity exists, so the
    hysteresis that guards against recovery spikes does not apply. One
    prior tick of parked demand is required (no same-tick double-spawn)."""
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "30")   # window would block
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "60")   # cooldown would block
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    auto = _autoscaler(sess, min_size=1, max_size=4)
    auto._note("down", 1, "test")   # a fresh scale event arms the cooldown
    _park(pool, 2)
    auto._tick()                    # observes parked demand (arms window)
    assert sess.grown == 0, "same-tick parked demand grew immediately"
    auto._tick()                    # prior-tick parked demand: grow NOW
    assert sess.grown == 2, "cooldown suppressed parked-demand grow"
    assert auto.events[-1]["direction"] == "up"
    assert "parked=2" in auto.events[-1]["reason"]
    _unpark(pool, 2)


def test_parked_demand_sizes_grow_predictively(monkeypatch):
    """One grow decision targets one free slot per parked admission —
    capped at the max bound — instead of stepping +1 per cooldown."""
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0")
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    auto = _autoscaler(sess, min_size=1, max_size=3)
    _park(pool, 5)
    auto._tick()
    auto._tick()
    assert len(pool.executors) == 3, "parked grow did not reach the cap"
    # the cap held: 5 parked would have wanted 6 executors
    assert sess.grown == 2
    _unpark(pool, 5)


def test_aqe_measured_bytes_size_the_pool(monkeypatch):
    """Predictive sizing from the AQE plane: with RDT_POOL_BYTES_PER_EXEC
    set, a grow decision targets ceil(measured stage bytes / knob)
    executors (a fake ledger supplies the measurement)."""
    monkeypatch.setenv("RDT_POOL_SCALE_UP_S", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0")
    monkeypatch.setenv("RDT_POOL_BYTES_PER_EXEC", "100")
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    sess.engine.measured_stage_bytes = lambda: 450   # -> ceil(4.5) = 5
    auto = _autoscaler(sess, min_size=1, max_size=8)
    pool._demand_delta(1)   # any queued demand triggers the decision
    auto._tick()
    assert len(pool.executors) == 5, \
        f"AQE sizing off: {len(pool.executors)} executors"
    assert "target=5" in auto.events[-1]["reason"]
    pool._demand_delta(-1)
    # without the knob the same decision steps +1
    monkeypatch.setenv("RDT_POOL_BYTES_PER_EXEC", "0")
    monkeypatch.setenv("RDT_POOL_COOLDOWN_S", "0")
    auto._cooldown_until = 0.0
    pool._demand_delta(1)
    auto._tick()
    assert len(pool.executors) == 6
    pool._demand_delta(-1)


def test_autoscaler_feeds_store_budget_derivation():
    """Every tick forwards the stage ledger's measured bytes to the store
    budget plane (Engine.derive_store_budgets) when the engine exposes it;
    bare stubs without the method are tolerated."""
    pool = ExecutorPool([StubExecutor(name="e0")])
    sess = _FakeSession(pool)
    calls = []
    sess.engine.derive_store_budgets = lambda: calls.append(1)
    auto = _autoscaler(sess, min_size=1, max_size=2)
    auto._tick()
    auto._tick()
    assert len(calls) == 2, "budget feed not driven from the tick"
