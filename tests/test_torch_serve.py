"""The port's serving plane (``raydp_tpu_torch.serve``) against the
reference's (``raydp_tpu.serve``) on the CPU.

Three layers:

- **dispatcher scenarios** — each fake-handle scenario of
  ``tests/test_serve.py`` (coalescing, demux, routing, hedging, re-route,
  overload shedding, hot swap, weighted versions, rollout, autoscaler) is
  one parametrised case that drives the same scripted replicas through the
  port's ``ServingSession`` and the reference's, side by side, holds each
  to the reference test's checks, and compares the ``serving_report()``
  counters that the reference test asserts exactly. The fakes are gated by events
  where the reference's versions race a sleep against the dispatcher (a
  straggler, a full queue), so no assertion waits on a wall-clock race: a
  check either polls until its condition holds (within a generous bound)
  or is structural;
- **servables** — ``TorchEstimator.export_serving`` → ``load_servable`` is
  bitwise equal to ``predict`` over the same batches (NYCTaxi MLP and
  DLRM), and bitwise across batch compositions; with the
  reference's weights carried across, within 1e-5 of the reference's
  servable; a Flax bundle is refused by name;
- **integration** — one port ETL session of 2 executors (module-scoped):
  coalesced serving on executor-resident replicas on the CPU bitwise equal
  to ``predict``, ``serve_stats``/unload, the typed ``ReplicaNotLoaded``,
  ``drain_info``'s replica list, and a session without ``device`` failing
  at its start because no replica finds CUDA.
"""

import re
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.models import (
    DLRM, NYCTaxiModel, criteo_batch_preprocessor, dlrm_params_from_flax,
    mlp_variables_from_flax,
)
from raydp_tpu_torch.serve import load_servable
from raydp_tpu_torch.train import TorchEstimator

SIDES = ("port", "reference")


def _api(side):
    """One package's serving surface, as the scenarios use it."""
    if side == "reference":
        from raydp_tpu import metrics
        from raydp_tpu.runtime.rpc import ConnectionLost, RemoteError
        from raydp_tpu.serve import autoscale, rollout, session
    else:
        from raydp_tpu_torch import metrics
        from raydp_tpu_torch.runtime.rpc import ConnectionLost, RemoteError
        from raydp_tpu_torch.serve import autoscale, rollout, session
    return SimpleNamespace(
        side=side, metrics=metrics, ConnectionLost=ConnectionLost,
        RemoteError=RemoteError, ServingSession=session.ServingSession,
        ServingError=session.ServingError,
        ServingOverloaded=session.ServingOverloaded,
        as_table=session._as_table,
        RolloutController=rollout.RolloutController,
        ServingAutoscaler=autoscale.ServingAutoscaler)


# ---------------------------------------------------------------------------
# scripted replica handles
# ---------------------------------------------------------------------------

def _decode_payload(payload: bytes) -> pa.Table:
    return pa.ipc.open_stream(pa.py_buffer(payload)).read_all()


def _mult(export_dir: str) -> float:
    """A bundle ``.../vN`` answers ``(N + 1) * v``; any other dir ``2 * v``
    — every response names the servable version that computed it."""
    m = re.search(r"/v(\d+)$", export_dir)
    return float(int(m.group(1)) + 1) if m else 2.0


class FakeReplica:
    """A duck-typed executor handle hosting replicas in-process.

    ``serve_predict`` answers on a thread after ``delay`` seconds (a number
    or a callable). ``stuck_after=n`` blocks every call after the first
    ``n`` until ``gate`` is set (``stuck_rid`` limits that to replica ids
    containing it): a straggler that answers only when the test says so.
    ``fail`` scripts an infrastructure failure (``ConnectionLost``),
    ``app_fail`` a deterministic application error (a remote
    ``ValueError``), ``fail_rid`` the chaos plane's re-routable
    ``InjectedFault`` for replica ids containing it, ``dead`` a retired
    executor, ``refuse_unload`` that many refused ``serve_unload`` calls
    per replica id (an executor mid-restart), ``serial`` one request at a
    time (a real replica's worker loop)."""

    def __init__(self, api, name, delay=0.0, stuck_after=None,
                 stuck_rid="", fail=False, app_fail=False, fail_rid=None,
                 refuse_unload=0, serial=False):
        self.api = api
        self.name = name
        self.delay = delay
        self.stuck_after = stuck_after
        self.stuck_rid = stuck_rid
        self.gate = threading.Event()
        self.fail = fail
        self.app_fail = app_fail
        self.fail_rid = fail_rid
        self.refuse_unload = refuse_unload
        self.dead = False
        self.loads = 0
        self.calls = 0
        self.dirs = {}
        self.unloaded = []
        self.unload_attempts = {}
        self._serial = threading.Lock() if serial else None
        self._lock = threading.Lock()

    def _load(self, rid, export_dir):
        with self._lock:
            self.loads += 1
            self.dirs[rid] = export_dir
        return {"replica": rid}

    def call(self, method, *args, timeout=None, **kwargs):
        if self.dead:
            raise self.api.ConnectionLost(f"{self.name} was retired")
        if method == "serve_load":
            return self._load(args[0], args[1])
        if method == "serve_unload":
            rid = args[0]
            with self._lock:
                n = self.unload_attempts[rid] = \
                    self.unload_attempts.get(rid, 0) + 1
            if n <= self.refuse_unload:
                raise self.api.ConnectionLost(f"{self.name} restarting")
            with self._lock:
                self.dirs.pop(rid, None)
                self.unloaded.append(rid)
            return True
        raise AssertionError(f"unexpected call {method}")

    def submit(self, method, *args, **kwargs):
        if self.dead:
            raise self.api.ConnectionLost(f"{self.name} was retired")
        fut = Future()
        if method == "serve_load":
            fut.set_result(self._load(args[0], args[1]))
            return fut
        assert method == "serve_predict"
        rid, payload = args
        with self._lock:
            self.calls += 1
            stuck = (self.stuck_after is not None
                     and self.calls > self.stuck_after
                     and self.stuck_rid in rid)
            mult = _mult(self.dirs.get(rid, ""))
        threading.Thread(target=self._serve, daemon=True,
                         args=(rid, payload, fut, mult, stuck)).start()
        return fut

    def _serve(self, rid, payload, fut, mult, stuck):
        if stuck:
            self.gate.wait(60.0)
        if self.fail:
            time.sleep(0.01)
            fut.set_exception(self.api.ConnectionLost(
                f"{self.name} is scripted down"))
            return
        if self.app_fail:
            time.sleep(0.01)
            fut.set_exception(self.api.RemoteError("ValueError", "bad rows",
                                                   "<tb>"))
            return
        if self.fail_rid is not None and self.fail_rid in rid:
            time.sleep(0.005)
            fut.set_exception(self.api.RemoteError(
                "InjectedFault", "scripted canary fault", "<tb>"))
            return
        if self._serial is not None:
            self._serial.acquire()
        try:
            d = self.delay() if callable(self.delay) else self.delay
            if d:
                time.sleep(d)
            v = _decode_payload(payload).column("v").to_numpy(
                zero_copy_only=False)
            fut.set_result((v * mult).astype(np.float32))
        finally:
            if self._serial is not None:
                self._serial.release()


def _knobs(mp, **values):
    for k, v in values.items():
        mp.setenv(k, str(v))


def _serving(api, mp, replicas, *, max_batch=1000, timeout_ms=40.0,
             hedge=False, hedge_mult=2.0, hedge_min_ms=50.0, grace_s=10.0,
             inflight=2, name="t", export_dir="/nonexistent/bundle",
             session=None):
    _knobs(mp, RDT_SERVE_MAX_BATCH=max_batch,
           RDT_SERVE_BATCH_TIMEOUT_MS=timeout_ms,
           RDT_SERVE_HEDGE="1" if hedge else "0",
           RDT_SERVE_HEDGE_QUANTILE=0.5,
           RDT_SERVE_HEDGE_MULTIPLIER=hedge_mult,
           RDT_SERVE_HEDGE_MIN_MS=hedge_min_ms,
           RDT_SERVE_REROUTE_GRACE_S=grace_s,
           RDT_SERVE_MAX_INFLIGHT=inflight)
    return api.ServingSession(export_dir, session=session,
                              executors=replicas, name=name)


def _rows(*vals):
    return {"v": np.asarray(vals, np.float64)}


def _until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _one_mult(got, vals):
    """The single version multiplier a whole response came from."""
    mults = {round(float(g) / float(v), 6) for g, v in zip(got, vals) if v}
    assert len(mults) == 1, f"response mixed versions: {mults}"
    return mults.pop()


def _admitted(api, srv, rows):
    """predict_async, retried while the admission slot of the previous
    (completed) request is still being released."""
    while True:
        try:
            return srv.predict_async(rows)
        except api.ServingOverloaded:
            time.sleep(0.001)


def _exact(rep, *keys):
    return {k: rep[k] for k in keys}


def _release(*fakes):
    for f in fakes:
        f.gate.set()


# ---------------------------------------------------------------------------
# the scenarios (tests/test_serve.py's fake-handle cases)
# ---------------------------------------------------------------------------

def sc_as_table(api, mp):
    assert api.as_table(pa.table({"v": [1.0]})).num_rows == 1
    assert api.as_table(pd.DataFrame({"v": [1.0, 2.0]})).num_rows == 2
    assert api.as_table({"v": np.array([3.0])}).num_rows == 1
    with pytest.raises(TypeError):
        api.as_table([1, 2, 3])
    return {}


def sc_coalescing(api, mp):
    """A burst of single-row requests coalesces into full batches (a
    60 s budget: only the row cap flushes), every caller getting its own
    row back."""
    fakes = [FakeReplica(api, "a", delay=0.02),
             FakeReplica(api, "b", delay=0.02)]
    srv = _serving(api, mp, fakes, max_batch=16, timeout_ms=60_000.0)
    try:
        futs = [srv.predict_async(_rows(float(i))) for i in range(64)]
        for i, f in enumerate(futs):
            got = f.result(timeout=30.0)
            assert got.shape == (1,) and got[0] == np.float32(2.0 * i)
        rep = srv.serving_report()
        assert rep["batches"] < rep["requests"] == 64
        assert rep["mean_batch_occupancy"] > 1.0
        return _exact(rep, "requests", "batches", "rows", "failed",
                      "max_batch_occupancy", "mean_batch_occupancy")
    finally:
        srv.close()


def sc_timeout_flush(api, mp):
    srv = _serving(api, mp, [FakeReplica(api, "a")], max_batch=100000,
                   timeout_ms=30.0)
    try:
        assert srv.predict(_rows(21.0), timeout=30.0)[0] == np.float32(42.0)
        rep = srv.serving_report()
        assert rep["batches"] == 1 and rep["max_batch_occupancy"] == 1
        return _exact(rep, "requests", "batches", "rows",
                      "max_batch_occupancy")
    finally:
        srv.close()


def sc_full_batch(api, mp):
    """The row cap flushes at once: with a 60 s budget, 8 requests at a
    cap of 8 complete well inside their 30 s result timeout."""
    srv = _serving(api, mp, [FakeReplica(api, "a")], max_batch=8,
                   timeout_ms=60_000.0)
    try:
        futs = [srv.predict_async(_rows(float(i))) for i in range(8)]
        for i, f in enumerate(futs):
            assert f.result(timeout=30.0)[0] == np.float32(2.0 * i)
        return _exact(srv.serving_report(), "batches", "rows")
    finally:
        srv.close()


def sc_oversized(api, mp):
    srv = _serving(api, mp, [FakeReplica(api, "a")], max_batch=4,
                   timeout_ms=10.0)
    try:
        vals = np.arange(10, dtype=np.float64)
        out = srv.predict({"v": vals}, timeout=30.0)
        assert np.array_equal(out, (vals * 2).astype(np.float32))
        rep = srv.serving_report()
        assert rep["max_batch_occupancy"] == 10
        return _exact(rep, "batches", "max_batch_occupancy")
    finally:
        srv.close()


def sc_demux_threads(api, mp):
    fakes = [FakeReplica(api, "a", delay=0.01),
             FakeReplica(api, "b", delay=0.01)]
    srv = _serving(api, mp, fakes, timeout_ms=20.0)
    errors = []

    def client(base):
        try:
            vals = np.array([base, base + 0.25, base + 0.5])
            out = srv.predict({"v": vals}, timeout=30.0)
            assert np.array_equal(out, (vals * 2).astype(np.float32))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(float(i),))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        assert not errors
        return _exact(srv.serving_report(), "requests", "rows", "failed")
    finally:
        srv.close()


def sc_routing(api, mp):
    """Sequential requests alternate over two idle replicas (ties rotate)."""
    fakes = [FakeReplica(api, "a"), FakeReplica(api, "b")]
    srv = _serving(api, mp, fakes, max_batch=1, timeout_ms=0.0)
    try:
        for i in range(10):
            srv.predict(_rows(float(i)), timeout=30.0)
        per = {r["replica"]: r["batches"]
               for r in srv.serving_report()["replicas"]}
        assert all(n >= 1 for n in per.values()), per
        return per
    finally:
        srv.close()


def sc_hedging(api, mp):
    """A replica that sticks after warmup gets hedged: the sibling answers,
    and the straggler's late answer, once released, is discarded and
    counted."""
    a = FakeReplica(api, "a", stuck_after=8)
    b = FakeReplica(api, "b")
    srv = _serving(api, mp, [a, b], max_batch=1, timeout_ms=0.0,
                   hedge=True, hedge_mult=2.0, hedge_min_ms=50.0)
    try:
        for i in range(16):   # warmup: alternating, 8 fast calls each
            srv.predict(_rows(float(i)), timeout=30.0)
        assert a.calls == 8
        futs = [srv.predict_async(_rows(100.0 + i)) for i in range(4)]
        for i, f in enumerate(futs):
            # answered while a holds its calls: only a hedge can do it
            assert f.result(timeout=30.0)[0] == np.float32(2 * (100 + i))
        rep = srv.serving_report()
        assert a.calls > 8 and rep["hedged"] >= 1 and rep["hedge_won"] >= 1
        _release(a)
        assert _until(lambda: srv.serving_report()["hedge_lost"] >= 1)
        return _exact(rep, "requests", "failed")
    finally:
        _release(a)
        srv.close()


def sc_reroute_reload(api, mp):
    down = FakeReplica(api, "a", fail=True)
    up = FakeReplica(api, "b")
    srv = _serving(api, mp, [down, up], max_batch=1, timeout_ms=0.0)
    try:
        for i in range(6):
            assert srv.predict(_rows(float(i)),
                               timeout=30.0)[0] == np.float32(2.0 * i)
        rep = srv.serving_report()
        assert rep["rerouted"] >= 1
        # the initial load and at least one background reload attempt
        assert _until(lambda: down.loads >= 2)
        return _exact(rep, "requests", "failed")
    finally:
        srv.close()


def sc_app_error(api, mp):
    """A deterministic application error fails the request at once: it is
    never re-routed, whatever the grace."""
    srv = _serving(api, mp, [FakeReplica(api, "a", app_fail=True),
                             FakeReplica(api, "b", app_fail=True)],
                   max_batch=1, timeout_ms=0.0, grace_s=30.0)
    try:
        with pytest.raises(api.ServingError, match="ValueError"):
            srv.predict(_rows(1.0), timeout=30.0)
        return _exact(srv.serving_report(), "requests", "rerouted", "failed")
    finally:
        srv.close()


def sc_rebind_retired(api, mp):
    """A replica whose executor left the pool re-homes onto the least
    loaded live member and reloads there; requests keep flowing."""
    r0 = FakeReplica(api, "ex0")
    r1 = FakeReplica(api, "ex1")
    r2 = FakeReplica(api, "ex2")
    _knobs(mp, RDT_SERVE_MAX_BATCH=1000, RDT_SERVE_BATCH_TIMEOUT_MS=5,
           RDT_SERVE_HEDGE=0, RDT_SERVE_REROUTE_GRACE_S=20)
    srv = api.ServingSession("/nonexistent/bundle",
                             session=SimpleNamespace(executors=[r1, r2]),
                             executors=[r0, r1], name="t")
    try:
        r0.dead = True
        np.testing.assert_allclose(srv.predict(_rows(1.0, 2.0), timeout=30.0),
                                   [2.0, 4.0])

        def rehomed():
            row = next(r for r in srv.serving_report()["replicas"]
                       if r["replica"] == "t-r0")
            return row["ready"] and row["executor"] == "ex2"

        assert _until(rehomed)
        assert r2.loads >= 1
        np.testing.assert_allclose(srv.predict(_rows(3.0), timeout=30.0),
                                   [6.0])
        return _exact(srv.serving_report(), "failed")
    finally:
        srv.close()


def sc_mixed_schemas(api, mp):
    srv = _serving(api, mp, [FakeReplica(api, "a")], timeout_ms=40.0)
    try:
        f1 = srv.predict_async({"v": np.array([1.0]),
                                "extra": np.array([9.0])})
        f2 = srv.predict_async(_rows(2.0))
        assert f2.result(timeout=30.0)[0] == np.float32(4.0)
        assert f1.result(timeout=30.0)[0] == np.float32(2.0)
        assert srv.predict(_rows(3.0), timeout=30.0)[0] == np.float32(6.0)
        return _exact(srv.serving_report(), "requests", "failed")
    finally:
        srv.close()


def sc_all_down(api, mp):
    srv = _serving(api, mp, [FakeReplica(api, "a", fail=True),
                             FakeReplica(api, "b", fail=True)],
                   max_batch=1, timeout_ms=0.0, grace_s=0.5)
    try:
        with pytest.raises(api.ServingError):
            srv.predict(_rows(1.0), timeout=30.0)
        rep = srv.serving_report()
        assert rep["failed"] >= 1
        return _exact(rep, "requests")
    finally:
        srv.close()


def sc_report_columns(api, mp):
    srv = _serving(api, mp, [FakeReplica(api, "a")])
    try:
        srv.predict(_rows(1.0), timeout=30.0)
        rep = srv.serving_report()
        assert rep["p99_ms"] >= rep["p50_ms"] >= 0.0
        return {"report": sorted(rep), "replica": sorted(rep["replicas"][0]),
                "version": sorted(rep["versions"][0])}
    finally:
        srv.close()


def sc_closed_session(api, mp):
    srv = _serving(api, mp, [FakeReplica(api, "a")])
    assert srv.predict(_rows(), timeout=5.0).shape == (0,)
    srv.close()
    with pytest.raises(api.ServingError):
        srv.predict_async(_rows(1.0))
    return _exact(srv.serving_report(), "requests")


def sc_overload_shed(api, mp):
    """Past RDT_SERVE_MAX_QUEUE outstanding requests predict_async sheds
    with the typed ServingOverloaded; the accepted ones are served, and
    the drained session accepts again. The replica holds every request
    until the burst is over, so exactly the bound's worth is accepted."""
    mp.setenv("RDT_SERVE_MAX_QUEUE", "4")
    slow = FakeReplica(api, "a", stuck_after=0)
    srv = _serving(api, mp, [slow], max_batch=1, timeout_ms=0.0, inflight=1)
    try:
        futs, sheds = [], 0
        for i in range(12):
            try:
                futs.append((i, srv.predict_async(_rows(float(i)))))
            except api.ServingOverloaded as e:
                assert isinstance(e, api.ServingError)
                sheds += 1
        assert sheds == 8 and len(futs) == 4
        _release(slow)
        for i, f in futs:
            assert f.result(timeout=30.0)[0] == np.float32(2.0 * i)
        rep = srv.serving_report()
        assert rep["failed"] == rep["shed"] == sheds
        out = _exact(rep, "requests", "shed", "failed", "outstanding",
                     "max_queue")
        assert _admitted(api, srv, _rows(99.0)).result(
            timeout=30.0)[0] == np.float32(198.0)
        return out
    finally:
        _release(slow)
        srv.close()


def sc_shed_disabled(api, mp):
    mp.setenv("RDT_SERVE_MAX_QUEUE", "0")
    slow = FakeReplica(api, "a", stuck_after=0)
    srv = _serving(api, mp, [slow], max_batch=1, timeout_ms=0.0, inflight=1)
    try:
        futs = [srv.predict_async(_rows(float(i))) for i in range(32)]
        _release(slow)
        for i, f in enumerate(futs):
            assert f.result(timeout=30.0)[0] == np.float32(2.0 * i)
        return _exact(srv.serving_report(), "requests", "shed", "failed")
    finally:
        _release(slow)
        srv.close()


def _hedge_straggler(api, mp, max_queue):
    """The straggler of the shedding gate's two cases: replica a sticks
    after warmup, and one request lands on it. Returns ``(session, a, its
    future)``."""
    mp.setenv("RDT_SERVE_MAX_QUEUE", max_queue)
    a = FakeReplica(api, "a", stuck_after=8)
    srv = _serving(api, mp, [a, FakeReplica(api, "b")], max_batch=1,
                   timeout_ms=0.0, hedge=True, hedge_mult=2.0,
                   hedge_min_ms=50.0)
    try:
        for i in range(16):
            _admitted(api, srv, _rows(float(i))).result(timeout=30.0)
        while True:
            f = _admitted(api, srv, _rows(123.0))
            assert _until(lambda: f.done() or a.calls > 8)
            if a.calls > 8:
                return srv, a, f
            f.result(timeout=30.0)
    except BaseException:
        _release(a)
        srv.close()
        raise


def sc_hedge_with_room(api, mp):
    """With room in the queue the straggler's request is hedged."""
    srv, a, f = _hedge_straggler(api, mp, "100")
    try:
        assert f.result(timeout=30.0)[0] == np.float32(246.0)
        assert srv.serving_report()["hedged"] >= 1
        return {}
    finally:
        _release(a)
        srv.close()


def sc_hedge_saturated(api, mp):
    """A saturated session must not hedge: with RDT_SERVE_MAX_QUEUE=1 the
    straggler's lone outstanding request saturates the session, and no
    hedge fires in ten hedge deadlines."""
    srv, a, f = _hedge_straggler(api, mp, "1")
    try:
        time.sleep(0.5)
        assert not f.done()
        rep = srv.serving_report()
        _release(a)
        assert f.result(timeout=30.0)[0] == np.float32(246.0)
        return _exact(rep, "hedged")
    finally:
        _release(a)
        srv.close()


def sc_hot_swap(api, mp):
    _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=5, RDT_SERVE_HEDGE=0,
           RDT_SERVE_SWAP_DRAIN_S=5)
    reps = [FakeReplica(api, "a"), FakeReplica(api, "b")]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="hs")
    try:
        assert np.array_equal(srv.predict(_rows(1.0, 2.0)), [2.0, 4.0])
        before = srv.serving_report()["servable"]
        info = srv.hot_swap("/bundles/v2", tag="epoch-9")
        assert info["version"] == 2
        assert info["replicas"] == ["hs-v2-r0", "hs-v2-r1"]
        assert np.array_equal(srv.predict(_rows(1.0, 2.0)), [3.0, 6.0])
        rep = srv.serving_report()
        assert _until(lambda: all(h.unloaded for h in reps), 5.0)
        return {"before": before, "after": rep["servable"],
                "hot_swaps": rep["hot_swaps"],
                "unloaded": [u for h in reps for u in h.unloaded]}
    finally:
        srv.close()


def sc_hot_swap_burst(api, mp):
    """Requests in flight across two hot swaps: zero dropped, each answered
    by exactly one version, and every request made after the second swap
    returned by the newest."""
    _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=2, RDT_SERVE_HEDGE=0,
           RDT_SERVE_SWAP_DRAIN_S=3)
    reps = [FakeReplica(api, "a", delay=0.01),
            FakeReplica(api, "b", delay=0.01)]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="race")
    try:
        def burst(base):
            return [(float(base + i), srv.predict_async(
                _rows(float(base + i)))) for i in range(1, 11)]

        futs = burst(0)
        srv.hot_swap("/bundles/v2", tag="epoch-2")
        futs += burst(10)
        srv.hot_swap("/bundles/v3", tag="epoch-4")
        last = burst(20)
        for v, f in futs + last:
            got = f.result(timeout=30.0)
            assert got.shape == (1,) and got[0] / v in (2.0, 3.0, 4.0)
        assert all(f.result()[0] / v == 4.0 for v, f in last)
        rep = srv.serving_report()
        return {**_exact(rep, "hot_swaps", "failed", "shed"),
                "servable": rep["servable"]}
    finally:
        srv.close()


def sc_hot_swap_drain(api, mp):
    """The outgoing version's in-flight dispatch completes, and its
    replica unloads only after it has."""
    _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=2, RDT_SERVE_HEDGE=0,
           RDT_SERVE_SWAP_DRAIN_S=10)
    slow = FakeReplica(api, "slow", stuck_after=0, stuck_rid="drain-r0")
    srv = api.ServingSession("/bundles/v1", executors=[slow], name="drain")
    try:
        f = srv.predict_async(_rows(5.0))
        assert _until(lambda: slow.calls == 1)
        srv.hot_swap("/bundles/v2")
        assert not slow.unloaded           # v1 still busy: not retired
        _release(slow)
        assert np.array_equal(f.result(timeout=30.0), [10.0])
        assert _until(lambda: slow.unloaded == ["drain-r0"], 5.0)
        assert np.array_equal(srv.predict(_rows(5.0)), [15.0])
        return {"unloaded": list(slow.unloaded)}
    finally:
        _release(slow)
        srv.close()


def sc_weighted(api, mp):
    """Smooth WRR at weights 1.0 : 0.5 splits sequential dispatches 2:1."""
    mp.setenv("RDT_SERVE_HEDGE", "0")
    reps = [FakeReplica(api, "a"), FakeReplica(api, "b")]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="w")
    try:
        srv.load_version("/bundles/v2", weight=0.5, tag="canary")
        counts = {2.0: 0, 3.0: 0}
        for i in range(1, 31):
            got = srv.predict(_rows(float(i)), timeout=30.0)
            counts[_one_mult(got, [float(i)])] += 1
        rep = srv.serving_report()
        rows = {v["version"]: {k: v[k] for k in (
            "primary", "weight", "requests", "tag", "lat_n")}
            for v in rep["versions"]}
        assert counts == {2.0: 20, 3.0: 10}, counts
        assert rep["servable"]["version"] == 1
        return {"counts": counts, "versions": rows}
    finally:
        srv.close()


def sc_no_split(api, mp):
    """Each multi-row response is computed by one version, even at a 50/50
    split (each 3-row request fills a 3-row batch: one dispatch each)."""
    _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=10, RDT_SERVE_HEDGE=0,
           RDT_SERVE_MAX_BATCH=3)
    reps = [FakeReplica(api, "a", delay=0.005),
            FakeReplica(api, "b", delay=0.005)]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="nosplit")
    try:
        srv.load_version("/bundles/v2", weight=1.0)
        futs = []
        for i in range(1, 25):
            vals = [float(i), float(i) + 0.25, float(i) + 0.5]
            futs.append((vals, srv.predict_async({"v": np.array(vals)})))
        counts = {2.0: 0, 3.0: 0}
        for vals, f in futs:
            counts[_one_mult(f.result(timeout=30.0), vals)] += 1
        assert counts[2.0] and counts[3.0]
        return {"counts": counts,
                **_exact(srv.serving_report(), "failed", "batches")}
    finally:
        srv.close()


def sc_weight_zero(api, mp):
    mp.setenv("RDT_SERVE_HEDGE", "0")
    srv = api.ServingSession("/bundles/v1",
                             executors=[FakeReplica(api, "a")], name="wz")
    try:
        srv.load_version("/bundles/v2", weight=1.0)
        srv.set_weight(2, 0.0)
        for i in range(1, 9):
            got = srv.predict(_rows(float(i)), timeout=30.0)
            assert _one_mult(got, [float(i)]) == 2.0
        live = sorted(v["version"] for v in srv.serving_report()["versions"])
        with pytest.raises(api.ServingError):
            srv.set_weight(99, 0.5)
        return {"live": live}
    finally:
        srv.close()


def sc_hedge_local(api, mp):
    """Hedges are version-local: two single-replica versions have no
    sibling to race, so a straggler is never hedged across versions."""
    n = {"calls": 0}

    def delay():
        n["calls"] += 1
        return 0.0 if n["calls"] <= 10 else 0.2

    _knobs(mp, RDT_SERVE_MAX_BATCH=1, RDT_SERVE_BATCH_TIMEOUT_MS=0,
           RDT_SERVE_HEDGE=1, RDT_SERVE_HEDGE_QUANTILE=0.5,
           RDT_SERVE_HEDGE_MULTIPLIER=2.0, RDT_SERVE_HEDGE_MIN_MS=50)
    srv = api.ServingSession("/bundles/v1",
                             executors=[FakeReplica(api, "a", delay=delay)],
                             name="hl")
    try:
        srv.load_version("/bundles/v2", weight=1.0)
        for i in range(1, 11):
            srv.predict(_rows(float(i)), timeout=30.0)
        got = srv.predict(_rows(7.0), timeout=30.0)
        assert _one_mult(got, [7.0]) in (2.0, 3.0)
        return _exact(srv.serving_report(), "hedged")
    finally:
        srv.close()


def sc_hedged_canary(api, mp):
    """With all traffic on the canary and a straggling canary replica, the
    hedge races the canary's own sibling: the answer keeps the canary's
    multiplier."""
    a = FakeReplica(api, "a", stuck_after=12)
    b = FakeReplica(api, "b")
    _knobs(mp, RDT_SERVE_MAX_BATCH=1, RDT_SERVE_BATCH_TIMEOUT_MS=0,
           RDT_SERVE_HEDGE=1, RDT_SERVE_HEDGE_QUANTILE=0.5,
           RDT_SERVE_HEDGE_MULTIPLIER=2.0, RDT_SERVE_HEDGE_MIN_MS=50)
    srv = api.ServingSession("/bundles/v1", executors=[a, b], name="hc")
    try:
        srv.load_version("/bundles/v2", weight=1.0)
        srv.set_weight(1, 0.0)
        for _ in range(200):
            got = srv.predict(_rows(3.0), timeout=30.0)
            assert _one_mult(got, [3.0]) == 3.0
            if srv.serving_report()["hedged"] >= 1:
                break
        rep = srv.serving_report()
        assert rep["hedged"] >= 1, "straggler never hedged"
        return _exact(rep, "failed")
    finally:
        _release(a)
        srv.close()


def sc_promote(api, mp):
    _knobs(mp, RDT_SERVE_HEDGE=0, RDT_SERVE_SWAP_DRAIN_S=5)
    reps = [FakeReplica(api, "a"), FakeReplica(api, "b")]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="pr")
    try:
        srv.load_version("/bundles/v2", weight=0.25, tag="canary")
        info = srv.promote_version(2)
        rep = srv.serving_report()
        for i in range(1, 6):
            got = srv.predict(_rows(float(i)), timeout=30.0)
            assert _one_mult(got, [float(i)]) == 3.0
        assert _until(lambda: all(h.unloaded for h in reps), 5.0)
        return {"retired": info["retired"], "servable": rep["servable"],
                "hot_swaps": rep["hot_swaps"],
                "versions": [v["version"] for v in rep["versions"]],
                "unloaded": [u for h in reps for u in h.unloaded]}
    finally:
        srv.close()


def sc_drop(api, mp):
    _knobs(mp, RDT_SERVE_HEDGE=0, RDT_SERVE_SWAP_DRAIN_S=5)
    a = FakeReplica(api, "a")
    srv = api.ServingSession("/bundles/v1", executors=[a], name="dr")
    try:
        srv.load_version("/bundles/v2", weight=0.5)
        with pytest.raises(api.ServingError):
            srv.drop_version(1)
        srv.drop_version(2)
        for i in range(1, 7):
            got = srv.predict(_rows(float(i)), timeout=30.0)
            assert _one_mult(got, [float(i)]) == 2.0
        assert _until(lambda: a.unloaded, 5.0)
        return {"unloaded": list(a.unloaded),
                "versions": [v["version"]
                             for v in srv.serving_report()["versions"]]}
    finally:
        srv.close()


def _traffic(api, srv, stop, errors, period_s=0.004):
    """Open-loop background load; ServingError is the expected casualty of
    a scripted-to-fail canary, anything else is not."""
    i = 0
    while not stop.is_set():
        try:
            srv.predict_async(_rows(float(i % 50 + 1)))
        except api.ServingError:
            pass
        except Exception as e:  # noqa: BLE001 - surfaced by the scenario
            errors.append(repr(e))
        i += 1
        time.sleep(period_s)


def _with_traffic(api, srv, run):
    stop, errors = threading.Event(), []
    t = threading.Thread(target=_traffic, args=(api, srv, stop, errors))
    t.start()
    try:
        return run()
    finally:
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive() and not errors, errors


def sc_rollout_promotes(api, mp):
    """A healthy canary under traffic ramps and is promoted. The latency
    arm is set out of reach (its judgment is exercised in
    ``sc_rollout_judge``): two fake versions' p99s differ only by the
    scheduler's noise."""
    _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=2, RDT_SERVE_HEDGE=0,
           RDT_SERVE_SWAP_DRAIN_S=3)
    reps = [FakeReplica(api, "a"), FakeReplica(api, "b")]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="ro")
    try:
        out = _with_traffic(api, srv, lambda: srv.rollout(
            "/bundles/v2", tag="epoch-1", initial_weight=0.5, steps=[1.0],
            step_s=8.0, min_samples=8, p99_factor=1e6))
        assert out["outcome"] == "promoted", out
        assert any(s["verdict"] == "healthy" for s in out["steps"])
        rep = srv.serving_report()
        return {"outcome": out["outcome"], "version": out["version"],
                "servable": rep["servable"], "hot_swaps": rep["hot_swaps"]}
    finally:
        srv.close()


def sc_rollout_rollback(api, mp):
    """Every canary dispatch fails (a re-routable InjectedFault, exhausted
    within the version): the judgment sees the error rate and rolls back;
    the baseline serves on, untouched."""
    _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=2, RDT_SERVE_HEDGE=0,
           RDT_SERVE_SWAP_DRAIN_S=3, RDT_SERVE_REROUTE_GRACE_S=0.4)
    reps = [FakeReplica(api, "a", fail_rid="-v2-"),
            FakeReplica(api, "b", fail_rid="-v2-")]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="rb")
    try:
        out = _with_traffic(api, srv, lambda: srv.rollout(
            "/bundles/v2", initial_weight=0.5, steps=[1.0], step_s=8.0,
            min_samples=6, err_tol=0.05))
        assert out["outcome"] == "rolled_back", out
        assert "error rate" in out["reason"]
        rep = srv.serving_report()
        want = {"rb-v2-r0", "rb-v2-r1"}
        assert _until(lambda: want <= {u for h in reps for u in h.unloaded},
                      5.0)
        assert any(e["kind"] == "rollout_rollback"
                   for e in api.metrics.events())
        return {"outcome": out["outcome"], "servable": rep["servable"],
                "versions": [v["version"] for v in rep["versions"]],
                "hot_swaps": rep["hot_swaps"],
                "baseline_failed": rep["versions"][0]["failed"]}
    finally:
        srv.close()


def sc_rollout_idle(api, mp):
    """An idle session still deploys: a step whose window never fills
    advances."""
    _knobs(mp, RDT_SERVE_HEDGE=0, RDT_SERVE_SWAP_DRAIN_S=3)
    srv = api.ServingSession("/bundles/v1",
                             executors=[FakeReplica(api, "a")], name="idle")
    try:
        out = srv.rollout("/bundles/v2", initial_weight=0.25, steps=[1.0],
                          step_s=0.15, min_samples=1000)
        assert out["outcome"] == "promoted", out
        assert all(s["verdict"] == "insufficient" for s in out["steps"])
        return {"outcome": out["outcome"],
                "servable": srv.serving_report()["servable"]["version"]}
    finally:
        srv.close()


def sc_rollout_judge(api, mp):
    """The judgment itself: identical canary numbers are unhealthy under
    normal load and suspended while shedding; the latency arm alone
    judges once windows are full; below the sample floor, no verdict."""
    ctl = api.RolloutController.__new__(api.RolloutController)
    ctl.min_samples, ctl.err_tol, ctl.p99_factor = 4, 0.02, 2.0
    base0 = {"requests": 0, "failed": 0, "p99_ms": 5.0, "lat_n": 50}
    can0 = {"requests": 0, "failed": 0, "p99_ms": 50.0, "lat_n": 50}
    base1 = {"requests": 100, "failed": 0, "p99_ms": 5.0, "lat_n": 50}
    cases = {
        "errors": ({"requests": 2, "failed": 20, "p99_ms": 50.0,
                    "lat_n": 50}, False),
        "errors_shedding": ({"requests": 2, "failed": 20, "p99_ms": 50.0,
                             "lat_n": 50}, True),
        "latency": ({"requests": 100, "failed": 0, "p99_ms": 50.0,
                     "lat_n": 50}, False),
        "tiny": ({"requests": 2, "failed": 1, "p99_ms": 50.0, "lat_n": 2},
                 False),
    }
    out = {k: ctl._judge(base0, can0, base1, can1, shedding=shed)
           for k, (can1, shed) in cases.items()}
    assert [out[k]["verdict"] for k in cases] == \
        ["unhealthy", "suspended", "unhealthy", "insufficient"]
    assert "p99" in out["latency"]["reason"]
    return out


def sc_scale(api, mp):
    _knobs(mp, RDT_SERVE_HEDGE=0, RDT_SERVE_SWAP_DRAIN_S=2)
    reps = [FakeReplica(api, "a"), FakeReplica(api, "b")]
    srv = api.ServingSession("/bundles/v1", executors=reps, name="sc")
    try:
        srv.load_version("/bundles/v2", weight=0.5)
        grown = srv.scale_replicas(3)
        rep = srv.serving_report()
        assert all(v["replicas"] == 3 for v in rep["versions"]), rep
        rids = sorted(r["replica"] for r in rep["replicas"])
        for i in range(1, 13):
            got = srv.predict(_rows(float(i)), timeout=30.0)
            assert _one_mult(got, [float(i)]) in (2.0, 3.0)
        srv.scale_replicas(1)
        rep = srv.serving_report()
        assert all(v["replicas"] == 1 for v in rep["versions"]), rep
        assert _until(lambda: sum(len(h.unloaded) for h in reps) == 4, 5.0)
        assert srv.predict(_rows(2.0), timeout=30.0).shape == (1,)
        return {"grown": grown["replicas"], "rids": rids,
                "unloaded": sum(len(h.unloaded) for h in reps)}
    finally:
        srv.close()


def sc_autoscaler(api, mp):
    """Sustained queue pressure (the replica holds a 60-request burst)
    grows the replicas; once the burst is served, sustained idleness
    drains them back to the floor."""
    _knobs(mp, RDT_SERVE_MAX_BATCH=1, RDT_SERVE_BATCH_TIMEOUT_MS=0,
           RDT_SERVE_HEDGE=0, RDT_SERVE_MAX_INFLIGHT=1,
           RDT_SERVE_SCALE_INTERVAL_S=0.05, RDT_SERVE_SCALE_UP_S=0.1,
           RDT_SERVE_SCALE_IDLE_S=0.4, RDT_SERVE_SCALE_COOLDOWN_S=0.1,
           RDT_SERVE_SWAP_DRAIN_S=2)
    rep = FakeReplica(api, "a", stuck_after=0, serial=True)
    srv = api.ServingSession("/bundles/v1", executors=[rep], name="as")
    scaler = api.ServingAutoscaler(srv, min_replicas=1,
                                   max_replicas=3).start()
    try:
        futs = [srv.predict_async(_rows(float(i + 1))) for i in range(60)]
        assert _until(lambda: any(e["direction"] == "up"
                                  for e in scaler.events)), scaler.events
        _release(rep)
        for i, f in enumerate(futs):
            assert f.result(timeout=30.0)[0] == np.float32(2.0 * (i + 1))
        assert _until(lambda: srv.serving_report()["versions"][0]
                      ["replicas"] == 1), scaler.events
        assert any(e["direction"] == "down" for e in scaler.events)
        return {"floor": srv.serving_report()["versions"][0]["replicas"]}
    finally:
        _release(rep)
        scaler.stop()
        srv.close()


def sc_swap_overload(api, mp):
    """A swap while the session sheds: accepted requests complete from
    one version, sheds stay typed (failed == shed), and the outgoing
    version's replica unloads within the drain bound."""
    _knobs(mp, RDT_SERVE_MAX_QUEUE=6, RDT_SERVE_MAX_BATCH=1,
           RDT_SERVE_BATCH_TIMEOUT_MS=0, RDT_SERVE_HEDGE=0,
           RDT_SERVE_MAX_INFLIGHT=1, RDT_SERVE_SWAP_DRAIN_S=2)
    a = FakeReplica(api, "a", stuck_after=0, stuck_rid="swsh-r0")
    srv = api.ServingSession("/bundles/v1", executors=[a], name="swsh")
    try:
        accepted, sheds = [], 0
        for i in range(10):
            try:
                accepted.append((float(i + 1), srv.predict_async(
                    _rows(float(i + 1)))))
            except api.ServingOverloaded:
                sheds += 1
        assert sheds == 4
        srv.hot_swap("/bundles/v2", tag="mid-burst")
        _release(a)
        for v, f in accepted:
            assert _one_mult(f.result(timeout=30.0), [v]) in (2.0, 3.0)
        assert _until(lambda: "swsh-r0" in a.unloaded, 8.0)
        assert _until(lambda: srv.serving_report()["retiring_replicas"]
                      == 0, 8.0)
        rep = srv.serving_report()
        assert rep["failed"] == rep["shed"] >= 1
        return {**_exact(rep, "failed", "shed", "retiring_replicas"),
                "servable": rep["servable"]["version"]}
    finally:
        _release(a)
        srv.close()


def _unload_failed(api):
    return api.metrics.snapshot()["counters"].get(
        "serve_unload_failed_total", {}).get("", 0)


def sc_unload_retry(api, mp):
    """Retirement unloads retry through an executor's restart: two refusals,
    then the registry entry goes, and no leak is counted."""
    _knobs(mp, RDT_SERVE_HEDGE=0, RDT_SERVE_SWAP_DRAIN_S=1)
    rep = FakeReplica(api, "a", refuse_unload=2)
    srv = api.ServingSession("/bundles/v1", executors=[rep], name="ur")
    try:
        base = _unload_failed(api)
        srv.predict(_rows(1.0), timeout=30.0)
        srv.hot_swap("/bundles/v2")
        assert _until(lambda: "ur-r0" in rep.unloaded, 10.0)
        assert _unload_failed(api) == base
        return {"attempts": rep.unload_attempts["ur-r0"]}
    finally:
        srv.close()


def sc_unload_exhaust(api, mp):
    """A replica that refuses unload through the whole window is a loud
    leak: the counter and an unload_failed event."""
    _knobs(mp, RDT_SERVE_HEDGE=0, RDT_SERVE_SWAP_DRAIN_S=0.5,
           RDT_SERVE_REROUTE_GRACE_S=1)
    rep = FakeReplica(api, "a", refuse_unload=10_000)
    srv = api.ServingSession("/bundles/v1", executors=[rep], name="ulk")
    try:
        base = _unload_failed(api)
        srv.hot_swap("/bundles/v2")
        assert _until(lambda: _unload_failed(api) > base, 10.0)
        ev = [e for e in api.metrics.events() if e["kind"] == "unload_failed"]
        assert ev and ev[-1]["replica"] == "ulk-r0"
        return {"leaked": _unload_failed(api) - base}
    finally:
        srv.close()


SCENARIOS = {name[3:]: fn for name, fn in list(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dispatcher_scenario_matches_reference(scenario, monkeypatch):
    """The scenario's checks hold on the port's session and on the
    reference's, and the exact counters agree."""
    run = SCENARIOS[scenario]
    # the two sides run side by side: each scenario sets its knobs once,
    # to the same values, before its session reads them
    with ThreadPoolExecutor(len(SIDES)) as pool:
        futs = {side: pool.submit(run, _api(side), monkeypatch)
                for side in SIDES}
        got = {side: f.result(timeout=300.0) for side, f in futs.items()}
    assert got["port"] == got["reference"]


# ---------------------------------------------------------------------------
# servables
# ---------------------------------------------------------------------------

FEATURES = [f"f{i}" for i in range(5)]
DLRM_SIZES = [20, 20, 20]
DLRM_WIDTHS = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1))
DLRM_FEATURES = [f"_c{i}" for i in range(1, 17)]


def _nyc_tables(sizes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        x = rng.randn(n, 5).astype(np.float32)
        y = (x @ np.array([1.5, -2.0, 0.5, 3.0, -1.0], np.float32)
             ).astype(np.float32)
        out.append(pa.table({**{f: x[:, i] for i, f in enumerate(FEATURES)},
                             "y": y}))
    return out


def _criteo_tables(sizes, seed, with_label=True):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        cols = {}
        if with_label:
            cols["_c0"] = rng.randint(0, 2, n).astype(np.float32)
        dense = rng.lognormal(size=(n, 13))
        for i in range(13):
            cols[f"_c{i + 1}"] = dense[:, i]
        for j in range(3):
            cols[f"_c{14 + j}"] = rng.zipf(1.3, size=n) % 20
        out.append(pa.table(cols))
    return out


def _flax_nyc():
    from raydp_tpu.models import NYCTaxiModel as JaxNYC
    jm = JaxNYC()
    return jm, jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5)), train=False))


def _flax_dlrm():
    from raydp_tpu.models import DLRM as JaxDLRM
    jm = JaxDLRM(categorical_sizes=DLRM_SIZES, **DLRM_WIDTHS)
    return jm, jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"dense": jnp.zeros((1, 13)),
                                "sparse": jnp.zeros((1, 3), jnp.int32)}))


def _torch_estimator(kind, **kw):
    if kind == "nyctaxi":
        return TorchEstimator(model=NYCTaxiModel(5, device="cpu"),
                              loss="smooth_l1", feature_columns=FEATURES,
                              label_column="y", batch_size=64, num_epochs=1,
                              device="cpu", **kw)
    return TorchEstimator(
        model=DLRM(DLRM_SIZES, device="cpu", **DLRM_WIDTHS),
        loss="bce_with_logits", feature_columns=DLRM_FEATURES,
        label_column="_c0", feature_dtype=np.float64, batch_size=64,
        num_epochs=1, batch_preprocessor=criteo_batch_preprocessor(13),
        device="cpu", **kw)


def _train_and_rows(kind):
    """(train tables, label-less request rows) of one model."""
    if kind == "nyctaxi":
        return (_nyc_tables((300,), 0),
                _nyc_tables((203,), 1)[0].drop(["y"]))
    return _criteo_tables((200,), 5), _criteo_tables((203,), 6, False)[0]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each model fitted once on the CPU and exported: ``{kind: (estimator,
    export dir, label-less rows)}``."""
    out = {}
    for kind in ("nyctaxi", "dlrm"):
        train, rows = _train_and_rows(kind)
        est = _torch_estimator(kind)
        est.fit(TableDataset(train))
        path = str(tmp_path_factory.mktemp("servable") / kind)
        est.export_serving(path)
        out[kind] = (est, path, rows)
    return out


@pytest.mark.parametrize("kind", ["nyctaxi", "dlrm"])
def test_servable_equals_predict_over_the_same_batches(exported, kind):
    """export_serving → load_servable → predict_table is bitwise equal to
    predict on the same batches, the ragged tail included."""
    est, path, rows = exported[kind]
    sv = load_servable(path, device="cpu")
    assert sv.kind == "torch" and sv.nbytes > 0
    ref = est.predict(TableDataset([rows]), batch_size=64)
    got = np.concatenate([sv.predict_table(rows.slice(i, 64))
                          for i in range(0, rows.num_rows, 64)])
    assert got.dtype == np.float32 and got.shape == (rows.num_rows,)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["nyctaxi", "dlrm"])
def test_servable_rows_across_batch_composition(exported, kind):
    """Any split of the rows into batches gives each row the bits of one
    whole-table predict (the reference's contract, ``tests/test_serve.py``:
    coalesced serving is ``predict``): every forward runs at the bundle's
    ``infer_rows``, whatever the batch holds."""
    est, path, rows = exported[kind]
    sv = load_servable(path, device="cpu")
    whole = est.predict(TableDataset([rows]), batch_size=rows.num_rows)
    assert np.array_equal(sv.predict_table(rows), whole)
    for cuts in ([1, 2, 3, 5, 8, 13, 171], [64, 64, 64, 11], [2] * 101 + [1]):
        offs = np.cumsum([0] + cuts)
        got = np.concatenate([sv.predict_table(rows.slice(a, b - a))
                              for a, b in zip(offs[:-1], offs[1:])])
        assert np.array_equal(got, whole), cuts


@pytest.mark.parametrize("kind", ["nyctaxi", "dlrm"])
def test_one_row_has_the_same_bits_in_batches_of_1_13_and_203(exported,
                                                              kind):
    """Each of the first 13 rows served alone, among 13 and among 203 rows
    (more than the estimator's 64-row batch) gets the same bits, and so
    does predict over host batches of 1, 13 and 203: the GEMMs run at one
    row count."""
    est, path, rows = exported[kind]
    sv = load_servable(path, device="cpu")
    alone = np.concatenate([sv.predict_table(rows.slice(i, 1))
                            for i in range(13)])
    among = [sv.predict_table(rows.slice(0, 13)),
             sv.predict_table(rows)[:13]]
    for size in (1, 13, 203):
        among.append(est.predict(TableDataset([rows]),
                                 batch_size=size)[:13])
    for got in among:
        assert np.array_equal(got, alone), np.abs(got - alone).max()


@pytest.mark.parametrize("kind", ["nyctaxi", "dlrm"])
def test_servable_matches_the_reference_servable(tmp_path, kind):
    """The reference's Flax servable and the port's, with the same weights
    (the Flax init as ``FlaxEstimator`` draws it, carried across), agree
    within 1e-5 on the same numpy rows (f32). The reference's bundle is
    the recipe ``FlaxEstimator.export_serving`` writes; the port's comes
    from ``TorchEstimator.export_serving``."""
    from raydp_tpu.models import criteo_batch_preprocessor as jax_prep
    from raydp_tpu.serve import load_servable as ref_load_servable
    from raydp_tpu.serve.servable import export_bundle as ref_export
    from raydp_tpu.train.flax_estimator import _takes_train

    train, rows = _train_and_rows(kind)
    jm, variables = _flax_nyc() if kind == "nyctaxi" else _flax_dlrm()
    custom = kind == "dlrm"
    columns = {"features": (FEATURES if kind == "nyctaxi"
                            else DLRM_FEATURES,
                            np.float32 if kind == "nyctaxi"
                            else np.float64)}
    if custom:
        columns["label"] = ("_c0", np.float32)
    ref_export(str(tmp_path / "flax"), "flax", {
        "model": jm, "columns": columns, "custom": custom,
        "preprocessor": jax_prep(13) if custom else None,
        "compute_dtype": None, "takes_train": _takes_train(jm)}, variables)
    est = _torch_estimator(kind)
    est.fit(TableDataset(train))
    est.get_model().load_state_dict(
        mlp_variables_from_flax(variables) if kind == "nyctaxi"
        else dlrm_params_from_flax(variables["params"]))
    est.export_serving(str(tmp_path / "torch"))
    ref = ref_load_servable(str(tmp_path / "flax")).predict_table(rows)
    got = load_servable(str(tmp_path / "torch"),
                        device="cpu").predict_table(rows)
    assert got.shape == ref.shape == (rows.num_rows,)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    with pytest.raises(ValueError, match="'flax'"):
        load_servable(str(tmp_path / "flax"), device="cpu")


def test_export_requires_fit_and_load_requires_a_bundle(tmp_path):
    with pytest.raises(RuntimeError, match="fit"):
        _torch_estimator("nyctaxi").export_serving(str(tmp_path / "x"))
    with pytest.raises(FileNotFoundError, match="servable.json"):
        load_servable(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# integration: the port's executors host the replicas (on the CPU)
# ---------------------------------------------------------------------------

SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")


@pytest.fixture(scope="module")
def served(exported):
    """One port ETL session of 2 executors for the integration tests."""
    import raydp_tpu_torch

    s = raydp_tpu_torch.init("pytest-serve", **SESSION)
    try:
        yield s, exported
    finally:
        raydp_tpu_torch.stop()


@pytest.mark.parametrize("kind", ["nyctaxi", "dlrm"])
def test_coalesced_serving_equals_predict(served, kind):
    """Concurrent 4-row requests coalesce on real RPCs to executor-resident
    replicas; each request gets the bits a driver-side predict computes,
    whatever it was coalesced with. A request dispatched alone is that
    predict too, and two replicas given the same batch answer the same
    bits."""
    from raydp_tpu_torch.serve import ServingSession
    from raydp_tpu_torch.serve.session import _encode

    s, exported = served
    est, path, rows = exported[kind]
    ref = est.predict(TableDataset([rows]), batch_size=rows.num_rows)
    with pytest.MonkeyPatch.context() as mp:
        _knobs(mp, RDT_SERVE_BATCH_TIMEOUT_MS=20, RDT_SERVE_HEDGE=0)
        srv = ServingSession(path, session=s, name=f"it-{kind}",
                             device="cpu")
    try:
        futs = [srv.predict_async(rows.slice(i, 4))
                for i in range(0, rows.num_rows, 4)]
        got = np.concatenate([f.result(timeout=120.0) for f in futs])
        assert np.array_equal(got, ref)
        rep = srv.serving_report()
        assert rep["requests"] == len(futs) and rep["failed"] == 0
        assert rep["batches"] < rep["requests"]
        assert sum(r["batches"] for r in rep["replicas"]) == rep["batches"]
        # above RDT_SERVE_MAX_BATCH (64): dispatched alone, un-split
        assert np.array_equal(srv.predict(rows, timeout=120.0), ref)
        payload = _encode(rows)
        each = [h.call("serve_predict", f"it-{kind}-r{i}", payload)
                for i, h in enumerate(s.executors)]
        assert all(np.array_equal(e, ref) for e in each)
    finally:
        srv.close()


def test_serve_stats_unload_and_drain_info(served):
    from raydp_tpu_torch.serve import ServingSession

    s, exported = served
    _, path, rows = exported["nyctaxi"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RDT_SERVE_HEDGE", "0")
        srv = ServingSession(path, session=s, name="stats", device="cpu")
    try:
        srv.predict(rows.slice(0, 8), timeout=60.0)
        stats = s.executors[0].call("serve_stats")
        mine = [r for r in stats["replicas"]
                if r["replica"].startswith("stats-")]
        assert mine and mine[0]["model_nbytes"] > 0
        listed = sorted(r for h in s.executors
                        for r in h.call("drain_info")["replicas"])
        assert listed == ["stats-r0", "stats-r1"]
    finally:
        srv.close()
    assert not any(r["replica"].startswith("stats-")
                   for r in s.executors[0].call("serve_stats")["replicas"])
    assert all(h.call("drain_info")["replicas"] == [] for h in s.executors)


def test_replica_not_loaded_is_typed(served):
    from raydp_tpu_torch.runtime.rpc import RemoteError

    s, _ = served
    with pytest.raises(RemoteError) as ei:
        s.executors[0].call("serve_predict", "no-such-replica", b"")
    assert ei.value.exc_type == "ReplicaNotLoaded"


def test_session_without_device_fails_where_there_is_no_card(served):
    """The default device is CUDA: each replica's load raises in its
    executor, and the session fails at its start — no replica serves on
    the CPU instead."""
    from raydp_tpu_torch.runtime.rpc import RemoteError
    from raydp_tpu_torch.serve import ServingSession

    s, exported = served
    with pytest.raises(RemoteError, match="CUDA is not available") as ei:
        ServingSession(exported["nyctaxi"][1], session=s, name="nocard")
    assert ei.value.exc_type == "RuntimeError"
    assert all(h.call("drain_info")["replicas"] == [] for h in s.executors)
