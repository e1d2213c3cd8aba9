"""Observability plane: causal cross-process tracing, the typed
metrics registry, and the failure flight recorder.

Units pin the registry contracts (typed increments, bounded rings that
announce truncation, snapshot merging, prometheus rendering) and the
context-propagation contract across every hard handoff: the RPC dispatcher,
DeferredReply completions on worker threads, executor streaming-task
threads, the serve dispatcher→worker→hedge chain, speculation (loser links
to the same parent, winner flagged), and a legacy caller without trace
metadata. Integration tests run a real 2-executor session: cross-process
flow events in the merged chrome trace, metrics_report() subsuming
op_counts(), skipped-actor accounting, and the blackbox bundle a
chaos-failed action writes.

The port's twin of ``tests/test_observability.py``: its cases, data, sizes
and assertions, run against ``raydp_tpu_torch``, whose copies of these
planes they guard against drift.
"""

import collections
import json
import os
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

import raydp_tpu_torch
from raydp_tpu_torch import metrics, profiler
from raydp_tpu_torch.etl.engine import ExecutorPool
from raydp_tpu_torch.runtime import rpc as rpc_mod
from raydp_tpu_torch.runtime.rpc import (
    ConnectionLost, DeferredReply, RpcClient, RpcServer,
)
from tests.torch_fixtures import session  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_telemetry():
    metrics.reset()
    profiler.clear()
    yield
    metrics.reset()
    profiler.clear()


# ---------------------------------------------------------------------------
# metrics registry units
# ---------------------------------------------------------------------------

def test_metrics_registry_is_typed():
    metrics.inc("serve_requests_total")
    metrics.inc("serve_requests_total", 2)
    metrics.set_gauge("serve_queue_depth", 7)
    metrics.observe("serve_request_seconds", 0.25)
    metrics.observe("serve_request_seconds", 0.75)
    metrics.inc("store_ops_total", label="seal")
    snap = metrics.snapshot()
    assert snap["counters"]["serve_requests_total"][""] == 3
    assert snap["counters"]["store_ops_total"]["seal"] == 1
    assert snap["gauges"]["serve_queue_depth"][""] == 7
    h = snap["hists"]["serve_request_seconds"][""]
    assert h["count"] == 2 and h["min"] == 0.25 and h["max"] == 0.75
    with pytest.raises(KeyError):
        # rdtlint: allow[telemetry-registry] deliberate unregistered-name probe
        metrics.inc("nope_total")
    with pytest.raises(ValueError):
        # rdtlint: allow[telemetry-registry] deliberate kind-mismatch probe
        metrics.inc("serve_request_seconds")  # histogram via counter API
    with pytest.raises(KeyError):
        # rdtlint: allow[telemetry-registry] deliberate unregistered-kind probe
        metrics.record_event("nope_event")


def test_event_ring_bounded_and_drop_counted(monkeypatch):
    monkeypatch.setenv("RDT_FLIGHT_MAX_EVENTS", "16")
    for i in range(20):
        metrics.record_event("hedge", dispatch=i)
    evs = metrics.events()
    assert len(evs) == 16
    assert evs[0]["dispatch"] == 4  # oldest four evicted
    snap = metrics.snapshot()
    assert snap["counters"]["flightrec_events_dropped_total"][""] == 4
    state = metrics.export_state()
    assert state["events_dropped"] == 4 and len(state["events"]) == 16


def test_merge_snapshots_sums_and_folds_hists():
    a = {"counters": {"serve_requests_total": {"": 2}},
         "gauges": {"serve_queue_depth": {"": 1}},
         "hists": {"serve_request_seconds":
                   {"": {"count": 2, "sum": 1.0, "min": 0.2, "max": 0.8}}}}
    b = {"counters": {"serve_requests_total": {"": 3},
                      "store_ops_total": {"seal": 1}},
         "gauges": {"serve_queue_depth": {"": 2}},
         "hists": {"serve_request_seconds":
                   {"": {"count": 1, "sum": 0.1, "min": 0.1, "max": 0.1}}}}
    m = metrics.merge_snapshots([a, b])
    assert m["counters"]["serve_requests_total"][""] == 5
    assert m["counters"]["store_ops_total"]["seal"] == 1
    assert m["gauges"]["serve_queue_depth"][""] == 3
    h = m["hists"]["serve_request_seconds"][""]
    assert h == {"count": 3, "sum": 1.1, "min": 0.1, "max": 0.8}


def test_prometheus_rendering():
    metrics.inc("store_ops_total", label="seal")
    metrics.observe("train_epoch_seconds", 1.5)
    text = metrics.render_prometheus(
        metrics.metrics_report(include_actors=False)["merged"])
    assert 'rdt_store_ops_total{op="seal"} 1' in text
    assert "# TYPE rdt_store_ops_total counter" in text
    assert "rdt_train_epoch_seconds_count 1" in text
    assert "rdt_train_epoch_seconds_max 1.5" in text


def test_dump_writes_json_and_prom(tmp_path):
    metrics.inc("serve_requests_total")
    paths = metrics.dump(str(tmp_path))
    report = json.loads(open(paths["json"]).read())
    assert report["merged"]["counters"]["serve_requests_total"][""] == 1
    assert "rdt_serve_requests_total 1" in open(paths["prom"]).read()


# ---------------------------------------------------------------------------
# profiler units: parentage, stable tids, drop accounting
# ---------------------------------------------------------------------------

def test_trace_nesting_records_parentage():
    with profiler.trace("etl:action", "driver", action="t"):
        outer = profiler.capture()
        with profiler.trace("stage:run", "etl"):
            inner = profiler.capture()
    assert profiler.capture() is None  # context fully unwound
    by_name = {s["name"]: s for s in profiler.spans()}
    act, stage = by_name["etl:action"], by_name["stage:run"]
    assert outer == (act["tr"], act["sid"])
    assert inner == (stage["tr"], stage["sid"])
    assert stage["tr"] == act["tr"] and stage["par"] == act["sid"]
    assert "par" not in act  # the root minted the trace


def test_sibling_top_level_spans_mint_distinct_traces():
    with profiler.trace("etl:action", "driver"):
        pass
    with profiler.trace("etl:action", "driver"):
        pass
    trs = [s["tr"] for s in profiler.spans()]
    assert len(set(trs)) == 2


def test_open_close_span_is_idempotent_and_contextual():
    with profiler.trace("etl:action", "driver"):
        span = profiler.open_span("serve:predict", "serve", rows=3)
    profiler.close_span(span)
    profiler.close_span(span)  # second close: no double record
    recs = [s for s in profiler.spans() if s["name"] == "serve:predict"]
    assert len(recs) == 1
    act = [s for s in profiler.spans() if s["name"] == "etl:action"][0]
    assert recs[0]["par"] == act["sid"]
    assert profiler.span_context(span) == (recs[0]["tr"], recs[0]["sid"])


def test_stable_tids_and_thread_names():
    names = {}

    def worker():
        with profiler.trace("stage:run", "etl"):
            pass

    t = threading.Thread(target=worker, name="rdt-test-worker")
    t.start()
    t.join()
    with profiler.trace("stage:run", "etl"):
        pass
    tids = {s["tid"] for s in profiler.spans()}
    assert len(tids) == 2 and all(isinstance(t, int) for t in tids)
    names = profiler.thread_names()
    assert "rdt-test-worker" in names.values()


def test_span_ring_drop_is_counted(monkeypatch):
    monkeypatch.setattr(profiler, "_spans",
                        collections.deque(maxlen=2))
    for _ in range(3):
        with profiler.trace("stage:run", "etl"):
            pass
    assert len(profiler.spans()) == 2
    assert profiler.spans_dropped() == 1
    snap = metrics.snapshot()
    assert snap["counters"]["profiler_spans_dropped_total"][""] == 1
    assert profiler.export_spans()["dropped"] == 1


def test_set_enabled_false_suppresses_open_spans_too():
    """Review fix: the async open/close pair honors the disable contract
    exactly like trace() — a disabled profiler records NOTHING from the
    serving plane."""
    profiler.set_enabled(False)
    try:
        span = profiler.open_span("serve:predict", "serve", rows=1)
        assert profiler.span_context(span) is None
        profiler.close_span(span)
        with profiler.trace("etl:action", "driver"):
            pass
        assert profiler.spans() == []
    finally:
        profiler.set_enabled(True)


def test_recycled_thread_ident_gets_fresh_lane():
    """Review fix: the OS recycling a dead thread's ident for a different
    thread must not render the new thread's spans under the dead thread's
    name."""
    ident = threading.get_ident()
    with profiler._tid_lock:
        old_tid = profiler._tids.get(ident)
        old_name = profiler._tid_names.get(old_tid) if old_tid else None
        profiler._tids[ident] = 999_999
        profiler._tid_names[999_999] = "rdt-dead-thread"
    try:
        tid = profiler._stable_tid()
        assert tid != 999_999
        assert profiler.thread_names()[tid] \
            == threading.current_thread().name
    finally:
        with profiler._tid_lock:
            profiler._tid_names.pop(999_999, None)
            if old_tid is not None:
                profiler._tids[ident] = old_tid
                profiler._tid_names[old_tid] = old_name


def test_clock_offset_midpoint():
    # a peer 5 ms ahead of us must measure ~+5000 µs
    off = profiler.measure_clock_offset(
        lambda: time.time_ns() + 5_000_000, samples=3)
    assert 4000 < off < 6000


# ---------------------------------------------------------------------------
# RPC propagation: dispatcher install, DeferredReply handoff, legacy caller
# ---------------------------------------------------------------------------

def _rpc_pair(handler):
    server = RpcServer(handler, name="obs-test")
    client = RpcClient(server.address)
    return server, client


def test_rpc_dispatch_installs_caller_context():
    seen = {}

    def handler(method, args, kwargs):
        if method == "ping":
            return "pong"
        seen["ctx"] = profiler.capture()
        with profiler.trace("stage:run", "etl"):
            pass
        return True

    server, client = _rpc_pair(handler)
    try:
        with profiler.trace("etl:action", "driver"):
            driver_ctx = profiler.capture()
            client.call("telemetry", timeout=10.0)
        assert seen["ctx"] == driver_ctx
        remote = [s for s in profiler.spans() if s["name"] == "stage:run"][0]
        assert remote["tr"] == driver_ctx[0]
        assert remote["par"] == driver_ctx[1]
    finally:
        client.close()
        server.stop()


def test_rpc_deferred_reply_worker_thread_keeps_context():
    """The streaming-task shape: the handler enqueues to a worker thread
    and returns a DeferredReply — the span the worker records must still
    parent to the caller's span."""

    def handler(method, args, kwargs):
        if method == "ping":
            return "pong"
        fut: Future = Future()
        ctx = profiler.capture()  # dispatcher thread: caller context live

        def work():
            with profiler.activate(ctx):
                with profiler.trace("task:", "executor"):
                    pass
                fut.set_result(profiler.capture())

        threading.Thread(target=work, daemon=True).start()
        return DeferredReply(fut)

    server, client = _rpc_pair(handler)
    try:
        with profiler.trace("stage:run", "etl"):
            driver_ctx = profiler.capture()
            worker_ctx = client.call("telemetry", timeout=10.0)
        assert worker_ctx == driver_ctx
        task = [s for s in profiler.spans() if s["name"] == "task:"][0]
        assert task["par"] == driver_ctx[1]
    finally:
        client.close()
        server.stop()


def test_legacy_caller_without_metadata_dispatches_cleanly():
    """A 4-tuple request (a peer running pre-causal code) must dispatch
    exactly as before, with no installed context."""
    seen = {}

    def handler(method, args, kwargs):
        seen["ctx"] = profiler.capture()
        return ("ok", args, kwargs)

    server = RpcServer(handler, name="obs-legacy")
    try:
        import socket

        import cloudpickle
        sock = socket.create_connection(server.address, timeout=10.0)
        lock = threading.Lock()
        rpc_mod._send_frame(
            sock, cloudpickle.dumps((7, "work", (1,), {"k": 2})), lock)
        req_id, ok, value = cloudpickle.loads(rpc_mod._recv_frame(sock))
        assert (req_id, ok) == (7, True)
        assert value == ("ok", (1,), {"k": 2})
        assert seen["ctx"] is None
        sock.close()
    finally:
        server.stop()


def test_rpc_without_active_trace_sends_no_metadata():
    """No active trace → the wire payload stays the legacy 4-tuple (byte
    compatibility with old peers is symmetric)."""
    captured = {}
    orig = rpc_mod.cloudpickle.dumps

    def spy(obj):
        if isinstance(obj, tuple) and len(obj) in (4, 5) \
                and isinstance(obj[0], int):
            captured.setdefault("lens", []).append(len(obj))
        return orig(obj)

    def handler(method, args, kwargs):
        return "pong"

    server = RpcServer(handler, name="obs-plain")
    client = RpcClient(server.address)
    try:
        rpc_mod.cloudpickle.dumps = spy
        client.call("ping", timeout=10.0)
        with profiler.trace("etl:action", "driver"):
            client.call("ping", timeout=10.0)
    finally:
        rpc_mod.cloudpickle.dumps = orig
        client.close()
        server.stop()
    assert 4 in captured["lens"] and 5 in captured["lens"]


# ---------------------------------------------------------------------------
# speculation: both attempts share the parent, the winner is flagged
# ---------------------------------------------------------------------------

class _CtxStub:
    """Executor-handle stand-in recording the trace context active at each
    submit (what the RPC client would ship) — the driver-side propagation
    contract for speculative pairs."""

    def __init__(self, name, latency=0.01):
        self.name = name
        self.latency = latency
        self.ctxs = []
        self._lock = threading.Lock()

    def submit(self, method, payload):
        with self._lock:
            self.ctxs.append(profiler.capture())
        fut: Future = Future()
        threading.Timer(self.latency, lambda: fut.set_result(
            {"num_rows": 1, "executor": self.name})).start()
        return fut

    def drop_blocks(self, keys, if_stamp=None):
        pass


def test_speculation_attempts_share_parent_and_winner_flagged(monkeypatch):
    monkeypatch.setenv("RDT_SPECULATION_MIN_S", "0.05")
    monkeypatch.setenv("RDT_SPECULATION_QUANTILE", "0.5")
    slow = _CtxStub("slow", latency=2.0)
    fast = _CtxStub("fast", latency=0.01)
    pool = ExecutorPool([slow, fast])
    tasks = [SimpleNamespace(task_id=f"t{i}") for i in range(4)]
    stats = {}
    with profiler.trace("stage:run", "etl"):
        stage_ctx = profiler.capture()
        out = pool.run_tasks(tasks, payloads=[b"p"] * 4, sched_stats=stats)
    assert stats["speculation_won"] >= 1
    # the winner result is flagged; the loser is the same task's other copy
    assert sum(int(r.get("_speculation_won", 0)) for r in out) \
        == stats["speculation_won"]
    # EVERY attempt — originals, backups (winners AND losers-to-be) — was
    # submitted under the same stage span: the loser's remote span would
    # link to the same parent as the winner's
    for ctx in slow.ctxs + fast.ctxs:
        assert ctx == stage_ctx
    snap = metrics.snapshot()
    assert snap["counters"]["sched_speculation_won_total"][""] \
        == stats["speculation_won"]
    assert sum(snap["counters"]["sched_tasks_dispatched_total"].values()) \
        == len(slow.ctxs) + len(fast.ctxs)


# ---------------------------------------------------------------------------
# serve dispatcher → worker → hedge propagation (fake replicas)
# ---------------------------------------------------------------------------

class _CtxReplica:
    """FakeReplicaHandle twin recording the context active at each
    serve_predict submit."""

    def __init__(self, name, delay_s=0.0):
        self.name = name
        self.delay_s = delay_s
        self.ctxs = []
        self._lock = threading.Lock()

    def call(self, method, *args, timeout=None, **kwargs):
        if method in ("serve_load", "serve_unload"):
            return {"replica": args[0]} if method == "serve_load" else True
        raise AssertionError(method)

    def submit(self, method, *args, **kwargs):
        fut: Future = Future()
        if method == "serve_load":
            fut.set_result({"replica": args[0]})
            return fut
        assert method == "serve_predict"
        with self._lock:
            self.ctxs.append(profiler.capture())
        _rid, payload = args

        def _serve():
            if self.delay_s:
                time.sleep(self.delay_s)
            table = pa.ipc.open_stream(pa.py_buffer(payload)).read_all()
            v = table.column("v").to_numpy(zero_copy_only=False)
            fut.set_result((v * 2.0).astype(np.float32))

        threading.Thread(target=_serve, daemon=True).start()
        return fut


def test_serve_dispatch_and_hedge_share_request_trace(monkeypatch):
    from raydp_tpu_torch.serve import ServingSession

    monkeypatch.setenv("RDT_SERVE_MAX_BATCH", "1000")
    monkeypatch.setenv("RDT_SERVE_BATCH_TIMEOUT_MS", "5.0")
    monkeypatch.setenv("RDT_SERVE_HEDGE", "1")
    monkeypatch.setenv("RDT_SERVE_HEDGE_QUANTILE", "0.5")
    monkeypatch.setenv("RDT_SERVE_HEDGE_MULTIPLIER", "1.5")
    monkeypatch.setenv("RDT_SERVE_HEDGE_MIN_MS", "40.0")
    monkeypatch.setenv("RDT_SERVE_REROUTE_GRACE_S", "10.0")
    slow = _CtxReplica("slow")
    fast = _CtxReplica("fast")
    srv = ServingSession("/nonexistent/bundle",
                         executors=[slow, fast], name="obs")
    def _span_index():
        spans = profiler.spans()
        return ({s["sid"] for s in spans if s["name"] == "serve:predict"},
                {s["sid"]: s for s in spans
                 if s["name"] in ("serve:batch", "serve:hedge")})

    try:
        # warm the hedge deadline window with fast round trips
        for _ in range(10):
            srv.predict({"v": np.asarray([1.0])}, timeout=10.0)
        # every dispatch submit ran under a serve:batch span whose parent
        # is some request's serve:predict span — the full causal chain
        predict_sids, dispatch_spans = _span_index()
        for ctx in slow.ctxs + fast.ctxs:
            assert ctx is not None
            sp = dispatch_spans[ctx[1]]
            assert sp["par"] in predict_sids and sp["tr"] == ctx[0]
        # now a slow attempt: the hedge fires and BOTH attempts (the loser
        # included) link to the SAME serve:predict parent; the hedge copy
        # is flagged by its serve:hedge span name
        slow.delay_s = 0.5
        fast.delay_s = 0.5
        ns, nf = len(slow.ctxs), len(fast.ctxs)
        srv.predict({"v": np.asarray([3.0])}, timeout=10.0)
        rep = srv.serving_report()
        assert rep["hedged"] >= 1
        new = slow.ctxs[ns:] + fast.ctxs[nf:]
        assert len(new) >= 2
        _, dispatch_spans = _span_index()
        pair = [dispatch_spans[c[1]] for c in new]
        assert len({s["par"] for s in pair}) == 1  # same request parent
        assert len({s["tr"] for s in pair}) == 1   # same trace
        assert {s["name"] for s in pair} == {"serve:batch", "serve:hedge"}
        snap = metrics.snapshot()
        assert snap["counters"]["serve_hedged_total"][""] >= 1
        assert snap["counters"]["serve_requests_total"][""] == 11
        assert snap["hists"]["serve_batch_occupancy_rows"][""]["count"] \
            == rep["batches"]
        # review fix: the gauge drains back to 0 once the session idles
        # (each dispatcher loop pass refreshes it) instead of freezing at
        # the last pre-dispatch depth. Poll: the hedge LOSER is legitimately
        # still in flight when predict() returns with the winner
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            srv.serving_report()  # round-trips (and ticks) the loop
            if metrics.snapshot()["gauges"]["serve_queue_depth"]["obs"] \
                    == 0:
                break
            time.sleep(0.05)
        assert metrics.snapshot()["gauges"]["serve_queue_depth"]["obs"] == 0
    finally:
        srv.close(unload=False)


# ---------------------------------------------------------------------------
# executor streaming-task thread handoff (unit: the capture/activate shape)
# ---------------------------------------------------------------------------

def test_streaming_task_thread_adopts_dispatcher_context():
    """EtlExecutor.run_task hands the dispatcher's context to the dedicated
    streaming-task thread; this pins the module-level contract the executor
    uses (capture before Thread, activate inside)."""
    from raydp_tpu_torch.etl import executor as ex_mod

    captured = {}

    class _Task:
        task_id = "t0"

    def fake_stream_sources_of(task):
        return ["stream"]

    class _FakeExec:
        _actor_name = "stub"

        def _run_task_obj(self, task):
            captured["ctx"] = profiler.capture()
            return {"num_rows": 0}

    import cloudpickle
    orig = ex_mod.T.stream_sources_of
    ex_mod.T.stream_sources_of = fake_stream_sources_of
    try:
        with profiler.trace("stage:run", "etl"):
            ctx = profiler.capture()
            reply = ex_mod.EtlExecutor.run_task(
                _FakeExec(), cloudpickle.dumps(_Task()))
        assert isinstance(reply, DeferredReply)
        assert reply.future.result(timeout=10.0) == {"num_rows": 0}
        assert captured["ctx"] == ctx
    finally:
        ex_mod.T.stream_sources_of = orig


# ---------------------------------------------------------------------------
# integration: real 2-executor session
# ---------------------------------------------------------------------------

def _groupagg(session, rows=2000):
    import pandas as pd
    df = session.createDataFrame(pd.DataFrame(
        {"k": np.arange(rows) % 7, "v": np.arange(float(rows))}))
    return df.groupBy("k").sum("v").collect()


def test_collect_chrome_trace_has_causal_flows(session, tmp_path):
    assert len(_groupagg(session)) == 7
    path = profiler.collect_chrome_trace(str(tmp_path / "trace.json"))
    assert path.skipped_actors == 0 and path.actors >= 2
    data = json.load(open(path))
    evs = data["traceEvents"]
    spans = [e for e in evs if e.get("ph") == "X"]
    # (i) >=1 cross-process flow event links a driver span to an executor
    # task span
    flows = [e for e in evs if e.get("cat") == "flow"]
    assert path.flow_events == len(flows) >= 2
    by_sid = {e["sid"]: e for e in spans if "sid" in e}
    finishes = [e for e in flows if e["ph"] == "f"]
    assert any(e["pid"] != 0 for e in finishes)
    starts = {e["id"] for e in flows if e["ph"] == "s"}
    assert all(e["id"] in starts for e in finishes)  # pairs, not orphans
    # executor task spans live in the driver action's trace
    actions = [s for s in spans if s["name"] == "etl:action"]
    task_spans = [s for s in spans
                  if str(s["name"]).startswith("task:") and s["pid"] != 0]
    assert actions and task_spans
    trs = {a["tr"] for a in actions}
    assert any(t["tr"] in trs for t in task_spans)
    # named thread lanes + collection health metadata
    assert any(e.get("name") == "thread_name" for e in evs)
    other = data["otherData"]
    assert other["skipped_actors"] == 0
    assert set(other["clock_offsets_us"]) >= {
        r["executor"] for r in []} | set(path.clock_offsets_us)
    assert "driver" in other["spans_dropped"]


def test_recovery_rerun_links_into_failed_actions_trace(monkeypatch,
                                                        tmp_path):
    """(ii) of the trace-smoke contract, in-process: after a seeded
    post-seal drop (armed via RDT_FAULTS so the EXECUTOR processes inherit
    it), the recovery span and the re-run's executor task spans carry the
    SAME trace id as the action that hit the loss."""
    import pandas as pd

    sentinel = str(tmp_path / "drop.sentinel")
    monkeypatch.setenv("RDT_FAULTS",
                       f"shuffle.write:drop:nth=1:once={sentinel}")
    s = raydp_tpu_torch.init("obs-rec", num_executors=2, executor_cores=1,
                       executor_memory="512MB")
    try:
        df = s.createDataFrame(pd.DataFrame(
            {"k": np.arange(1000) % 5, "v": np.arange(1000.0)}))
        out = df.groupBy("k").sum("v").collect()
        assert len(out) == 5
        rep = [e for e in s.engine.shuffle_stage_report()
               if e["regenerated"]]
        assert rep, "seeded drop did not trigger recovery"
        path = profiler.collect_chrome_trace(str(tmp_path / "rec.json"))
    finally:
        raydp_tpu_torch.stop()
    spans = [e for e in json.load(open(path))["traceEvents"]
             if e.get("ph") == "X"]
    recov = [s_ for s_ in spans if s_["name"] == "recover:lineage"]
    assert recov
    tr = recov[0]["tr"]
    actions = [s_ for s_ in spans if s_["name"] == "etl:action"
               and s_["tr"] == tr]
    assert actions, "recovery span lost its action's trace id"
    rerun_tasks = [s_ for s_ in spans if str(s_["name"]).startswith("task:")
                   and s_["pid"] != 0 and s_["tr"] == tr
                   and s_["ts"] >= recov[0]["ts"]]
    assert rerun_tasks, "no re-run executor task span in the action's trace"


def test_skipped_actor_is_counted_not_silent(session, tmp_path):
    from raydp_tpu_torch.runtime import head as head_mod
    from raydp_tpu_torch.runtime.actor import ALIVE, ActorSpec
    from raydp_tpu_torch.runtime.head import ActorRecord

    rt = head_mod.get_runtime()
    ghost = ActorRecord(
        spec=ActorSpec(actor_id="ghost", name="ghost-actor",
                       cls_bytes=b"", args_bytes=b""),
        state=ALIVE, address=("127.0.0.1", 1))  # nothing listens there
    rt.records["ghost"] = ghost
    try:
        path = profiler.collect_chrome_trace(str(tmp_path / "t.json"))
        assert path.skipped_actors >= 1
        assert json.load(open(path))["otherData"]["skipped_actors"] >= 1
        rep = metrics.metrics_report()
        assert rep["skipped_processes"] >= 1
        assert "ghost-actor" not in rep["processes"]
        merged = rep["merged"]["counters"]
        assert merged["telemetry_skipped_processes_total"][""] >= 2
    finally:
        rt.records.pop("ghost", None)


def test_metrics_report_subsumes_op_counts(session):
    from raydp_tpu_torch.runtime import head as head_mod

    _groupagg(session)
    rep = metrics.metrics_report()
    ops = rep["merged"]["counters"]["store_ops_total"]
    legacy = head_mod.get_runtime().store_server.op_counts()
    assert sum(ops.values()) == sum(legacy.values()) > 0
    for op, n in legacy.items():
        assert ops.get(op) == n
    # scheduler counters present and plausible
    dispatched = rep["merged"]["counters"]["sched_tasks_dispatched_total"]
    assert sum(dispatched.values()) > 0


def test_blackbox_bundle_on_chaos_failed_action(monkeypatch, tmp_path):
    """A chaos schedule that defeats recovery must leave a postmortem: the
    bundle carries the injected-fault events (executor processes), the
    object-loss events, and the driver's recovery rounds."""
    monkeypatch.setenv("RDT_FAULTS", "shuffle.write:drop:every=1")
    monkeypatch.setenv("RDT_LINEAGE_ROUNDS", "1")
    import pandas as pd

    from raydp_tpu_torch.etl.engine import StageError
    from raydp_tpu_torch.runtime import head as head_mod

    s = raydp_tpu_torch.init("obs-chaos", num_executors=2, executor_cores=1,
                       executor_memory="512MB")
    try:
        session_dir = head_mod.get_runtime().session_dir
        df = s.createDataFrame(pd.DataFrame(
            {"k": np.arange(500) % 5, "v": np.arange(500.0)}))
        with pytest.raises(StageError):
            df.groupBy("k").sum("v").collect()
        bb_dir = os.path.join(session_dir, "blackbox")
        bundles = [f for f in os.listdir(bb_dir)
                   if f.startswith("blackbox-") and f.endswith(".json")]
        assert bundles, "failed action wrote no blackbox bundle"
        bundle = json.load(open(os.path.join(bb_dir, sorted(bundles)[0])))
        assert bundle["exc_type"] in ("ObjectsLostError", "StageError")
        kinds = {ev["kind"] for st in bundle["processes"].values()
                 for ev in st.get("events", [])}
        assert "fault_injected" in kinds, kinds
        assert "object_lost" in kinds, kinds
        assert "recovery_round" in kinds, kinds
        assert "action_failed" in kinds, kinds
        assert bundle["skipped_processes"] == 0
    finally:
        raydp_tpu_torch.stop()
