"""Causal tracing/profiling subsystem.

The reference has **no** tracer or profiler hooks anywhere (SURVEY.md §5:
"Tracing / profiling: none" — its only timing code is an unreported wall-clock
helper in examples/pytorch_dlrm.ipynb). This module is deliberately beyond
parity, and since the observability PR the spans are **causal**, not just
per-process lanes:

- :func:`trace` — a span context manager usable in any session process
  (driver, ETL executor, serve replica, SPMD rank). Every span carries a
  ``trace_id`` and its parent span id through a ``contextvars`` context:
  a top-level driver span mints a fresh trace, ``runtime/rpc.py`` ships the
  active ``(trace_id, parent_span_id)`` in call metadata, and the server
  dispatcher re-installs it — so an executor task span is the *child* of
  the driver stage that submitted it. Thread handoffs that contextvars
  cannot follow (streaming-task threads, the serve dispatcher/worker/
  prefetcher chain) :func:`capture` the context explicitly and
  :func:`activate` it on the other side.
- :func:`collect_chrome_trace` — merges the driver's spans with every live
  actor's (``__rdt_spans__`` intrinsic) and node agent's into one Chrome
  ``chrome://tracing`` / Perfetto JSON: one "process" lane per role, named
  thread lanes (stable per-process thread ids), **flow events**
  (``ph:"s"/"f"``) drawn for every cross-process parent→child link, and
  per-process clock offsets measured against each peer (``__rdt_clock__``
  round-trip handshake) so the merged timeline is aligned to the driver's
  clock — see doc/observability.md for the method and its limits.
- :func:`torch_trace` — wraps ``torch.profiler`` so host and device
  activity (a Chrome trace) lands in the session directory next to the
  span trace.

Span/metric/event *names* are registered in ``raydp_tpu_torch/metrics.py`` and
statically checked by rdtlint's ``telemetry-registry`` rule; the registry
also feeds the generated tables in doc/observability.md.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import secrets
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from raydp_tpu_torch import faults, knobs, metrics

_lock = threading.Lock()
# bounded ring: long-lived actors trace every task (etl/executor.py), so an
# unbounded list would grow for the life of the process; oldest spans drop —
# loudly: the drop count rides the metrics registry and the trace metadata
MAX_SPANS = int(knobs.get("RDT_PROFILER_MAX_SPANS"))
_spans: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=MAX_SPANS)
_dropped = 0  # guarded-by: _lock
_enabled = True

#: the active (trace_id, parent_span_id) of this task of execution; None =
#: no trace yet (the next top-level span mints one)
_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("rdt_trace", default=None)

# ---- stable thread ids -------------------------------------------------------
# threading.get_ident() % 1e6 collided across recycled idents and told the
# viewer nothing; instead each thread gets a stable small id on first span
# and its NAME is recorded for Chrome thread_name metadata
_tid_lock = threading.Lock()
_tids: Dict[int, int] = {}        # guarded-by: _tid_lock (ident -> stable)
_tid_names: Dict[int, str] = {}   # guarded-by: _tid_lock (stable -> name)


def _stable_tid() -> int:
    ident = threading.get_ident()
    name = threading.current_thread().name
    with _tid_lock:
        tid = _tids.get(ident)
        if tid is not None and _tid_names.get(tid) != name:
            # the OS recycled a dead thread's ident for a DIFFERENT thread:
            # reusing the cached id would render this thread's spans in a
            # lane labeled with the dead thread's name
            tid = None
        if tid is None:
            tid = len(_tid_names) + 1
            _tids[ident] = tid
            _tid_names[tid] = name
        return tid


def thread_names() -> Dict[int, str]:
    """stable tid → thread name, for the Chrome thread_name metadata."""
    with _tid_lock:
        return dict(_tid_names)


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = value


# ---- trace context -----------------------------------------------------------

def _new_id() -> str:
    return secrets.token_hex(8)


def current_trace() -> Optional[Tuple[str, str]]:
    """The active ``(trace_id, span_id)`` pair, or None. This is what
    ``runtime/rpc.py`` injects into call metadata."""
    return _ctx.get()


#: explicit-handoff alias: worker threads, completion callbacks, and queue
#: consumers cannot inherit contextvars — they ``capture()`` on the
#: submitting side and ``activate()`` on theirs
capture = current_trace


@contextlib.contextmanager
def activate(ctx: Optional[Tuple[str, str]]):
    """Install a captured/remote trace context for the body (no-op on
    None, so legacy callers without metadata dispatch unchanged)."""
    if not ctx:
        yield
        return
    token = _ctx.set((str(ctx[0]), str(ctx[1])))
    try:
        yield
    finally:
        _ctx.reset(token)


def _append(span: Dict[str, Any]) -> None:
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
            dropped = True
        else:
            dropped = False
        _spans.append(span)
    if dropped:
        metrics.inc("profiler_spans_dropped_total")


def open_span(name: str, category: str = "app",
              parent: Optional[Tuple[str, str]] = None,
              **args) -> Dict[str, Any]:
    """Start a span WITHOUT entering a context (async lifetimes: a serving
    request whose completion happens on another thread). Pair with
    :func:`close_span`; the span's own context for child propagation is
    ``span_context(span)``. Does not touch the contextvar. Honors
    :func:`set_enabled` like :func:`trace`: when disabled it returns a
    no-op span that ``close_span`` discards and whose context is None."""
    if not _enabled:
        return {"_noop": True}
    ctx = parent if parent is not None else _ctx.get()
    sid = _new_id()
    if ctx is None:
        tr, par = _new_id(), None
    else:
        tr, par = ctx[0], ctx[1]
    span = {
        "name": name,
        "cat": category,
        "ts": time.time_ns() // 1000,  # chrome trace wants microseconds
        "ph": "X",
        "tid": _stable_tid(),
        "sid": sid,
        "tr": tr,
    }
    if par is not None:
        span["par"] = par
    if args:
        span["args"] = {k: str(v) for k, v in args.items()}
    return span


def span_context(span: Dict[str, Any]) -> Optional[Tuple[str, str]]:
    """The (trace_id, span_id) children of this span should activate
    (None for a disabled-profiler no-op span)."""
    if span.get("_noop"):
        return None
    return (span["tr"], span["sid"])


def close_span(span: Dict[str, Any], **args) -> None:
    """Finish an :func:`open_span` span and record it (idempotent: the
    second close of a race loses silently)."""
    if span.get("_closed") or span.get("_noop"):
        return
    span["_closed"] = True
    span["dur"] = max(0, time.time_ns() // 1000 - span["ts"])
    if args:
        span.setdefault("args", {}).update(
            {k: str(v) for k, v in args.items()})
    rec = {k: v for k, v in span.items() if k != "_closed"}
    _append(rec)


@contextlib.contextmanager
def trace(name: str, category: str = "app", **args):
    """Record a wall-clock span around the body (no-op when disabled).

    The span joins the active trace as a child (minting a fresh trace_id
    when there is none — every driver-initiated action's root span is such
    a mint) and becomes the parent of any span opened inside the body,
    including across RPC boundaries."""
    if not _enabled:
        yield
        return
    span = open_span(name, category, **args)
    token = _ctx.set(span_context(span))
    try:
        yield
    finally:
        _ctx.reset(token)
        close_span(span)


def spans() -> List[Dict[str, Any]]:
    with _lock:
        return list(_spans)


def spans_dropped() -> int:
    with _lock:
        return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def export_spans() -> Dict[str, Any]:
    """The ``__rdt_spans__`` intrinsic payload: spans + thread names + the
    drop count + this process's wall clock (offset alignment)."""
    return {"spans": spans(), "threads": thread_names(),
            "dropped": spans_dropped(), "clock_ns": time.time_ns(),
            "pid": os.getpid()}


# the flight recorder wants every fired fault as an event; faults.py is a
# stdlib-only bootstrap module, so IT exposes a hook and the first import of
# this module (any process running runtime code) arms it
faults.set_fire_hook(
    lambda site, key, action: (
        metrics.inc("faults_injected_total", label=site),
        metrics.record_event("fault_injected", site=site, key=key,
                             action=action)))


# ---- chrome trace merge ------------------------------------------------------

class TracePath(str):
    """The collect result: the output path, plus the collection health a
    caller should check before trusting the picture."""

    actors: int = 0
    skipped_actors: int = 0
    flow_events: int = 0
    spans_dropped: int = 0
    clock_offsets_us: Dict[str, int]


def _label_spans(span_list: List[Dict[str, Any]], role: str, pid: int,
                 threads: Optional[Dict] = None,
                 offset_us: int = 0) -> List[Dict[str, Any]]:
    out = []
    for s in span_list:
        s = dict(s)
        s["pid"] = pid
        if offset_us:
            s["ts"] = int(s["ts"]) - offset_us
        out.append(s)
    out.append({"name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": role}})
    for tid, tname in (threads or {}).items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": int(tid), "args": {"name": tname}})
    return out


def measure_clock_offset(call, samples: int = 3) -> int:
    """Offset (µs) of a peer's wall clock relative to ours, from ``samples``
    ``__rdt_clock__``-style round trips: the estimate with the smallest RTT
    wins (midpoint method — accurate to ~RTT/2, see doc/observability.md).
    ``call()`` must return the peer's ``time.time_ns()``."""
    best_rtt = None
    best_off = 0
    for _ in range(max(1, samples)):
        t0 = time.time_ns()
        remote = int(call())
        t1 = time.time_ns()
        rtt = t1 - t0
        if best_rtt is None or rtt < best_rtt:
            best_rtt = rtt
            best_off = remote - (t0 + t1) // 2
    return best_off // 1000


def _flow_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Chrome flow-event pairs (``ph:"s"`` at the parent, ``ph:"f"`` at the
    child) for every parent→child span link that crosses a process lane —
    the causal arrows the merged timeline exists for."""
    by_sid: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        sid = ev.get("sid")
        if sid:
            by_sid[sid] = ev
    flows: List[Dict[str, Any]] = []
    for ev in events:
        par = ev.get("par")
        if not par:
            continue
        parent = by_sid.get(par)
        if parent is None or parent.get("pid") == ev.get("pid"):
            continue
        flow_id = int(ev["sid"], 16)
        # the start ts is clamped into the parent span so viewers bind it;
        # the finish lands at the child span's start
        start_ts = min(max(int(ev["ts"]), int(parent["ts"])),
                       int(parent["ts"]) + int(parent.get("dur", 0)))
        common = {"name": "trace", "cat": "flow", "id": flow_id}
        flows.append(dict(common, ph="s", pid=parent["pid"],
                          tid=parent["tid"], ts=start_ts))
        flows.append(dict(common, ph="f", bp="e", pid=ev["pid"],
                          tid=ev["tid"], ts=int(ev["ts"])))
    return flows


def collect_chrome_trace(path: Optional[str] = None,
                         include_actors: bool = True) -> TracePath:
    """Write a merged Chrome-trace JSON; returns the output path (a
    :class:`TracePath` carrying collection health: actors reached/skipped,
    flow-event count, span drops).

    The driver's spans get pid 0; each live actor contributes its buffer as
    a separate pid lane (the ``__rdt_spans__`` intrinsic), node agents
    through their ``telemetry`` RPC. Per-peer clock offsets are measured at
    collect time (``__rdt_clock__`` round trips) and actor timestamps are
    shifted onto the driver's clock before the merge. Dead actors' spans
    are lost — collect before teardown; unreachable ones are COUNTED
    (``skipped_actors``), so a half-empty trace is distinguishable from a
    healthy one."""
    events = _label_spans(spans(), "driver", 0, thread_names())
    actors = skipped = 0
    offsets: Dict[str, int] = {}
    dropped = {"driver": spans_dropped()}

    from raydp_tpu_torch.runtime import head as head_mod

    session_dir = head_mod.session_root()
    if head_mod.runtime_initialized():
        rt = head_mod.get_runtime()
        session_dir = rt.session_dir
        if include_actors:
            from raydp_tpu_torch.runtime.actor import ActorHandle
            pid = 1
            for aid, rec in list(rt.records.items()):
                if rec.state != "ALIVE":
                    continue
                if not rec.ready.is_set():
                    # mid-restart: resolving would park on the 60 s
                    # ready-waiter grace — telemetry skips NOW, counted
                    skipped += 1
                    pid += 1
                    continue
                role = rec.spec.name or aid
                try:
                    handle = ActorHandle(aid, rec.spec.name,
                                         rt.server.address)
                    offset_us = measure_clock_offset(
                        lambda h=handle: h.call("__rdt_clock__",
                                                timeout=10.0))
                    payload = handle.call("__rdt_spans__", timeout=10.0)
                except Exception:  # noqa: BLE001 - dying actor: skip, COUNT
                    skipped += 1
                    pid += 1
                    continue
                if isinstance(payload, dict):  # current wire format
                    actor_spans = payload.get("spans", [])
                    threads = payload.get("threads", {})
                    dropped[role] = int(payload.get("dropped", 0))
                else:  # a peer running the pre-causal profiler
                    actor_spans, threads = payload, {}
                events.extend(_label_spans(actor_spans, role, pid, threads,
                                           offset_us))
                offsets[role] = offset_us
                actors += 1
                pid += 1
            for node_id, agent in list(getattr(rt, "node_agents",
                                               {}).items()):
                role = f"agent-{node_id}"
                try:
                    offset_us = measure_clock_offset(
                        lambda a=agent: a.call("clock_ns", timeout=10.0))
                    payload = agent.call("telemetry", timeout=10.0)
                except Exception:  # noqa: BLE001 - same skip contract
                    skipped += 1
                    pid += 1
                    continue
                events.extend(_label_spans(
                    payload.get("spans", []), role, pid,
                    payload.get("threads", {}), offset_us))
                offsets[role] = offset_us
                dropped[role] = int(payload.get("dropped", 0))
                actors += 1
                pid += 1
    if skipped:
        metrics.inc("telemetry_skipped_processes_total", skipped)

    flows = _flow_events(events)
    events.extend(flows)

    if path is None:
        os.makedirs(os.path.join(session_dir, "traces"), exist_ok=True)
        path = os.path.join(session_dir, "traces", "trace.json")
    else:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump({
            "traceEvents": events,
            "displayTimeUnit": "ms",
            # a truncated or half-collected trace must announce itself
            "otherData": {
                "skipped_actors": skipped,
                "spans_dropped": dropped,
                "clock_offsets_us": offsets,
                "flow_events": len(flows),
            },
        }, fh)
    out = TracePath(path)
    out.actors = actors
    out.skipped_actors = skipped
    out.flow_events = len(flows)
    out.spans_dropped = sum(dropped.values())
    out.clock_offsets_us = offsets
    return out


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str] = None, device=None):
    """Capture a ``torch.profiler`` trace around the body: CPU activity
    always, CUDA activity when ``device`` is a card (``None`` means the
    card, as every entry point of the port). The Chrome trace is written on
    exit to ``<log_dir>/torch-<pid>-<n>.json``; ``log_dir`` defaults to
    ``<session>/traces/torch``. Yields ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raydp_tpu_torch.device import resolve_device
    from raydp_tpu_torch.runtime import head as head_mod

    dev = resolve_device(device)
    if log_dir is None:
        base = (head_mod.get_runtime().session_dir
                if head_mod.runtime_initialized() else head_mod.session_root())
        log_dir = os.path.join(base, "traces", "torch")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    n = len([f for f in os.listdir(log_dir)
             if f.startswith(f"torch-{os.getpid()}-")])
    prof.export_chrome_trace(
        os.path.join(log_dir, f"torch-{os.getpid()}-{n}.json"))
