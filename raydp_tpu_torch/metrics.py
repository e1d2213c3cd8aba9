"""Typed telemetry registries + the failure flight recorder.

The per-subsystem report dicts (``op_counts()``, ``shuffle_stage_report()``,
``serving_report()``, estimator epoch timers) grew by accretion, one PR at a
time, each with its own naming and its own collection path. This module is
the designed replacement — the ``knobs.py`` pattern applied to telemetry:

- **Metrics registry** — every counter/gauge/histogram is declared here
  (name, kind, unit, owning subsystem, one-line doc). Process-local
  increments are a dict update under one lock; per-process state is
  harvested over the existing actor RPC plane through the
  ``__rdt_metrics__`` intrinsic (beside ``__rdt_spans__``), and
  :func:`metrics_report` merges driver, executors, and node agents into one
  view that subsumes the legacy report dicts (which remain as compatible
  views over the same counters).
- **Span registry** — every literal ``profiler.trace(...)`` span name is
  declared here too; dynamic families (``task:<Step>``) are declared as
  prefixes. The ``telemetry-registry`` rdtlint rule statically checks
  literal span/metric/event names against these registries. (The port
  keeps the reference's registries as they are; the reference generates
  ``doc/observability.md`` from its own copy.)
- **Flight recorder** — a bounded per-process ring of structured events
  (faults fired, object losses, recovery rounds, re-seals, executor
  down/up, hedges, aborts). When an action surfaces a ``StageError`` /
  ``ServingError`` the driver harvests every process's ring into a
  ``blackbox-<action>.json`` postmortem bundle (:func:`write_blackbox`), so
  chaos runs leave artifacts instead of log archaeology.

This module must stay **stdlib-only at import** (the same contract as
``knobs.py``): it is loaded standalone by the linter and imported by
bootstrap-adjacent paths. Anything that needs the runtime (report merging,
blackbox harvest) imports it lazily inside the function.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

#: histograms are summary-shaped (count/sum/min/max), not bucketed: every
#: producer is a wall-clock or size observation whose tails the driver can
#: read off max, and bucket layouts would be one more thing to keep in sync
_HIST_ZERO = {"count": 0, "sum": 0.0, "min": None, "max": None}


@dataclass(frozen=True)
class Metric:
    """One declared metric."""

    name: str
    kind: str          # COUNTER | GAUGE | HISTOGRAM
    unit: str          # "1", "s", "rows", "bytes" — doc only
    subsystem: str     # "scheduler" | "store" | "serving" | ...
    doc: str
    #: the single optional label dimension ("" = unlabeled)
    label: str = ""


@dataclass(frozen=True)
class Span:
    """One declared trace-span name (or a dynamic family prefix)."""

    name: str
    subsystem: str
    doc: str
    #: True = ``name`` is a prefix of runtime-formatted span names
    #: (f-strings); the linter only checks literal names, these rows exist
    #: so the doc table is the complete span vocabulary
    dynamic: bool = False


@dataclass(frozen=True)
class Event:
    """One declared flight-recorder event kind."""

    kind: str
    subsystem: str
    doc: str


def _m(name, kind, unit, subsystem, doc, label=""):
    return Metric(name=name, kind=kind, unit=unit, subsystem=subsystem,
                  doc=doc, label=label)


#: declaration order is presentation order in the generated tables
_ALL_METRICS = [
    # ---- scheduler / engine -------------------------------------------------
    _m("sched_tasks_dispatched_total", COUNTER, "1", "scheduler",
       "Task attempts submitted to executors (retries and speculative "
       "backups included).", label="executor"),
    _m("sched_speculated_total", COUNTER, "1", "scheduler",
       "Tasks that received a speculative backup."),
    _m("sched_speculation_won_total", COUNTER, "1", "scheduler",
       "Tasks whose speculative backup finished first."),
    _m("sched_executor_down_total", COUNTER, "1", "scheduler",
       "Times an executor was marked unreachable by task placement.",
       label="executor"),
    _m("sched_executor_up_total", COUNTER, "1", "scheduler",
       "Times a down-marked executor answered again and re-entered task "
       "placement (the executor_down symmetry).", label="executor"),
    _m("pool_size", GAUGE, "1", "scheduler",
       "Live executors in the elastic pool (draining members excluded)."),
    _m("pool_drains_total", COUNTER, "1", "scheduler",
       "Graceful executor drains started (retire_executor / autoscale "
       "scale-down)."),
    _m("pool_scaled_up_total", COUNTER, "1", "scheduler",
       "Executors the autoscale controller added to the pool."),
    _m("pool_scaled_down_total", COUNTER, "1", "scheduler",
       "Executors the autoscale controller drained out of the pool."),
    _m("sched_tenant_dispatched_total", COUNTER, "1", "scheduler",
       "Task attempts dispatched per tenant (the fair-share observability "
       "column: under contention the per-tenant rates track the "
       "configured weights).", label="tenant"),
    _m("pool_admission_parked_total", COUNTER, "1", "scheduler",
       "Actions that parked at admission because the pool's queued "
       "backlog exceeded RDT_POOL_MAX_QUEUED.", label="tenant"),
    _m("pool_admission_rejects_total", COUNTER, "1", "scheduler",
       "Actions failed with AdmissionRejected after parking past "
       "RDT_ADMIT_TIMEOUT_S.", label="tenant"),
    _m("pool_backpressure_total", COUNTER, "1", "scheduler",
       "Times dispatch to a host paused on the store high-watermark "
       "(memory backpressure trip transitions, not per-task skips).",
       label="host"),
    _m("sched_locality_hits_total", COUNTER, "1", "scheduler",
       "Task attempts dispatched to their locality-preferred executor "
       "(data-gravity scheduling landed the task where its bytes are)."),
    _m("pool_warm_forks_total", COUNTER, "1", "scheduler",
       "Workers spawned by forking the pre-imported warm-start prototype "
       "instead of cold-spawning a fresh interpreter."),
    _m("pool_warm_refreshes_total", COUNTER, "1", "scheduler",
       "Supervised warm-fork prototype restarts: a latched-failed plane "
       "re-warmed a fresh prototype (bounded by RDT_WARM_FORK_RETRIES) and "
       "returned to fork-fast scale-up."),
    _m("recovery_rounds_total", COUNTER, "1", "recovery",
       "Lineage-recovery rounds that re-executed producers."),
    _m("recovery_blobs_regenerated_total", COUNTER, "1", "recovery",
       "Lost store blobs rebuilt through lineage recovery."),
    _m("stage_aborts_total", COUNTER, "1", "scheduler",
       "Failing stages that ran the abort contract (drain + free)."),
    _m("stream_reseals_total", COUNTER, "1", "shuffle",
       "Pipelined-shuffle seals superseded by a regenerated producer "
       "(generation > 1)."),
    # ---- object store -------------------------------------------------------
    _m("store_ops_total", COUNTER, "1", "store",
       "Store control-plane table operations (a batch call counts one), "
       "per method — the registry view of ObjectStoreServer.op_counts().",
       label="op"),
    _m("store_objects_lost_total", COUNTER, "1", "store",
       "ObjectLostError raised: a blob was gone or unreachable at read."),
    _m("store_fault_in_total", COUNTER, "1", "store",
       "Spilled payloads faulted back into shared memory on read (the "
       "disk-read side of the spill plane)."),
    # ---- tracing / telemetry plane ------------------------------------------
    _m("profiler_spans_dropped_total", COUNTER, "1", "profiler",
       "Trace spans silently evicted from the bounded per-process ring "
       "(RDT_PROFILER_MAX_SPANS) — nonzero means the timeline is "
       "truncated."),
    _m("telemetry_skipped_processes_total", COUNTER, "1", "profiler",
       "Live processes a trace/metrics/blackbox harvest could not reach — "
       "nonzero means the merged view is missing lanes."),
    _m("flightrec_events_dropped_total", COUNTER, "1", "profiler",
       "Flight-recorder events evicted from the bounded ring "
       "(RDT_FLIGHT_MAX_EVENTS)."),
    # ---- fault plane --------------------------------------------------------
    _m("faults_injected_total", COUNTER, "1", "faults",
       "Fault-injection rules fired in this process, per site.",
       label="site"),
    # ---- serving plane ------------------------------------------------------
    _m("serve_requests_total", COUNTER, "1", "serving",
       "predict()/predict_async() requests accepted by the dispatcher."),
    _m("serve_batches_total", COUNTER, "1", "serving",
       "Coalesced micro-batches dispatched to replicas."),
    _m("serve_rows_total", COUNTER, "rows", "serving",
       "Rows dispatched across all micro-batches."),
    _m("serve_hedged_total", COUNTER, "1", "serving",
       "Dispatches duplicated onto a second replica past the hedge "
       "deadline."),
    _m("serve_hedge_won_total", COUNTER, "1", "serving",
       "Hedged dispatches whose second copy responded first."),
    _m("serve_hedge_lost_total", COUNTER, "1", "serving",
       "Duplicate responses discarded after the sibling copy won."),
    _m("serve_rerouted_total", COUNTER, "1", "serving",
       "Dispatches re-routed off a failed/unreachable replica."),
    _m("serve_failed_total", COUNTER, "1", "serving",
       "Requests failed after every replica refused within the re-route "
       "grace (ServingError)."),
    _m("serve_shed_total", COUNTER, "1", "serving",
       "Requests refused at admission with the typed retriable "
       "ServingOverloaded (outstanding queue at RDT_SERVE_MAX_QUEUE)."),
    _m("serve_queue_depth", GAUGE, "1", "serving",
       "Pending + in-flight dispatcher work per serving session, refreshed "
       "on every dispatcher loop pass (an idle session reads 0).",
       label="session"),
    _m("serve_batch_occupancy_rows", HISTOGRAM, "rows", "serving",
       "Rows per dispatched micro-batch (coalescing effectiveness)."),
    _m("serve_request_seconds", HISTOGRAM, "s", "serving",
       "Per-request latency from enqueue to demuxed completion."),
    _m("serve_hot_swaps_total", COUNTER, "1", "serving",
       "Servable hot-swaps completed by a serving session (new version "
       "loaded beside the old, traffic shifted, old retired; guarded-"
       "rollout promotions count here too)."),
    _m("serve_version_requests_total", COUNTER, "1", "serving",
       "Requests answered per live servable version (label "
       "'<session>:v<N>') — the rollout judgment's traffic counter.",
       label="version"),
    _m("serve_version_failed_total", COUNTER, "1", "serving",
       "Requests failed per servable version (the rollout judgment's "
       "error-rate numerator).", label="version"),
    _m("serve_version_request_seconds", HISTOGRAM, "s", "serving",
       "Per-request latency per servable version — the per-version p99 "
       "window a guarded rollout judges the canary on.", label="version"),
    _m("serve_version_weight", GAUGE, "1", "serving",
       "Current dispatch-traffic weight of each live servable version "
       "(0 after a drop/rollback).", label="version"),
    _m("serve_version_replicas", GAUGE, "1", "serving",
       "Replica count of each live servable version (the serving "
       "autoscaler's actuator target).", label="version"),
    _m("serve_unload_failed_total", COUNTER, "1", "serving",
       "Retired replicas that still refused serve_unload at the retry "
       "deadline — their servable's weights stay pinned in that "
       "executor's RAM (loud leak counter; see the unload_failed "
       "event)."),
    _m("serve_rollouts_total", COUNTER, "1", "serving",
       "Guarded rollouts started (RolloutController.run)."),
    _m("serve_rollouts_rolled_back_total", COUNTER, "1", "serving",
       "Guarded rollouts auto-rolled-back on an unhealthy verdict (or "
       "timeout); the complement promoted."),
    _m("serve_scaled_up_total", COUNTER, "1", "serving",
       "Serving-autoscaler replica additions (every live version grows "
       "together)."),
    _m("serve_scaled_down_total", COUNTER, "1", "serving",
       "Serving-autoscaler replica drains after sustained idleness."),
    # ---- continuous pipelines -----------------------------------------------
    _m("stream_epochs_total", COUNTER, "1", "stream",
       "Micro-batch epochs a continuous pipeline completed (transform ran, "
       "result sealed + published to the epoch ledger)."),
    _m("stream_rows_total", COUNTER, "rows", "stream",
       "Input rows ingested across all continuous-pipeline epochs."),
    _m("stream_epoch_seconds", HISTOGRAM, "s", "stream",
       "Wall-clock of one micro-batch epoch (source rows in hand to sealed "
       "+ published result)."),
    _m("stream_windows_total", COUNTER, "1", "stream",
       "Windowed aggregations closed (tumbling/sliding merges over epoch "
       "partials)."),
    _m("stream_replays_total", COUNTER, "1", "stream",
       "Lost epoch blobs re-derived from the source journal "
       "(exactly-once replay rounds; each replayed epoch counts once)."),
    # ---- data feed / training -----------------------------------------------
    _m("feed_phase_seconds", HISTOGRAM, "s", "feed",
       "Feed-pipeline phase walls (decode / stage / h2d), one observation "
       "per timed section — the registry twin of PipelineTimings.",
       label="phase"),
    _m("train_epoch_seconds", HISTOGRAM, "s", "training",
       "Wall-clock of one training epoch (both estimators)."),
    _m("train_param_bytes_per_process", GAUGE, "bytes", "training",
       "Params + optimizer state resident on this process's devices after "
       "sharded placement (replicated leaves count one copy per device) — "
       "the fsdp-vs-replicated HBM headroom measure."),
    _m("train_padded_rows_total", COUNTER, "rows", "training",
       "Zero rows appended by pad-and-mask feeds to square a ragged final "
       "batch; each padded row is masked out of losses and metrics."),
    _m("train_accum_steps", GAUGE, "1", "training",
       "Gradient-accumulation microbatches per optimizer step this fit is "
       "running with (1 = unaccumulated; the RDT_TRAIN_ACCUM_STEPS / "
       "accum_steps= setting after validation)."),
    _m("train_activation_bytes_per_process", GAUGE, "bytes", "training",
       "Compiled peak temporary (activation) bytes of the train step on "
       "this process's devices, read off XLA's memory_analysis — the "
       "activation-residency measure accumulation/remat/seq-sharding "
       "drive down."),
    _m("train_pipeline_stages", GAUGE, "1", "training",
       "Pipeline stages the current fit's GPipe schedule runs over (the "
       "mesh's stage extent; set only when training a PipelineModel — the "
       "accum microbatches double as its pipeline microbatches)."),
]

METRICS: Dict[str, Metric] = {m.name: m for m in _ALL_METRICS}
assert len(METRICS) == len(_ALL_METRICS), "duplicate metric declaration"


def _s(name, subsystem, doc, dynamic=False):
    return Span(name=name, subsystem=subsystem, doc=doc, dynamic=dynamic)


_ALL_SPANS = [
    # ---- driver -------------------------------------------------------------
    _s("etl:action", "engine",
       "Root span of one engine action (collect/count/cache/materialize/"
       "random-shuffle; the action label rides in args). Mints the "
       "trace_id every downstream span of the action inherits."),
    _s("stage:run", "engine",
       "One stage dispatch: covers submits, retries, speculation, and "
       "lineage-recovery rounds — executor task spans parent here."),
    _s("shuffle:", "engine",
       "Per-stage shuffle totals, one span per wide-op stage "
       "(shuffle:<label>).", dynamic=True),
    _s("aqe:replan", "engine",
       "An adaptive-execution rule re-planned a stage."),
    _s("recover:lineage", "engine",
       "One lineage-recovery rerun of lost producers; links back into the "
       "failing action's trace."),
    _s("speculate:submit", "engine",
       "A speculative backup was submitted for a straggling attempt."),
    _s("speculate:win", "engine",
       "A speculative backup finished before the original attempt."),
    # ---- executor -----------------------------------------------------------
    _s("task:", "executor",
       "One executor task body (task:<SourceType>); child of the driver's "
       "stage:run span across the process boundary.", dynamic=True),
    _s("shuffle:map-partial", "executor",
       "Map-side partial aggregation inside a shuffle map task."),
    _s("shuffle:bucket", "executor",
       "Bucketing a map task's output table."),
    _s("shuffle:write", "executor",
       "Sealing a map task's bucket blobs into the store."),
    _s("shuffle:fetch", "executor",
       "A reduce-side ranged fetch/decode of shuffle input."),
    # ---- serving ------------------------------------------------------------
    _s("serve:predict", "serving",
       "One serving request, enqueue to demuxed completion (driver side); "
       "the batch/hedge/apply spans of its dispatch parent here."),
    _s("serve:batch", "serving",
       "One coalesced micro-batch dispatch to a replica."),
    _s("serve:hedge", "serving",
       "The duplicate dispatch of a hedged micro-batch."),
    _s("serve:apply", "serving",
       "The replica-side jitted apply of one micro-batch."),
    # ---- continuous pipelines -----------------------------------------------
    _s("stream:epoch", "stream",
       "One micro-batch epoch of a continuous pipeline: ingest, transform "
       "action, seal + ledger publish, window partials."),
    _s("stream:window", "stream",
       "One windowed-aggregation merge over the epoch partials of a "
       "closing window (including any replay rounds)."),
    # ---- training -----------------------------------------------------------
    _s("train:place", "training",
       "Sharded placement of the train state onto the mesh (host → device "
       "under each leaf's PartitionSpec; covers the initial FSDP/TP scatter "
       "or replication)."),
    _s("train:accum", "training",
       "Compilation + activation-residency analysis of the accumulated "
       "train step (the lax.scan over microbatches; covers the "
       "memory_analysis read behind train_activation_bytes_per_process)."),
    _s("train:pipeline", "training",
       "Compilation + activation-residency analysis of the pipelined "
       "(stage-stacked shard_map GPipe) train step — the train:accum twin "
       "for stage>1 fits."),
]

SPANS: Dict[str, Span] = {s.name: s for s in _ALL_SPANS}
assert len(SPANS) == len(_ALL_SPANS), "duplicate span declaration"

#: exact names literal ``profiler.trace(...)`` calls may use (the linter's
#: check set); dynamic families are prefixes of runtime-formatted names
SPAN_NAMES = frozenset(s.name for s in _ALL_SPANS if not s.dynamic)
SPAN_PREFIXES = tuple(s.name for s in _ALL_SPANS if s.dynamic)


def _e(kind, subsystem, doc):
    return Event(kind=kind, subsystem=subsystem, doc=doc)


_ALL_EVENTS = [
    _e("fault_injected", "faults",
       "A fault-injection rule fired (site, key, action) — recorded in the "
       "process where the fault executed."),
    _e("object_lost", "store",
       "An ObjectLostError was raised (object id + detail) — the read-side "
       "view of a store loss."),
    _e("recovery_round", "recovery",
       "The engine re-executed producers for lost blobs (stage, producer "
       "and blob counts)."),
    _e("stream_reseal", "shuffle",
       "A regenerated map re-sealed its publication under the next "
       "generation."),
    _e("executor_down", "scheduler",
       "Task placement marked an executor unreachable."),
    _e("executor_up", "scheduler",
       "A down-marked executor answered again and re-entered task "
       "placement (restart re-admission; the executor_down symmetry)."),
    _e("executor_drain", "scheduler",
       "An executor began a graceful drain out of the pool (deliberate "
       "retirement, never a crash)."),
    _e("pool_scale", "scheduler",
       "The autoscale controller grew or shrank the executor pool "
       "(direction + resulting size)."),
    _e("warm_fork", "scheduler",
       "A worker spawn went through (or degraded out of) the warm-fork "
       "plane: forked pid, or the failure that fell back to cold spawn."),
    _e("store_budget", "store",
       "Per-host store budgets were re-derived from the AQE plane's "
       "measured stage bytes (or the derivation degraded to the static "
       "budgets on an injected store.budget fault)."),
    _e("store_fault_in", "store",
       "A spilled payload was faulted back into shared memory on read "
       "(object id + host)."),
    _e("stage_abort", "scheduler",
       "A failing stage ran the abort contract (drain + free)."),
    _e("admission_reject", "scheduler",
       "An action parked at admission timed out (RDT_ADMIT_TIMEOUT_S) and "
       "failed with the typed no-retry AdmissionRejected."),
    _e("backpressure", "scheduler",
       "Dispatch to a host paused on the store high-watermark, or resumed "
       "below the low-watermark (memory backpressure transitions)."),
    _e("action_failed", "engine",
       "An engine action surfaced a StageError; a blackbox bundle is "
       "written alongside."),
    _e("replica_down", "serving",
       "A serving replica left the rotation (connection lost or "
       "ReplicaNotLoaded)."),
    _e("replica_up", "serving",
       "A serving replica reloaded and rejoined the rotation."),
    _e("hedge", "serving",
       "A dispatch was hedged onto a second replica."),
    _e("request_failed", "serving",
       "A serving request failed on every replica within the re-route "
       "grace (ServingError)."),
    _e("overload_shed", "serving",
       "A serving request was refused at admission (ServingOverloaded) "
       "because the session's outstanding queue was at its bound."),
    _e("hot_swap", "serving",
       "A serving session atomically shifted traffic to a freshly loaded "
       "servable version (the old one retires in the background)."),
    _e("unload_failed", "serving",
       "A retired replica refused serve_unload through the whole retry "
       "window — its servable's weights stay pinned in that executor "
       "process (loud leak record: replica, executor, version, error)."),
    _e("rollout_promote", "serving",
       "A guarded rollout ramped its canary to full weight healthy and "
       "promoted it to primary through the swap/retire machinery."),
    _e("rollout_rollback", "serving",
       "A guarded rollout auto-rolled-back: the canary judged unhealthy "
       "(error-rate or p99 vs baseline) or the rollout timed out — "
       "weight to 0, canary unloaded, blackbox bundle written with the "
       "failing step's numbers."),
    _e("serve_scale", "serving",
       "The serving autoscaler changed (or failed to change) the "
       "per-version replica count (direction, replicas, reason)."),
    _e("stream_replay", "stream",
       "A continuous pipeline re-derived a lost epoch blob from its "
       "source journal (exactly-once replay; epoch + reason recorded)."),
]

EVENTS: Dict[str, Event] = {e.kind: e for e in _ALL_EVENTS}
assert len(EVENTS) == len(_ALL_EVENTS), "duplicate event declaration"


# ---- process-local state -----------------------------------------------------

_lock = threading.Lock()
_counters: Dict[str, Dict[str, float]] = {}  # guarded-by: _lock
_gauges: Dict[str, Dict[str, float]] = {}    # guarded-by: _lock
_hists: Dict[str, Dict[str, Dict[str, Any]]] = {}  # guarded-by: _lock
_events: Optional[collections.deque] = None  # guarded-by: _lock
_events_dropped = 0                          # guarded-by: _lock


def _event_cap() -> int:
    """The flight-recorder ring bound — read lazily so this module stays
    stdlib-only at import (the knob registry itself imports the package)."""
    try:
        from raydp_tpu_torch import knobs
        return max(16, int(knobs.get("RDT_FLIGHT_MAX_EVENTS")))
    except Exception:  # noqa: BLE001 - standalone load (linter), bootstrap
        return 1024


def _metric(name: str, kind: str) -> Metric:
    m = METRICS[name]  # unknown name must fail loudly, same as knobs.get
    if m.kind != kind:
        raise ValueError(f"metric {name} is a {m.kind}, not a {kind}")
    return m


def inc(name: str, value: float = 1, label: str = "") -> None:
    """Add to a counter (cheap: one lock + dict update)."""
    _metric(name, COUNTER)
    with _lock:
        by_label = _counters.setdefault(name, {})
        by_label[label] = by_label.get(label, 0) + value


def set_gauge(name: str, value: float, label: str = "") -> None:
    _metric(name, GAUGE)
    with _lock:
        _gauges.setdefault(name, {})[label] = value


def observe(name: str, value: float, label: str = "") -> None:
    """Record one observation into a summary-shaped histogram."""
    _metric(name, HISTOGRAM)
    with _lock:
        h = _hists.setdefault(name, {}).setdefault(label, dict(_HIST_ZERO))
        h["count"] += 1
        h["sum"] += value
        h["min"] = value if h["min"] is None else min(h["min"], value)
        h["max"] = value if h["max"] is None else max(h["max"], value)


def record_event(kind: str, **fields) -> None:
    """Append one structured event to the bounded flight-recorder ring."""
    global _events, _events_dropped
    EVENTS[kind]  # unknown kind must fail loudly
    ev = {"ts": time.time(), "kind": kind}
    ev.update(fields)
    dropped = False
    with _lock:
        if _events is None:
            _events = collections.deque(maxlen=_event_cap())
        if len(_events) == _events.maxlen:
            _events_dropped += 1
            dropped = True
        _events.append(ev)
    if dropped:
        inc("flightrec_events_dropped_total")  # outside _lock: inc takes it


def events() -> List[Dict[str, Any]]:
    with _lock:
        return list(_events) if _events is not None else []


def snapshot() -> Dict[str, Any]:
    """This process's metric state: ``{"counters": {name: {label: v}},
    "gauges": ..., "hists": {name: {label: {count,sum,min,max}}}}``."""
    with _lock:
        return {
            "counters": {n: dict(d) for n, d in _counters.items()},
            "gauges": {n: dict(d) for n, d in _gauges.items()},
            "hists": {n: {lb: dict(h) for lb, h in d.items()}
                      for n, d in _hists.items()},
        }


def export_state() -> Dict[str, Any]:
    """The ``__rdt_metrics__`` intrinsic payload: metrics + the flight
    recorder ring + this process's wall clock (for offset alignment)."""
    with _lock:
        evs = list(_events) if _events is not None else []
        dropped = _events_dropped
    return {"metrics": snapshot(), "events": evs,
            "events_dropped": dropped, "clock_ns": time.time_ns(),
            "pid": os.getpid()}


def reset() -> None:
    """Wipe all process-local metric and event state (tests)."""
    global _events, _events_dropped
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _events = None
        _events_dropped = 0


# ---- merging -----------------------------------------------------------------

def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-process snapshots: counters and histogram components sum;
    gauges sum too (each process contributes its own level — per-process
    values stay readable under ``processes`` in :func:`metrics_report`)."""
    out = {"counters": {}, "gauges": {}, "hists": {}}
    for snap in snaps:
        for name, by_label in (snap.get("counters") or {}).items():
            tgt = out["counters"].setdefault(name, {})
            for lb, v in by_label.items():
                tgt[lb] = tgt.get(lb, 0) + v
        for name, by_label in (snap.get("gauges") or {}).items():
            tgt = out["gauges"].setdefault(name, {})
            for lb, v in by_label.items():
                tgt[lb] = tgt.get(lb, 0) + v
        for name, by_label in (snap.get("hists") or {}).items():
            tgt = out["hists"].setdefault(name, {})
            for lb, h in by_label.items():
                t = tgt.setdefault(lb, dict(_HIST_ZERO))
                t["count"] += h.get("count", 0)
                t["sum"] += h.get("sum", 0.0)
                for k, fn in (("min", min), ("max", max)):
                    v = h.get(k)
                    if v is not None:
                        t[k] = v if t[k] is None else fn(t[k], v)
    return out


def _collect_process_states(timeout: float = 10.0):
    """(states, skipped): every reachable process's ``export_state()`` —
    the driver itself, live actors via the ``__rdt_metrics__`` intrinsic,
    and node agents via their ``telemetry`` RPC."""
    states: Dict[str, Dict[str, Any]] = {"driver": export_state()}
    skipped = 0
    try:
        from raydp_tpu_torch.runtime import head as head_mod
        if not head_mod.runtime_initialized():
            return states, skipped
        rt = head_mod.get_runtime()
        from raydp_tpu_torch.runtime.actor import ActorHandle
        for aid, rec in list(rt.records.items()):
            if rec.state != "ALIVE":
                continue
            if not rec.ready.is_set():
                skipped += 1  # mid-restart: never park on the ready grace
                continue
            role = rec.spec.name or aid
            try:
                handle = ActorHandle(aid, rec.spec.name, rt.server.address)
                states[role] = handle.call("__rdt_metrics__",
                                           timeout=timeout)
            except Exception:  # noqa: BLE001 - a dying actor is skipped,
                skipped += 1   # counted, and reported — never silent
        for node_id, agent in list(getattr(rt, "node_agents", {}).items()):
            try:
                # metrics_state, NOT telemetry: the latter ships the whole
                # span ring, which this harvest would discard (and a
                # blackbox bundle would embed verbatim)
                states[f"agent-{node_id}"] = agent.call("metrics_state",
                                                        timeout=timeout)
            except Exception:  # noqa: BLE001 - same skip contract
                skipped += 1
    except Exception:  # noqa: BLE001 - no runtime: the driver state stands
        pass
    if skipped:
        inc("telemetry_skipped_processes_total", skipped)
        states["driver"] = export_state()  # re-snapshot with the skip count
    return states, skipped


def metrics_report(include_actors: bool = True) -> Dict[str, Any]:
    """The merged cross-process metrics view: ``merged`` (counters/hists
    summed, gauges summed), ``processes`` (role → that process's metrics),
    and ``skipped_processes`` (unreachable lanes — nonzero means the merge
    is incomplete). Subsumes the legacy per-subsystem reports:
    ``store_ops_total`` is ``op_counts()``, the ``serve_*`` counters are
    ``serving_report()``'s, the scheduler/recovery counters are the
    ``shuffle_stage_report`` columns."""
    if include_actors:
        states, skipped = _collect_process_states()
    else:
        states, skipped = {"driver": export_state()}, 0
    procs = {role: st.get("metrics", {}) for role, st in states.items()}
    return {"merged": merge_snapshots(list(procs.values())),
            "processes": procs,
            "skipped_processes": skipped}


# ---- prometheus / json dumps -------------------------------------------------

def _prom_name(name: str) -> str:
    return "rdt_" + name


def render_prometheus(merged: Dict[str, Any]) -> str:
    """Prometheus text exposition of one merged snapshot (histograms render
    as summary-style ``_count``/``_sum`` plus ``_max``)."""
    lines: List[str] = []

    def _sample(pname, label_name, label, value):
        tag = f'{{{label_name}="{label}"}}' if label else ""
        lines.append(f"{pname}{tag} {value}")

    for m in _ALL_METRICS:
        pname = _prom_name(m.name)
        if m.kind == COUNTER:
            data = merged.get("counters", {}).get(m.name)
        elif m.kind == GAUGE:
            data = merged.get("gauges", {}).get(m.name)
        else:
            data = merged.get("hists", {}).get(m.name)
        if not data:
            continue
        lines.append(f"# HELP {pname} {m.doc}")
        lines.append(f"# TYPE {pname} "
                     f"{'summary' if m.kind == HISTOGRAM else m.kind}")
        for lb in sorted(data):
            if m.kind == HISTOGRAM:
                h = data[lb]
                _sample(pname + "_count", m.label, lb, h["count"])
                _sample(pname + "_sum", m.label, lb, h["sum"])
                if h["max"] is not None:
                    _sample(pname + "_max", m.label, lb, h["max"])
            else:
                _sample(pname, m.label, lb, data[lb])
    return "\n".join(lines) + "\n"


def dump(out_dir: Optional[str] = None) -> Dict[str, str]:
    """Write the merged report as ``metrics.json`` + ``metrics.prom`` into
    ``out_dir`` (default: ``<session_dir>/metrics``); returns the paths."""
    if out_dir is None:
        out_dir = os.path.join(_session_dir(), "metrics")
    os.makedirs(out_dir, exist_ok=True)
    report = metrics_report()
    json_path = os.path.join(out_dir, "metrics.json")
    prom_path = os.path.join(out_dir, "metrics.prom")
    with open(json_path, "w") as fh:
        json.dump(report, fh, indent=2, default=str)
    with open(prom_path, "w") as fh:
        fh.write(render_prometheus(report["merged"]))
    return {"json": json_path, "prom": prom_path}


def _session_dir() -> str:
    try:
        from raydp_tpu_torch.runtime import head as head_mod
        if head_mod.runtime_initialized():
            return head_mod.get_runtime().session_dir
    except Exception:  # noqa: BLE001 - no runtime: the default dir stands
        pass
    from raydp_tpu_torch.runtime.head import session_root
    return session_root()


# ---- flight-recorder blackbox bundles ---------------------------------------

#: bundles written per action label this session — a chaos storm failing the
#: same action in a loop must not fill the disk with identical postmortems
_BLACKBOX_CAP_PER_ACTION = 5
_blackbox_counts: Dict[str, int] = {}  # guarded-by: _lock


def write_blackbox(action: str, error: Optional[BaseException] = None,
                   extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Harvest every reachable process's flight-recorder ring (plus its
    metrics snapshot) into ``<session_dir>/blackbox/blackbox-<action>[-n]
    .json``; returns the path (None past the per-action cap). Called by the
    engine when an action surfaces ``StageError`` and by the serving
    session on ``ServingError`` — best-effort by contract: a failed harvest
    must never mask the error that triggered it."""
    safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in action)
    with _lock:
        n = _blackbox_counts.get(safe, 0)
        if n >= _BLACKBOX_CAP_PER_ACTION:
            return None
        _blackbox_counts[safe] = n + 1
    states, skipped = _collect_process_states()
    bundle = {
        "action": action,
        "ts": time.time(),
        "error": None if error is None else str(error),
        "exc_type": None if error is None else type(error).__name__,
        "skipped_processes": skipped,
        "processes": states,
    }
    if extra:
        bundle["extra"] = extra
    out_dir = os.path.join(_session_dir(), "blackbox")
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if n == 0 else f"-{n}"
    path = os.path.join(out_dir, f"blackbox-{safe}{suffix}.json")
    with open(path, "w") as fh:
        json.dump(bundle, fh, indent=2, default=str)
    return path
