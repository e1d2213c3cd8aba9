"""The ``RDT_*`` environment knobs the port reads — its copy of the entries
of :mod:`raydp_tpu.knobs` on the ported paths (training, the runtime, the
object store, the ETL engine, the fault plane, continuous pipelines, the
serving plane, the SPMD gang). Every entry is the reference's entry of the
same name, field for field, except ``RDT_WARM_IMPORTS``, whose default names
``torch`` where the reference's names ``jax``, and ``RDT_SPMD_COORDINATOR``
and ``RDT_SPMD_JAX_DISTRIBUTED``, whose docs name ``torch.distributed``'s
``init_process_group`` where the reference's name ``jax.distributed``.

Every runtime read goes through :func:`get`, and the knob tables under
``raydp_tpu_torch/doc/`` are GENERATED from this registry
(``python -m raydp_tpu_torch.knobs --write-docs``). The port's linter
(``raydp_tpu_torch/tools/rdtlint``, rule ``knob-registry``) holds the
package to it: no direct ``os.environ`` read of an ``RDT_*`` name elsewhere,
no per-action knob read at import time, and generated tables that match.

Read scopes:

- ``per-action`` — re-read from the environment at every use, so tests and
  runs can flip a knob between actions.
- ``process-start`` — read once per process (at import, process bootstrap,
  or session init).

Stdlib only: node agents and forked workers read it at bootstrap, and the
linter loads it standalone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

PER_ACTION = "per-action"
PROCESS_START = "process-start"

#: the truthiness convention every boolean knob shares (``RDT_X=0`` /
#: ``false`` / ``off`` / ``no`` disables; anything else enables)
_FALSY = ("0", "false", "off", "no")


@dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    type: str          # "bool" | "int" | "float" | "str"
    default: object    # typed default; None = unset (or computed at the site)
    scope: str         # PER_ACTION | PROCESS_START
    category: str      # "etl" | "training" | "serving" | "stream"
                       # | "runtime" | "faults" | "spmd"
    doc: str           # one-line description for the generated doc tables
    #: framework-injected IPC value (set by the head/agent/submit wrapper for
    #: child processes), not a user-facing tuning knob
    internal: bool = False
    #: display override for computed defaults (e.g. "sized from /dev/shm")
    default_doc: str = ""

    def parse(self, raw: str) -> object:
        if self.type == "bool":
            return raw.strip().lower() not in _FALSY
        if self.type == "int":
            # int(float(...)) so "8e6"-style and "2048.0"-style values work
            return int(float(raw))
        if self.type == "float":
            return float(raw)
        return raw


def _k(name: str, type: str, default: object, scope: str, category: str,
       doc: str, **kw) -> Knob:
    return Knob(name=name, type=type, default=default, scope=scope,
                category=category, doc=doc, **kw)


#: declaration order is presentation order in the generated tables
_ALL = [
    _k("RDT_PREFETCH_TO_DEVICE", "int", 2, PER_ACTION, "training",
       "Already-device_put batches the streaming feed keeps ahead of the "
       "train step (0 = place synchronously)."),
    _k("RDT_FEED_CACHE_MB", "float", 2048.0, PER_ACTION, "training",
       "Per-iterator budget (MiB) for the decoded-block host cache reused "
       "across epochs."),
    _k("RDT_DEVICE_CACHE", "bool", True, PER_ACTION, "training",
       "Device-resident dataset cache opt-out (0 always streams batches)."),
    _k("RDT_DEVICE_CACHE_MB", "float", 2048.0, PER_ACTION, "training",
       "HBM budget (MiB) under which a dataset is eligible for full "
       "device residency."),
    _k("RDT_STAGE_THREADS", "int", 1, PER_ACTION, "training",
       "Column fan-out threads of the native staging core (host decode)."),
    _k("RDT_TRAIN_PAD_TAIL", "bool", True, PER_ACTION, "training",
       "Pad-and-mask the ragged final batch under a >1 data extent (or a "
       ">1 stage extent — the pipelined forward reshapes every batch into "
       "microbatches): zero rows square the batch and a mask drops them "
       "from losses/metrics. 0 restores the silent tail drop."),
    _k("RDT_TRAIN_ACCUM_STEPS", "int", 1, PER_ACTION, "training",
       "Gradient-accumulation microbatches per optimizer step: each global "
       "batch splits into this many slices scanned through the forward/"
       "backward before one update, dividing peak activation bytes by the "
       "same factor. Must divide batch_size; the estimator accum_steps= "
       "argument overrides."),
    _k("RDT_TRAIN_REMAT", "str", "none", PER_ACTION, "training",
       "Rematerialization policy for the train-step forward (jax.checkpoint "
       "placement by role, parallel/roles.py): a global mode — 'dots' keeps "
       "MXU products (kernel/embedding contractions) and recomputes "
       "elementwise glue; 'full' recomputes everything; 'none' saves all "
       "residuals — or a per-role 'role=mode,...' map over the param roles "
       "('embedding=none,kernel=dots,default=full'), chosen per segment by "
       "its dominant parameter role; a bare mode is the default policy for "
       "every role. Validated eagerly, before any compile."),
    # ---- serving plane -------------------------------------------------------
    _k("RDT_SERVE_MAX_BATCH", "int", 64, PER_ACTION, "serving",
       "Micro-batch row cap: concurrent predict() requests coalesce into "
       "one replica dispatch up to this many rows. Read at serving-session "
       "construction."),
    _k("RDT_SERVE_BATCH_TIMEOUT_MS", "float", 5.0, PER_ACTION, "serving",
       "Latency budget a partially-filled micro-batch waits for more rows "
       "before dispatching anyway."),
    _k("RDT_SERVE_MAX_INFLIGHT", "int", 2, PER_ACTION, "serving",
       "Per-replica in-flight dispatch cap; dispatches queue driver-side "
       "once every ready replica is at its cap."),
    _k("RDT_SERVE_HEDGE", "bool", True, PER_ACTION, "serving",
       "Hedged requests: a dispatch older than the hedge deadline is "
       "duplicated onto a second replica; first responder wins, the "
       "loser's result is discarded and counted."),
    _k("RDT_SERVE_HEDGE_QUANTILE", "float", 0.9, PER_ACTION, "serving",
       "Completed-batch latency quantile the hedge deadline is computed "
       "from."),
    _k("RDT_SERVE_HEDGE_MULTIPLIER", "float", 3.0, PER_ACTION, "serving",
       "Hedge deadline = this multiple of the latency quantile."),
    _k("RDT_SERVE_HEDGE_MIN_MS", "float", 20.0, PER_ACTION, "serving",
       "Floor under the hedge deadline: dispatches younger than this "
       "never hedge."),
    _k("RDT_SERVE_REROUTE_GRACE_S", "float", 60.0, PER_ACTION, "serving",
       "Wall-clock grace a failed/unroutable dispatch keeps re-routing "
       "across replicas (sized for an executor restart + replica reload) "
       "before failing the request."),
    _k("RDT_SERVE_PREFETCH", "int", 2, PER_ACTION, "serving",
       "Staged batches a replica keeps decoded + device-placed ahead of "
       "its jitted apply (the DevicePrefetcher depth). Read at replica "
       "load."),
    _k("RDT_SERVE_MAX_QUEUE", "int", 1024, PER_ACTION, "serving",
       "Overload bound on outstanding (accepted, unfinished) requests: "
       "past it predict_async sheds with the typed retriable "
       "ServingOverloaded instead of growing the dispatcher queue, and "
       "hedging is suppressed while saturated. 0 disables shedding. Read "
       "at serving-session construction."),
    _k("RDT_SERVE_SWAP_DRAIN_S", "float", 30.0, PER_ACTION, "serving",
       "How long a hot-swap's background retirement waits for the OLD "
       "servable's in-flight dispatches to drain before unloading it "
       "anyway (in-flight requests on it still complete; the registry "
       "entry just goes away)."),
    _k("RDT_SERVE_CANARY_WEIGHT", "float", 0.1, PER_ACTION, "serving",
       "Traffic share a guarded rollout gives the canary version the "
       "moment it loads (the first ramp step). Read per rollout."),
    _k("RDT_SERVE_ROLLOUT_RAMP", "str", "0.25,0.5,1.0", PER_ACTION,
       "serving",
       "Comma-separated non-decreasing weight schedule a rollout ramps "
       "the canary through after the initial canary weight, each step "
       "judged healthy before the next."),
    _k("RDT_SERVE_ROLLOUT_STEP_S", "float", 30.0, PER_ACTION, "serving",
       "Longest a rollout holds one ramp step waiting for the judgment "
       "window to fill; a step that times out without evidence either "
       "way advances (insufficient traffic is not a regression)."),
    _k("RDT_SERVE_ROLLOUT_MIN_SAMPLES", "int", 32, PER_ACTION, "serving",
       "Step-local requests BOTH the canary and the baseline must have "
       "answered before a health verdict is allowed — a one-request "
       "blip must not kill a deploy."),
    _k("RDT_SERVE_ROLLOUT_ERR_TOL", "float", 0.02, PER_ACTION, "serving",
       "Absolute error-rate margin the canary may exceed the baseline "
       "by within a ramp step before the rollout rolls back."),
    _k("RDT_SERVE_ROLLOUT_P99_FACTOR", "float", 2.0, PER_ACTION,
       "serving",
       "Multiple of the baseline's per-version p99 the canary's p99 "
       "must exceed (with full windows on both sides) before the "
       "rollout rolls back on latency."),
    _k("RDT_SERVE_MIN_REPLICAS", "int", 1, PER_ACTION, "serving",
       "Serving-autoscaler floor on per-version replica count."),
    _k("RDT_SERVE_MAX_REPLICAS", "int", 4, PER_ACTION, "serving",
       "Serving-autoscaler ceiling on per-version replica count."),
    _k("RDT_SERVE_SCALE_INTERVAL_S", "float", 1.0, PER_ACTION, "serving",
       "Seconds between serving-autoscaler ticks (each tick reads one "
       "serving_report and decides at most one scale event)."),
    _k("RDT_SERVE_SCALE_UP_S", "float", 3.0, PER_ACTION, "serving",
       "Sustained dispatch pressure (queue depth beyond replica "
       "capacity, or the admission queue half full) required before the "
       "serving autoscaler adds a replica — a momentary spike never "
       "scales by itself."),
    _k("RDT_SERVE_SCALE_IDLE_S", "float", 30.0, PER_ACTION, "serving",
       "Sustained full idleness (zero queued, zero outstanding) before "
       "the serving autoscaler drains a replica back."),
    _k("RDT_SERVE_SCALE_COOLDOWN_S", "float", 10.0, PER_ACTION,
       "serving",
       "Hysteresis after any serving scale event: no further scale "
       "decisions until it passes (sustained windows keep accumulating "
       "through it)."),
    # ---- continuous pipelines ------------------------------------------------
    _k("RDT_STREAM_RETAIN", "int", 64, PER_ACTION, "stream",
       "Epochs of replay state a continuous pipeline keeps: the source "
       "journal and the published epoch blobs of the newest N epochs stay "
       "available for exactly-once replay / late ranged-fetch; older "
       "epochs are freed as the stream advances."),
    _k("RDT_STREAM_REPLAY_ROUNDS", "int", 4, PER_ACTION, "stream",
       "Replay rounds a window merge (or epoch-stream fetch) attempts when "
       "an epoch blob is lost (ObjectLostError): each round re-derives the "
       "lost epochs from the source journal and re-seals them."),
    _k("RDT_STREAM_POLL_TIMEOUT_S", "float", 10.0, PER_ACTION, "stream",
       "Longest a pipeline step blocks on its source before re-checking "
       "for stop/close (idle tick; the source may return rows sooner)."),
    _k("RDT_STREAM_EXPORT_EVERY", "int", 0, PER_ACTION, "stream",
       "Default epochs between partial_fit servable exports (and hot-swaps "
       "when a serving session is attached). 0 disables the cadence; the "
       "partial_fit export_every= argument overrides."),
    _k("RDT_STREAM_MAX_PARTITIONS", "int", 0, PER_ACTION, "stream",
       "Partitions each micro-batch epoch is split into before its engine "
       "action (0 = auto: min(executors, rows))."),
    _k("RDT_STREAM_ROLLOUT", "bool", False, PER_ACTION, "stream",
       "Ship partial_fit exports through a guarded rollout (canary ramp "
       "+ auto-rollback, doc/serving.md) instead of an immediate "
       "hot_swap. The partial_fit rollout= argument overrides; rollouts "
       "block on serving traffic, so the default stays the atomic "
       "swap."),
    # ---- ETL engine ----------------------------------------------------------
    _k("RDT_ETL_OPTIMIZER", "bool", True, PER_ACTION, "etl",
       "Rule-based logical-plan optimizer (projection pruning + predicate "
       "pushdown); 0 preserves the naive compile-verbatim path."),
    _k("RDT_ETL_AQE", "bool", True, PER_ACTION, "etl",
       "Adaptive query execution: runtime re-planning from measured stage "
       "statistics (broadcast join, skew split, coalesce)."),
    _k("RDT_AQE_BROADCAST_MAX", "int", 8 << 20, PER_ACTION, "etl",
       "Broadcast-hash-join threshold: a join side whose measured bytes fit "
       "under this replicates instead of shuffling. 0 disables the rule."),
    _k("RDT_AQE_SKEW_FACTOR", "float", 4.0, PER_ACTION, "etl",
       "Skew trigger: a reduce bucket larger than this multiple of the "
       "(lower) median bucket splits across reduce tasks. 0 disables."),
    _k("RDT_AQE_COALESCE_MIN", "int", 1 << 20, PER_ACTION, "etl",
       "Coalescing target: adjacent reduce buckets fuse until their combined "
       "bytes reach this; also the floor under which a bucket never "
       "skew-splits. 0 disables."),
    _k("RDT_SHUFFLE_CONSOLIDATE", "bool", True, PER_ACTION, "etl",
       "Consolidated map outputs: one store blob per map task with a "
       "per-bucket byte-range index; 0 restores per-bucket blobs."),
    _k("RDT_SHUFFLE_PIPELINE", "bool", True, PER_ACTION, "etl",
       "Pipelined (push-based) shuffle: reducers stream ranges as maps seal. "
       "Needs the consolidated index, so RDT_SHUFFLE_CONSOLIDATE=0 disables "
       "it too."),
    _k("RDT_LINEAGE_RECOVERY", "bool", True, PER_ACTION, "etl",
       "Lineage rebuild of lost intermediates; 0 surfaces losses as stage "
       "failures."),
    _k("RDT_LINEAGE_ROUNDS", "int", 4, PER_ACTION, "etl",
       "Recovery rounds per stage (each round may regenerate several "
       "blobs)."),
    _k("RDT_LINEAGE_DEPTH", "int", 4, PER_ACTION, "etl",
       "Max transitive producer-of-producer regeneration depth."),
    _k("RDT_EXECUTOR_WAIT_S", "float", 60.0, PER_ACTION, "etl",
       "Wall-clock grace a stage keeps probing for a reachable executor "
       "(sized for restart spawn + jax import) before failing."),
    _k("RDT_SPECULATION", "bool", True, PER_ACTION, "etl",
       "Speculative backup tasks for stragglers; first finisher wins, the "
       "loser's outputs are freed."),
    _k("RDT_SPECULATION_QUANTILE", "float", 0.75, PER_ACTION, "etl",
       "Completion fraction a stage must reach before backups are "
       "considered."),
    _k("RDT_SPECULATION_MULTIPLIER", "float", 1.5, PER_ACTION, "etl",
       "A pending attempt is a straggler past this multiple of the "
       "completed-task median runtime."),
    _k("RDT_SPECULATION_MIN_S", "float", 1.0, PER_ACTION, "etl",
       "Floor on the straggler threshold: sub-second stages never "
       "speculate."),
    _k("RDT_POOL_MIN", "int", 1, PER_ACTION, "etl",
       "Autoscale floor: the controller never drains the pool below this "
       "many live executors."),
    _k("RDT_POOL_MAX", "int", 0, PER_ACTION, "etl",
       "Autoscale ceiling: the controller never grows past this. 0 keeps "
       "the pool fixed at its session size (autoscaling must be asked for "
       "explicitly via Session.autoscale(max_size=...))."),
    _k("RDT_POOL_SCALE_INTERVAL_S", "float", 1.0, PER_ACTION, "etl",
       "Autoscale controller tick period (load is sampled once per tick)."),
    _k("RDT_POOL_SCALE_UP_S", "float", 2.0, PER_ACTION, "etl",
       "Sustained queue-depth window before the controller grows the pool "
       "(a single recovery-induced spike never spawns an executor)."),
    _k("RDT_POOL_IDLE_S", "float", 10.0, PER_ACTION, "etl",
       "Sustained fully-idle window before the controller drains an "
       "executor back out."),
    _k("RDT_POOL_COOLDOWN_S", "float", 5.0, PER_ACTION, "etl",
       "Hysteresis: no further scale decision for this long after any "
       "grow/shrink event."),
    _k("RDT_DRAIN_REHOME", "bool", True, PER_ACTION, "etl",
       "Graceful drain re-homes a retiring executor's cached blocks onto "
       "survivors (rebuilt from their lineage recipes); 0 abandons them to "
       "on-read lineage recovery instead."),
    _k("RDT_DRAIN_TIMEOUT_S", "float", 30.0, PER_ACTION, "etl",
       "How long a drain waits for the retiring executor's in-flight tasks "
       "before abandoning them to the normal retry/recovery machinery."),
    _k("RDT_POOL_TENANT_WEIGHT", "float", 1.0, PER_ACTION, "etl",
       "Fair-share weight of this action's tenant: under contention each "
       "tenant's in-flight share tracks weight/sum(weights). Engine-level "
       "tenant_weight= overrides per tenant."),
    _k("RDT_POOL_MAX_QUEUED", "int", 0, PER_ACTION, "etl",
       "Admission bound on the pool's queued (admitted, not yet in-flight) "
       "backlog: an action that would push past it parks at admission — "
       "visible to the autoscaler — instead of flooding dispatch. 0 "
       "disables admission control."),
    _k("RDT_ADMIT_TIMEOUT_S", "float", 30.0, PER_ACTION, "etl",
       "How long an action parks at admission before failing with the "
       "typed, no-retry AdmissionRejected."),
    _k("RDT_STORE_HIGH_WATERMARK", "float", 1.25, PER_ACTION, "etl",
       "Memory backpressure trip point: dispatch to a host whose store "
       "shm use exceeds this fraction of its budget pauses (spill is not "
       "keeping up). <= 0 disables backpressure."),
    _k("RDT_STORE_LOW_WATERMARK", "float", 0.95, PER_ACTION, "etl",
       "Memory backpressure release point: a paused host re-enters "
       "dispatch once its shm use drops below this fraction of its "
       "budget."),
    _k("RDT_LOCALITY_SPILLED_WEIGHT", "float", 0.5, PER_ACTION, "etl",
       "Locality weight multiplier for bytes whose local copy is SPILLED "
       "to disk: a spilled-local host scores between in-memory-local (1.0) "
       "and remote (0) — reading spilled bytes pays a fault-in wherever "
       "the task lands, so disk-local placement is a smaller win. 0 makes "
       "spilled bytes count as absent; 1 restores tier-blind weighting."),
    _k("RDT_LOCALITY_REMOTE_WEIGHT", "float", 0.25, PER_ACTION, "etl",
       "Locality weight multiplier for a task's bytes held on OTHER "
       "dispatchable hosts (remote in-memory residency tier): every live "
       "host is credited remote bytes x this, so when the byte-holding "
       "host is draining or backpressured the ranking still prefers a "
       "real host instead of returning no preference. 0 restores the "
       "holder-only ranking; 1 scores remote copies like local ones "
       "(distance-blind)."),
    _k("RDT_STORE_STAGE_HINTS", "bool", True, PER_ACTION, "etl",
       "Stage-aware eviction: each stage pins its input blobs in the "
       "store for its duration and demotes them to evict-first when it "
       "completes, so LRU only breaks ties among blobs no stage is "
       "reading. 0 restores pure-LRU spill order."),
    _k("RDT_STORE_AQE_BUDGET", "bool", True, PER_ACTION, "etl",
       "Re-derive per-host store budgets from the AQE plane's measured "
       "stage bytes (clamped to the statically configured capacity), so "
       "cold bytes spill ahead of demand when the measured working set is "
       "smaller than the static budget. 0 keeps static budgets only."),
    _k("RDT_POOL_BYTES_PER_EXEC", "int", 0, PER_ACTION, "etl",
       "Predictive autoscale: measured per-stage bytes each executor is "
       "expected to carry; a grow decision targets ceil(measured stage "
       "bytes / this) executors (capped by RDT_POOL_MAX). 0 disables the "
       "byte-driven component (parked-demand sizing stays on)."),
    # ---- runtime and object store ------------------------------------------
    _k("RDT_LOG_LEVEL", "str", "INFO", PROCESS_START, "runtime",
       "Log level of spawned processes (node agents, SPMD rank workers)."),
    _k("RDT_DRIVER_REAP_S", "float", 60.0, PROCESS_START, "runtime",
       "Heartbeat silence after which an attached driver's actors and owned "
       "objects are reaped by the head."),
    _k("RDT_ARENA_FREE_GRACE_S", "float", 60.0, PROCESS_START, "runtime",
       "Seconds an arena-resident payload stays mapped after its free "
       "(borrowed zero-copy views may still be live)."),
    _k("RDT_STORE_BUDGET_HEADROOM", "float", 1.5, PER_ACTION, "etl",
       "Multiplier on the measured per-stage bytes when deriving store "
       "budgets (derived = min(static capacity, measured x headroom))."),
    _k("RDT_PROFILER_MAX_SPANS", "int", 100000, PROCESS_START, "runtime",
       "Bound on retained trace spans per process."),
    _k("RDT_FLIGHT_MAX_EVENTS", "int", 1024, PROCESS_START, "runtime",
       "Bound on the per-process flight-recorder event ring "
       "(doc/observability.md); evictions are counted, never silent."),
    _k("RDT_STORE_ISOLATED", "bool", False, PROCESS_START, "runtime",
       "Force a node agent to host its own payload plane even on the head's "
       "machine (the multi-host store topology, in tests)."),
    _k("RDT_NODE_SHM_BUDGET", "int", None, PROCESS_START, "runtime",
       "Shared-memory budget (bytes) of an isolated node's store host; "
       "objects past it LRU-spill to disk.",
       default_doc="node arena size (1 GiB fallback)"),
    _k("RDT_NODE_ARENA_SIZE", "int", None, PROCESS_START, "runtime",
       "Size (bytes) of an isolated node's store arena.",
       default_doc="sized from /dev/shm"),
    _k("RDT_STORE_HOST_ID", "str", "head", PROCESS_START, "runtime",
       "Which machine's payload plane this process writes to.",
       internal=True),
    _k("RDT_STORE_PAYLOAD_ADDR", "str", None, PROCESS_START, "runtime",
       "RPC address of this machine's payload server (None = the head).",
       internal=True),
    _k("RDT_STORE_ARENA", "str", None, PROCESS_START, "runtime",
       "Shared-memory segment name of the machine-local store arena.",
       internal=True),
    _k("RDT_SUBMIT_ARGS", "str", None, PROCESS_START, "runtime",
       "JSON config packaged by rdt-submit; fills init() arguments left at "
       "their defaults.", internal=True),
    # ---- warm-start workers --------------------------------------------------
    _k("RDT_WARM_FORK", "bool", False, PER_ACTION, "runtime",
       "Fork new workers from a pre-imported prototype process instead of "
       "cold-spawning a fresh interpreter: scale-up readiness goes from "
       "~seconds of jax/pyarrow import to process-fork-fast. Any warm-fork "
       "failure degrades loudly to the cold-spawn path."),
    _k("RDT_WARM_IMPORTS", "str", "pyarrow,pandas,numpy,cloudpickle,torch",
       PROCESS_START, "runtime",
       "Comma-separated modules the warm-fork prototype pre-imports; a "
       "module that fails to import is skipped with a warning (the fork "
       "still works, just colder)."),
    _k("RDT_WARM_FORK_WAIT_S", "float", 15.0, PER_ACTION, "runtime",
       "How long a spawn waits for the warm-fork prototype's readiness "
       "handshake before falling back to cold spawn."),
    _k("RDT_WARM_FORK_RETRIES", "int", 2, PER_ACTION, "runtime",
       "Supervised prototype restarts after a warm-fork plane failure: a "
       "latched-failed plane re-warms a fresh prototype on the next fork "
       "request, up to this many times per manager (0 keeps the "
       "latch-permanent pre-r20 behavior). Each re-warm emits a warm_fork "
       "re-warm event and counts pool_warm_refreshes_total."),
    _k("RDT_WARM_REFRESH_COOLDOWN_S", "float", 30.0, PER_ACTION, "runtime",
       "Minimum seconds between warm-fork prototype restarts: fork "
       "requests inside the cooldown go straight to cold spawn instead of "
       "hammering a crashing prototype."),
    _k("RDT_WARM_FORKED", "bool", False, PROCESS_START, "runtime",
       "Set by the warm-fork plane in forked workers (telemetry reports "
       "it as spawn provenance).", internal=True),
    # ---- fault plane ---------------------------------------------------------
    _k("RDT_FAULTS", "str", None, PROCESS_START, "faults",
       "Declarative fault-injection spec (doc/fault_tolerance.md); loaded "
       "once per process, re-armed by raydp_tpu_torch.init()."),
    _k("RDT_FAULTS_SEED", "int", 0, PROCESS_START, "faults",
       "Global default PRNG seed for probability-scheduled fault rules."),
    # ---- SPMD gang plumbing --------------------------------------------------
    _k("RDT_SPMD_JOB_ID", "str", None, PROCESS_START, "spmd",
       "Gang job id of an SPMD rank worker.", internal=True),
    _k("RDT_SPMD_DRIVER", "str", None, PROCESS_START, "spmd",
       "RPC url of the gang driver a rank worker reports to.",
       internal=True),
    _k("RDT_SPMD_RANK", "int", None, PROCESS_START, "spmd",
       "This worker's rank in the gang.", internal=True),
    _k("RDT_SPMD_WORLD_SIZE", "int", None, PROCESS_START, "spmd",
       "Gang world size.", internal=True),
    _k("RDT_SPMD_COORDINATOR", "str", None, PROCESS_START, "spmd",
       "torch.distributed rendezvous address override (the host:port of "
       "init_process_group's tcp:// store).", internal=True),
    _k("RDT_SPMD_JAX_DISTRIBUTED", "bool", False, PROCESS_START, "spmd",
       "Whether a rank worker calls "
       "torch.distributed.init_process_group().", internal=True),
]

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}
assert len(KNOBS) == len(_ALL), "duplicate knob declaration"


def get(name: str):
    """The typed value of knob ``name`` read from the environment NOW, or
    its declared default when unset or empty (empty string = unset, so
    ``RDT_X= python ...`` behaves like an absent var, never a parse
    error). An undeclared name raises ``KeyError``."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return knob.default
    return knob.parse(raw)


def require(name: str):
    """Like :func:`get` but raises when the var is unset — for
    framework-injected values (SPMD rank plumbing) whose absence means the
    process was launched outside its harness."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        raise KeyError(
            f"{name} is not set — this process expects it injected by its "
            f"launcher ({knob.doc})")
    return knob.parse(raw)


def get_raw(name: str) -> Optional[str]:
    """The raw environment string of a declared knob (None when unset).
    For sites that need the unparsed value (e.g. JSON payloads)."""
    KNOBS[name]  # unknown name must fail loudly, same as get()
    return os.environ.get(name)


# ---- generated doc tables ---------------------------------------------------

def _default_cell(knob: Knob) -> str:
    if knob.default is None:
        return knob.default_doc or "unset"
    if knob.type == "bool":
        return f"`{'1' if knob.default else '0'}`"
    return f"`{knob.default}`"


def generate_table(category: Optional[str] = None) -> str:
    """Markdown knob table for one category (None = the full registry).
    The doc blocks between ``rdtlint:knob-table`` markers are exactly this
    output; rule ``knob-registry`` fails on any drift."""
    rows = [k for k in _ALL if category is None or k.category == category]
    lines = ["| Knob | Type | Default | Read | Description |",
             "| --- | --- | --- | --- | --- |"]
    for k in rows:
        doc = k.doc + (" *(framework-injected)*" if k.internal else "")
        lines.append(f"| `{k.name}` | {k.type} | {_default_cell(k)} | "
                     f"{k.scope} | {doc} |")
    return "\n".join(lines)


#: which of the port's doc files carries which category's generated table
#: (paths from the repo root); dev_lint.md carries the full registry
DOC_TABLES = (
    ("raydp_tpu_torch/doc/etl.md", "etl"),
    ("raydp_tpu_torch/doc/training.md", "training"),
    ("raydp_tpu_torch/doc/serving.md", "serving"),
    ("raydp_tpu_torch/doc/streaming.md", "stream"),
    ("raydp_tpu_torch/doc/runtime.md", "runtime"),
    ("raydp_tpu_torch/doc/fault_tolerance.md", "faults"),
    ("raydp_tpu_torch/doc/spmd.md", "spmd"),
    ("raydp_tpu_torch/doc/dev_lint.md", None),
)

_BEGIN = "<!-- rdtlint:knob-table:begin {tag} -->"
_END = "<!-- rdtlint:knob-table:end -->"


def table_markers(category: Optional[str]) -> tuple:
    return _BEGIN.format(tag=category or "all"), _END


def render_block(category: Optional[str]) -> str:
    begin, end = table_markers(category)
    return f"{begin}\n{generate_table(category)}\n{end}"


def write_doc_tables(root: str) -> list:
    """Rewrite every marker block under ``root`` from the registry; returns
    the files changed. Used by ``python -m raydp_tpu_torch.knobs
    --write-docs``."""
    changed = []
    for rel, category in DOC_TABLES:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        begin, end = table_markers(category)
        if begin not in text or end not in text:
            continue
        head, rest = text.split(begin, 1)
        _, tail = rest.split(end, 1)
        new = head + render_block(category) + tail
        if new != text:
            with open(path, "w", encoding="utf-8") as f:
                f.write(new)
            changed.append(rel)
    return changed


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.knobs",
        description="print or regenerate the RDT_* knob tables")
    ap.add_argument("--write-docs", action="store_true",
                    help="rewrite the generated doc tables in place")
    ap.add_argument("--root", default=".",
                    help="repo root holding raydp_tpu_torch/doc/ "
                         "(default: cwd)")
    args = ap.parse_args(argv)
    if args.write_docs:
        for rel in write_doc_tables(args.root):
            print(f"rewrote {rel}")
        return 0
    print(generate_table())
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI shim
    raise SystemExit(main())
