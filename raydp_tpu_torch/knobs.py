"""The ``RDT_*`` environment knobs the port reads — its copy of the entries
of :mod:`raydp_tpu.knobs` on the ported paths (training, the runtime, the
object store, the ETL engine, the fault plane, continuous pipelines, the
serving plane), with the same names, types, defaults and read semantics,
except ``RDT_WARM_IMPORTS``, whose default names ``torch`` where the
reference's names ``jax``.

:func:`get` reads the environment at the call, so tests and runs can flip a
knob between actions; the runtime's process-start knobs are read once by
the process that uses them. Stdlib only: node agents and forked workers
read it at bootstrap.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

#: the truthiness convention every boolean knob shares (``RDT_X=0`` /
#: ``false`` / ``off`` / ``no`` disables; anything else enables)
_FALSY = ("0", "false", "off", "no")


@dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    type: str          # "bool" | "int" | "float" | "str"
    default: object
    doc: str

    def parse(self, raw: str) -> object:
        if self.type == "bool":
            return raw.strip().lower() not in _FALSY
        if self.type == "int":
            # int(float(...)) so "8e6"-style and "2048.0"-style values work
            return int(float(raw))
        if self.type == "float":
            return float(raw)
        return raw


_ALL = [
    Knob("RDT_PREFETCH_TO_DEVICE", "int", 2,
         "Already-placed batches the streaming feed keeps ahead of the "
         "train step (0 = place synchronously)."),
    Knob("RDT_FEED_CACHE_MB", "float", 2048.0,
         "Per-iterator budget (MiB) for the decoded-block host cache reused "
         "across epochs."),
    Knob("RDT_DEVICE_CACHE", "bool", True,
         "Device-resident dataset cache opt-out (0 always streams batches)."),
    Knob("RDT_DEVICE_CACHE_MB", "float", 2048.0,
         "Device-memory budget (MiB) under which a dataset is eligible for "
         "full device residency."),
    Knob("RDT_STAGE_THREADS", "int", 1,
         "Column fan-out threads of the native staging core (host decode)."),
    Knob("RDT_TRAIN_ACCUM_STEPS", "int", 1,
         "Gradient-accumulation microbatches per optimizer step. Must "
         "divide batch_size; the estimator accum_steps= argument "
         "overrides."),
    Knob("RDT_TRAIN_REMAT", "str", "none",
         "Rematerialization policy for the train-step forward "
         "(torch.utils.checkpoint placement by role, parallel/roles.py): a "
         "global mode — 'dots' keeps matrix products (kernel/embedding "
         "contractions) and recomputes elementwise glue; 'full' recomputes "
         "everything; 'none' saves all residuals — or a per-role "
         "'role=mode,...' map over the param roles "
         "('embedding=none,kernel=dots,default=full'), chosen by the "
         "model's dominant parameter role; a bare mode is the default "
         "policy for every role. Validated eagerly, before any step. The "
         "estimator remat= argument overrides."),
    # ---- serving plane -------------------------------------------------------
    Knob("RDT_SERVE_MAX_BATCH", "int", 64,
         "Micro-batch row cap: concurrent predict() requests coalesce into "
         "one replica dispatch up to this many rows. Read at serving-session "
         "construction."),
    Knob("RDT_SERVE_BATCH_TIMEOUT_MS", "float", 5.0,
         "Latency budget a partially-filled micro-batch waits for more rows "
         "before dispatching anyway."),
    Knob("RDT_SERVE_MAX_INFLIGHT", "int", 2,
         "Per-replica in-flight dispatch cap; dispatches queue driver-side "
         "once every ready replica is at its cap."),
    Knob("RDT_SERVE_HEDGE", "bool", True,
         "Hedged requests: a dispatch older than the hedge deadline is "
         "duplicated onto a second replica; first responder wins, the "
         "loser's result is discarded and counted."),
    Knob("RDT_SERVE_HEDGE_QUANTILE", "float", 0.9,
         "Completed-batch latency quantile the hedge deadline is computed "
         "from."),
    Knob("RDT_SERVE_HEDGE_MULTIPLIER", "float", 3.0,
         "Hedge deadline = this multiple of the latency quantile."),
    Knob("RDT_SERVE_HEDGE_MIN_MS", "float", 20.0,
         "Floor under the hedge deadline: dispatches younger than this "
         "never hedge."),
    Knob("RDT_SERVE_REROUTE_GRACE_S", "float", 60.0,
         "Wall-clock grace a failed/unroutable dispatch keeps re-routing "
         "across replicas (sized for an executor restart + replica reload) "
         "before failing the request."),
    Knob("RDT_SERVE_PREFETCH", "int", 2,
         "Staged batches a replica keeps decoded + device-placed ahead of "
         "its apply (the DevicePrefetcher depth). Read at replica "
         "load."),
    Knob("RDT_SERVE_MAX_QUEUE", "int", 1024,
         "Overload bound on outstanding (accepted, unfinished) requests: "
         "past it predict_async sheds with the typed retriable "
         "ServingOverloaded instead of growing the dispatcher queue, and "
         "hedging is suppressed while saturated. 0 disables shedding. Read "
         "at serving-session construction."),
    Knob("RDT_SERVE_SWAP_DRAIN_S", "float", 30.0,
         "How long a hot-swap's background retirement waits for the OLD "
         "servable's in-flight dispatches to drain before unloading it "
         "anyway (in-flight requests on it still complete; the registry "
         "entry just goes away)."),
    Knob("RDT_SERVE_CANARY_WEIGHT", "float", 0.1,
         "Traffic share a guarded rollout gives the canary version the "
         "moment it loads (the first ramp step). Read per rollout."),
    Knob("RDT_SERVE_ROLLOUT_RAMP", "str", "0.25,0.5,1.0",
         "Comma-separated non-decreasing weight schedule a rollout ramps "
         "the canary through after the initial canary weight, each step "
         "judged healthy before the next."),
    Knob("RDT_SERVE_ROLLOUT_STEP_S", "float", 30.0,
         "Longest a rollout holds one ramp step waiting for the judgment "
         "window to fill; a step that times out without evidence either "
         "way advances (insufficient traffic is not a regression)."),
    Knob("RDT_SERVE_ROLLOUT_MIN_SAMPLES", "int", 32,
         "Step-local requests BOTH the canary and the baseline must have "
         "answered before a health verdict is allowed — a one-request "
         "blip must not kill a deploy."),
    Knob("RDT_SERVE_ROLLOUT_ERR_TOL", "float", 0.02,
         "Absolute error-rate margin the canary may exceed the baseline "
         "by within a ramp step before the rollout rolls back."),
    Knob("RDT_SERVE_ROLLOUT_P99_FACTOR", "float", 2.0,
         "Multiple of the baseline's per-version p99 the canary's p99 "
         "must exceed (with full windows on both sides) before the "
         "rollout rolls back on latency."),
    Knob("RDT_SERVE_MIN_REPLICAS", "int", 1,
         "Serving-autoscaler floor on per-version replica count."),
    Knob("RDT_SERVE_MAX_REPLICAS", "int", 4,
         "Serving-autoscaler ceiling on per-version replica count."),
    Knob("RDT_SERVE_SCALE_INTERVAL_S", "float", 1.0,
         "Seconds between serving-autoscaler ticks (each tick reads one "
         "serving_report and decides at most one scale event)."),
    Knob("RDT_SERVE_SCALE_UP_S", "float", 3.0,
         "Sustained dispatch pressure (queue depth beyond replica "
         "capacity, or the admission queue half full) required before the "
         "serving autoscaler adds a replica — a momentary spike never "
         "scales by itself."),
    Knob("RDT_SERVE_SCALE_IDLE_S", "float", 30.0,
         "Sustained full idleness (zero queued, zero outstanding) before "
         "the serving autoscaler drains a replica back."),
    Knob("RDT_SERVE_SCALE_COOLDOWN_S", "float", 10.0,
         "Hysteresis after any serving scale event: no further scale "
         "decisions until it passes (sustained windows keep accumulating "
         "through it)."),
    # ---- continuous pipelines ------------------------------------------------
    Knob("RDT_STREAM_RETAIN", "int", 64,
         "Epochs of replay state a continuous pipeline keeps: the source "
         "journal and the published epoch blobs of the newest N epochs stay "
         "available for exactly-once replay / late ranged-fetch; older "
         "epochs are freed as the stream advances."),
    Knob("RDT_STREAM_REPLAY_ROUNDS", "int", 4,
         "Replay rounds a window merge (or epoch-stream fetch) attempts when "
         "an epoch blob is lost (ObjectLostError): each round re-derives the "
         "lost epochs from the source journal and re-seals them."),
    Knob("RDT_STREAM_POLL_TIMEOUT_S", "float", 10.0,
         "Longest a pipeline step blocks on its source before re-checking "
         "for stop/close (idle tick; the source may return rows sooner)."),
    Knob("RDT_STREAM_EXPORT_EVERY", "int", 0,
         "Default epochs between partial_fit servable exports (and "
         "hot-swaps when a serving session is attached). 0 disables the "
         "cadence; the partial_fit export_every= argument overrides."),
    Knob("RDT_STREAM_MAX_PARTITIONS", "int", 0,
         "Partitions each micro-batch epoch is split into before its engine "
         "action (0 = auto: min(executors, rows))."),
    Knob("RDT_STREAM_ROLLOUT", "bool", False,
         "Ship partial_fit exports through a guarded rollout (canary ramp "
         "+ auto-rollback) instead of an immediate hot_swap. The "
         "partial_fit rollout= argument overrides; rollouts block on "
         "serving traffic, so the default stays the atomic swap."),
    # ---- ETL engine ----------------------------------------------------------
    Knob("RDT_ETL_OPTIMIZER", "bool", True,
         "Rule-based logical-plan optimizer (projection pruning + predicate "
         "pushdown); 0 preserves the naive compile-verbatim path."),
    Knob("RDT_ETL_AQE", "bool", True,
         "Adaptive query execution: runtime re-planning from measured stage "
         "statistics (broadcast join, skew split, coalesce)."),
    Knob("RDT_AQE_BROADCAST_MAX", "int", 8 << 20,
         "Broadcast-hash-join threshold: a join side whose measured bytes "
         "fit under this replicates instead of shuffling. 0 disables the "
         "rule."),
    Knob("RDT_AQE_SKEW_FACTOR", "float", 4.0,
         "Skew trigger: a reduce bucket larger than this multiple of the "
         "(lower) median bucket splits across reduce tasks. 0 disables."),
    Knob("RDT_AQE_COALESCE_MIN", "int", 1 << 20,
         "Coalescing target: adjacent reduce buckets fuse until their "
         "combined bytes reach this; also the floor under which a bucket "
         "never skew-splits. 0 disables."),
    Knob("RDT_SHUFFLE_CONSOLIDATE", "bool", True,
         "Consolidated map outputs: one store blob per map task with a "
         "per-bucket byte-range index; 0 restores per-bucket blobs."),
    Knob("RDT_SHUFFLE_PIPELINE", "bool", True,
         "Pipelined (push-based) shuffle: reducers stream ranges as maps "
         "seal. Needs the consolidated index, so RDT_SHUFFLE_CONSOLIDATE=0 "
         "disables it too."),
    Knob("RDT_LINEAGE_RECOVERY", "bool", True,
         "Lineage rebuild of lost intermediates; 0 surfaces losses as stage "
         "failures."),
    Knob("RDT_LINEAGE_ROUNDS", "int", 4,
         "Recovery rounds per stage (each round may regenerate several "
         "blobs)."),
    Knob("RDT_LINEAGE_DEPTH", "int", 4,
         "Max transitive producer-of-producer regeneration depth."),
    Knob("RDT_EXECUTOR_WAIT_S", "float", 60.0,
         "Wall-clock grace a stage keeps probing for a reachable executor "
         "(sized for restart spawn + the executor's imports) before "
         "failing."),
    Knob("RDT_SPECULATION", "bool", True,
         "Speculative backup tasks for stragglers; first finisher wins, the "
         "loser's outputs are freed."),
    Knob("RDT_SPECULATION_QUANTILE", "float", 0.75,
         "Completion fraction a stage must reach before backups are "
         "considered."),
    Knob("RDT_SPECULATION_MULTIPLIER", "float", 1.5,
         "A pending attempt is a straggler past this multiple of the "
         "completed-task median runtime."),
    Knob("RDT_SPECULATION_MIN_S", "float", 1.0,
         "Floor on the straggler threshold: sub-second stages never "
         "speculate."),
    Knob("RDT_POOL_MIN", "int", 1,
         "Autoscale floor: the controller never drains the pool below this "
         "many live executors."),
    Knob("RDT_POOL_MAX", "int", 0,
         "Autoscale ceiling: the controller never grows past this. 0 keeps "
         "the pool fixed at its session size (autoscaling must be asked for "
         "explicitly via Session.autoscale(max_size=...))."),
    Knob("RDT_POOL_SCALE_INTERVAL_S", "float", 1.0,
         "Autoscale controller tick period (load is sampled once per tick)."),
    Knob("RDT_POOL_SCALE_UP_S", "float", 2.0,
         "Sustained queue-depth window before the controller grows the pool "
         "(a single recovery-induced spike never spawns an executor)."),
    Knob("RDT_POOL_IDLE_S", "float", 10.0,
         "Sustained fully-idle window before the controller drains an "
         "executor back out."),
    Knob("RDT_POOL_COOLDOWN_S", "float", 5.0,
         "Hysteresis: no further scale decision for this long after any "
         "grow/shrink event."),
    Knob("RDT_DRAIN_REHOME", "bool", True,
         "Graceful drain re-homes a retiring executor's cached blocks onto "
         "survivors (rebuilt from their lineage recipes); 0 abandons them "
         "to on-read lineage recovery instead."),
    Knob("RDT_DRAIN_TIMEOUT_S", "float", 30.0,
         "How long a drain waits for the retiring executor's in-flight "
         "tasks before abandoning them to the normal retry/recovery "
         "machinery."),
    Knob("RDT_POOL_TENANT_WEIGHT", "float", 1.0,
         "Fair-share weight of this action's tenant: under contention each "
         "tenant's in-flight share tracks weight/sum(weights). Engine-level "
         "tenant_weight= overrides per tenant."),
    Knob("RDT_POOL_MAX_QUEUED", "int", 0,
         "Admission bound on the pool's queued (admitted, not yet "
         "in-flight) backlog: an action that would push past it parks at "
         "admission — visible to the autoscaler — instead of flooding "
         "dispatch. 0 disables admission control."),
    Knob("RDT_ADMIT_TIMEOUT_S", "float", 30.0,
         "How long an action parks at admission before failing with the "
         "typed, no-retry AdmissionRejected."),
    Knob("RDT_STORE_HIGH_WATERMARK", "float", 1.25,
         "Memory backpressure trip point: dispatch to a host whose store "
         "shm use exceeds this fraction of its budget pauses (spill is not "
         "keeping up). <= 0 disables backpressure."),
    Knob("RDT_STORE_LOW_WATERMARK", "float", 0.95,
         "Memory backpressure release point: a paused host re-enters "
         "dispatch once its shm use drops below this fraction of its "
         "budget."),
    Knob("RDT_LOCALITY_SPILLED_WEIGHT", "float", 0.5,
         "Locality weight multiplier for bytes whose local copy is SPILLED "
         "to disk: a spilled-local host scores between in-memory-local "
         "(1.0) and remote (0) — reading spilled bytes pays a fault-in "
         "wherever the task lands, so disk-local placement is a smaller "
         "win. 0 makes spilled bytes count as absent; 1 restores tier-blind "
         "weighting."),
    Knob("RDT_LOCALITY_REMOTE_WEIGHT", "float", 0.25,
         "Locality weight multiplier for a task's bytes held on OTHER "
         "dispatchable hosts (remote in-memory residency tier): every live "
         "host is credited remote bytes x this, so when the byte-holding "
         "host is draining or backpressured the ranking still prefers a "
         "real host instead of returning no preference. 0 restores the "
         "holder-only ranking; 1 scores remote copies like local ones "
         "(distance-blind)."),
    Knob("RDT_STORE_STAGE_HINTS", "bool", True,
         "Stage-aware eviction: each stage pins its input blobs in the "
         "store for its duration and demotes them to evict-first when it "
         "completes, so LRU only breaks ties among blobs no stage is "
         "reading. 0 restores pure-LRU spill order."),
    Knob("RDT_STORE_AQE_BUDGET", "bool", True,
         "Re-derive per-host store budgets from the AQE plane's measured "
         "stage bytes (clamped to the statically configured capacity), so "
         "cold bytes spill ahead of demand when the measured working set is "
         "smaller than the static budget. 0 keeps static budgets only."),
    Knob("RDT_POOL_BYTES_PER_EXEC", "int", 0,
         "Predictive autoscale: measured per-stage bytes each executor is "
         "expected to carry; a grow decision targets ceil(measured stage "
         "bytes / this) executors (capped by RDT_POOL_MAX). 0 disables the "
         "byte-driven component (parked-demand sizing stays on)."),
    # ---- runtime and object store ------------------------------------------
    Knob("RDT_LOG_LEVEL", "str", "INFO",
         "Log level of spawned processes (node agents)."),
    Knob("RDT_DRIVER_REAP_S", "float", 60.0,
         "Heartbeat silence after which an attached driver's actors and "
         "owned objects are reaped by the head."),
    Knob("RDT_ARENA_FREE_GRACE_S", "float", 60.0,
         "Seconds an arena-resident payload stays mapped after its free "
         "(borrowed zero-copy views may still be live)."),
    Knob("RDT_STORE_BUDGET_HEADROOM", "float", 1.5,
         "Multiplier on the measured per-stage bytes when deriving store "
         "budgets (derived = min(static capacity, measured x headroom))."),
    Knob("RDT_PROFILER_MAX_SPANS", "int", 100000,
         "Bound on retained trace spans per process."),
    Knob("RDT_FLIGHT_MAX_EVENTS", "int", 1024,
         "Bound on the per-process flight-recorder event ring; evictions "
         "are counted, never silent."),
    Knob("RDT_STORE_ISOLATED", "bool", False,
         "Force a node agent to host its own payload plane even on the "
         "head's machine (the multi-host store topology, in tests)."),
    Knob("RDT_NODE_SHM_BUDGET", "int", None,
         "Shared-memory budget (bytes) of an isolated node's store host; "
         "objects past it LRU-spill to disk (default: the node arena's "
         "size, 1 GiB without an arena)."),
    Knob("RDT_NODE_ARENA_SIZE", "int", None,
         "Size (bytes) of an isolated node's store arena (default: sized "
         "from /dev/shm)."),
    Knob("RDT_STORE_HOST_ID", "str", "head",
         "Which machine's payload plane this process writes to (set by the "
         "runtime for its children)."),
    Knob("RDT_STORE_PAYLOAD_ADDR", "str", None,
         "RPC address of this machine's payload server (None = the head; "
         "set by the runtime for its children)."),
    Knob("RDT_STORE_ARENA", "str", None,
         "Shared-memory segment name of the machine-local store arena (set "
         "by the runtime for its children)."),
    Knob("RDT_SUBMIT_ARGS", "str", None,
         "JSON config packaged by rdt-submit; fills init() arguments left "
         "at their defaults."),
    # ---- warm-start workers --------------------------------------------------
    Knob("RDT_WARM_FORK", "bool", False,
         "Fork new workers from a pre-imported prototype process instead of "
         "cold-spawning a fresh interpreter. Any warm-fork failure degrades "
         "loudly to the cold-spawn path."),
    Knob("RDT_WARM_IMPORTS", "str", "pyarrow,pandas,numpy,cloudpickle,torch",
         "Comma-separated modules the warm-fork prototype pre-imports; a "
         "module that fails to import is skipped with a warning. The "
         "prototype never initialises CUDA, so its forks can."),
    Knob("RDT_WARM_FORK_WAIT_S", "float", 15.0,
         "How long a spawn waits for the warm-fork prototype's readiness "
         "handshake before falling back to cold spawn."),
    Knob("RDT_WARM_FORK_RETRIES", "int", 2,
         "Supervised prototype restarts after a warm-fork plane failure."),
    Knob("RDT_WARM_REFRESH_COOLDOWN_S", "float", 30.0,
         "Minimum seconds between warm-fork prototype restarts."),
    Knob("RDT_WARM_FORKED", "bool", False,
         "Set by the warm-fork plane in forked workers (spawn provenance)."),
    # ---- fault plane ---------------------------------------------------------
    Knob("RDT_FAULTS", "str", None,
         "Declarative fault-injection spec; loaded once per process."),
    Knob("RDT_FAULTS_SEED", "int", 0,
         "Global default PRNG seed for probability-scheduled fault rules."),
]

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}


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


def get_raw(name: str) -> Optional[str]:
    """The raw environment string of a declared knob (None when unset).
    For sites that need the unparsed value (e.g. JSON payloads)."""
    KNOBS[name]  # unknown name must fail loudly, same as get()
    return os.environ.get(name)
