"""The ``RDT_*`` environment knobs the port reads — its copy of the entries
of :mod:`raydp_tpu.knobs` on the ported paths (training, the runtime, the
object store, the fault plane), with the same names, types, defaults and
read semantics, except ``RDT_WARM_IMPORTS``, whose default names ``torch``
where the reference's names ``jax``.

:func:`get` reads the environment at the call, so tests and runs can flip a
knob between actions; the runtime's process-start knobs are read once by
the process that uses them. Stdlib only: node agents and forked workers
read it at bootstrap.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

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
