"""Driver-side serving sessions: micro-batched, hedged inference over the
executor pool — the port of :mod:`raydp_tpu.serve.session`, whose only
change is the ``device`` every replica load is given.

:class:`ServingSession` loads an exported servable
(``estimator.export_serving(dir)``) onto N executor-resident replicas and
exposes a thread-safe ``predict(batch)`` / ``predict_async(rows)`` API over
the existing actor RPC plane. Mechanisms, each reusing an ETL-plane design:

- **dynamic micro-batching** — concurrent requests coalesce into one device
  dispatch up to ``RDT_SERVE_MAX_BATCH`` rows or an
  ``RDT_SERVE_BATCH_TIMEOUT_MS`` latency budget; the batched output demuxes
  back per request. The replica side stages decode/H2D for the next batch
  on a ``DevicePrefetcher`` thread while the apply runs.
- **multi-version weighted routing** — the session keeps N live *version
  groups* (servable version, its replicas, a routing weight) and assigns
  each dispatch a version by smooth weighted round-robin BEFORE choosing a
  replica; a request is answered by exactly one version, re-routes and
  hedges stay inside that version's replica set, and a canary at weight
  0.1 therefore answers ~10% of dispatches and 0% of the baseline's
  (doc/serving.md "Guarded rollouts").
- **replica routing + hedged requests** — dispatches land on the
  least-busy replica of their version (per-replica in-flight counters,
  ties rotating — the task scheduler's shape); a dispatch older than
  ``max(RDT_SERVE_HEDGE_MULTIPLIER × latency-quantile,
  RDT_SERVE_HEDGE_MIN_MS)`` is hedged onto a second replica of the SAME
  version, first responder wins, the loser's result is discarded and
  counted (the scheduler's speculation, re-aimed at tail latency).
- **fault path** — a replica that dies mid-request (connection lost, or a
  restarted executor answering ``ReplicaNotLoaded``) re-routes the dispatch
  through the same hedge machinery instead of surfacing an error; the
  replica reloads in the background (its OWN version's bundle) and rejoins
  the rotation. Requests fail only when every replica of their version has
  refused within the re-route grace.
- **observability** — per-replica request/batch/row counters, per-VERSION
  request/error counters and latency windows (the rollout judgment base),
  batch occupancy and queue-depth gauges, and request p50/p99 in
  :meth:`serving_report` (the ``shuffle_stage_report`` twin), plus
  ``serve:batch`` / ``serve:hedge`` trace spans.

All routing/hedging/demux state is owned by ONE dispatcher thread fed by an
event queue — RPC completion callbacks (which run on client read-loop
threads) only enqueue, so no lock ordering exists to get wrong and the
read loops never block.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from raydp_tpu_torch import knobs, metrics, profiler
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime.rpc import ConnectionLost, RemoteError

logger = get_logger("serve.session")

#: completed-batch latencies required before the hedge deadline is trusted
#: (below this the quantile is noise and hedging would fire on warmup jitter)
_HEDGE_MIN_SAMPLES = 8
#: bounded latency reservoirs (batch + request + per-version) for the
#: quantile/report
_LAT_WINDOW = 2048


class ServingError(RuntimeError):
    """A request failed on every live replica within the re-route grace."""


class ServingOverloaded(ServingError):
    """A request was shed at admission: the session's outstanding queue
    (accepted, unfinished requests) is at ``RDT_SERVE_MAX_QUEUE``. Typed
    and RETRIABLE by contract — unlike :class:`ServingError` this is not a
    verdict on the request, only on the moment: the queue drains as
    batches complete, so back off and retry (or route elsewhere)."""


#: ``RemoteError.exc_type`` values that mark a replica/infrastructure
#: failure worth re-routing: a restarted executor's empty registry, and the
#: chaos plane's transient ``raise`` (doc/serving.md failure table). Any
#: other remote exception is a deterministic application error — replaying
#: it on another replica replays the error, so it fails fast instead.
_REROUTE_EXC_TYPES = ("ReplicaNotLoaded", "InjectedFault")


def _reroutable(err: BaseException) -> bool:
    if isinstance(err, (ConnectionLost, OSError)):
        return True
    return isinstance(err, RemoteError) \
        and err.exc_type in _REROUTE_EXC_TYPES


def _as_table(data) -> pa.Table:
    if isinstance(data, pa.Table):
        return data
    if isinstance(data, dict):
        return pa.table({k: np.asarray(v) for k, v in data.items()})
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return pa.Table.from_pandas(data, preserve_index=False)
    except ImportError:  # pragma: no cover - pandas is a hard dep elsewhere
        pass
    raise TypeError(f"cannot serve rows of type {type(data)}; pass a "
                    "pyarrow Table, pandas DataFrame, or dict of arrays")


def _encode(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def _quantile(sample: Sequence[float], q: float) -> float:
    s = sorted(sample)
    if not s:
        return 0.0
    return s[min(len(s) - 1, int(q * len(s)))]


class _Request:
    __slots__ = ("table", "fut", "t_enq", "rows", "span")

    def __init__(self, table: pa.Table, fut: Future):
        self.table = table
        self.fut = fut
        self.t_enq = time.monotonic()
        self.rows = table.num_rows
        # the request's serve:predict span opens on the caller's thread
        # (joining the caller's trace, or minting one) and closes when the
        # demuxed result lands; its context is what the dispatcher
        # activates around the batch submit, so serve:batch / serve:hedge /
        # replica serve:apply all parent here
        self.span = profiler.open_span("serve:predict", "serve",
                                       rows=self.rows)

    @property
    def ctx(self):
        return profiler.span_context(self.span)

    def finish(self, **args) -> None:
        profiler.close_span(self.span, **args)


class _Attempt:
    __slots__ = ("replica", "t0", "hedge")

    def __init__(self, replica: "_ReplicaState", t0: float, hedge: bool):
        self.replica = replica
        self.t0 = t0
        self.hedge = hedge


class _Dispatch:
    """One coalesced batch in flight (possibly on two replicas at once).
    ``version`` pins it to ONE version group: every attempt — first route,
    re-route, hedge — draws from that group's replicas, so a response is
    always the output of exactly one servable version."""

    __slots__ = ("id", "payload", "rows", "parts", "attempts", "tried",
                 "hedged", "done", "t_first", "last_error", "version")

    def __init__(self, did: int, payload: bytes, rows: int, parts,
                 version: int):
        self.id = did
        self.payload = payload
        self.rows = rows
        self.parts = parts            # [(request, row offset)]
        self.attempts: Dict[int, _Attempt] = {}
        self.tried: set = set()       # replica ids an attempt ran on
        self.hedged = False
        self.done = False
        self.t_first = time.monotonic()
        self.last_error: Optional[BaseException] = None
        self.version = version


class _ReplicaState:
    """Driver-side view of one replica: its actor handle, its in-flight
    count, and its readiness (False while the executor restarts/reloads).
    ``export_dir`` is the bundle THIS replica serves — the background
    reload must restore a canary replica's canary bundle, not whatever the
    session's primary happens to be."""

    def __init__(self, rid: str, replica, executor_name: str,
                 export_dir: str):
        self.rid = rid
        #: the ActorHandle — named `replica` so rdtlint's rpc-surface rule
        #: resolves `replica.submit("serve_predict", ...)` call sites against
        #: the actor surface (tools/rdtlint/config.py RPC_RECEIVER_SURFACES)
        self.replica = replica
        self.executor = executor_name
        self.export_dir = export_dir
        self.inflight = 0
        self.inflight_peak = 0
        self.ready = True
        self.reloading = False
        # counters for serving_report()
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.hedges = 0
        self.reloads = 0


class _VersionGroup:
    """One live servable version: its replicas, its routing weight, and the
    per-version health windows the rollout judgment reads. All fields are
    dispatcher-owned after registration."""

    def __init__(self, version: int, export_dir: str, tag: Optional[str],
                 replicas: List[_ReplicaState], weight: float = 1.0):
        self.version = version
        self.export_dir = export_dir
        self.tag = tag
        self.weight = float(weight)
        self.replicas = replicas
        #: smooth-WRR credit: deterministic proportional interleave, so a
        #: weight-0.25 canary answers exactly one dispatch in four (no RNG
        #: — tests and the judgment windows see the configured split)
        self.wrr = 0.0
        #: next scale-up replica index (initial replicas claimed 0..n-1)
        self.rid_seq = len(replicas)
        # per-version health counters/windows (the judgment base: a global
        # latency window would let a healthy baseline mask a regressing
        # canary)
        self.requests = 0
        self.failed = 0
        self.req_lat: List[float] = []


class ServingSession:
    """See module docstring. Construct with a live ETL session (or an
    explicit executor-handle list) and a servable ``export_dir``:

        est.fit_on_frame(train_df)
        est.export_serving("/shared/model-v1")
        srv = ServingSession("/shared/model-v1", session=session)
        preds = srv.predict(rows)          # or predict_async(rows) -> Future
        srv.rollout("/shared/model-v2")    # guarded canary → promote/rollback
        srv.serving_report(); srv.close()

    Knobs (all re-read at construction; doc/serving.md): batching
    ``RDT_SERVE_MAX_BATCH`` / ``RDT_SERVE_BATCH_TIMEOUT_MS``, routing
    ``RDT_SERVE_MAX_INFLIGHT``, hedging ``RDT_SERVE_HEDGE`` /
    ``RDT_SERVE_HEDGE_QUANTILE`` / ``RDT_SERVE_HEDGE_MULTIPLIER`` /
    ``RDT_SERVE_HEDGE_MIN_MS``, fault path ``RDT_SERVE_REROUTE_GRACE_S``,
    overload shedding ``RDT_SERVE_MAX_QUEUE``, replica staging
    ``RDT_SERVE_PREFETCH``; the rollout/autoscale knobs are read by
    :class:`~raydp_tpu_torch.serve.rollout.RolloutController` /
    :class:`~raydp_tpu_torch.serve.autoscale.ServingAutoscaler`.

    ``device`` is where every replica serves: ``None`` means CUDA (a
    replica whose executor has no card fails its load, and the session
    with it — nothing retries on the CPU); pass ``"cpu"`` for the CPU."""

    def __init__(self, export_dir: str, session=None,
                 executors: Optional[List] = None,
                 num_replicas: Optional[int] = None,
                 name: str = "serving", device=None):
        if executors is None:
            if session is None:
                from raydp_tpu_torch.context import active_session
                session = active_session()
            if session is None:
                raise ValueError("pass session= or executors= (no active "
                                 "raydp_tpu_torch session to serve from)")
            executors = list(session.executors)
        if not executors:
            raise ValueError("serving needs at least one executor")
        #: the live-member view replica reloads route through: when the
        #: executor hosting a replica is RETIRED from the pool (not merely
        #: restarting), the background reload re-binds the replica onto a
        #: surviving member instead of probing the corpse until the
        #: re-route grace expires. None with an explicit executors= list
        #: (no pool to consult — reloads then probe the fixed handle only).
        self._session = session
        if num_replicas is not None:
            if num_replicas < 1:
                raise ValueError("num_replicas must be >= 1")
            executors = [executors[i % len(executors)]
                         for i in range(num_replicas)]
        self.export_dir = export_dir
        self.name = name
        #: the device every replica load is given (a string: the executor
        #: resolves it, and raises there without CUDA)
        self._device = None if device is None else str(device)
        self._max_batch = max(1, int(knobs.get("RDT_SERVE_MAX_BATCH")))
        self._timeout_s = max(
            0.0, float(knobs.get("RDT_SERVE_BATCH_TIMEOUT_MS")) / 1000.0)
        self._max_inflight = max(1, int(knobs.get("RDT_SERVE_MAX_INFLIGHT")))
        self._hedge_on = bool(knobs.get("RDT_SERVE_HEDGE"))
        self._hedge_q = float(knobs.get("RDT_SERVE_HEDGE_QUANTILE"))
        self._hedge_mult = float(knobs.get("RDT_SERVE_HEDGE_MULTIPLIER"))
        self._hedge_min_s = max(
            0.0, float(knobs.get("RDT_SERVE_HEDGE_MIN_MS")) / 1000.0)
        self._reroute_grace_s = float(knobs.get("RDT_SERVE_REROUTE_GRACE_S"))
        self._max_queue = max(0, int(knobs.get("RDT_SERVE_MAX_QUEUE")))
        # overload shedding state — touched from REQUEST threads (admission
        # in predict_async, decrements from future callbacks), never by the
        # dispatcher alone, so unlike the dispatcher-owned state below it
        # needs its own lock
        self._adm_lock = threading.Lock()
        self._outstanding = 0  # guarded-by: _adm_lock
        self._shed_count = 0   # guarded-by: _adm_lock
        #: serializes hot_swap()/load_version()/scale_replicas() callers —
        #: the structural changes themselves apply on the dispatcher
        #: thread; this only orders concurrent load/version allocations
        self._swap_lock = threading.Lock()
        self._next_version = 2  # guarded-by: _swap_lock
        self._swap_drain_s = max(
            0.0, float(knobs.get("RDT_SERVE_SWAP_DRAIN_S")))

        reps: List[_ReplicaState] = []
        loads = []
        for i, h in enumerate(executors):
            rid = f"{name}-r{i}"
            rep = _ReplicaState(rid, h, getattr(h, "name", None) or f"ex{i}",
                                export_dir)
            # parallel load: each replica pays its torch import and CUDA
            # context once, concurrently, instead of serializing session
            # bring-up
            replica = rep.replica
            loads.append(replica.submit("serve_load", rid, export_dir,
                                        self._device))
            reps.append(rep)
        for f in loads:
            f.result(timeout=180.0)

        # dispatcher-owned state (no locks: one thread mutates it)
        self._events: "queue.Queue" = queue.Queue()
        self._pending: List[_Request] = []     # awaiting coalescing
        self._pending_rows = 0
        self._inflight: Dict[int, _Dispatch] = {}
        self._parked: List[_Dispatch] = []     # waiting for a replica
        self._rr = itertools.count()
        self._did = itertools.count()
        # version-group state (dispatcher-owned after construction): the
        # PRIMARY group is the baseline every new session starts with;
        # canaries register beside it via load_version()
        self._primary = _VersionGroup(1, export_dir, None, reps, weight=1.0)
        self._groups: List[_VersionGroup] = [self._primary]
        self._swaps = 0
        #: (drain deadline, replicas, version) of swapped-out servables
        self._retiring: List = []
        self._closed = False
        self._batch_lat: List[float] = []      # bounded; hedge quantile base
        self._req_lat: List[float] = []        # bounded; report p50/p99
        self._occupancy: List[int] = []        # rows per dispatched batch
        self._queue_depth_peak = 0
        self._stats = {"requests": 0, "batches": 0, "rows": 0,
                       "hedged": 0, "hedge_won": 0, "hedge_lost": 0,
                       "rerouted": 0, "failed": 0}
        self._dispatcher = threading.Thread(
            target=self._run, daemon=True, name=f"rdt-serve-dispatch-{name}")
        self._dispatcher.start()

    # ---- public API ---------------------------------------------------------
    def predict_async(self, rows) -> Future:
        """Enqueue rows (Table / DataFrame / dict of arrays); the Future
        resolves to a float32 prediction array, one entry per input row.
        Thread-safe; callable from any number of request threads.

        Overload shedding: past ``RDT_SERVE_MAX_QUEUE`` outstanding
        (accepted, unfinished) requests this fails fast with the typed
        retriable :class:`ServingOverloaded` instead of growing the
        dispatcher queue without bound — a burst degrades to rejections,
        never to a collapsing dispatcher (doc/serving.md "Overload")."""
        table = _as_table(rows)
        fut: Future = Future()
        if table.num_rows == 0:
            fut.set_result(np.empty((0,), np.float32))
            return fut
        if self._closed:
            raise ServingError("serving session is closed")
        with self._adm_lock:
            if self._max_queue > 0 and self._outstanding >= self._max_queue:
                self._shed_count += 1
                outstanding = self._outstanding
                shed = True
            else:
                self._outstanding += 1
                shed = False
        if shed:
            metrics.inc("serve_shed_total")
            metrics.record_event("overload_shed", session=self.name,
                                 outstanding=outstanding,
                                 max_queue=self._max_queue)
            raise ServingOverloaded(
                f"serving session {self.name!r} is saturated "
                f"({outstanding} outstanding requests >= "
                f"RDT_SERVE_MAX_QUEUE={self._max_queue}); retry with "
                "backoff")
        # whichever way the request ends (demuxed result, re-route
        # exhaustion, close) the admission slot releases with its future
        fut.add_done_callback(self._release_admission)
        self._events.put(("req", _Request(table, fut)))
        if self._closed and not fut.done():
            # close() raced the enqueue: the request may sit behind the
            # stop event on a queue nobody drains anymore — fail it here
            # rather than leave a Future that never resolves (the winner
            # path guards set_result with done(), so the benign double
            # race resolves to whichever side got there first)
            try:
                fut.set_exception(ServingError("serving session is closed"))
            except Exception:  # noqa: BLE001 - lost the race: it completed
                pass
        return fut

    def predict(self, rows, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous :meth:`predict_async`."""
        return self.predict_async(rows).result(timeout=timeout)

    def _release_admission(self, _fut) -> None:
        with self._adm_lock:
            self._outstanding = max(0, self._outstanding - 1)

    def _shedding(self) -> bool:
        """Saturated right now? While True the dispatcher suppresses
        hedging — a hedge is a duplicate dispatch, and duplicating work
        while shedding new requests amplifies exactly the overload the
        shed exists to absorb. The rollout judgment reads the same gate
        (via ``serving_report``): saturation inflates BOTH versions'
        windows, so a health verdict taken now would roll back a healthy
        canary for the pool's overload."""
        with self._adm_lock:
            return self._max_queue > 0 \
                and self._outstanding >= self._max_queue

    def hot_swap(self, export_dir: str, tag: Optional[str] = None,
                 timeout: float = 180.0) -> Dict[str, Any]:
        """Atomically roll the session onto a new servable under live
        traffic: load the bundle at ``export_dir`` BESIDE the active one on
        every primary replica's executor (distinct replica ids — the
        registry holds both), shift all new primary dispatches to it in one
        dispatcher step, and retire the old version in the background once
        its in-flight work drains (bounded by ``RDT_SERVE_SWAP_DRAIN_S``;
        stragglers still complete, the registry entry just goes away). No
        request is dropped: every response comes from exactly one version —
        the one its dispatch was routed to. ``tag`` annotates the version
        in :meth:`serving_report` (``partial_fit`` passes the source
        epoch). Thread-safe; concurrent swaps serialize in call order.

        This is the UNGUARDED cut-over (100% of primary traffic the moment
        the load lands); :meth:`rollout` is the guarded ramp on top."""
        if self._closed:
            raise ServingError("serving session is closed")
        with self._swap_lock:
            v = self._next_version
            self._next_version += 1
            new_reps = self._load_beside_primary(export_dir, timeout, v)
            done: Future = Future()
            self._events.put(("swap", new_reps, export_dir, v, tag, done))
            return done.result(timeout=30.0)

    def _load_beside_primary(self, export_dir: str, timeout: float,
                             v: int) -> List["_ReplicaState"]:
        """Load one replica of ``export_dir`` beside each primary replica
        (caller thread — these are blocking RPCs) under the
        caller-allocated version number ``v``. Returns the loaded
        ``_ReplicaState`` list; a partial load is rolled back before the
        error surfaces. Callers hold ``_swap_lock`` (the version
        allocation and replica-id namespace)."""
        # replica handles/executors are dispatcher-owned state (reloads
        # re-bind them): snapshot them ON the dispatcher thread instead
        # of racing _maybe_rebind from here
        snap: Future = Future()
        self._events.put(("swap_prep", snap))
        members = snap.result(timeout=30.0)
        new_reps: List[_ReplicaState] = []
        loads = []
        for i, (handle, executor) in enumerate(members):
            rid = f"{self.name}-v{v}-r{i}"
            rep = _ReplicaState(rid, handle, executor, export_dir)
            # parallel load beside the active servable — the old rid
            # keeps serving while the new one loads
            replica = rep.replica
            loads.append(replica.submit("serve_load", rid, export_dir,
                                        self._device))
            new_reps.append(rep)
        errors = []
        for f in loads:
            try:
                f.result(timeout=timeout)
            except Exception as e:  # noqa: BLE001 - collected below
                errors.append(e)
        if errors:
            # never leave a half-loaded version pinning executor RAM:
            # unload whatever DID land, then surface the failure
            threading.Thread(
                target=self._unload_replicas, args=(new_reps, v),
                daemon=True,
                name=f"rdt-serve-loadfail-{self.name}-v{v}").start()
            raise ServingError(
                f"loading {export_dir!r} failed on "
                f"{len(errors)}/{len(loads)} replica(s); the partial "
                f"load was rolled back") from errors[0]
        return new_reps

    # ---- guarded rollout / weighted versions (doc/serving.md) ---------------
    def load_version(self, export_dir: str, weight: float,
                     tag: Optional[str] = None,
                     timeout: float = 180.0) -> Dict[str, Any]:
        """Load ``export_dir`` as a NEW live version group beside the
        primary (one replica per primary replica, same executors) and start
        routing ``weight`` of dispatch traffic to it. The building block
        under :meth:`rollout`; pair with :meth:`set_weight` /
        :meth:`promote_version` / :meth:`drop_version`."""
        if self._closed:
            raise ServingError("serving session is closed")
        if weight < 0:
            raise ValueError("weight must be >= 0")
        with self._swap_lock:
            v = self._next_version
            self._next_version += 1
            new_reps = self._load_beside_primary(export_dir, timeout, v)
            group = _VersionGroup(v, export_dir, tag, new_reps,
                                  weight=weight)
            done: Future = Future()
            self._events.put(("add_group", group, done))
            return done.result(timeout=30.0)

    def set_weight(self, version: int, weight: float) -> Dict[str, Any]:
        """Re-weight a live version group (effective on the next dispatch,
        in one dispatcher step). Weight 0 parks a version out of NEW
        traffic without unloading it — its in-flight work still completes."""
        if self._closed:
            raise ServingError("serving session is closed")
        if weight < 0:
            raise ValueError("weight must be >= 0")
        done: Future = Future()
        self._events.put(("set_weight", int(version), float(weight), done))
        return done.result(timeout=30.0)

    def promote_version(self, version: int) -> Dict[str, Any]:
        """Make a live canary group THE primary (weight 1.0) and retire the
        old primary through the ordinary swap/retire machinery (drain, then
        unload, bounded by ``RDT_SERVE_SWAP_DRAIN_S``). One dispatcher
        step: a dispatch routed before it answers from the version it
        chose; after it the canary is the baseline."""
        if self._closed:
            raise ServingError("serving session is closed")
        done: Future = Future()
        self._events.put(("promote", int(version), done))
        return done.result(timeout=30.0)

    def drop_version(self, version: int) -> Dict[str, Any]:
        """Take a canary group OUT: weight to 0, replicas retired (in-flight
        dispatches complete, then unload — the rollback half of a guarded
        rollout). Parked dispatches that chose this version re-home to the
        primary (they were never answered, so no response mixes versions).
        The primary cannot be dropped."""
        if self._closed:
            raise ServingError("serving session is closed")
        done: Future = Future()
        self._events.put(("drop_group", int(version), done))
        return done.result(timeout=30.0)

    def rollout(self, export_dir: str, tag: Optional[str] = None,
                timeout: Optional[float] = None,
                **opts) -> Dict[str, Any]:
        """Guarded deployment of ``export_dir``: load it as a canary at
        ``RDT_SERVE_CANARY_WEIGHT``, ramp its traffic share on the
        ``RDT_SERVE_ROLLOUT_RAMP`` schedule judging per-version error-rate
        and p99 at every step, then auto-promote — or auto-roll-back on the
        first unhealthy verdict (weight→0, unload, ``rollout_rollback``
        event + blackbox bundle). Blocking; returns the outcome record.
        See :class:`~raydp_tpu_torch.serve.rollout.RolloutController`."""
        from raydp_tpu_torch.serve.rollout import RolloutController

        return RolloutController(self, export_dir, tag=tag,
                                 timeout=timeout, **opts).run()

    def autoscale(self, min_replicas: Optional[int] = None,
                  max_replicas: Optional[int] = None):
        """Start a :class:`~raydp_tpu_torch.serve.autoscale.ServingAutoscaler`
        driving this session's per-version replica counts from queue
        depth. Returns the started controller (caller stops it)."""
        from raydp_tpu_torch.serve.autoscale import ServingAutoscaler

        return ServingAutoscaler(self, min_replicas=min_replicas,
                                 max_replicas=max_replicas).start()

    def scale_replicas(self, count: int,
                       timeout: float = 180.0) -> Dict[str, Any]:
        """Set EVERY live version group to ``count`` replicas (the
        autoscaler's actuator). Growth loads new replicas onto the
        least-loaded live executors (blocking RPCs on the caller thread);
        shrink drains the least-busy replicas through the retire path —
        their in-flight dispatches complete before the unload. Every group
        gets the same count so a low-weight canary is never capacity-bound:
        queueing inside the canary would inflate exactly the p99 window
        the rollout judgment reads."""
        if count < 1:
            raise ValueError("count must be >= 1")
        if self._closed:
            raise ServingError("serving session is closed")
        with self._swap_lock:
            snap: Future = Future()
            self._events.put(("scale_prep", snap))
            groups = snap.result(timeout=30.0)
            live = self._live_executors()
            # replica count per executor name, across every group — growth
            # packs the least-loaded member first
            counts: Dict[str, int] = {}
            handles: Dict[str, Any] = {}
            for _v, _dir, _seq, members in groups:
                for handle, executor in members:
                    counts[executor] = counts.get(executor, 0) + 1
                    handles.setdefault(executor, handle)
            for h in live:
                counts.setdefault(h.name, 0)
                handles[h.name] = h
            per_version: Dict[int, Any] = {}
            for v, export_dir, rid_seq, members in groups:
                have = len(members)
                if count > have:
                    new_reps: List[_ReplicaState] = []
                    loads = []
                    for k in range(count - have):
                        executor = min(counts, key=counts.get)
                        counts[executor] += 1
                        rid = f"{self.name}-v{v}-r{rid_seq + k}"
                        rep = _ReplicaState(rid, handles[executor],
                                            executor, export_dir)
                        replica = rep.replica
                        loads.append(
                            replica.submit("serve_load", rid, export_dir,
                                           self._device))
                        new_reps.append(rep)
                    errors = []
                    for f in loads:
                        try:
                            f.result(timeout=timeout)
                        except Exception as e:  # noqa: BLE001 - below
                            errors.append(e)
                    if errors:
                        threading.Thread(
                            target=self._unload_replicas,
                            args=(new_reps, v), daemon=True,
                            name=f"rdt-serve-scalefail-{self.name}").start()
                        raise ServingError(
                            f"scale-up of v{v} failed loading "
                            f"{len(errors)}/{len(loads)} replica(s)"
                        ) from errors[0]
                    done: Future = Future()
                    self._events.put(
                        ("add_replicas", v, new_reps, rid_seq + count - have,
                         done))
                    per_version[v] = done.result(timeout=30.0)
                elif count < have:
                    done = Future()
                    self._events.put(("shrink_group", v, have - count, done))
                    per_version[v] = done.result(timeout=30.0)
                else:
                    per_version[v] = {"replicas": have, "unchanged": True}
            return {"replicas": count, "versions": per_version}

    def serving_report(self) -> Dict[str, Any]:
        """Counters + latency snapshot (the ``shuffle_stage_report`` twin
        for the serving plane; columns documented in doc/serving.md),
        including one row per live VERSION group — requests, failures,
        p50/p99 over its own window, weight, replica counts — the rollout
        judgment's input."""
        if self._closed and not self._dispatcher.is_alive():
            return self._report()  # post-close snapshot: nothing mutates
        done: Future = Future()
        self._events.put(("report", done))
        return done.result(timeout=30.0)

    def close(self, unload: bool = True) -> None:
        """Stop the dispatcher; in-flight work is failed, replicas unloaded
        (``unload=False`` keeps them for a successor session)."""
        if self._closed:
            return
        self._closed = True
        self._events.put(("stop",))
        self._dispatcher.join(timeout=30.0)
        if unload:
            # every live group's replicas plus any swapped-out version
            # still draining (the dispatcher is down: nothing retires them
            # now); single attempt each — the runtime is going away, so
            # the retry-probe path would just dial a stopping pool
            doomed = [r for g in self._groups for r in g.replicas]
            for _, reps, _ in self._retiring:
                doomed.extend(reps)
            self._retiring = []
            for rep in doomed:
                try:
                    rep.replica.call("serve_unload", rep.rid, timeout=10.0)
                except Exception:  # noqa: BLE001 - executor may be gone
                    pass

    def __enter__(self) -> "ServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- dispatcher internals (single thread) -------------------------------
    def _run(self) -> None:
        while True:
            timeout = self._next_wakeup()
            try:
                ev = self._events.get(timeout=timeout)
            except queue.Empty:
                ev = None
            try:
                if ev is not None:
                    kind = ev[0]
                    if kind == "stop":
                        self._drain_stop()
                        return
                    if kind == "req":
                        self._on_request(ev[1])
                    elif kind == "done":
                        self._on_done(ev[1], ev[2], ev[3], ev[4])
                    elif kind == "replica_up":
                        self._on_replica_up(ev[1], ev[2])
                    elif kind in ("swap_prep", "scale_prep"):
                        # a torn mid-rebind (handle, name) pair is what the
                        # dispatcher-thread copy exists to prevent
                        if kind == "swap_prep":
                            ev[1].set_result(
                                [(r.replica, r.executor)
                                 for r in self._primary.replicas])
                        else:
                            ev[1].set_result(
                                [(g.version, g.export_dir, g.rid_seq,
                                  [(r.replica, r.executor)
                                   for r in g.replicas])
                                 for g in self._groups])
                    elif kind == "swap":
                        self._on_swap(ev[1], ev[2], ev[3], ev[4], ev[5])
                    elif kind == "add_group":
                        self._on_add_group(ev[1], ev[2])
                    elif kind == "set_weight":
                        self._on_set_weight(ev[1], ev[2], ev[3])
                    elif kind == "promote":
                        self._on_promote(ev[1], ev[2])
                    elif kind == "drop_group":
                        self._on_drop_group(ev[1], ev[2])
                    elif kind == "add_replicas":
                        self._on_add_replicas(ev[1], ev[2], ev[3], ev[4])
                    elif kind == "shrink_group":
                        self._on_shrink_group(ev[1], ev[2], ev[3])
                    elif kind == "report":
                        ev[1].set_result(self._report())
                self._flush_batches()
                self._maybe_hedge()
                self._retry_parked()
                self._retire_swapped()
                # refresh on every loop pass (arrivals, flushes, drains
                # alike) so an idle session reads 0, not the last
                # pre-dispatch depth; labeled per session so two sessions
                # in one driver never overwrite each other's slot
                metrics.set_gauge("serve_queue_depth",
                                  len(self._pending) + len(self._inflight),
                                  label=self.name)
            except Exception:  # noqa: BLE001 - the loop must survive anything
                # a dead dispatcher bricks every current and future request;
                # per-batch/per-dispatch errors are already routed to their
                # own futures, so whatever reaches here is a bug to log,
                # never a reason to stop serving
                logger.exception("serving dispatcher error (loop continues)")

    def _next_wakeup(self) -> Optional[float]:
        """Sleep until the earliest deadline the loop owns: the oldest
        pending batch's flush, or the next hedge-eligibility instant."""
        deadlines = []
        if self._pending:
            deadlines.append(self._pending[0].t_enq + self._timeout_s)
        hedge_after = self._hedge_deadline()
        if hedge_after is not None:
            for d in self._inflight.values():
                if not d.hedged and not d.done:
                    deadlines.append(d.t_first + hedge_after)
        if self._parked:
            deadlines.append(time.monotonic() + 0.05)
        if self._retiring:
            deadlines.append(time.monotonic() + 0.05)
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - time.monotonic()) or 0.001

    # -- batching -------------------------------------------------------------
    def _on_request(self, req: _Request) -> None:
        self._stats["requests"] += 1
        metrics.inc("serve_requests_total")
        self._pending.append(req)
        self._pending_rows += req.rows
        self._queue_depth_peak = max(
            self._queue_depth_peak, len(self._pending) + len(self._inflight))

    def _flush_batches(self) -> None:
        while self._pending:
            full = self._pending_rows >= self._max_batch
            aged = (time.monotonic() - self._pending[0].t_enq
                    >= self._timeout_s)
            if not (full or aged):
                return
            # coalesce only schema-equal requests: a mixed batch would fail
            # pa.concat_tables and punish the well-formed requests packed
            # with it; the other-schema requests stay pending and form
            # their own batch on a later pass of this loop
            schema = self._pending[0].table.schema
            batch: List[_Request] = []
            rows = 0
            rest: List[_Request] = []
            for r in self._pending:
                if (batch and rows + r.rows > self._max_batch) \
                        or not r.table.schema.equals(schema):
                    rest.append(r)
                    continue
                batch.append(r)
                rows += r.rows
            self._pending = rest
            self._pending_rows -= rows
            self._dispatch_new(batch, rows)

    def _dispatch_new(self, batch: List[_Request], rows: int) -> None:
        parts, off = [], 0
        for r in batch:
            parts.append((r, off))
            off += r.rows
        try:
            table = (batch[0].table if len(batch) == 1
                     else pa.concat_tables([r.table for r in batch]))
            payload = _encode(table)
        except Exception as e:  # noqa: BLE001 - a bad request fails fast
            self._stats["failed"] += len(batch)
            for r in batch:
                if not r.fut.done():
                    r.fut.set_exception(e)
            return
        # the version is chosen ONCE, at dispatch birth: whatever happens
        # to this batch later (re-route, hedge, park) stays inside the
        # chosen version's replica set
        group = self._choose_version()
        d = _Dispatch(next(self._did), payload, rows, parts, group.version)
        self._stats["batches"] += 1
        self._stats["rows"] += rows
        metrics.inc("serve_batches_total")
        metrics.inc("serve_rows_total", rows)
        metrics.observe("serve_batch_occupancy_rows", rows)
        self._occupancy.append(rows)
        if len(self._occupancy) > _LAT_WINDOW:
            del self._occupancy[:-_LAT_WINDOW]
        self._submit(d, hedge=False)

    # -- routing --------------------------------------------------------------
    def _group(self, version: int) -> Optional[_VersionGroup]:
        for g in self._groups:
            if g.version == version:
                return g
        return None

    def _vlabel(self, g: _VersionGroup) -> str:
        return f"{self.name}:v{g.version}"

    def _choose_version(self) -> _VersionGroup:
        """Smooth weighted round-robin over the live version groups: each
        candidate accrues its weight in credit, the highest credit wins and
        pays back the total — a deterministic interleave whose long- AND
        short-run split matches the weight table (nginx's algorithm). A
        weight-0 group gets nothing; with every weight 0 (transient
        rollback states) the primary serves."""
        live = [g for g in self._groups if g.weight > 0 and g.replicas]
        if not live:
            return self._primary
        if len(live) == 1:
            return live[0]
        total = 0.0
        best = None
        for g in live:
            g.wrr += g.weight
            total += g.weight
            if best is None or g.wrr > best.wrr:
                best = g
        best.wrr -= total
        return best

    def _choose(self, d: _Dispatch) -> Optional[_ReplicaState]:
        """Least-busy ready replica OF THIS DISPATCH'S VERSION not already
        carrying it, round-robin on ties, respecting the per-replica
        in-flight cap — except when EVERY ready replica is at cap, where
        the least-busy one is taken anyway (a serving request must queue,
        not park forever). A dispatch whose version group was dropped
        (rolled back) before any replica answered re-homes to the primary —
        it was never answered, so no response mixes versions."""
        g = self._group(d.version)
        if g is None or not g.replicas:
            g = self._primary
            if d.version != g.version:
                d.version = g.version
                d.tried.clear()
        reps = g.replicas
        start = next(self._rr)
        k = len(reps)
        best = None
        for allow_full in (False, True):
            for i in range(k):
                rep = reps[(start + i) % k]
                if not rep.ready or rep.rid in d.tried:
                    continue
                if not allow_full and rep.inflight >= self._max_inflight:
                    continue
                if best is None or rep.inflight < best.inflight:
                    best = rep
            if best is not None:
                return best
        return None

    def _submit(self, d: _Dispatch, hedge: bool) -> bool:
        """Route and send one attempt; True only when an attempt is
        actually in flight (the hedge accounting keys on it)."""
        rep = self._choose(d)
        if rep is None:
            if hedge:
                return False  # no second replica free: simply do not hedge
            self._park(d)
            return False
        d.tried.add(rep.rid)
        t0 = time.monotonic()
        span = "serve:hedge" if hedge else "serve:batch"
        try:
            # the span covers the driver-side submit (encode happened at
            # coalesce time); the replica-side serve:apply span carries the
            # device half of the timeline. The batch joins the FIRST
            # coalesced request's trace (a batch has one parent lane; the
            # sibling requests' spans still record their own latency), so
            # the RPC layer ships serve:batch as the remote apply's parent
            with profiler.activate(d.parts[0][0].ctx if d.parts else None):
                with profiler.trace(span, "serve", replica=rep.rid,
                                    rows=d.rows, requests=len(d.parts)):
                    replica = rep.replica
                    fut = replica.submit("serve_predict", rep.rid, d.payload)
        except (ConnectionLost, OSError) as e:
            # the executor is unreachable (restarting): take the replica out
            # of rotation, start its background reload, and re-route
            self._note_replica_error(_Attempt(rep, t0, hedge), e)
            self._attempt_failed(d, rep, e)
            return False
        rep.inflight += 1
        rep.inflight_peak = max(rep.inflight_peak, rep.inflight)
        rep.batches += 1
        rep.requests += len(d.parts)
        rep.rows += d.rows
        if hedge:
            rep.hedges += 1
        aid = id(fut)
        d.attempts[aid] = _Attempt(rep, t0, hedge)
        self._inflight[d.id] = d

        def _cb(f, did=d.id, aid=aid, rid=rep.rid):
            # client read-loop thread: enqueue only, never block
            self._events.put(("done", did, aid, rid, f))

        fut.add_done_callback(_cb)
        return True

    def _park(self, d: _Dispatch) -> None:
        """No routable replica right now (all restarting/reloading): hold
        the dispatch and retry as replicas come back, up to the grace."""
        if time.monotonic() - d.t_first > self._reroute_grace_s:
            self._fail_dispatch(d)
            return
        if d not in self._parked:
            # a parked dispatch may be re-tried on any replica again once
            # one reloads — a reloaded replica is a FRESH process
            d.tried.clear()
            self._parked.append(d)
        # parked work is the strongest signal a dead replica is still
        # needed: re-kick any reload that previously gave up, so a
        # transient full outage longer than one reload pass does not brick
        # the session for its remaining lifetime
        for g in self._groups:
            for rep in g.replicas:
                if not rep.ready and not rep.reloading:
                    rep.reloading = True
                    threading.Thread(
                        target=self._reload, args=(rep,), daemon=True,
                        name=f"rdt-serve-reload-{rep.rid}").start()

    def _retry_parked(self) -> None:
        if not self._parked:
            return
        parked, self._parked = self._parked, []
        for d in parked:
            if not d.done:
                self._submit(d, hedge=False)

    # -- completion / hedging / fault path ------------------------------------
    def _on_done(self, did: int, aid: int, rid: str, fut: Future) -> None:
        d = self._inflight.get(did)
        if d is None:
            return
        att = d.attempts.pop(aid, None)
        if att is not None:
            att.replica.inflight = max(0, att.replica.inflight - 1)
        err = fut.exception()
        if d.done:
            # the loser of a won hedge (or of a rescue): discard, count
            if err is None and att is not None:
                self._stats["hedge_lost"] += 1
                metrics.inc("serve_hedge_lost_total")
            if not d.attempts:
                self._inflight.pop(did, None)
            if err is not None:
                self._note_replica_error(att, err)
            return
        if err is None:
            d.done = True
            if att is not None and att.hedge:
                self._stats["hedge_won"] += 1
                metrics.inc("serve_hedge_won_total")
            now = time.monotonic()
            if att is not None:
                self._batch_lat.append(now - att.t0)
                if len(self._batch_lat) > _LAT_WINDOW:
                    del self._batch_lat[:-_LAT_WINDOW]
            g = self._group(d.version)
            preds = np.asarray(fut.result())
            for req, off in d.parts:
                if not req.fut.done():  # close()/race-failed futures skip
                    req.fut.set_result(preds[off:off + req.rows])
                self._req_lat.append(now - req.t_enq)
                metrics.observe("serve_request_seconds", now - req.t_enq)
                if g is not None:
                    g.req_lat.append(now - req.t_enq)
                    metrics.observe("serve_version_request_seconds",
                                    now - req.t_enq, label=self._vlabel(g))
                req.finish(replica=rid)
            if len(self._req_lat) > _LAT_WINDOW:
                del self._req_lat[:-_LAT_WINDOW]
            if g is not None:
                g.requests += len(d.parts)
                metrics.inc("serve_version_requests_total", len(d.parts),
                            label=self._vlabel(g))
                if len(g.req_lat) > _LAT_WINDOW:
                    del g.req_lat[:-_LAT_WINDOW]
            if not d.attempts:
                self._inflight.pop(did, None)
            return
        # failed attempt
        self._note_replica_error(att, err)
        self._attempt_failed(d, att.replica if att else None, err)

    def _attempt_failed(self, d: _Dispatch, rep: Optional[_ReplicaState],
                        err: BaseException) -> None:
        d.last_error = err
        if d.attempts:
            return  # a sibling copy is still racing; it may still win
        if not _reroutable(err):
            # deterministic application error (bad schema, model bug):
            # another replica would compute the same failure — fail the
            # request now instead of burning the re-route grace on it
            self._fail_dispatch(d)
            return
        if time.monotonic() - d.t_first > self._reroute_grace_s:
            self._fail_dispatch(d)
            return
        self._stats["rerouted"] += 1
        metrics.inc("serve_rerouted_total")
        logger.warning("serve dispatch %d (v%d) re-routing off %s after: %s",
                       d.id, d.version, rep.rid if rep else "?", err)
        self._submit(d, hedge=False)

    def _fail_dispatch(self, d: _Dispatch) -> None:
        d.done = True
        self._inflight.pop(d.id, None)
        self._stats["failed"] += len(d.parts)
        metrics.inc("serve_failed_total", len(d.parts))
        g = self._group(d.version)
        if g is not None:
            g.failed += len(d.parts)
            metrics.inc("serve_version_failed_total", len(d.parts),
                        label=self._vlabel(g))
        err = ServingError(
            f"request failed on every replica within "
            f"{self._reroute_grace_s:.0f}s (last error: {d.last_error})")
        err.__cause__ = d.last_error
        for req, _ in d.parts:
            if not req.fut.done():
                req.fut.set_exception(err)
            req.finish(failed=True)
        metrics.record_event("request_failed", dispatch=d.id,
                             version=d.version, requests=len(d.parts),
                             last_error=str(d.last_error)[:300])
        # the ServingError postmortem bundle (doc/observability.md) — on a
        # BACKGROUND thread: the harvest RPCs every live process with a 10s
        # timeout each, and this runs on the dispatcher event loop, which
        # must keep batching/hedging/demuxing the session's OTHER requests
        # (a hung executor is exactly the scenario that got us here).
        # Capped per label inside write_blackbox, best-effort by contract.
        threading.Thread(target=self._write_blackbox_bg, args=(err,),
                         daemon=True,
                         name=f"rdt-serve-blackbox-{self.name}").start()

    def _write_blackbox_bg(self, err: BaseException) -> None:
        try:
            path = metrics.write_blackbox(f"serve-{self.name}", err)
            if path:
                logger.warning("serve request failed on every replica; "
                               "flight-recorder bundle written to %s", path)
        except Exception:  # noqa: BLE001 - never mask the request failure
            logger.warning("blackbox harvest for failed serve dispatch "
                           "failed", exc_info=True)

    def _note_replica_error(self, att: Optional[_Attempt],
                            err: BaseException) -> None:
        """Infra errors take the replica out of rotation and start a
        background reload; app errors (a bad request) leave it serving."""
        if att is None:
            return
        rep = att.replica
        not_loaded = (isinstance(err, RemoteError)
                      and err.exc_type == "ReplicaNotLoaded")
        if not (isinstance(err, ConnectionLost) or not_loaded):
            return
        if rep.reloading:
            return
        rep.ready = False
        rep.reloading = True
        metrics.record_event("replica_down", replica=rep.rid,
                             executor=rep.executor,
                             error=type(err).__name__)
        threading.Thread(target=self._reload, args=(rep,), daemon=True,
                         name=f"rdt-serve-reload-{rep.rid}").start()

    def _reload(self, rep: _ReplicaState) -> None:
        """Background: wait out the executor restart and reload the
        servable, then hand the replica back to the dispatcher. Reloads the
        replica's OWN bundle (``rep.export_dir``) — a canary replica must
        come back as the canary, not as whatever the primary moved to.
        Routed through the pool's live-member view: an executor that was
        RETIRED (drained out of the session) never comes back under its old
        handle, so the replica re-binds onto a surviving member and loads
        there — probing the corpse until the grace expired was exactly the
        fixed-identity bug this replaces."""
        deadline = time.monotonic() + self._reroute_grace_s
        last: Optional[BaseException] = None
        fails = 0
        while time.monotonic() < deadline:
            if self._closed:
                return  # session gone: stop dialing a stopped runtime
            try:
                replica = rep.replica
                replica.call("serve_load", rep.rid, rep.export_dir,
                             self._device, timeout=60.0)
                self._events.put(("replica_up", rep, None))
                return
            except Exception as e:  # noqa: BLE001 - keep probing the restart
                last = e
                fails += 1
                if self._maybe_rebind(rep, fails):
                    # fresh target: it earns its own probe allowance (a
                    # carried-over count would ping-pong the replica
                    # between live members on every failed probe)
                    fails = 0
                time.sleep(0.5)
        logger.error("replica %s did not come back within %.0fs: %s",
                     rep.rid, self._reroute_grace_s, last)
        self._events.put(("replica_up", rep, last))

    def _live_executors(self) -> List:
        """The owning session's current pool members (empty without one)."""
        if self._session is None:
            return []
        try:
            return [h for h in list(self._session.executors)
                    if getattr(h, "name", None)]
        except Exception:  # noqa: BLE001 - a stopping session reads as none
            return []

    def _all_replicas(self) -> List[_ReplicaState]:
        return [r for g in self._groups for r in g.replicas]

    def _maybe_rebind(self, rep: _ReplicaState, fails: int) -> bool:
        """Re-home a reloading replica whose executor left the pool: once
        the bound executor is no longer a live member (retired/reaped), or
        keeps refusing while live alternatives exist, bind the replica to
        the live member hosting the fewest replicas and let the reload loop
        land it there (True = the binding changed). The dispatcher reads
        ``rep.replica`` concurrently — a plain attribute swap, and either
        handle is safe to dial (a lost submit re-routes through the
        ordinary fault path)."""
        live = self._live_executors()
        if not live:
            return False
        names = {h.name for h in live}
        still_member = rep.executor in names
        # a live member may just be restarting in place: give it a few
        # probes before abandoning locality; a NON-member never returns
        if still_member and fails < 4:
            return False
        counts: Dict[str, int] = {}
        all_reps = self._all_replicas()
        for r in all_reps:
            counts[r.executor] = counts.get(r.executor, 0) + 1
        target = min(live, key=lambda h: (counts.get(h.name, 0)
                                          if h.name != rep.executor
                                          else len(all_reps) + 1))
        if target.name == rep.executor:
            return False
        logger.warning("replica %s re-homing from %s executor %s to %s",
                       rep.rid, "retired" if not still_member else "dead",
                       rep.executor, target.name)
        if still_member:
            # abandoning a LIVE member (persistent refusals, e.g. a long
            # GC pause): best-effort unload there, or a merely-unreachable
            # process would keep the rid's servable weights in RAM forever
            try:
                rep.replica.call("serve_unload", rep.rid, timeout=10.0)
            except Exception:  # noqa: BLE001 - it may really be dead
                pass
        rep.replica = target
        rep.executor = target.name
        return True

    def _on_replica_up(self, rep: _ReplicaState,
                       err: Optional[BaseException]) -> None:
        rep.reloading = False
        if err is None:
            rep.ready = True
            rep.reloads += 1
            rep.inflight = 0
            metrics.record_event("replica_up", replica=rep.rid,
                                 executor=rep.executor)
            logger.info("replica %s reloaded and back in rotation", rep.rid)

    # -- hot swap / version lifecycle (dispatcher side) -----------------------
    def _on_swap(self, new_reps: List[_ReplicaState], export_dir: str,
                 version: int, tag: Optional[str], done: Future) -> None:
        """The atomic half of :meth:`hot_swap`: one dispatcher step swaps
        the primary group, so a dispatch either chose the old version or
        the new one — never a mix, never a gap. Canary groups (if any)
        keep their weights and replicas."""
        old = self._primary
        group = _VersionGroup(version, export_dir, tag, new_reps,
                              weight=old.weight)
        self._groups[self._groups.index(old)] = group
        self._primary = group
        self.export_dir = export_dir
        self._swaps += 1
        self._retiring.append(
            (time.monotonic() + self._swap_drain_s, old.replicas,
             old.version))
        metrics.inc("serve_hot_swaps_total")
        metrics.record_event("hot_swap", session=self.name, version=version,
                             export_dir=export_dir, tag=tag or "")
        logger.info("serving session %s hot-swapped to v%d (%s%s); v%d "
                    "retiring behind %d in-flight dispatch(es)", self.name,
                    version, export_dir, f", tag={tag}" if tag else "",
                    old.version, sum(r.inflight for r in old.replicas))
        done.set_result({"version": version, "export_dir": export_dir,
                         "tag": tag,
                         "replicas": [r.rid for r in new_reps]})

    def _on_add_group(self, group: _VersionGroup, done: Future) -> None:
        self._groups.append(group)
        metrics.set_gauge("serve_version_weight", group.weight,
                          label=self._vlabel(group))
        metrics.set_gauge("serve_version_replicas", len(group.replicas),
                          label=self._vlabel(group))
        logger.info("serving session %s added v%d (%s) at weight %.3g "
                    "(%d replica(s))", self.name, group.version,
                    group.export_dir, group.weight, len(group.replicas))
        done.set_result({"version": group.version,
                         "export_dir": group.export_dir,
                         "tag": group.tag, "weight": group.weight,
                         "replicas": [r.rid for r in group.replicas]})

    def _on_set_weight(self, version: int, weight: float,
                       done: Future) -> None:
        g = self._group(version)
        if g is None:
            done.set_exception(ServingError(
                f"no live version v{version} in session {self.name!r}"))
            return
        g.weight = weight
        # fresh credit all around: the new split starts NOW, not after the
        # old credits drain through
        for grp in self._groups:
            grp.wrr = 0.0
        metrics.set_gauge("serve_version_weight", weight,
                          label=self._vlabel(g))
        done.set_result({"version": version, "weight": weight})

    def _on_promote(self, version: int, done: Future) -> None:
        g = self._group(version)
        if g is None:
            done.set_exception(ServingError(
                f"no live version v{version} to promote"))
            return
        if g is self._primary:
            done.set_result({"version": version, "already_primary": True})
            return
        old = self._primary
        self._groups.remove(old)
        g.weight = 1.0
        g.wrr = 0.0
        self._primary = g
        self.export_dir = g.export_dir
        self._swaps += 1
        self._retiring.append(
            (time.monotonic() + self._swap_drain_s, old.replicas,
             old.version))
        metrics.inc("serve_hot_swaps_total")
        metrics.set_gauge("serve_version_weight", 1.0, label=self._vlabel(g))
        metrics.set_gauge("serve_version_weight", 0.0,
                          label=self._vlabel(old))
        metrics.record_event("hot_swap", session=self.name,
                             version=g.version, export_dir=g.export_dir,
                             tag=g.tag or "", promoted=True)
        logger.info("serving session %s promoted v%d to primary; v%d "
                    "retiring behind %d in-flight dispatch(es)", self.name,
                    g.version, old.version,
                    sum(r.inflight for r in old.replicas))
        done.set_result({"version": g.version, "export_dir": g.export_dir,
                         "tag": g.tag, "retired": old.version})

    def _on_drop_group(self, version: int, done: Future) -> None:
        g = self._group(version)
        if g is None:
            done.set_exception(ServingError(
                f"no live version v{version} to drop"))
            return
        if g is self._primary:
            done.set_exception(ServingError(
                "cannot drop the primary version; promote another first"))
            return
        self._groups.remove(g)
        self._retiring.append(
            (time.monotonic() + self._swap_drain_s, g.replicas, g.version))
        metrics.set_gauge("serve_version_weight", 0.0,
                          label=self._vlabel(g))
        metrics.set_gauge("serve_version_replicas", 0,
                          label=self._vlabel(g))
        logger.info("serving session %s dropped v%d (%d replica(s) "
                    "retiring)", self.name, version, len(g.replicas))
        done.set_result({"version": version,
                         "requests": g.requests, "failed": g.failed,
                         "replicas": [r.rid for r in g.replicas]})

    def _on_add_replicas(self, version: int, reps: List[_ReplicaState],
                         rid_seq: int, done: Future) -> None:
        g = self._group(version)
        if g is None:
            # the group was dropped between the blocking load and this
            # step: retire the freshly loaded replicas instead of leaking
            self._retiring.append((time.monotonic(), reps, version))
            done.set_exception(ServingError(
                f"version v{version} disappeared during scale-up"))
            return
        g.replicas.extend(reps)
        g.rid_seq = max(g.rid_seq, rid_seq)
        metrics.set_gauge("serve_version_replicas", len(g.replicas),
                          label=self._vlabel(g))
        done.set_result({"version": version, "replicas": len(g.replicas),
                         "added": [r.rid for r in reps]})

    def _on_shrink_group(self, version: int, n: int, done: Future) -> None:
        g = self._group(version)
        if g is None:
            done.set_exception(ServingError(
                f"no live version v{version} to shrink"))
            return
        n = min(n, max(0, len(g.replicas) - 1))  # never below one replica
        # drain the least-busy first (ready replicas with work pending are
        # the ones actually carrying the load); not-ready replicas are the
        # cheapest victims of all
        victims = sorted(g.replicas,
                         key=lambda r: (r.ready, r.inflight))[:n]
        for r in victims:
            g.replicas.remove(r)
        if victims:
            self._retiring.append(
                (time.monotonic() + self._swap_drain_s, victims, version))
        metrics.set_gauge("serve_version_replicas", len(g.replicas),
                          label=self._vlabel(g))
        done.set_result({"version": version, "replicas": len(g.replicas),
                         "removed": [r.rid for r in victims]})

    def _retire_swapped(self) -> None:
        """Unload swapped-out versions (and scaled-down replicas) once
        their in-flight dispatches drained (or the ``RDT_SERVE_SWAP_DRAIN_S``
        deadline passed — the straggler requests still complete; only the
        registry entry goes)."""
        if not self._retiring:
            return
        keep = []
        for deadline, reps, ver in self._retiring:
            if all(r.inflight <= 0 for r in reps) \
                    or time.monotonic() >= deadline:
                # the unloads are RPCs with their own timeouts: background
                # thread, never the dispatcher loop
                threading.Thread(
                    target=self._unload_replicas, args=(reps, ver),
                    daemon=True,
                    name=f"rdt-serve-retire-{self.name}-v{ver}").start()
            else:
                keep.append((deadline, reps, ver))
        self._retiring = keep

    def _unload_replicas(self, reps: List[_ReplicaState], ver: int) -> None:
        """Unload retired replicas, RETRIED through the reload-probe shape:
        an executor mid-restart refuses now but answers within the grace,
        so fire-and-forget here used to leave the servable's weights pinned
        in the restarted process's RAM forever. An executor that left the
        pool entirely (retired member) took the registry down with its
        process — that counts as unloaded. A replica that still refuses at
        the deadline is counted LOUDLY (``serve_unload_failed_total`` + an
        ``unload_failed`` event) instead of silently leaking."""
        deadline = time.monotonic() + self._reroute_grace_s
        failed = 0
        for rep in reps:
            last: Optional[BaseException] = None
            while True:
                try:
                    rep.replica.call("serve_unload", rep.rid, timeout=10.0)
                    last = None
                    break
                except Exception as e:  # noqa: BLE001 - probe the restart
                    last = e
                    live = self._live_executors()
                    if live and rep.executor not in {h.name for h in live}:
                        # the executor is out of the pool: its process (and
                        # the replica registry pinning the weights) is gone
                        last = None
                        break
                    if self._closed or time.monotonic() >= deadline:
                        break
                    time.sleep(0.5)
            if last is not None:
                failed += 1
                metrics.inc("serve_unload_failed_total")
                metrics.record_event("unload_failed", session=self.name,
                                     replica=rep.rid, executor=rep.executor,
                                     version=ver, error=str(last)[:200])
                logger.error(
                    "replica %s (v%d) refused serve_unload on %s within "
                    "%.0fs — its servable weights stay pinned in that "
                    "process: %s", rep.rid, ver, rep.executor,
                    self._reroute_grace_s, last)
        logger.info("serving session %s retired servable v%d "
                    "(%d/%d replica(s) unloaded)", self.name, ver,
                    len(reps) - failed, len(reps))

    # -- hedging --------------------------------------------------------------
    def _hedge_deadline(self) -> Optional[float]:
        """Seconds after which an in-flight dispatch earns a hedge, or None
        while hedging is off / unwarmed / pointless (no version group holds
        a second replica to race)."""
        if not self._hedge_on \
                or not any(len(g.replicas) >= 2 for g in self._groups):
            return None
        if len(self._batch_lat) < _HEDGE_MIN_SAMPLES:
            return None
        return max(self._hedge_mult * _quantile(self._batch_lat,
                                                self._hedge_q),
                   self._hedge_min_s)

    def _maybe_hedge(self) -> None:
        if self._shedding():
            return  # hedges amplify overload; suppressed while saturated
        deadline = self._hedge_deadline()
        if deadline is None:
            return
        now = time.monotonic()
        for d in list(self._inflight.values()):
            if d.done or d.hedged or not d.attempts:
                continue
            # hedges are VERSION-LOCAL: the duplicate races a sibling of
            # the same servable, so a canary never answers a baseline
            # request (and vice versa) through the hedge path
            g = self._group(d.version)
            if g is None or len(g.replicas) < 2:
                continue
            if now - d.t_first >= deadline:
                # count (and retire) the hedge only once it is really in
                # flight: with the sibling replica reloading/at-fault the
                # dispatch stays eligible and retries on a later tick
                if self._submit(d, hedge=True):
                    d.hedged = True
                    self._stats["hedged"] += 1
                    metrics.inc("serve_hedged_total")
                    metrics.record_event("hedge", dispatch=d.id,
                                         rows=d.rows)

    # -- reporting / teardown -------------------------------------------------
    def _report(self) -> Dict[str, Any]:
        lat = sorted(self._req_lat)
        occ = self._occupancy
        out = dict(self._stats)
        with self._adm_lock:
            shed = self._shed_count
            outstanding = self._outstanding
        # a shed request IS a failed request from the caller's view, so
        # ``failed`` includes ``shed`` — a clean overload run reads
        # failed == shed (nothing failed except typed rejections)
        out["shed"] = shed
        out["failed"] = out["failed"] + shed
        primary = self._primary
        replica_rows = []
        version_rows = []
        for g in sorted(self._groups,
                        key=lambda x: (x is not primary, x.version)):
            glat = sorted(g.req_lat)
            version_rows.append({
                "version": g.version,
                "export_dir": g.export_dir,
                "tag": g.tag,
                "weight": g.weight,
                "primary": g is primary,
                "requests": g.requests,
                "failed": g.failed,
                # admission sheds precede version choice (no dispatch
                # exists yet to attribute): charged to the primary, whose
                # saturation they are
                "shed": shed if g is primary else 0,
                "p50_ms": round(_quantile(glat, 0.50) * 1000.0, 3),
                "p99_ms": round(_quantile(glat, 0.99) * 1000.0, 3),
                "lat_n": len(glat),
                "replicas": len(g.replicas),
                "ready": sum(1 for r in g.replicas if r.ready),
            })
            for r in g.replicas:
                replica_rows.append({
                    "replica": r.rid,
                    "version": g.version,
                    "executor": r.executor,
                    "ready": r.ready,
                    "requests": r.requests,
                    "batches": r.batches,
                    "rows": r.rows,
                    "hedges": r.hedges,
                    "inflight": r.inflight,
                    "inflight_peak": r.inflight_peak,
                    "reloads": r.reloads,
                })
        out.update({
            # which model answers the PRIMARY traffic right now: the active
            # servable's version, bundle dir, and the tag the swapper
            # attached (partial_fit's source epoch) — what the bench/chaos
            # legs assert on
            "servable": {"version": primary.version,
                         "export_dir": primary.export_dir,
                         "tag": primary.tag},
            "hot_swaps": self._swaps,
            "versions": version_rows,
            "retiring_replicas": sum(len(reps)
                                     for _, reps, _ in self._retiring),
            "outstanding": outstanding,
            "max_queue": self._max_queue,
            "max_inflight": self._max_inflight,
            "shedding": self._max_queue > 0 and outstanding >= self._max_queue,
            "p50_ms": round(_quantile(lat, 0.50) * 1000.0, 3),
            "p99_ms": round(_quantile(lat, 0.99) * 1000.0, 3),
            "mean_batch_occupancy": (round(sum(occ) / len(occ), 2)
                                     if occ else 0.0),
            "max_batch_occupancy": max(occ) if occ else 0,
            "queue_depth": len(self._pending) + len(self._inflight),
            "queue_depth_peak": self._queue_depth_peak,
            "replicas": replica_rows,
        })
        return out

    def _drain_stop(self) -> None:
        err = ServingError("serving session closed with requests in flight")
        for req in self._pending:
            if not req.fut.done():
                req.fut.set_exception(err)
            req.finish(failed=True)
        self._pending = []
        for d in list(self._inflight.values()) + self._parked:
            if not d.done:
                for req, _ in d.parts:
                    if not req.fut.done():
                        req.fut.set_exception(err)
                    req.finish(failed=True)
        self._inflight.clear()
        self._parked = []
        # requests enqueued behind the stop event would otherwise hold
        # futures nobody ever completes
        while True:
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                break
            if ev[0] == "req":
                if not ev[1].fut.done():
                    ev[1].fut.set_exception(err)
                ev[1].finish(failed=True)
            elif ev[0] in ("swap_prep", "scale_prep"):
                if not ev[1].done():
                    ev[1].set_exception(
                        ServingError("serving session closed mid-swap"))
            elif ev[0] in ("swap", "add_group", "add_replicas"):
                # the new version/replicas DID load on the executors:
                # unload them (in the background — these are RPCs) instead
                # of leaving their weights pinned in executor RAM forever
                if ev[0] == "swap":
                    reps, ver, done = ev[1], ev[3], ev[5]
                elif ev[0] == "add_group":
                    reps, ver, done = ev[1].replicas, ev[1].version, ev[2]
                else:
                    reps, ver, done = ev[2], ev[1], ev[4]
                threading.Thread(
                    target=self._unload_replicas, args=(reps, ver),
                    daemon=True,
                    name=f"rdt-serve-drainswap-{self.name}").start()
                if not done.done():
                    done.set_exception(
                        ServingError("serving session closed mid-swap"))
            elif ev[0] in ("set_weight", "promote", "drop_group",
                           "shrink_group"):
                done = ev[-1]
                if not done.done():
                    done.set_exception(
                        ServingError("serving session closed"))
            elif ev[0] == "report":
                ev[1].set_result(self._report())
