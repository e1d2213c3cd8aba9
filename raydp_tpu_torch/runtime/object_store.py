"""Shared-memory object store: the plasma-equivalent data plane.

The reference's data plane is Ray's plasma store: Spark executors serialize Arrow IPC
partitions into shared memory, Python training workers map them zero-copy, and an
ownership protocol decides lifetime (SURVEY.md §2.5; reference
RayDPUtils.java:45-53 ``readBinary`` is the zero-copy handoff kernel;
dataset.py:137-158 transfers object ownership to the master actor so data outlives
Spark). This module provides the native equivalent:

- every object is one POSIX shared-memory segment (``/dev/shm``), written once and
  sealed; readers attach and get a zero-copy ``memoryview``;
- a metadata server (thread in the head process) keeps the object table:
  ``id -> (segment, size, kind, owner)``;
- objects are *owned*: when their owning actor dies un-transferred, they are freed;
  ``transfer_ownership`` re-homes them (parity with ``get_raydp_master_owner``,
  dataset.py:137-158);
- Arrow payloads round-trip as IPC streams so a reader can decode a table without
  copying the body buffers (``pa.ipc.open_stream(pa.py_buffer(view))``).

Payload layout has two modes behind the same client API:

- **native arena** (default when the C++ core builds): all payloads live in one
  session-wide shared-memory segment carved by the C++ slab allocator
  (``csrc/store/arena.cpp``, bound via :mod:`raydp_tpu_torch.native.arena`). Writers
  ``rdt_alloc`` from any process; readers attach the one segment once and slice
  zero-copy views — one mmap per process instead of one per object;
- **per-object segments** (fallback): each object is its own ``/dev/shm``
  segment, written once and sealed.

The metadata entry records ``offset >= 0`` for arena-resident payloads.
"""

from __future__ import annotations

import collections
import os
import secrets
import threading
import time as _time_mod
from concurrent.futures import Future
from dataclasses import dataclass, field
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle
import pyarrow as pa

from raydp_tpu_torch import faults, metrics
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch import knobs
from raydp_tpu_torch.runtime.rpc import DeferredReply

logger = get_logger("object_store")


class ObjectLostError(KeyError):
    """A store blob is gone or unreachable: the table has no entry (freed,
    owner died, host purged) or the payload plane cannot serve it. Typed so
    the ETL engine can tell this apart from deterministic application errors
    (which fail fast) and route it into lineage recovery — retrying the
    consumer task would just replay the miss until the retry budget burns.

    Carried across processes as ``RemoteError.exc_type == "ObjectLostError"``
    with the 32-hex object id embedded in the message, which is how the
    driver learns *which* blob to regenerate."""

    def __init__(self, object_id: str, detail: str = ""):
        msg = f"object {object_id} lost from store"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.object_id = object_id
        # flight recorder: constructed exactly at loss-detection sites, so
        # recording here covers every raise path (local KeyError translate,
        # RPC-proxied RemoteError, vanished segment, dead payload host)
        try:
            metrics.inc("store_objects_lost_total")
            metrics.record_event("object_lost", oid=object_id, detail=detail)
        except Exception:  # noqa: BLE001 - telemetry never masks the loss
            pass

    # not KeyError.__str__: loss messages must not render repr-quoted in
    # logs, RemoteError.message, and ObjectsLostError text
    __str__ = Exception.__str__


class ShuffleStreamAborted(RuntimeError):
    """A pipelined-shuffle seal stream ended without completing: its map
    stage failed (the driver published an abort) or the stage was closed /
    never began (a drain-abandoned reducer polling after its action ended).
    Deterministic from the reducer's point of view — retrying the consumer
    replays the same abort — so the engine treats it as no-retry and the
    stage fails fast with the abort's message (which carries the map-stage
    error when there was one)."""


class _StreamStage:
    """Seal ledger of ONE pipelined shuffle stage: the latest generation of
    every map task's consolidated blob (``map_id -> (gen, ref_id, blob_size,
    bucket_index)``). A regenerated producer re-seals under the same map_id
    with a higher generation; reducers holding the older generation's decoded
    portion keep it (reruns are byte-identical), reducers whose fetch of the
    stale range fails refetch the newer one."""

    __slots__ = ("num_maps", "seals", "aborted")

    def __init__(self, num_maps: Optional[int]):
        self.num_maps = num_maps
        self.seals: Dict[int, Tuple[int, str, int, list]] = {}
        self.aborted: Optional[str] = None


class ShuffleStreamLedger:
    """Seal-notification plane of the pipelined shuffle (head-resident, next
    to the object table): the driver publishes ``(map_id, ref, per-bucket
    offset/size index)`` as each map task's consolidated blob seals — only
    the WINNING attempt's result reaches the driver, so a speculation loser
    never publishes — and already-dispatched reduce tasks long-poll for the
    events of their bucket, beginning ranged fetch + Arrow decode while the
    map tail is still running.

    Long-polls do not park an RPC dispatcher thread: ``poll`` returns a
    :class:`~raydp_tpu_torch.runtime.rpc.DeferredReply` whose future completes on
    the next publish/abort/close or when the poll timeout lapses (a lazy
    sweeper thread that exits whenever no waiter is outstanding)."""

    TOMBSTONES = 1024  # closed stage keys remembered so late polls abort

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stages: Dict[str, _StreamStage] = {}  # guarded-by: _lock
        # guarded-by: _lock
        self._closed: "collections.OrderedDict[str, bool]" = \
            collections.OrderedDict()
        self._waiters: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._sweeper: Optional[threading.Thread] = None  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock

    # -- driver side ----------------------------------------------------------
    def begin(self, stage_key: str, num_maps: int) -> None:
        with self._lock:
            st = self._stages.get(stage_key)
            if st is None:
                self._stages[stage_key] = _StreamStage(int(num_maps))
            else:
                st.num_maps = int(num_maps)

    def publish(self, stage_key: str, map_id: int, gen: int, ref_id: str,
                size: int, index: Sequence[Sequence[int]]) -> None:
        with self._lock:
            st = self._stages.get(stage_key)
            if st is None:
                # a legitimate publish always follows stream_begin, so an
                # unknown key is a late republish after the action closed
                # (possibly past the tombstone window) — drop it rather
                # than resurrect a stage no close() would ever remove
                return
            cur = st.seals.get(int(map_id))
            if cur is None or int(gen) > cur[0]:
                st.seals[int(map_id)] = (int(gen), ref_id, int(size),
                                         [tuple(e) for e in index])
            ready = self._collect_ready_locked(stage_key)
        self._complete(ready)

    def abort(self, stage_key: str, message: str) -> None:
        with self._lock:
            st = self._stages.get(stage_key)
            if st is None:
                return  # already closed (pollers abort via the tombstone
                #         / unknown-key path) — never resurrect the stage
            if st.aborted is None:
                st.aborted = str(message)
            ready = self._collect_ready_locked(stage_key)
        self._complete(ready)

    def close(self, stage_keys: Sequence[str]) -> None:
        ready: List[Tuple[Future, Dict[str, Any]]] = []
        with self._lock:
            for key in stage_keys:
                self._stages.pop(key, None)
                self._closed[key] = True
                while len(self._closed) > self.TOMBSTONES:
                    self._closed.popitem(last=False)
                ready.extend(self._collect_ready_locked(key))
        self._complete(ready)

    # -- reducer side ---------------------------------------------------------
    def poll(self, stage_key: str, bucket: int,
             have: Optional[Dict[int, int]], timeout_s: float):
        """Events newer than ``have`` (``map_id -> generation``) for one
        bucket, immediately when any exist (or the stage is aborted/closed),
        else a DeferredReply completed by the next publish or the timeout."""
        have = {int(k): int(v) for k, v in (have or {}).items()}
        with self._lock:
            resp = self._resp_locked(stage_key, int(bucket), have)
            if resp is not None or timeout_s <= 0 or self._stopped:
                return resp if resp is not None \
                    else self._empty_locked(stage_key)
            fut: Future = Future()
            self._waiters.append({
                "key": stage_key, "bucket": int(bucket), "have": have,
                "fut": fut,
                "deadline": _time_mod.monotonic() + float(timeout_s)})
            self._ensure_sweeper_locked()
            self._cond.notify_all()
        return DeferredReply(fut)

    # -- internals ------------------------------------------------------------
    def _empty_locked(self, stage_key: str) -> Dict[str, Any]:  # guarded-by: _lock
        st = self._stages.get(stage_key)
        return {"events": [], "aborted": None,
                "expected": st.num_maps if st is not None else None}

    def _resp_locked(self, stage_key: str, bucket: int,  # guarded-by: _lock
                     have: Dict[int, int]) -> Optional[Dict[str, Any]]:
        st = self._stages.get(stage_key)
        if st is None:
            reason = "stream closed" if stage_key in self._closed \
                else "unknown stream stage"
            return {"events": [], "aborted": f"{reason}: {stage_key}",
                    "expected": None}
        events = []
        for map_id, (gen, ref_id, size, index) in st.seals.items():
            if gen <= have.get(map_id, 0):
                continue
            if bucket >= len(index):
                raise ValueError(
                    f"bucket {bucket} out of range for stage {stage_key} "
                    f"(map {map_id} sealed {len(index)} buckets)")
            off, bsize = int(index[bucket][0]), int(index[bucket][1])
            events.append((map_id, gen, ref_id, size, off, bsize))
        if events or st.aborted is not None:
            return {"events": events, "aborted": st.aborted,
                    "expected": st.num_maps}
        return None

    def _collect_ready_locked(self, stage_key: str  # guarded-by: _lock
                              ) -> List[Tuple[Future, Dict[str, Any]]]:
        ready, keep = [], []
        for w in self._waiters:
            if w["key"] != stage_key:
                keep.append(w)
                continue
            resp = self._resp_locked(stage_key, w["bucket"], w["have"])
            if resp is not None:
                ready.append((w["fut"], resp))
            else:
                keep.append(w)
        self._waiters = keep
        return ready

    @staticmethod
    def _complete(ready: List[Tuple[Future, Dict[str, Any]]]) -> None:
        # futures complete OUTSIDE the ledger lock: a done-callback (the RPC
        # server's reply submit) must never run under it
        for fut, resp in ready:
            if not fut.done():
                fut.set_result(resp)

    def _ensure_sweeper_locked(self) -> None:  # guarded-by: _lock
        if self._sweeper is None or not self._sweeper.is_alive():
            self._sweeper = threading.Thread(
                target=self._sweep_loop, daemon=True,
                name="rdt-stream-ledger-sweep")
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        while True:
            with self._lock:
                if not self._waiters:
                    self._sweeper = None
                    return
                now = _time_mod.monotonic()
                due = [w for w in self._waiters
                       if w["deadline"] <= now or self._stopped]
                if due:
                    self._waiters = [w for w in self._waiters
                                     if w not in due]
                    ready = [(w["fut"], self._empty_locked(w["key"]))
                             for w in due]
                else:
                    nxt = min(w["deadline"] for w in self._waiters)
                    self._cond.wait(timeout=max(0.01, min(nxt - now, 5.0)))
                    continue
            self._complete(ready)

    def shutdown(self) -> None:
        with self._lock:
            self._stopped = True
            waiters, self._waiters = self._waiters, []
            self._stages.clear()
            self._cond.notify_all()
        self._complete([(w["fut"], {"events": [], "expected": None,
                                    "aborted": "store shutting down"})
                        for w in waiters])


KIND_RAW = "raw"
KIND_PICKLE = "pickle"
KIND_ARROW = "arrow"

DRIVER_OWNER = "__driver__"

#: host id of the head's machine in the distributed data plane. Every other
#: store host is keyed by the node id of the agent machine hosting it.
HEAD_HOST = "head"

ENV_STORE_HOST_ID = "RDT_STORE_HOST_ID"
ENV_STORE_PAYLOAD_ADDR = "RDT_STORE_PAYLOAD_ADDR"
ENV_STORE_ARENA = "RDT_STORE_ARENA"


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Stop Python's resource tracker from unlinking the segment at process exit.

    Lifetime is managed by the store server (and final sweep at session shutdown);
    3.12 has no ``track=False`` so we unregister manually.
    """
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


def new_object_id() -> str:
    return secrets.token_hex(16)


@dataclass
class _Entry:
    segment: str
    size: int
    kind: str
    owner: str
    offset: int = -1  # >= 0: payload lives at this offset inside the arena
    host_id: str = HEAD_HOST  # machine holding the payload
    payload_addr: Optional[str] = None  # "host:port" serving cross-host fetches
    sealed: bool = True
    spilled: bool = False      # payload currently on disk, not in shm
    last_access: float = 0.0   # monotonic; LRU clock for spilling


class PayloadHost:
    """One machine's payload plane: local arena + per-object segments + frees.

    This is the per-node plasma role in the distributed data plane: the head
    runs one for its machine (inside :class:`ObjectStoreServer`), and every
    node agent on another machine runs its own (``runtime/node_agent.py``), so
    payload bytes are written and served where they live — readers on other
    machines fetch them with ONE direct RPC to the owning node, never through
    the head. Parity: per-node plasma stores + ``getBlockLocations`` routing
    (reference RayDPExecutor.scala:271-287, RayDatasetRDD.scala:48-56).
    """

    #: seconds an arena-resident payload stays mapped after its free. Readers
    #: hold *borrowed* zero-copy views (``get_buffer`` / ``get(zero_copy=True)``,
    #: e.g. the device feed's epoch-long block tables) and frees can arrive
    #: asynchronously (owner-death sweeps, executor-shrink); an immediate
    #: ``rdt_free`` would let a writer recycle bytes under a live view. The
    #: per-object-segment mode never had this hazard (unlink preserves mapped
    #: contents), so arena mode defers reclamation for a grace period instead.
    ARENA_FREE_GRACE_S = float(knobs.get("RDT_ARENA_FREE_GRACE_S"))

    def __init__(self, arena=None):
        self._arena = arena
        # rdt_free/munmap on the arena base must not interleave: a supervisor
        # or RPC thread freeing a dead owner's blocks races session shutdown.
        self._arena_lock = threading.Lock()
        self._deferred: List[Tuple] = []  # guarded-by: _arena_lock; (due, kind, payload)

    # -- arena ----------------------------------------------------------------
    def arena_info(self) -> Optional[Dict[str, Any]]:
        if self._arena is None:
            return None
        return {"segment": self._arena.segment, "size": self._arena.size}

    def arena_stats(self) -> Optional[Dict[str, int]]:
        with self._arena_lock:
            return None if self._arena is None else self._arena.stats()

    def reap(self) -> bool:
        """Free deferred allocations whose grace elapsed (writers call this
        when the arena looks full before falling back to segments)."""
        self._reap_deferred()
        return True

    # -- payload IO ------------------------------------------------------------
    def fetch(self, segment: str, offset: int, size: int) -> bytes:
        """Payload bytes for a reader on ANOTHER machine (one direct hop)."""
        return self.fetch_range(segment, offset, 0, size)

    def fetch_range(self, segment: str, base: int, start: int,
                    size: int) -> bytes:
        """A byte range of a payload hosted here: ``base`` locates the
        payload (its arena offset, or -1 for a dedicated segment — the same
        convention the object table records), ``start`` is the range offset
        WITHIN the payload. The two cannot be folded into one absolute
        offset: a positive value means "arena" to this plane, so a ranged
        read of a dedicated segment must keep them apart."""
        if base >= 0:
            with self._arena_lock:
                if self._arena is None or segment != self._arena.segment:
                    raise KeyError(f"arena segment {segment} not hosted here")
                return bytes(self._arena.view(base + start, size))
        shm = shared_memory.SharedMemory(name=segment)
        try:
            _untrack(shm)
            return bytes(shm.buf[start:start + size])
        finally:
            shm.close()

    def write(self, data: bytes, segment_name: str) -> Tuple[str, int]:
        """Write bytes locally (arena first, dedicated segment fallback);
        returns ``(segment, offset)`` with ``offset=-1`` for a segment."""
        size = len(data)
        with self._arena_lock:
            if self._arena is not None:
                offset = self._arena.alloc(size)
                if offset is not None:
                    try:
                        if size:
                            self._arena.view(offset, size)[:] = data
                    except BaseException:
                        self._arena.free(offset)
                        raise
                    return self._arena.segment, offset
        shm = shared_memory.SharedMemory(name=segment_name, create=True,
                                         size=max(size, 1))
        try:
            if size:
                shm.buf[:size] = data
        finally:
            _untrack(shm)
            shm.close()
        return segment_name, -1

    # -- release ---------------------------------------------------------------
    def release(self, items: List[Tuple[str, int]],
                defer_segments: bool = False) -> int:
        """Release payloads: ``(segment, offset)`` pairs. Arena offsets are
        deferred for the view-grace period; dedicated segments unlink now —
        unless ``defer_segments`` (the spill path uses it: a reader that
        looked the object up but has not yet attached the segment must still
        find the name for the grace period; unlink preserves only mappings
        that already exist)."""
        import time as _time
        due = _time.monotonic() + self.ARENA_FREE_GRACE_S
        n = 0
        with self._arena_lock:
            for segment, offset in items:
                if offset >= 0:
                    if self._arena is not None:
                        self._deferred.append((due, "arena", int(offset)))
                elif defer_segments:
                    self._deferred.append((due, "segment", segment))
                else:
                    _unlink_segment(segment)
                n += 1
        self._reap_deferred()
        return n

    def _reap_deferred(self, everything: bool = False) -> None:
        """Free deferred payloads whose grace period elapsed (activity-driven:
        called on frees and seals; shutdown reaps everything)."""
        import time as _time
        now = _time.monotonic()
        with self._arena_lock:
            keep = []
            for due, kind, payload in self._deferred:
                if everything or due <= now:
                    if kind == "arena":
                        if self._arena is not None:
                            self._arena.free(payload)
                    else:
                        _unlink_segment(payload)
                else:
                    keep.append((due, kind, payload))
            self._deferred = keep

    def shutdown(self) -> None:
        self._reap_deferred(everything=True)
        with self._arena_lock:
            if self._arena is not None:
                self._arena.close()
                self._arena = None


class ObjectStoreServer:
    """Metadata server for the object table. Runs inside the head process.

    All methods are called through the head's RPC server; they must stay cheap —
    object payloads never pass through here, only segment names. The head's
    machine-local payload plane (arena + segments) is an embedded
    :class:`PayloadHost`; payloads on agent machines are released/fetched
    through the ``node_release`` / ``node_fetch`` callbacks the runtime wires
    to the owning node's agent RPC.
    """

    def __init__(self, session_id: str, arena=None,
                 spill_dir: Optional[str] = None,
                 shm_budget: Optional[int] = None):
        self.session_id = session_id
        self.host = PayloadHost(arena)
        self._lock = threading.Lock()
        self._table: Dict[str, _Entry] = {}  # guarded-by: _lock
        #: head-mediated payload RPC counters — the distributed-plane tests
        #: assert these stay flat while cross-node traffic flows node→node
        self.payload_rpc_count = 0
        # per-method control-plane op counters: how many table operations the
        # session issued (a seal_batch of 100 entries counts ONE op — that is
        # the point of batching; benchmarks read these to fence the
        # metadata-plane reduction of the consolidated shuffle path)
        self._op_lock = threading.Lock()
        self._op_counts: Dict[str, int] = {}  # guarded-by: _op_lock
        # callbacks wired by RuntimeContext for payloads on agent machines
        self.node_release = None  # (host_id, [(segment, offset)]) -> None
        self.node_fetch = None    # (host_id, segment, offset, size) -> bytes
        self.node_spill = None    # (host_id, oid, segment, offset, size)
        self.node_fault_in = None  # (host_id, oid, seg_name) -> (seg, off)
        self.node_remove_spill = None  # (host_id, [oids]) -> None
        # per-node shm accounting (the head owns the table and the LRU
        # decision; the payload IO happens on the owning node)
        self._host_bytes: Dict[str, int] = {}  # guarded-by: _lock
        self._host_budgets: Dict[str, int] = {}  # guarded-by: _lock
        # eviction/spill (plasma parity): sealed head-host objects LRU-spill
        # to disk once their shm footprint exceeds the budget; lookups fault
        # them back in transparently. Disabled when spill_dir is None.
        self.spill_dir = spill_dir
        self.shm_budget = shm_budget
        self._shm_bytes = 0        # unspilled head-host payload bytes
        self._spilled_bytes = 0
        # stage-aware eviction hints (doc/etl.md "Store budgets"): the
        # engine pins the blobs of the stage it is currently consuming
        # (refcounted — concurrent stages can share inputs) and demotes
        # them to evict-first once their consumer stage completes. The
        # spill victim sort reads these as a priority band; LRU breaks
        # ties only. Pinned blobs still spill as a LAST resort — the
        # budget invariant outranks any hint.
        self._pin_counts: Dict[str, int] = {}  # guarded-by: _lock
        self._evict_first: set = set()         # guarded-by: _lock
        # AQE-derived per-host budgets (derive_budgets): when set they
        # tighten the statically configured capacity, never exceed it
        self._derived_budgets: Dict[str, int] = {}  # guarded-by: _lock
        self._spill_locks: Dict[str, threading.Lock] = {}
        self._fault_gen = 0        # fault-in segments get fresh names (the
        #                            old name may still be alive under grace)
        # pipelined-shuffle seal notifications (doc/etl.md "Pipelined
        # shuffle"): the metadata-plane extension reducers long-poll
        self._streams = ShuffleStreamLedger()

    # -- control-plane accounting ---------------------------------------------
    def _count_op(self, name: str) -> None:
        with self._op_lock:
            self._op_counts[name] = self._op_counts.get(name, 0) + 1
        # registry twin of op_counts(): metrics_report()'s store_ops_total
        # subsumes this dict (which stays as the compatible view)
        metrics.inc("store_ops_total", label=name)

    def op_counts(self) -> Dict[str, int]:
        """Per-method control-plane operation counts since start/reset. A
        batch call counts one op regardless of batch size."""
        with self._op_lock:
            return dict(self._op_counts)

    def reset_op_counts(self) -> None:
        with self._op_lock:
            self._op_counts.clear()

    # -- arena (head machine) --------------------------------------------------
    def arena_info(self) -> Optional[Dict[str, Any]]:
        return self.host.arena_info()

    def arena_stats(self) -> Optional[Dict[str, int]]:
        return self.host.arena_stats()

    def arena_reap(self) -> bool:
        return self.host.reap()

    # -- write path -----------------------------------------------------------
    def seal(self, object_id: str, segment: str, size: int, kind: str,
             owner: str, offset: int = -1, host_id: str = HEAD_HOST,
             payload_addr: Optional[str] = None) -> None:
        self._count_op("seal")
        self._seal_locked([(object_id, segment, size, kind, owner, offset,
                            host_id, payload_addr)])
        self.host.reap()
        self._maybe_spill(host_id, exclude=object_id)

    def seal_batch(self, entries: List[Sequence]) -> None:
        """Seal many objects in ONE control-plane operation; each entry is
        the positional argument tuple of :meth:`seal`. All-or-nothing: a
        duplicate id rejects the whole batch before any entry lands, so the
        caller's rollback (release the written payloads) stays simple."""
        self._count_op("seal_batch")
        entries = [tuple(e) for e in entries]
        self._seal_locked(entries)
        self.host.reap()
        by_host: Dict[str, set] = {}
        for e in entries:
            by_host.setdefault(e[6] if len(e) > 6 else HEAD_HOST,
                               set()).add(e[0])
        for host_id, ids in by_host.items():
            # exclude every id the batch just sealed on this host — same
            # immediate-re-evict guard seal() applies to its one object
            self._maybe_spill(host_id, exclude=ids)

    def _seal_locked(self, entries: List[Sequence]) -> None:
        import time as _time
        with self._lock:
            for e in entries:
                if e[0] in self._table:
                    raise KeyError(f"object {e[0]} already sealed")
            if len({e[0] for e in entries}) != len(entries):
                raise KeyError("duplicate object id in seal batch")
            now = _time.monotonic()
            for e in entries:
                (object_id, segment, size, kind, owner) = e[:5]
                offset = e[5] if len(e) > 5 else -1
                host_id = e[6] if len(e) > 6 else HEAD_HOST
                payload_addr = e[7] if len(e) > 7 else None
                self._table[object_id] = _Entry(segment, size, kind, owner,
                                                offset, host_id, payload_addr,
                                                last_access=now)
                if host_id == HEAD_HOST:
                    self._shm_bytes += size
                else:
                    self._host_bytes[host_id] = \
                        self._host_bytes.get(host_id, 0) + size

    # -- eviction/spill (one implementation; per-host backends) ---------------
    def _spill_path(self, object_id: str) -> str:
        return os.path.join(self.spill_dir, object_id)

    def register_node_budget(self, host_id: str, budget: Optional[int]) -> None:
        if budget:
            with self._lock:
                self._host_budgets[host_id] = int(budget)

    def _budget_of(self, host_id: str) -> Optional[int]:
        if host_id == HEAD_HOST:
            static = self.shm_budget if self.spill_dir is not None else None
        else:
            with self._lock:
                static = self._host_budgets.get(host_id) \
                    if self.node_spill is not None else None
        if not static:
            return None
        # an AQE-derived budget only ever TIGHTENS the configured capacity
        # (derive_budgets clamps it); absent a derivation the static
        # ENV_STORE_* number stands
        with self._lock:
            derived = self._derived_budgets.get(host_id)
        return min(int(static), derived) if derived else static

    def _shm_used(self, host_id: str) -> int:  # guarded-by: _lock
        return self._shm_bytes if host_id == HEAD_HOST \
            else self._host_bytes.get(host_id, 0)

    def _adjust_shm(self, host_id: str, delta: int) -> None:  # guarded-by: _lock
        if host_id == HEAD_HOST:
            self._shm_bytes += delta
        else:
            self._host_bytes[host_id] = \
                self._host_bytes.get(host_id, 0) + delta

    def _spill_lock(self, host_id: str) -> threading.Lock:
        """One spill/fault-in at a time PER HOST: a slow or dead node must
        not stall the head plane (or other nodes) behind its 120s RPCs."""
        with self._lock:
            lock = self._spill_locks.get(host_id)
            if lock is None:
                lock = self._spill_locks[host_id] = threading.Lock()
            return lock

    def _backend(self, host_id: str):
        """(write_spill, release_shm, fault_read, remove_spill) for a host —
        head-local file/shm IO, or the owning node's agent RPCs. Everything
        above this seam (LRU choice, survive re-check, counters) is shared."""
        if host_id == HEAD_HOST:
            def write_spill(oid, segment, offset, size):
                data = self.host.fetch(segment, offset, size)
                os.makedirs(self.spill_dir, exist_ok=True)
                tmp = self._spill_path(oid) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, self._spill_path(oid))

            def release_shm(segment, offset):
                self.host.release([(segment, offset)], defer_segments=True)

            def fault_read(oid, seg_name):
                # the spill file is NOT deleted here: removal is directed by
                # the caller only after the table committed the new location
                with open(self._spill_path(oid), "rb") as f:
                    data = f.read()
                return self.host.write(data, seg_name)

            def remove_spill(oid):
                _remove_quiet(self._spill_path(oid))
        else:
            def write_spill(oid, segment, offset, size):
                self.node_spill(host_id, oid, segment, offset, size)

            def release_shm(segment, offset):
                self.node_release(host_id, [(segment, offset)],
                                  defer_segments=True)

            def fault_read(oid, seg_name):
                segment, offset = self.node_fault_in(host_id, oid, seg_name)
                return segment, int(offset)

            def remove_spill(oid):
                if self.node_remove_spill is not None:
                    try:
                        self.node_remove_spill(host_id, [oid])
                    except Exception:
                        pass
        return write_spill, release_shm, fault_read, remove_spill

    def _maybe_spill(self, host_id: str = HEAD_HOST,
                     exclude=None) -> None:
        """LRU-spill sealed objects on ``host_id`` until its shm use fits its
        budget. Shm bytes are released on the view-grace deferral (segments
        included), so borrowed zero-copy views and lookup-then-attach readers
        never see recycled bytes. ``exclude`` (an id or a set of ids — a
        seal batch protects ALL its entries) exempts just-sealed objects
        from being the victim of their own seal. Parity: plasma
        eviction/spill.

        Victim order is (hint band, LRU): evict-first blobs (their
        consumer stage completed) go before unhinted ones, and blobs
        pinned by a running stage go LAST — spilled only when nothing
        else can satisfy the budget, because the budget invariant
        outranks any hint (the out-of-core bench's bounded-shm
        contract). LRU breaks ties within a band."""
        budget = self._budget_of(host_id)
        if not budget:
            return
        excluded = (exclude if isinstance(exclude, (set, frozenset))
                    else {exclude} if exclude is not None else set())
        while True:
            with self._lock:
                if self._shm_used(host_id) <= budget:
                    return
                victims = sorted(
                    ((0 if oid in self._evict_first
                      else 2 if self._pin_counts.get(oid) else 1,
                      e.last_access, oid)
                     for oid, e in self._table.items()
                     if e.host_id == host_id and not e.spilled
                     and e.size > 0 and oid not in excluded))
                if not victims:
                    return
                victim = victims[0][2]
            if not self._spill_one(host_id, victim):
                return

    def _spill_one(self, host_id: str, object_id: str) -> bool:
        write_spill, release_shm, _, remove_spill = self._backend(host_id)
        survived = False
        with self._spill_lock(host_id):
            with self._lock:
                e = self._table.get(object_id)
                if e is None or e.spilled or e.host_id != host_id:
                    return False
                segment, offset, size = e.segment, e.offset, e.size
            # chaos site: checked only after the victim is validated — a
            # raced no-op spill (victim freed / already spilled) must not
            # consume the schedule (nth/times/once) while injecting
            # nothing. ``drop`` deletes the spill FILE after the commit
            # (the lost-disk model — the next fault-in surfaces the typed
            # loss into lineage recovery); delay/raise model slow/failing
            # spill IO and are applied INSIDE the write try, so an
            # injected raise fails just this spill (warning + object stays
            # in shm) instead of escaping into the seal path after the
            # table entry was committed.
            rule = faults.check("store.spill", key=object_id)
            drop_after = rule is not None and rule.action == "drop"
            try:
                if rule is not None and not drop_after:
                    faults.apply(rule, "store.spill")
                write_spill(object_id, segment, offset, size)
            except Exception as exc:
                logger.warning("spill of %s on %s failed: %s",
                               object_id, host_id, exc)
                return False
            with self._lock:
                e = self._table.get(object_id)
                if e is not None:
                    e.spilled = True
                    e.segment, e.offset = "", -1
                    self._adjust_shm(host_id, -size)
                    self._spilled_bytes += size
                    survived = True
        # backend IO OUTSIDE the table lock (for node hosts these are RPCs
        # and must not stall every seal/lookup/free behind them):
        if not survived:
            # freed while we were writing: free() already released the shm —
            # only the now-orphaned spill file needs to go (the shm must NOT
            # be released twice; an offset double-free would reclaim someone
            # else's live bytes)
            remove_spill(object_id)
            return True
        # exactly-once, only after the entry survived the write
        try:
            release_shm(segment, offset)
        except Exception as exc:
            logger.warning("post-spill release on %s failed: %s",
                           host_id, exc)
        if drop_after:
            try:
                remove_spill(object_id)
            except Exception:  # noqa: BLE001 - injection must not mask IO
                pass
        return True

    def _fault_in(self, host_id: str, object_id: str) -> None:
        """Bring a spilled payload back into shm (transparent on lookup).

        The spill file is removed only AFTER the table commits the new shm
        location: a fault-in whose result is lost (dropped RPC reply, slow
        node exceeding the call timeout) leaves the file in place, so the
        next lookup simply retries instead of losing the object forever."""
        import time as _time
        _, release_shm, fault_read, remove_spill = self._backend(host_id)
        committed = False
        with self._spill_lock(host_id):
            with self._lock:
                e = self._table.get(object_id)
                if e is None or not e.spilled:
                    return  # raced with another fault-in or a free
                size = e.size
            self._fault_gen += 1
            seg_name = (f"rdt{self.session_id[:8]}_{object_id[:20]}"
                        f"g{self._fault_gen}")
            try:
                segment, offset = fault_read(object_id, seg_name)
            except Exception as exc:
                if not (isinstance(exc, FileNotFoundError)
                        or getattr(exc, "exc_type", None)
                        == "FileNotFoundError"):
                    raise
                # the spill FILE is gone (disk loss, node wipe) — not a
                # lost RPC reply: the payload is unrecoverable here.
                # Surface the typed loss (→ lineage recovery) and drop the
                # zombie table entry so later readers miss fast instead of
                # re-probing a file that will never return
                with self._lock:
                    e = self._table.get(object_id)
                    if e is not None and e.spilled:
                        del self._table[object_id]
                        self._spilled_bytes -= e.size
                raise ObjectLostError(
                    object_id, f"spill file lost on {host_id}: {exc}") \
                    from exc
            with self._lock:
                e = self._table.get(object_id)
                if e is None:  # freed mid-fault-in: drop the fresh shm
                    try:
                        release_shm(segment, offset)
                    except Exception:
                        pass
                    return  # free() already removed the spill file
                e.segment, e.offset = segment, offset
                e.spilled = False
                e.last_access = _time.monotonic()
                self._adjust_shm(host_id, size)
                self._spilled_bytes -= size
                committed = True
        if committed:
            metrics.inc("store_fault_in_total")
            metrics.record_event("store_fault_in", object_id=object_id,
                                 host=host_id)
            remove_spill(object_id)
        self._maybe_spill(host_id, exclude=object_id)

    # -- head-mediated payload path (clients with NO shared memory at all) -----
    def fetch_payload(self, object_id: str) -> Tuple[bytes, str]:
        """Payload bytes + kind through the head — the slow compatibility path
        for shm-less clients. Machine-local readers attach segments directly;
        cross-machine readers go straight to the owning node's PayloadHost."""
        self._count_op("fetch_payload")
        segment, size, kind, offset, host_id, _ = self._lookup_one(object_id)
        self.payload_rpc_count += 1
        if host_id != HEAD_HOST:
            if self.node_fetch is None:
                raise KeyError(f"object {object_id} lives on {host_id}; "
                               "no node fetch route")
            return self.node_fetch(host_id, segment, offset, size), kind
        return self.host.fetch(segment, offset, size), kind

    def store_payload(self, object_id: str, data: bytes, kind: str,
                      owner: str) -> int:
        """Write + seal on behalf of a shm-less client; returns the size."""
        self._count_op("store_payload")
        self.payload_rpc_count += 1
        seg_name = f"rdt{self.session_id[:8]}_{object_id}"
        segment, offset = self.host.write(data, seg_name)
        try:
            self.seal(object_id, segment, len(data), kind, owner, offset)
        except BaseException:
            self.host.release([(segment, offset)])
            raise
        return len(data)

    # -- read path ------------------------------------------------------------
    def lookup(self, object_id: str
               ) -> Tuple[str, int, str, int, str, Optional[str]]:
        self._count_op("lookup")
        return self._lookup_one(object_id)

    def lookup_batch(self, object_ids: List[str]
                     ) -> Dict[str, Tuple[str, int, str, int, str,
                                          Optional[str]]]:
        """Resolve many objects in ONE control-plane operation. Missing ids
        are simply absent from the result (the caller decides whether a miss
        is a lost object); present-but-spilled entries fault in exactly like
        :meth:`lookup`."""
        self._count_op("lookup_batch")
        out = {}
        for oid in object_ids:
            try:
                out[oid] = self._lookup_one(oid)
            except KeyError:
                pass
        return out

    def _lookup_one(self, object_id: str
                    ) -> Tuple[str, int, str, int, str, Optional[str]]:
        import time as _time
        # a concurrent seal can re-evict the object between our fault-in and
        # re-read (it is the LRU victim when it is the only candidate): retry
        # a few rounds rather than failing a live ref
        for _ in range(4):
            with self._lock:
                e = self._table.get(object_id)
                if e is None:
                    raise KeyError(f"object {object_id} not found")
                e.last_access = _time.monotonic()
                if not e.spilled:
                    return (e.segment, e.size, e.kind, e.offset, e.host_id,
                            e.payload_addr)
                host_id = e.host_id
            self._fault_in(host_id, object_id)
        raise RuntimeError(
            f"object {object_id} is thrashing between shm and spill; "
            "raise raydp.tpu.object_store.shm_budget")

    def contains(self, object_id: str) -> bool:
        self._count_op("contains")
        with self._lock:
            return object_id in self._table

    def locations(self, object_ids: List[str]) -> Dict[str, str]:
        """``object_id -> host_id`` for the ids present — the engine's
        locality source (parity: ``getBlockLocations`` / preferred locations,
        RayDPExecutor.scala:271-287, RayDatasetRDD.scala:48-56)."""
        self._count_op("locations")
        with self._lock:
            return {oid: self._table[oid].host_id for oid in object_ids
                    if oid in self._table}

    def residency(self, object_ids: List[str]
                  ) -> Dict[str, Tuple[str, str]]:
        """``object_id -> (host_id, tier)`` for the ids present; tier is
        ``"shm"`` (payload resident in shared memory on that host) or
        ``"spilled"`` (on that host's disk — a read pays a fault-in
        first). The tier-blind view is :meth:`locations`; the engine's
        data-gravity weighting reads this one, so a host holding only a
        spilled copy scores between in-memory-local and remote
        (doc/etl.md "Data-gravity scheduling")."""
        self._count_op("residency")
        with self._lock:
            return {oid: (self._table[oid].host_id,
                          "spilled" if self._table[oid].spilled else "shm")
                    for oid in object_ids if oid in self._table}

    def eviction_hints(self, pin: Optional[List[str]] = None,
                       unpin: Optional[List[str]] = None,
                       evict_first: Optional[List[str]] = None
                       ) -> Dict[str, int]:
        """Stage-aware eviction hints from the engine's stage ledger:
        ``pin`` marks blobs a dispatching stage is about to consume
        (refcounted — concurrent stages can share inputs), ``unpin``
        releases one pin and, at refcount zero, demotes the blob to
        evict-first (its consumer stage completed), ``evict_first``
        demotes explicitly. Advisory only: :meth:`_maybe_spill` reads
        the bands, the budget invariant always wins. Returns the live
        band sizes."""
        self._count_op("eviction_hints")
        with self._lock:
            for oid in pin or ():
                self._pin_counts[oid] = self._pin_counts.get(oid, 0) + 1
                self._evict_first.discard(oid)
            for oid in unpin or ():
                n = self._pin_counts.get(oid)
                if n is None:
                    continue
                if n <= 1:
                    del self._pin_counts[oid]
                    self._evict_first.add(oid)
                else:
                    self._pin_counts[oid] = n - 1
            for oid in evict_first or ():
                if not self._pin_counts.get(oid):
                    self._evict_first.add(oid)
            return {"pinned": len(self._pin_counts),
                    "evict_first": len(self._evict_first)}

    def derive_budgets(self, measured_bytes: int) -> Dict[str, int]:
        """Re-derive per-host shm budgets from the AQE plane's measured
        per-stage bytes: derived = min(static capacity, measured x
        RDT_STORE_BUDGET_HEADROOM), floored at 1 MiB. Derived budgets
        only ever TIGHTEN the statically configured ``ENV_STORE_*``
        capacity — when the measured working set is smaller, cold bytes
        spill ahead of demand; a workload bigger than capacity keeps the
        static number. Hosts without spill plumbing are untouched.

        The ``store.budget`` chaos site fires here (key: the measured
        byte count); an injected failure degrades LOUDLY to the static
        budgets (derived state cleared) instead of erroring."""
        self._count_op("derive_budgets")
        measured = max(0, int(measured_bytes))
        rule = faults.check("store.budget", key=str(measured))
        if rule is not None:
            try:
                faults.apply(rule, "store.budget")
            except Exception as exc:
                logger.warning("store budget derivation failed (injected); "
                               "keeping static budgets: %s", exc)
                with self._lock:
                    self._derived_budgets.clear()
                metrics.record_event("store_budget",
                                     measured_bytes=measured, degraded=True)
                return {}
        headroom = max(0.0, float(knobs.get("RDT_STORE_BUDGET_HEADROOM")))
        target = max(1 << 20, int(measured * headroom))
        derived: Dict[str, int] = {}
        with self._lock:
            if self.shm_budget and self.spill_dir is not None:
                derived[HEAD_HOST] = min(int(self.shm_budget), target)
            if self.node_spill is not None:
                for host_id, cap in self._host_budgets.items():
                    derived[host_id] = min(int(cap), target)
            self._derived_budgets = dict(derived)
        metrics.record_event("store_budget", measured_bytes=measured,
                             headroom=headroom, hosts=len(derived),
                             budget=(target if derived else 0))
        # a tightened budget spills cold bytes ahead of demand, off the
        # read/write hot paths
        for host_id in derived:
            self._maybe_spill(host_id)
        return derived

    # -- pipelined-shuffle seal notifications ----------------------------------
    def stream_begin(self, stage_key: str, num_maps: int) -> None:
        """Open a seal stream for one shuffle stage (driver, before any
        reduce task dispatches — a poll on a never-begun stage aborts)."""
        self._count_op("stream_begin")
        self._streams.begin(stage_key, num_maps)

    def stream_publish(self, stage_key: str, map_id: int, gen: int,
                       ref_id: str, size: int,
                       index: Sequence[Sequence[int]]) -> None:
        """Seal notification: map ``map_id``'s consolidated blob (generation
        ``gen`` — a lineage-regenerated producer re-seals with gen+1) with
        its per-bucket (offset, size, rows) index."""
        self._count_op("stream_publish")
        self._streams.publish(stage_key, map_id, gen, ref_id, size, index)

    def stream_poll(self, stage_key: str, bucket: int,
                    have: Optional[Dict[int, int]] = None,
                    timeout_s: float = 10.0):
        """Long-poll one bucket's seal events newer than ``have``; may return
        a DeferredReply (completed on publish/abort/close or timeout)."""
        self._count_op("stream_poll")
        return self._streams.poll(stage_key, bucket, have, timeout_s)

    def stream_abort(self, stage_key: str, message: str) -> None:
        self._count_op("stream_abort")
        self._streams.abort(stage_key, message)

    def stream_close(self, stage_keys: List[str]) -> None:
        """Action end: drop the stage ledgers; drain-abandoned reducers still
        polling get an abort instead of waiting forever."""
        self._count_op("stream_close")
        self._streams.close(stage_keys)

    def fetch_ranges(self, items: List[Sequence]) -> List[bytes]:
        """Byte ranges of payloads hosted on the HEAD machine, one RPC for
        many ranges: each item is ``(segment, base, start, size)`` — the
        payload's table offset (arena offset or -1 for a dedicated segment)
        plus the range offset within it. This is the head acting as its
        machine's payload host (the node-agent twin is
        ``store_fetch_ranges``), serving consolidated shuffle blobs to
        readers on other machines without one round-trip per range."""
        self._count_op("fetch_ranges")
        return [self.host.fetch_range(seg, int(base), int(start), int(size))
                for seg, base, start, size in items]

    # -- lifetime: ownership-based (owner death sweeps; explicit free releases).
    # A refcount protocol is deliberately absent — every object has exactly one
    # owner and lineage makes re-creation cheap, so ownership is the whole story.
    def free(self, object_ids: List[str]) -> int:
        """Explicitly delete objects regardless of owner (release path,
        parity with ``release_spark_recoverable``, dataset.py:224-237)."""
        self._count_op("free")
        freed = []
        with self._lock:
            for oid in object_ids:
                # eviction-hint state dies with the blob (a stale hint for
                # a reused id would misprioritize the newcomer)
                self._pin_counts.pop(oid, None)
                self._evict_first.discard(oid)
                e = self._table.pop(oid, None)
                if e is not None:
                    freed.append((oid, e))
        self._release_payloads(freed)
        return len(freed)

    def _release_payloads(self, entries: List[Tuple[str, _Entry]]) -> None:
        local = []
        for oid, e in entries:
            if e.host_id != HEAD_HOST:
                continue
            if e.spilled:
                _remove_quiet(self._spill_path(oid))
                with self._lock:
                    self._spilled_bytes -= e.size
            else:
                local.append((e.segment, e.offset))
                with self._lock:
                    self._shm_bytes -= e.size
        if local:
            self.host.release(local)
        by_node: Dict[str, List[Tuple[str, int]]] = {}
        spill_removals: Dict[str, List[str]] = {}
        for oid, e in entries:
            if e.host_id == HEAD_HOST:
                continue
            if e.spilled:
                with self._lock:
                    self._spilled_bytes -= e.size
                spill_removals.setdefault(e.host_id, []).append(oid)
            else:
                with self._lock:
                    self._host_bytes[e.host_id] = \
                        self._host_bytes.get(e.host_id, 0) - e.size
                by_node.setdefault(e.host_id, []).append((e.segment, e.offset))
        for host_id, oids in spill_removals.items():
            # one batched RPC per host, like the shm-release path below
            if self.node_remove_spill is None:
                continue
            try:
                self.node_remove_spill(host_id, oids)
            except Exception:
                pass
        for host_id, items in by_node.items():
            if self.node_release is None:
                continue
            try:
                self.node_release(host_id, items)
            except Exception as exc:  # node may be dead; lineage re-creates
                logger.warning("release on node %s failed: %s", host_id, exc)

    def transfer_ownership(self, object_ids: List[str], new_owner: str) -> int:
        with self._lock:
            n = 0
            for oid in object_ids:
                e = self._table.get(oid)
                if e is not None:
                    e.owner = new_owner
                    n += 1
            return n

    def free_owned_by(self, owner: str) -> int:
        """Called when an owner (actor) dies or is stopped with cleanup."""
        freed = []
        with self._lock:
            for oid in [o for o, e in self._table.items() if e.owner == owner]:
                self._pin_counts.pop(oid, None)
                self._evict_first.discard(oid)
                freed.append((oid, self._table.pop(oid)))
        self._release_payloads(freed)
        return len(freed)

    def purge_host(self, host_id: str) -> int:
        """Node death: its payloads are gone — drop their table entries so
        readers fail fast into lineage recovery instead of timing out."""
        dropped = 0
        with self._lock:
            for oid in [o for o, e in self._table.items()
                        if e.host_id == host_id]:
                if self._table[oid].spilled:
                    self._spilled_bytes -= self._table[oid].size
                self._pin_counts.pop(oid, None)
                self._evict_first.discard(oid)
                del self._table[oid]
                dropped += 1
            self._host_bytes.pop(host_id, None)
            self._host_budgets.pop(host_id, None)
        if dropped:
            logger.warning("purged %d objects hosted on dead node %s",
                           dropped, host_id)
        return dropped

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            budgets: Dict[str, int] = dict(self._host_budgets)
            if self.shm_budget and self.spill_dir is not None:
                budgets[HEAD_HOST] = int(self.shm_budget)
            host_spilled: Dict[str, int] = {}
            for e in self._table.values():
                if e.spilled:
                    host_spilled[e.host_id] = \
                        host_spilled.get(e.host_id, 0) + e.size
            return {
                "num_objects": len(self._table),
                "total_bytes": sum(e.size for e in self._table.values()),
                "owners": sorted({e.owner for e in self._table.values()}),
                "hosts": sorted({e.host_id for e in self._table.values()}),
                "shm_bytes": self._shm_bytes,
                "spilled_bytes": self._spilled_bytes,
                "spilled_objects": sum(1 for e in self._table.values()
                                       if e.spilled),
                # per-host shm footprint + budgets: what the engine's
                # memory backpressure (doc/etl.md "Fair sharing and
                # admission") reads its watermark fractions from
                "host_shm": {HEAD_HOST: self._shm_bytes,
                             **dict(self._host_bytes)},
                "host_budgets": budgets,
                # residency-tier + policy-plane visibility (data-gravity
                # scheduling / stage-aware eviction): per-host spilled
                # bytes, live hint-band sizes, and any AQE-derived
                # budgets currently tightening the static capacity
                "host_spilled": host_spilled,
                "pinned_objects": len(self._pin_counts),
                "evict_first_objects": len(self._evict_first),
                "derived_budgets": dict(self._derived_budgets),
            }

    def owned_by(self, owner: str) -> List[str]:
        with self._lock:
            return [o for o, e in self._table.items() if e.owner == owner]

    def shutdown(self) -> None:
        self._streams.shutdown()
        with self._lock:
            entries = list(self._table.items())
            self._table.clear()
        # node-hosted payloads: route their release to the owning agents
        # BEFORE the runtime tears the agents down (dedicated /dev/shm
        # segments on a node would otherwise outlive the session)
        self._release_payloads([(oid, e) for oid, e in entries
                                if e.host_id != HEAD_HOST])
        for oid, e in entries:
            if e.host_id != HEAD_HOST:
                continue
            if e.spilled:
                _remove_quiet(self._spill_path(oid))
            elif e.offset < 0:
                _unlink_segment(e.segment)
        if self.spill_dir is not None:
            import shutil
            shutil.rmtree(self.spill_dir, ignore_errors=True)
        self.host.shutdown()


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _unlink_segment(segment: str) -> None:
    try:
        shm = shared_memory.SharedMemory(name=segment)
        _untrack(shm)
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass
    except Exception as e:  # pragma: no cover
        logger.warning("failed to unlink segment %s: %s", segment, e)


@dataclass
class ObjectRef:
    """A handle to a sealed object. Picklable; resolvable in any session process.

    Parity: Ray ``ObjectRef`` + owner address as rehydrated by the reference's
    ``RayDPUtils.readBinary`` (RayDPUtils.java:45-53). ``get()`` resolves through
    the process-local :class:`ObjectStoreClient`.
    """

    id: str
    size: int = 0
    kind: str = KIND_PICKLE

    def get(self) -> Any:
        return get_client().get(self)

    def __hash__(self):
        return hash(self.id)


#: RemoteError.exc_type names meaning "the blob is unreachable where the
#: table said it was" — translated to :class:`ObjectLostError` so the reader
#: falls into lineage recovery instead of burning its retry budget. One
#: constant, not per-site tuples: the five hand-copied copies these replace
#: are exactly the drift rdtlint's ``exc-contract`` rule now guards.
_REMOTE_LOST_EXC_TYPES = ("KeyError", "ObjectLostError", "FileNotFoundError")

#: the subset meaning "possibly just a stale location" (spill/fault-in moved
#: the payload between lookup and read): worth ONE fresh-lookup retry before
#: escalating to a typed loss. KeyError joins FileNotFoundError here because
#: a peer arena that re-homed a segment reports the miss as KeyError.
_REMOTE_STALE_EXC_TYPES = ("FileNotFoundError", "KeyError")


class ObjectStoreClient:
    """Per-process client: creates/attaches segments, talks to the table server.

    ``server`` is any object exposing the ObjectStoreServer methods — in the head
    process it is the server itself; in actor processes it is an RPC proxy.
    """

    def __init__(self, server, session_id: str, default_owner: str = DRIVER_OWNER,
                 remote: Optional[bool] = None, host_id: Optional[str] = None,
                 payload_addr: Optional[str] = None):
        self._server = server
        self.session_id = session_id
        self.default_owner = default_owner
        self._attached: Dict[str, shared_memory.SharedMemory] = {}
        #: object id → the dedicated segment this process attached for it, so
        #: free()/loss can evict the handle (fault-in segments carry a
        #: generation suffix — deriving the name from the id alone misses
        #: them, which was the handle/fd leak this map fixes)
        self._seg_of: Dict[str, str] = {}
        # client-side lookup memo for sealed entries. Only entries whose
        # payload CANNOT silently move under a reader are memoized: dedicated
        # segments are written once, and any relocation (spill/fault-in) or
        # free changes/unlinks the NAME, so a stale hit surfaces as
        # FileNotFoundError and takes the existing one-fresh-lookup recovery.
        # Arena-resident entries are deliberately not memoized — the arena
        # segment name never changes, so a recycled offset would be read
        # silently.
        self._lookup_memo: Dict[str, Tuple] = {}
        self._MEMO_CAP = 4096
        #: handles whose close() failed because a borrowed view still pins
        #: the mapping; kept strongly referenced (GC-time close would just
        #: raise the same BufferError) and re-tried on later evictions
        self._retired: List[shared_memory.SharedMemory] = []
        # control-plane instrumentation: table-server calls and payload-fetch
        # RPCs issued by THIS process (executors report per-task deltas into
        # the engine's shuffle ledger). Seal-stream polls are counted apart —
        # a long-poll is a wait, not a table op, and folding it into
        # meta_rpcs would make the consolidation comparisons meaningless.
        self.meta_rpc_count = 0
        self.fetch_rpc_count = 0
        self.stream_poll_count = 0
        self._lock = threading.Lock()
        self._arena = None          # native write handle, lazily probed
        self._arena_probed = False
        # distributed data plane: which machine this process is on, and the
        # address of that machine's payload server (node agent RPC; None =
        # the head). Writes land in the machine-local arena/segments; reads
        # of objects on OTHER machines go directly to the owning node.
        self.host_id = (host_id if host_id is not None
                        else str(knobs.get(ENV_STORE_HOST_ID)))
        self.payload_addr = (payload_addr if payload_addr is not None
                             else knobs.get(ENV_STORE_PAYLOAD_ADDR))
        self._peers: Dict[str, Any] = {}  # payload_addr -> RpcClient
        # remote mode (explicit constructor opt-in): this process has no
        # usable shared memory at all; every payload read and write is
        # head-mediated — the slow compatibility path for external clients
        self.remote = bool(remote)

    # -- segment naming: session-scoped so shutdown can sweep leftovers -------
    def _segment_name(self, object_id: str) -> str:
        return f"rdt{self.session_id[:8]}_{object_id}"

    def _write_arena(self):
        """The machine-local arena handle for allocations, or None (fallback).

        Head-machine processes attach the head's arena; processes on an
        isolated node attach the node's own arena (segment name handed down
        via ``RDT_STORE_ARENA`` by the node agent that spawned them)."""
        if self._arena_probed:
            return self._arena
        with self._lock:
            if self._arena_probed:
                return self._arena
            try:
                if self.host_id != HEAD_HOST:
                    segment = knobs.get(ENV_STORE_ARENA)
                    if segment:
                        from raydp_tpu_torch.native.arena import Arena
                        self._arena = Arena.attach(segment)
                else:
                    info = self._server.arena_info()
                    if info is not None:
                        from raydp_tpu_torch.native.arena import Arena
                        self._arena = Arena.attach(info["segment"])
            except Exception as e:
                logger.warning("arena attach failed (%s); using per-object "
                               "segments in this process", e)
                self._arena = None
            self._arena_probed = True
        return self._arena

    def _peer(self, addr: str):
        """RPC client to another machine's payload server (node agent).
        Connects OUTSIDE the client-wide lock (a dead node's connect timeout
        must not stall unrelated same-host reads/writes in this process)."""
        with self._lock:
            client = self._peers.get(addr)
        if client is not None and not client._closed:  # noqa: SLF001
            return client
        from raydp_tpu_torch.runtime.rpc import RpcClient
        host, port = addr.rsplit(":", 1)
        fresh = RpcClient((host, int(port)), connect_timeout=5.0)
        with self._lock:
            cur = self._peers.get(addr)
            if cur is not None and not cur._closed:  # noqa: SLF001
                fresh.close()
                return cur
            self._peers[addr] = fresh
            return fresh

    def _local_reap(self) -> None:
        """Ask this machine's payload host to reap expired deferred frees."""
        if self.host_id == HEAD_HOST:
            self._server.arena_reap()
        elif self.payload_addr:
            self._peer(self.payload_addr).call("store_reap", timeout=30.0)

    # -- write ----------------------------------------------------------------
    def _write_local(self, object_id: str, data) -> Tuple[str, int]:
        """Write payload bytes into this machine's plane (arena first with a
        reap-retry, dedicated segment fallback); returns ``(segment, offset)``
        with ``offset=-1`` for a dedicated segment. No metadata RPC happens
        here — the caller seals (individually or batched)."""
        size = len(data)
        arena = self._write_arena()
        if arena is not None:
            offset = arena.alloc(size)
            if offset is None:
                # expired deferred frees may be holding the space: reap on
                # this machine's payload host and retry once before the slow
                # per-segment path
                try:
                    self._local_reap()
                    offset = arena.alloc(size)
                except Exception:
                    offset = None
            if offset is not None:
                try:
                    if size:
                        view = arena.view(offset, size)
                        if isinstance(data, memoryview):
                            view[:] = data.cast("B")
                        else:
                            view[:] = data
                except BaseException:
                    # unsealed allocation would leak until session end
                    try:
                        arena.free(offset)
                    except Exception:
                        pass
                    raise
                return arena.segment, offset
            # arena full: fall through to a dedicated segment
        seg_name = self._segment_name(object_id)
        if size == 0:
            # shm segments cannot be zero-sized; keep 1 byte and record size=0
            shm = shared_memory.SharedMemory(name=seg_name, create=True, size=1)
        else:
            shm = shared_memory.SharedMemory(name=seg_name, create=True, size=size)
            if isinstance(data, memoryview):
                shm.buf[:size] = data.cast("B")
            else:
                shm.buf[:size] = data
        _untrack(shm)
        shm.close()
        return seg_name, -1

    def _release_local(self, items: List[Tuple[str, int]]) -> None:
        """Roll back local payload writes that never got sealed."""
        arena = self._write_arena()
        for segment, offset in items:
            try:
                if offset >= 0:
                    if arena is not None:
                        arena.free(offset)
                else:
                    _unlink_segment(segment)
            except Exception:
                pass

    def put_raw(self, data, kind: str = KIND_RAW, owner: Optional[str] = None) -> ObjectRef:
        object_id = new_object_id()
        size = len(data)
        if self.remote:
            payload = bytes(data.cast("B")) if isinstance(data, memoryview) \
                else bytes(data)
            self.meta_rpc_count += 1
            self._server.store_payload(object_id, payload, kind,
                                       owner or self.default_owner)
            return ObjectRef(id=object_id, size=size, kind=kind)
        segment, offset = self._write_local(object_id, data)
        try:
            self.meta_rpc_count += 1
            self._server.seal(object_id, segment, size, kind,
                              owner or self.default_owner, offset,
                              self.host_id, self.payload_addr)
        except BaseException:
            self._release_local([(segment, offset)])
            raise
        return ObjectRef(id=object_id, size=size, kind=kind)

    def put_raw_many(self, items: Sequence[Tuple[Any, str]],
                     owner: Optional[str] = None) -> List[ObjectRef]:
        """Write many payloads locally and seal them with ONE ``seal_batch``
        RPC — the batched half of the metadata plane (a map task's B shuffle
        buckets, or createDataFrame's N chunks, used to cost one head
        round-trip each). ``items`` are ``(data, kind)`` pairs; order is
        preserved. All-or-nothing on the seal: a rejected batch releases
        every payload written here."""
        if self.remote:
            return [self.put_raw(d, kind=k, owner=owner) for d, k in items]
        own = owner or self.default_owner
        refs: List[ObjectRef] = []
        specs: List[Tuple] = []
        written: List[Tuple[str, int]] = []
        try:
            for data, kind in items:
                object_id = new_object_id()
                size = len(data)
                segment, offset = self._write_local(object_id, data)
                written.append((segment, offset))
                specs.append((object_id, segment, size, kind, own, offset,
                              self.host_id, self.payload_addr))
                refs.append(ObjectRef(id=object_id, size=size, kind=kind))
            if specs:
                self.meta_rpc_count += 1
                self._server.seal_batch(specs)
        except BaseException:
            self._release_local(written)
            raise
        return refs

    def put(self, obj: Any, owner: Optional[str] = None) -> ObjectRef:
        if isinstance(obj, pa.Table):
            return self.put_arrow(obj, owner=owner)
        return self.put_raw(cloudpickle.dumps(obj), kind=KIND_PICKLE, owner=owner)

    def put_arrow(self, table: pa.Table, owner: Optional[str] = None) -> ObjectRef:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        buf = sink.getvalue()
        return self.put_raw(memoryview(buf), kind=KIND_ARROW, owner=owner)

    def put_arrow_many(self, tables: Sequence[pa.Table],
                       owner: Optional[str] = None) -> List[ObjectRef]:
        """Serialize and store many tables, sealed with one batched RPC."""
        items = []
        for table in tables:
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, table.schema) as writer:
                writer.write_table(table)
            items.append((memoryview(sink.getvalue()), KIND_ARROW))
        return self.put_raw_many(items, owner=owner)

    # -- read -----------------------------------------------------------------
    def _memoize(self, object_id: str, entry: Tuple) -> None:
        segment, size, kind, offset, host_id, payload_addr = entry
        if offset >= 0:
            return  # arena-resident: a recycled offset would be read silently
        with self._lock:
            if len(self._lookup_memo) >= self._MEMO_CAP:
                self._lookup_memo.pop(next(iter(self._lookup_memo)))
            self._lookup_memo[object_id] = entry

    def _evict(self, object_id: str) -> None:
        """Drop everything this process cached about an object: the lookup
        memo entry AND the attached dedicated-segment handle (the arena
        attachment is shared by every arena object and stays). Called on
        free, on a lost object, and before a fresh-lookup retry — a stale
        handle would otherwise hold the mapping (and an open fd) for the
        life of the process."""
        with self._lock:
            self._lookup_memo.pop(object_id, None)
            seg = self._seg_of.pop(object_id, None)
            shm = self._attached.pop(seg, None) if seg is not None else None
        if shm is not None:
            self._close_handle(shm)
        self._sweep_retired()

    def _close_handle(self, shm: shared_memory.SharedMemory) -> None:
        try:
            shm.close()
        except Exception:
            # a borrowed view still pins the mapping: keep a strong ref and
            # retry later (a GC-time __del__ would raise the same
            # BufferError, just noisily)
            with self._lock:
                self._retired.append(shm)

    def _sweep_retired(self) -> None:
        with self._lock:
            retired, self._retired = self._retired, []
        for shm in retired:
            self._close_handle(shm)

    def _lookup_entry(self, object_id: str, fresh: bool = False) -> Tuple:
        if not fresh:
            with self._lock:
                hit = self._lookup_memo.get(object_id)
            if hit is not None:
                return hit
        elif not self.remote:
            self._evict(object_id)
        self.meta_rpc_count += 1
        entry = tuple(self._server.lookup(object_id))
        self._memoize(object_id, entry)
        return entry

    def lookup_many(self, object_ids: Sequence[str],
                    fresh: bool = False) -> Dict[str, Tuple]:
        """Resolve many objects with at most ONE ``lookup_batch`` RPC (memo
        hits cost nothing). Missing ids are absent from the result."""
        out: Dict[str, Tuple] = {}
        todo: List[str] = []
        for oid in dict.fromkeys(object_ids):
            hit = None
            if not fresh:
                with self._lock:
                    hit = self._lookup_memo.get(oid)
            elif not self.remote:
                self._evict(oid)
            if hit is not None:
                out[oid] = hit
            else:
                todo.append(oid)
        if todo:
            self.meta_rpc_count += 1
            for oid, entry in self._server.lookup_batch(todo).items():
                entry = tuple(entry)
                self._memoize(oid, entry)
                out[oid] = entry
        return out
    def _attach(self, object_id: str) -> Tuple[memoryview, str]:
        rule = faults.check("store.get", key=object_id)
        if rule is not None:
            if rule.action == "drop":
                # genuinely remove the blob (the store-host-died model), so
                # every later reader misses too — recovery must regenerate,
                # not merely retry
                try:
                    self._server.free([object_id])
                except Exception:
                    pass
                raise ObjectLostError(object_id, "fault-injected drop")
            faults.apply(rule, "store.get")
        try:
            try:
                return self._attach_once(object_id)
            except FileNotFoundError:
                # the payload moved (spill eviction recycled the segment
                # between our lookup and attach): one fresh lookup resolves
                # the new home (and evicts the stale memo entry + handle)
                return self._attach_once(object_id, fresh=True)
            except Exception as e:
                # the same lookup/attach race through an RPC proxy: the
                # server's FileNotFoundError arrives as a RemoteError, so it
                # gets the same single fresh-lookup retry — a still-alive
                # blob must not be escalated to "lost" (which bypasses task
                # retry and re-executes its producer)
                if getattr(e, "exc_type", None) == "FileNotFoundError":
                    return self._attach_once(object_id, fresh=True)
                raise
        except ObjectLostError:
            self._evict(object_id)
            raise
        except KeyError as e:
            # table lookup miss (head in-process) — the blob is gone
            self._evict(object_id)
            raise ObjectLostError(object_id, "not in store table") from e
        except FileNotFoundError as e:
            self._evict(object_id)
            raise ObjectLostError(object_id, f"segment vanished: {e}") from e
        except Exception as e:
            # lookup/fetch through an RPC proxy surfaces the server's
            # KeyError (table miss) or FileNotFoundError (segment vanished on
            # the payload host) as a RemoteError; duck-type on exc_type to
            # avoid importing rpc
            if getattr(e, "exc_type", None) in _REMOTE_LOST_EXC_TYPES:
                self._evict(object_id)
                raise ObjectLostError(object_id, "blob unreachable: "
                                      f"{getattr(e, 'message', e)}") from e
            raise

    def _attach_once(self, object_id: str,
                     fresh: bool = False) -> Tuple[memoryview, str]:
        if self.remote:
            self.fetch_rpc_count += 1
            data, kind = self._server.fetch_payload(object_id)
            return memoryview(data), kind
        segment, size, kind, offset, host_id, payload_addr = \
            self._lookup_entry(object_id, fresh=fresh)
        if host_id != self.host_id:
            # payload lives on another machine: ONE direct hop to the owning
            # node's payload server (never through the head — parity with
            # plasma's node-to-node object transfer)
            if payload_addr:
                import concurrent.futures as _cf
                try:
                    # bounded: a wedged-but-connected owner must fail the
                    # read into task retry / lineage recovery, not hang it
                    self.fetch_rpc_count += 1
                    data = self._peer(payload_addr).call(
                        "store_fetch", segment, offset, size, timeout=60.0)
                except (OSError, _cf.TimeoutError, TimeoutError) as e:
                    # the store host died/wedged with the table entry still
                    # present (purge_host lags the death): this IS the
                    # lost-blob case — surface the typed signal so lineage
                    # recovery regenerates instead of the consumer burning
                    # its retry budget against a dead host. ConnectionLost
                    # subclasses RpcError, not OSError — duck-type it.
                    raise ObjectLostError(
                        object_id,
                        f"payload host {payload_addr} unreachable: {e}") \
                        from e
                except Exception as e:
                    if type(e).__name__ == "ConnectionLost":
                        raise ObjectLostError(
                            object_id,
                            f"payload host {payload_addr} unreachable: {e}") \
                            from e
                    raise
            else:  # owner is the head machine; the table server serves it
                self.fetch_rpc_count += 1
                data, kind = self._server.fetch_payload(object_id)
            return memoryview(data), kind
        view = self._local_view(object_id, segment, offset, size)
        return view, kind

    def _local_view(self, object_id: str, segment: str, offset: int,
                    size: int) -> memoryview:
        """Zero-copy view of a same-machine payload, attaching (and caching)
        the segment handle. Dedicated segments are recorded per object id so
        free/loss can evict the handle."""
        with self._lock:
            shm = self._attached.get(segment)
            if shm is None:
                shm = shared_memory.SharedMemory(name=segment)
                _untrack(shm)
                self._attached[segment] = shm
            if offset < 0:
                self._seg_of[object_id] = segment
        if offset >= 0:
            return shm.buf[offset:offset + size]
        return shm.buf[:size]

    def get_buffer(self, ref: ObjectRef) -> memoryview:
        """Borrowed zero-copy view; valid only until the object is freed."""
        view, _ = self._attach(ref.id)
        return view

    def get(self, ref: ObjectRef, zero_copy: bool = False) -> Any:
        """Resolve an object. Arrow payloads copy their IPC stream out of the
        store by default so the result outlives ``free``; hot paths that
        consume the table immediately (e.g. the device feed, which copies to
        HBM anyway) pass ``zero_copy=True`` to decode in place."""
        view, kind = self._attach(ref.id)
        if kind == KIND_ARROW:
            buf = pa.py_buffer(view) if zero_copy else pa.py_buffer(bytes(view))
            return pa.ipc.open_stream(buf).read_all()
        if kind == KIND_PICKLE:
            return cloudpickle.loads(bytes(view))
        return bytes(view)

    def get_many(self, refs: List[ObjectRef], zero_copy: bool = False) -> List[Any]:
        return [self.get(r, zero_copy=zero_copy) for r in refs]

    # -- ranged reads (consolidated shuffle blobs) -----------------------------
    def get_range_buffers(self, parts: Sequence[Tuple[ObjectRef, int, int]]
                          ) -> List[bytes]:
        """Payload byte ranges: ``(ref, offset, size)`` per part, offsets
        relative to the payload. Control traffic is batched — ONE
        ``lookup_batch`` for all distinct refs (memo hits free), then one
        ``store_fetch_ranges`` RPC per remote payload host, fanned out on
        threads across distinct hosts; same-machine ranges are sliced out of
        the attached segment with no RPC at all. A vanished segment gets the
        standard one-fresh-lookup retry before escalating to
        :class:`ObjectLostError`."""
        if not parts:
            return []
        if self.remote:
            # compatibility path (shm-less client): one head-mediated fetch
            # per DISTINCT blob, sliced locally. Losses get the same typed
            # translation as _attach — a table miss must route into lineage
            # recovery, not fail the stage as a bare KeyError
            blobs: Dict[str, bytes] = {}
            for ref, _, _ in parts:
                if ref.id in blobs:
                    continue
                self.fetch_rpc_count += 1
                try:
                    data, _ = self._server.fetch_payload(ref.id)
                except ObjectLostError:
                    raise
                except (KeyError, FileNotFoundError) as e:
                    raise ObjectLostError(ref.id,
                                          "not in store table") from e
                except Exception as e:
                    if getattr(e, "exc_type", None) \
                            in _REMOTE_LOST_EXC_TYPES:
                        raise ObjectLostError(
                            ref.id, "blob unreachable: "
                            f"{getattr(e, 'message', e)}") from e
                    raise
                blobs[ref.id] = data
            return [bytes(blobs[ref.id][off:off + size])
                    for ref, off, size in parts]
        try:
            return self._get_ranges_once(parts, fresh=False)
        except ObjectLostError:
            raise
        except (FileNotFoundError, KeyError):
            # stale location (spill/fault-in moved the payload between our
            # lookup and read): one fresh lookup resolves the new home
            return self._get_ranges_once(parts, fresh=True)
        except Exception as e:
            if getattr(e, "exc_type", None) in _REMOTE_STALE_EXC_TYPES:
                return self._get_ranges_once(parts, fresh=True)
            raise

    def _get_ranges_once(self, parts: Sequence[Tuple[ObjectRef, int, int]],
                         fresh: bool) -> List[bytes]:
        ids = [ref.id for ref, _, _ in parts]
        entries = self.lookup_many(ids, fresh=fresh)
        missing = next((oid for oid in ids if oid not in entries), None)
        if missing is not None:
            self._evict(missing)
            raise ObjectLostError(missing, "not in store table")
        out: List[Optional[bytes]] = [None] * len(parts)
        # group remote ranges per payload host; local ones slice immediately.
        # Remote items carry (index, segment, base, start, size, oid): base
        # is the payload's table offset (arena offset / -1 for a dedicated
        # segment) and start the range offset within the payload — the
        # payload host needs both to route arena vs segment reads.
        groups: Dict[Optional[str],
                     List[Tuple[int, str, int, int, int, str]]] = {}
        for i, (ref, off, size) in enumerate(parts):
            segment, esize, kind, eoff, host_id, addr = entries[ref.id]
            if off + size > esize:
                raise ValueError(
                    f"range [{off}, {off + size}) exceeds payload size "
                    f"{esize} of object {ref.id}")
            if host_id == self.host_id:
                try:
                    # whole-payload view (zero-copy), then slice the range
                    view = self._local_view(ref.id, segment, eoff, esize)
                except FileNotFoundError:
                    if fresh:
                        # the segment is gone even after a fresh lookup: the
                        # blob is lost — surface the typed signal so lineage
                        # recovery regenerates instead of the consumer
                        # burning its retry budget on a repeating miss
                        self._evict(ref.id)
                        raise ObjectLostError(
                            ref.id, "segment vanished") from None
                    raise
                out[i] = bytes(view[off:off + size])
            else:
                groups.setdefault(addr, []).append(
                    (i, segment, eoff, off, size, ref.id))

        def _fetch_group(addr, items):
            ranges = [(seg, base, start, size)
                      for _, seg, base, start, size, _ in items]
            self.fetch_rpc_count += 1
            try:
                if addr:
                    chunks = self._peer(addr).call(
                        "store_fetch_ranges", ranges, timeout=60.0)
                else:  # payloads hosted on the head machine
                    chunks = self._server.fetch_ranges(ranges)
            except Exception as e:
                import concurrent.futures as _cf
                # KeyError covers a peer arena that no longer hosts the
                # segment (payload re-homed) — same stale-location shape as
                # a vanished dedicated segment
                if getattr(e, "exc_type", None) in _REMOTE_STALE_EXC_TYPES \
                        or isinstance(e, (FileNotFoundError, KeyError)):
                    if fresh:  # gone even after the fresh lookup: lost
                        for item in items:
                            self._evict(item[-1])
                        raise ObjectLostError(
                            items[0][-1],
                            f"payload vanished on {addr or 'head'}: {e}") \
                            from e
                    raise
                if isinstance(e, (OSError, _cf.TimeoutError, TimeoutError)) \
                        or type(e).__name__ == "ConnectionLost":
                    for item in items:
                        self._evict(item[-1])
                    raise ObjectLostError(
                        items[0][-1],
                        f"payload host {addr or 'head'} unreachable: {e}") \
                        from e
                raise
            for item, chunk in zip(items, chunks):
                out[item[0]] = chunk

        if len(groups) == 1:
            addr, items = next(iter(groups.items()))
            _fetch_group(addr, items)
        elif groups:
            import concurrent.futures as _cf
            with _cf.ThreadPoolExecutor(
                    max_workers=min(4, len(groups))) as pool:
                futs = [pool.submit(_fetch_group, addr, items)
                        for addr, items in groups.items()]
                for f in futs:
                    f.result()
        return out  # type: ignore[return-value]

    # -- pipelined-shuffle seal notifications ----------------------------------
    def stream_begin(self, stage_key: str, num_maps: int) -> None:
        self._server.stream_begin(stage_key, int(num_maps))

    def stream_publish(self, stage_key: str, map_id: int, gen: int,
                       ref_id: str, size: int,
                       index: Sequence[Sequence[int]]) -> None:
        self._server.stream_publish(stage_key, int(map_id), int(gen),
                                    ref_id, int(size), list(index))

    def stream_poll(self, stage_key: str, bucket: int,
                    have: Optional[Dict[int, int]] = None,
                    timeout_s: float = 10.0) -> Dict[str, Any]:
        """One seal-stream poll round. In-process (driver) callers get the
        server's DeferredReply and wait its future here; proxied callers
        (executors) receive the final dict — the head's RPC server resolves
        the deferred reply before the response frame ships."""
        self.stream_poll_count += 1
        res = self._server.stream_poll(stage_key, int(bucket),
                                       dict(have or {}), float(timeout_s))
        if isinstance(res, DeferredReply):
            res = res.future.result()
        return res

    def stream_abort(self, stage_key: str, message: str) -> None:
        self._server.stream_abort(stage_key, str(message))

    def stream_close(self, stage_keys: Sequence[str]) -> None:
        self._server.stream_close(list(stage_keys))

    # -- lifetime -------------------------------------------------------------
    def free(self, refs: List[ObjectRef]) -> int:
        """Release blobs; idempotent and duplicate-tolerant — a speculation
        loser's outputs can reach free() from the late-result drain AND a
        stage-abort sweep, and the store-count audits (chaos tests) rely on
        a double free never going negative or erroring. The server pop
        already ignores unknown ids; ids are deduped here so a batch with
        repeats evicts local memo/segment state exactly once."""
        ids = list(dict.fromkeys(r.id for r in refs))
        if not ids:
            return 0
        for oid in ids:
            self._evict(oid)
        self.meta_rpc_count += 1
        return self._server.free(ids)

    def transfer_ownership(self, refs: List[ObjectRef], new_owner: str) -> int:
        self.meta_rpc_count += 1
        return self._server.transfer_ownership([r.id for r in refs], new_owner)

    def contains(self, ref: ObjectRef) -> bool:
        self.meta_rpc_count += 1
        return self._server.contains(ref.id)

    def locations(self, refs: List[ObjectRef]) -> Dict[str, str]:
        """``object_id -> host_id`` (the machine holding each payload)."""
        self.meta_rpc_count += 1
        return self._server.locations([r.id for r in refs])

    def residency(self, refs: List[ObjectRef]) -> Dict[str, Tuple[str, str]]:
        """``object_id -> (host_id, tier)`` with tier ``"shm"`` or
        ``"spilled"`` — the engine's data-gravity locality source (the
        tier-blind twin is :meth:`locations`)."""
        self.meta_rpc_count += 1
        return self._server.residency([r.id for r in refs])

    def eviction_hints(self, pin: Optional[List[ObjectRef]] = None,
                       unpin: Optional[List[ObjectRef]] = None,
                       evict_first: Optional[List[ObjectRef]] = None
                       ) -> Dict[str, int]:
        """Push stage-aware eviction hints (pin the stage being consumed,
        evict-first what its consumers finished with). Policy-plane, not
        metadata-plane: deliberately NOT counted in ``meta_rpc_count``,
        so the benches' metadata-RPC comparisons measure the data plane
        unchanged."""
        return self._server.eviction_hints(
            [r.id for r in pin or ()],
            [r.id for r in unpin or ()],
            [r.id for r in evict_first or ()])

    def derive_budgets(self, measured_bytes: int) -> Dict[str, int]:
        """Re-derive per-host store budgets from measured stage bytes
        (policy-plane; uncounted like :meth:`eviction_hints`)."""
        return self._server.derive_budgets(int(measured_bytes))

    def stats(self) -> Dict[str, Any]:
        return self._server.stats()

    def rpc_counters(self) -> Dict[str, int]:
        """Control-plane calls this process issued: ``meta`` (table server),
        ``fetch`` (payload-fetch RPCs; zero on the pure local-shm path), and
        ``stream_poll`` (pipelined-shuffle seal polls — long waits, counted
        apart so they never pollute the metadata-plane comparisons)."""
        return {"meta": self.meta_rpc_count, "fetch": self.fetch_rpc_count,
                "stream_poll": self.stream_poll_count}

    def close(self) -> None:
        self._sweep_retired()
        with self._lock:
            for shm in self._attached.values():
                try:
                    shm.close()
                except Exception:
                    self._retired.append(shm)
            self._attached.clear()
            self._seg_of.clear()
            self._lookup_memo.clear()
            for client in self._peers.values():
                try:
                    client.close()
                except Exception:
                    pass
            self._peers.clear()
            # the write-arena mapping is deliberately NOT munmapped here: an
            # in-flight put_raw may still be writing through a view, and the
            # OS reclaims the mapping at process exit anyway
            self._arena = None
            self._arena_probed = False


# -- process-global client (set by head init / actor bootstrap) ---------------------
_client: Optional[ObjectStoreClient] = None


def set_client(client: Optional[ObjectStoreClient]) -> None:
    global _client
    _client = client


def get_client() -> ObjectStoreClient:
    if _client is None:
        raise RuntimeError(
            "no object store client in this process; call init_runtime() first")
    return _client
