"""The ETL executor actor: computes partitions, serves cached blocks.

Parity: ``RayDPExecutor`` — a worker hosted as a runtime actor that computes
partitions and doubles as the data-plane server for cached Arrow blocks
(RayDPExecutor.scala:103-249 serves Spark tasks; 271-355 serves
``getBlockLocations``/``getRDDPartition`` with recache-on-miss). Restart behavior:
a revived executor re-registers with the master under a fresh executor id and the
master keeps the old→new mapping (RayDPExecutor.scala:82-101,
RayAppMaster.scala:192-209); our executor does the same through
``current_actor_context().was_restarted``.
"""

from __future__ import annotations

import os
import sys
import threading
import uuid
from typing import Any, Dict, List, Optional

import cloudpickle
import pyarrow as pa

from raydp_tpu_torch import faults, knobs
from raydp_tpu_torch.etl import tasks as T
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime.actor import current_actor_context
from raydp_tpu_torch.runtime.object_store import get_client

logger = get_logger("etl.executor")


class BlockCache:
    """In-memory named Arrow block cache (the BlockManager analogue)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: Dict[str, pa.Table] = {}  # guarded-by: _lock
        #: per-put generation stamp — a drop conditioned on a stamp only
        #: removes the exact entry its caller saw, so a drain-abandoned
        #: straggler's deferred cleanup can't delete the live block a
        #: recovery resubmit of the same task cached under the same key
        self._stamps: Dict[str, Optional[str]] = {}  # guarded-by: _lock

    def get(self, key: str) -> Optional[pa.Table]:
        with self._lock:
            return self._blocks.get(key)

    def put(self, key: str, table: pa.Table,
            stamp: Optional[str] = None) -> None:
        with self._lock:
            self._blocks[key] = table
            self._stamps[key] = stamp

    def put_once(self, key: str, table: pa.Table,
                 stamp: Optional[str] = None) -> Optional[str]:
        """Idempotent cache-put for duplicate task attempts (speculative
        backups, recovery resubmits racing a drain-abandoned straggler): if
        the key is already cached, keep the existing entry and return ITS
        stamp — tasks are deterministic recipes, so two attempts' tables are
        byte-identical, and sharing one entry + stamp lets the driver's
        loser drain recognize "the loser's block IS the winner's block" and
        skip the drop. Worst case (the first writer's deferred drop fires
        later) the block vanishes and the next read rebuilds it from its
        lineage recipe — never wrong data, never a pinned stale table."""
        with self._lock:
            if key in self._blocks:
                return self._stamps.get(key)
            self._blocks[key] = table
            self._stamps[key] = stamp
            return stamp

    def drop(self, keys: List[str], if_stamp: Optional[str] = None) -> int:
        with self._lock:
            n = 0
            for k in keys:
                if if_stamp is not None and self._stamps.get(k) != if_stamp:
                    continue
                if self._blocks.pop(k, None) is not None:
                    self._stamps.pop(k, None)
                    n += 1
            return n

    def drop_prefix(self, prefix: str) -> int:
        with self._lock:
            victims = [k for k in self._blocks if k.startswith(prefix)]
            for k in victims:
                del self._blocks[k]
                self._stamps.pop(k, None)
            return len(victims)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._blocks)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(t.nbytes for t in self._blocks.values())


_block_cache: Optional[BlockCache] = None


def current_block_cache() -> BlockCache:
    """The block cache of the executor actor this code is running in."""
    if _block_cache is None:
        raise RuntimeError("no block cache: not inside an ETL executor actor")
    return _block_cache


class BroadcastCache:
    """Bounded process-local cache of broadcast-join build tables.

    The AQE broadcast rule replicates a small join side to every executor;
    this cache is the executor half of that replication — the FIRST
    ``BroadcastJoinStep`` on an executor pays the batched ranged fetch, and
    every sibling partition probes the already-built table. Keys embed the
    exact (blob id, offset, size) ranges, so a lineage-regenerated broadcast
    side (fresh blob ids) misses and refetches instead of probing stale
    bytes. LRU-bounded: a long session running many different joins holds at
    most ``max_entries`` small-side tables in executor RAM."""

    def __init__(self, max_entries: int = 4):
        self._lock = threading.Lock()
        self._max = max_entries
        # guarded-by: _lock; insertion-ordered (LRU via re-insert)
        self._tables: "dict" = {}

    def get_or_load(self, key, loader):
        with self._lock:
            hit = self._tables.pop(key, None)
            if hit is not None:
                self._tables[key] = hit  # re-insert: most recently used
                return hit
        # load OUTSIDE the lock: a slow fetch must not serialize sibling
        # tasks probing other (cached) broadcasts; a duplicate concurrent
        # load of the same key is benign (deterministic bytes, last wins)
        table = loader()
        with self._lock:
            self._tables[key] = table
            while len(self._tables) > self._max:
                self._tables.pop(next(iter(self._tables)))
        return table

    def clear(self) -> None:
        with self._lock:
            self._tables.clear()


_broadcast_cache = BroadcastCache()


def broadcast_cache() -> BroadcastCache:
    """The process-local broadcast-side table cache (executors; also used
    in-process by unit tests running steps directly)."""
    return _broadcast_cache


class EtlExecutor:
    """Actor class. One instance per executor process."""

    def __init__(self, master_name: Optional[str] = None):
        global _block_cache
        self.cache = BlockCache()
        _block_cache = self.cache
        self.executor_id: Optional[str] = None
        ctx = current_actor_context()
        self._actor_name = ctx.name if ctx else f"local-{uuid.uuid4().hex[:6]}"
        # register with the master; a restarted actor asks for a fresh executor id
        # (parity: RequestAddPendingRestartedExecutor, RayAppMaster.scala:192-209)
        if master_name and ctx is not None:
            from raydp_tpu_torch.runtime.head import ENV_HEAD  # noqa: F401 (doc pointer)
            from raydp_tpu_torch.runtime.rpc import RpcClient
            master_id = ctx.head.call("get_named_actor", master_name)
            if master_id is not None:
                address = ctx.head.call("get_actor_address", master_id)
                if address is not None:
                    master = RpcClient(tuple(address))
                    self.executor_id = master.call(
                        "register_executor", self._actor_name, ctx.was_restarted)
                    master.close()

    # -- control ---------------------------------------------------------------
    def ping(self) -> str:
        return "pong"

    def crash(self) -> None:
        """Fault injection: die abruptly (tests' node-kill analogue). The
        declarative twin is an ``executor.run_task:crash`` rule in
        ``RDT_FAULTS`` (see raydp_tpu_torch/faults.py)."""
        faults.crash_process()

    def get_executor_id(self) -> Optional[str]:
        return self.executor_id

    def spawn_info(self) -> Dict[str, Any]:
        """Spawn provenance: ``warm_forked`` is True when this process was
        forked from the pre-imported warm-start prototype (the warm plane
        injects RDT_WARM_FORKED into the child env) rather than cold-spawned
        — the gravity bench's readiness audit reads this to prove the warm
        path actually served the scale-up."""
        return {"executor": self._actor_name, "pid": os.getpid(),
                "warm_forked": bool(knobs.get("RDT_WARM_FORKED"))}

    # -- compute ---------------------------------------------------------------
    def run_task(self, task_bytes: bytes):
        """Execute one task; the return shape depends on the task's output
        mode. Tasks with a STREAMING source (pipelined-shuffle reducers, and
        downstream map tasks reading a pipelined stage) run on a dedicated
        daemon thread behind a :class:`~raydp_tpu_torch.runtime.rpc.DeferredReply`:
        they spend most of their life waiting on seal notifications and
        eagerly fetching/decoding arriving portions, and parking one of the
        bounded RPC dispatcher threads on that wait could starve — or, with
        every dispatcher parked, deadlock — the very map tasks being waited
        on. One thread per streaming task (no pool, so no queue to deadlock
        in); the count is bounded by the driver's per-executor in-flight
        caps."""
        from concurrent.futures import Future

        from raydp_tpu_torch import profiler
        from raydp_tpu_torch.runtime.rpc import DeferredReply

        task: T.Task = cloudpickle.loads(task_bytes)
        if T.stream_sources_of(task):
            fut: Future = Future()
            # the dispatcher thread holds the caller's trace context (the
            # RPC layer installed it); a plain Thread would lose it — hand
            # it across explicitly so the task's spans keep their driver
            # stage as parent
            ctx = profiler.capture()

            def _run():
                try:
                    with profiler.activate(ctx):
                        fut.set_result(self._run_task_obj(task))
                except BaseException as e:  # noqa: BLE001 - serialize any
                    fut.set_exception(e)

            threading.Thread(target=_run, daemon=True,
                             name=f"rdt-stream-{task.task_id}").start()
            return DeferredReply(fut)
        return self._run_task_obj(task)

    def _run_task_obj(self, task: T.Task) -> Dict[str, Any]:
        from raydp_tpu_torch import profiler

        # the fault key carries the executor name so a chaos schedule can
        # target ONE executor (`match=<executor name>|` = a seeded straggler
        # or crashy node) as well as one task (`match=<task id>`; shuffle map
        # tasks carry an `mt-` id prefix, so `match=|mt-` pins the map side)
        rule = faults.check("executor.run_task",
                            key=f"{self._actor_name}|{task.task_id}")
        if rule is not None:
            faults.apply(rule, "executor.run_task")
        client = get_client()
        # per-task store control-plane deltas for the engine's shuffle ledger.
        # Concurrent tasks share the process counters, so an op can land in
        # every overlapping task's window: the per-stage sums are an upper
        # bound under concurrency, good for relative comparisons — the exact
        # session-wide numbers live in ObjectStoreServer.op_counts()
        rpc0 = client.rpc_counters()

        def _with_rpcs(result: Dict[str, Any]) -> Dict[str, Any]:
            rpc1 = client.rpc_counters()
            result["meta_rpcs"] = rpc1["meta"] - rpc0["meta"]
            result["fetch_rpcs"] = rpc1["fetch"] - rpc0["fetch"]
            # streamed reads leave overlap/first-fetch stats on their
            # sources; the driver folds them into the CONSUMED stage's entry
            result.update(T.collect_stream_stats(task))
            return result

        pre = (int(getattr(task, "shuffle_pre_steps", 0) or 0)
               if task.output == T.SHUFFLE else 0)
        rows_in = bytes_in = None
        with profiler.trace(f"task:{type(task.source).__name__}", "etl",
                            task_id=task.task_id):
            if pre:
                # run the narrow chain, measure what ENTERS the shuffle
                # stage, then apply the shuffle-side steps (partial agg)
                trimmed = task.with_output(steps=task.steps[:-pre])
                table = T.run_task_body(trimmed)
                rows_in, bytes_in = table.num_rows, table.nbytes
                with profiler.trace("shuffle:map-partial", "etl",
                                    task_id=task.task_id, rows_in=rows_in,
                                    bytes_in=bytes_in):
                    for step in task.steps[-pre:]:
                        table = step.run(table)
            else:
                table = T.run_task_body(task)
        owner = task.owner

        if task.output == T.ROWCOUNT:
            return _with_rpcs({"num_rows": table.num_rows})

        if task.output == T.COLLECT:
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, table.schema) as w:
                w.write_table(table)
            return _with_rpcs({"ipc": sink.getvalue().to_pybytes(),
                               "num_rows": table.num_rows})

        if task.output == T.CACHE:
            assert task.cache_key is not None
            # put_once: a speculative duplicate of this task may have cached
            # the key already — both attempts then report the SAME stamp, so
            # the driver's loser drain knows the entries coincide
            stamp = self.cache.put_once(task.cache_key, table,
                                        uuid.uuid4().hex)
            return _with_rpcs({
                "num_rows": table.num_rows,
                "nbytes": table.nbytes,
                "cache_key": task.cache_key,
                "cache_stamp": stamp,
                "executor": self._actor_name,
                "schema": table.schema.serialize().to_pybytes(),
            })

        if task.output == T.SHUFFLE:
            with profiler.trace("shuffle:bucket", "etl",
                                task_id=task.task_id,
                                rows_in=table.num_rows):
                if task.range_key is not None:
                    key, boundaries, *rest = task.range_key
                    if isinstance(key, str):  # legacy single-key format
                        buckets = T.range_buckets(
                            table, key, boundaries,
                            nulls_high=bool(rest and rest[0]))
                    else:  # composite: key = [(name, order), ...]
                        buckets = T.range_buckets_multi(table, key, boundaries)
                elif task.shuffle_keys:
                    buckets = T.hash_buckets(table, task.shuffle_keys,
                                             task.num_buckets)
                elif task.shuffle_seed is not None:
                    buckets = T.random_buckets(table, task.num_buckets,
                                               task.shuffle_seed)
                else:
                    start = T.hash_bytes(task.task_id) % max(task.num_buckets, 1)
                    buckets = T.round_robin_buckets(table, task.num_buckets,
                                                    start)
            consolidated_index = None
            if getattr(task, "shuffle_consolidate", False):
                # consolidated map output: every bucket serialized
                # back-to-back as independent Arrow IPC streams into ONE blob
                # (a single arena allocation), sealed with a single RPC; the
                # (offset, size, rows) index lets each reduce task read only
                # its bucket's byte range (tasks.RangeRefSource)
                sink = pa.BufferOutputStream()
                consolidated_index = []
                for b in buckets:
                    start = sink.tell()
                    with pa.ipc.new_stream(sink, b.schema) as w:
                        w.write_table(b)
                    consolidated_index.append(
                        (int(start), int(sink.tell() - start), b.num_rows))
                ref = client.put_raw(memoryview(sink.getvalue()),
                                     owner=owner)
                refs = [ref]
            else:
                refs = [client.put_arrow(b, owner=owner) for b in buckets]
            rule = faults.check("shuffle.write", key=task.task_id)
            if rule is not None:
                if rule.action == "drop" and refs:
                    # the blob is written, its ref handed to the driver — and
                    # the payload silently dies before the reduce stage reads
                    # it (the store-host-died model the lineage ledger
                    # exists for). On the consolidated path there is exactly
                    # ONE blob per map task — bucket= wraps onto it, so the
                    # drop takes every bucket at once and recovery must
                    # rebuild the whole consolidated output
                    victim = refs[rule.bucket % len(refs)]
                    try:
                        client.free([victim])
                    except Exception:
                        pass
                    logger.warning("fault plane dropped shuffle bucket %s "
                                   "of %s", victim.id, task.task_id)
                else:
                    # a fired rule must never be swallowed (its once-sentinel
                    # is already claimed): generic actions apply here too. An
                    # injected raise fails the task AFTER its buckets hit the
                    # store — free them first, or the retry's fresh copies
                    # leave these orphaned until session shutdown (crash is
                    # deliberately not cleaned up: an abruptly dead process
                    # leaves its writes behind, which is the point)
                    if rule.action == "raise" and refs:
                        try:
                            client.free(refs)
                        except Exception:
                            pass
                    faults.apply(rule, "shuffle.write")
            # ref.size is the serialized payload written to the store — the
            # honest bytes-moved number (bucket tables are zero-copy slices,
            # whose nbytes would overcount shared buffers)
            shuffle_bytes = sum(int(getattr(r, "size", 0) or 0) for r in refs)
            with profiler.trace("shuffle:write", "etl", task_id=task.task_id,
                                rows_out=table.num_rows,
                                bytes_out=shuffle_bytes,
                                consolidated=consolidated_index is not None):
                pass
            result = {
                "num_rows": table.num_rows,
                "shuffle_bytes": shuffle_bytes,
                # pre-shuffle-stage size (differs from num_rows/bytes out
                # when map-side partial aggregation ran; bytes_in is the
                # in-memory table estimate, bytes out are serialized sizes)
                "shuffle_rows_in": rows_in if rows_in is not None
                else table.num_rows,
                "shuffle_bytes_in": bytes_in if bytes_in is not None
                else table.nbytes,
                "schema": table.schema.serialize().to_pybytes(),
            }
            if consolidated_index is not None:
                result["consolidated_ref"] = refs[0]
                result["bucket_index"] = consolidated_index
            else:
                result["bucket_refs"] = refs
            return _with_rpcs(result)

        # default: RETURN_REF
        ref = client.put_arrow(table, owner=owner)
        return _with_rpcs({
            "ref": ref,
            "num_rows": table.num_rows,
            "nbytes": table.nbytes,
            "schema": table.schema.serialize().to_pybytes(),
        })

    # -- serving replicas (raydp_tpu_torch/serve/replica.py) -------------------
    def serve_load(self, replica_id: str, export_dir: str,
                   device: Optional[str] = None) -> Dict[str, Any]:
        """(Re)load a serving replica in this process from an exported
        bundle, on ``device`` (``None``: CUDA, raising without it);
        idempotent per (id, dir). The first load imports torch and takes
        this process's CUDA context. A restarted executor comes back with
        an empty registry — the driver calls this again on the
        ``ReplicaNotLoaded`` signal."""
        from raydp_tpu_torch.serve import replica as serve_replica
        return serve_replica.load(replica_id, export_dir, self._actor_name,
                                  device)

    def serve_predict(self, replica_id: str, payload: bytes):
        """One encoded micro-batch → prediction array. Enqueues onto the
        replica's worker (decode/stage/H2D overlap the apply there) and
        returns a DeferredReply — a slow model never parks this bounded
        dispatcher pool."""
        from raydp_tpu_torch.serve import replica as serve_replica
        return serve_replica.predict(replica_id, payload)

    def serve_unload(self, replica_id: str) -> bool:
        from raydp_tpu_torch.serve import replica as serve_replica
        return serve_replica.unload(replica_id)

    def serve_stats(self) -> Dict[str, Any]:
        from raydp_tpu_torch.serve import replica as serve_replica
        return serve_replica.stats()

    # -- data-plane server (parity: getRDDPartition) ---------------------------
    def get_block(self, cache_key: str, recover_bytes: Optional[bytes] = None,
                  owner: Optional[str] = None) -> Dict[str, Any]:
        """Serve a cached block as an object-store ref; recompute on miss.

        Parity: RayDPExecutor.scala:312-355 — BlockManager read, recache via the
        driver agent on miss, then an Arrow IPC stream handed back through the
        object store.
        """
        table = self.cache.get(cache_key)
        if table is None:
            if recover_bytes is None:
                raise KeyError(f"block {cache_key} not cached and no lineage")
            task: T.Task = cloudpickle.loads(recover_bytes)
            table = T.run_task_body(task)
            self.cache.put(cache_key, table)
            logger.warning("recovered lost block %s via lineage", cache_key)
        ref = get_client().put_arrow(table, owner=owner)
        return {"ref": ref, "num_rows": table.num_rows}

    def warm_block(self, cache_key: str,
                   recover_bytes: Optional[bytes] = None) -> bool:
        """Pre-populate this executor's block cache — the graceful-drain
        re-homing path: a retiring executor's cached partition is rebuilt
        HERE from its lineage recipe (which reads the frame's pinned store
        blobs through the ranged-fetch plane) before the retiree is reaped,
        so later cache-local reads never pay the on-miss rebuild. Unlike
        :meth:`get_block`, nothing is written to the object store. True
        when the block is cached afterwards."""
        if self.cache.get(cache_key) is not None:
            return True
        if recover_bytes is None:
            return False
        task: T.Task = cloudpickle.loads(recover_bytes)
        table = T.run_task_body(task)
        self.cache.put(cache_key, table)
        return True

    def drain_info(self) -> Dict[str, Any]:
        """What this executor uniquely holds in process RAM — the drain
        protocol's inventory (cached blocks to re-home, serving replicas to
        re-route) and the scale bench's audit surface. An executor that
        never loaded a replica has not imported the serving plane (nor
        torch), and reading its empty registry imports neither."""
        serve_replica = sys.modules.get("raydp_tpu_torch.serve.replica")
        replicas = [] if serve_replica is None else sorted(
            r.get("replica", "") for r in serve_replica.stats()["replicas"])
        return {
            "executor": self._actor_name,
            "blocks": self.cache.keys(),
            "block_bytes": self.cache.total_bytes(),
            "replicas": replicas,
        }

    def has_block(self, cache_key: str) -> bool:
        return self.cache.get(cache_key) is not None

    def list_blocks(self) -> List[str]:
        return self.cache.keys()

    def drop_blocks(self, keys: List[str],
                    if_stamp: Optional[str] = None) -> int:
        return self.cache.drop(keys, if_stamp)

    def drop_block_prefix(self, prefix: str) -> int:
        return self.cache.drop_prefix(prefix)

    def cache_stats(self) -> Dict[str, Any]:
        return {"keys": self.cache.keys(), "total_bytes": self.cache.total_bytes()}
