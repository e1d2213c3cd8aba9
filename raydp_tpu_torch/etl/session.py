"""The ETL Session: the SparkSession analogue returned by ``raydp_tpu_torch.init``.

Bring-up parity (call stack §3.1 of SURVEY.md): create the master actor, then the
executor gang — each an actor with ``{CPU, memory}`` resources, scheduled into the
session's placement-group bundles round-robin (RayAppMaster.scala:290-303), with
``max_restarts=-1`` (RayExecutorUtils.java:58). Teardown order parity:
``stop(cleanup_data=False)`` keeps the master actor (and the objects it owns)
alive so converted datasets survive the ETL engine, exactly like
``RayDPSparkMaster.stop(cleanup_data)`` (ray_cluster_master.py:236-247).
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional, Union

import pandas as pd
import pyarrow as pa

from raydp_tpu_torch import config as cfg
from raydp_tpu_torch.config import Config
from raydp_tpu_torch.etl import plan as P
from raydp_tpu_torch.etl.engine import Engine, ExecutorPool
from raydp_tpu_torch.etl.frame import DataFrame
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime import get_runtime
from raydp_tpu_torch.runtime.actor import ActorHandle

logger = get_logger("etl.session")


class Session:
    def __init__(self, app_name: str, num_executors: int, executor_cores: int,
                 executor_memory: int, config: Optional[Config] = None,
                 placement_group=None):
        self.app_name = app_name
        self.num_executors = num_executors
        self.executor_cores = executor_cores
        self.executor_memory = executor_memory
        self.config = config or Config()
        self.placement_group = placement_group
        self.master_name = f"{app_name}_MASTER"
        self.master: Optional[ActorHandle] = None
        self.cluster = None  # EtlCluster after start()
        self.engine: Optional[Engine] = None
        self._cached_frames: Dict[str, P.CachedScan] = {}
        self._stopped = False
        self._autoscaler = None  # PoolAutoscaler once autoscale() is asked for
        #: serializes EVERY scale operation — manual request_total_executors,
        #: retire_executor, and the autoscaler's grow/shrink — so two racing
        #: ops can never read cluster.workers[-1] for each other's spawn or
        #: pick the same drain victim. Reentrant: request_total_executors
        #: holds it around the per-executor ops that also take it.
        self._scale_lock = threading.RLock()

    @property
    def executors(self) -> List[ActorHandle]:
        return self.cluster.workers if self.cluster is not None else []

    # ---- lifecycle ----------------------------------------------------------
    def start(self) -> "Session":
        """Bring-up through the generic :class:`~raydp_tpu_torch.cluster.Cluster`
        surface (reference services.py:22-90): the built-in engine is an
        :class:`EtlCluster`; an external engine subclasses ``Cluster`` and
        rides the same lifecycle."""
        from raydp_tpu_torch.cluster import EtlCluster

        master_resources = self.config.resource_map(
            cfg.MASTER_ACTOR_RESOURCE_PREFIX)
        self.cluster = EtlCluster(self.app_name, master_resources)
        self.master = self.cluster.master.handle

        for _ in range(self.num_executors):
            self._launch_executor(block=False)
        for h in self.executors:
            h.wait_ready()

        pool = ExecutorPool(self.executors,
                            hosts_by_name=self._executor_hosts())
        self.engine = Engine(
            pool,
            shuffle_partitions=self.config.get_int(cfg.SHUFFLE_PARTITIONS_KEY, 8),
            owner=self.master_name,
        )
        logger.info("session %s started: master + %d executors",
                    self.app_name, len(self.executors))
        return self

    def _launch_executor(self, block: bool = True) -> ActorHandle:
        executor_resources = {"CPU": float(self.executor_cores),
                              "memory": float(self.executor_memory)}
        executor_resources.update(
            self.config.resource_map(cfg.EXECUTOR_ACTOR_RESOURCE_PREFIX))
        max_restarts = self.config.get_int(cfg.EXECUTOR_RESTARTS_KEY, -1)
        pg_id, bundle = None, None
        if self.placement_group is not None:
            pg_id = self.placement_group.group_id
            bundle = (self.cluster._worker_index
                      % len(self.placement_group.bundles))
        self.cluster.add_worker(
            executor_resources,
            max_restarts=max_restarts,
            max_concurrency=max(2, self.executor_cores),
            placement_group=pg_id,
            bundle_index=bundle,
            block=block,
        )
        return self.cluster.workers[-1]

    def _executor_hosts(self) -> Dict[str, str]:
        """Executor name → data-plane host id, for locality-aware scheduling
        of ref-reading tasks (a no-op when everything shares one machine)."""
        hosts: Dict[str, str] = {}
        try:
            rt = get_runtime()
            for h in self.executors:
                rec = rt.records.get(h.actor_id)
                if rec is not None and h.name:
                    hosts[h.name] = rt.store_host_of_node(rec.node_id)
        except Exception:
            pass
        return hosts

    # ---- dynamic allocation / elastic pool ----------------------------------
    def request_total_executors(self, total: int) -> int:
        """Scale the executor gang to ``total`` live executors.

        Parity: Spark dynamic allocation routed to actor create/kill —
        ``doRequestTotalExecutors`` / ``doKillExecutors``
        (RayCoarseGrainedSchedulerBackend.scala:278-301, RayAppMaster.scala:
        173-190, 275-288). Shrinking DRAINS the newest executors gracefully
        (:meth:`retire_executor`: out of rotation, in-flight work finishes,
        cached blocks re-home or abandon to lineage, then the process is
        reaped); growing spawns through the ordinary launch path and admits
        each executor into the live pool once ready."""
        if total < 1:
            raise ValueError("need at least one executor")
        from raydp_tpu_torch import knobs
        with self._scale_lock:
            while len(self.executors) > total:
                victim = self._shrink_candidate()
                if victim is None:
                    break
                self.retire_executor(victim)
            # grow in PARALLEL: launch every missing executor non-blocking
            # first, then absorb their warm-ups concurrently through the
            # readiness probes (serial spawn+wait would pay the import
            # storm once per executor)
            need = total - len(self.executors)
            launched = [self._launch_executor(block=False)
                        for _ in range(need)]
            wait_s = float(knobs.get("RDT_EXECUTOR_WAIT_S"))
            ready, failures = [], []
            for h in launched:
                try:
                    h.wait_ready(timeout=wait_s)
                    ready.append(h)
                except Exception as e:  # noqa: BLE001 - reaped + re-raised
                    # a half-started worker is reaped, never admitted — and
                    # never left as an invisible member a later scale call
                    # would count but the scheduler never dispatches to
                    failures.append((h, e))
                    self.cluster.remove_worker(h)
            hosts = self._executor_hosts()  # once, not per admission
            if self.engine is not None:
                for h in ready:
                    self.engine.pool.add_executor(h,
                                                  host_id=hosts.get(h.name))
            if failures:
                raise RuntimeError(
                    f"{len(failures)}/{len(launched)} executors never "
                    f"became ready during scale-up (first: "
                    f"{failures[0][0].name})") from failures[0][1]
        logger.info("session %s scaled to %d executors", self.app_name,
                    len(self.executors))
        return len(self.executors)

    def retire_executor(self, name: str) -> int:
        """Gracefully drain executor ``name`` out of the session: scheduler
        rotation stops, in-flight tasks finish (or re-queue through
        retry/recovery), cached frame partitions re-home onto survivors
        (``RDT_DRAIN_REHOME``) or abandon to their lineage recipes, and only
        then is the process reaped (through its node agent on remote
        nodes). Returns the new pool size."""
        if self.engine is None:
            raise RuntimeError("session is not started")
        with self._scale_lock:
            out = self.engine.retire_executor(
                name, rehome=self._rehome_blocks,
                reap=lambda h: self.cluster.remove_worker(h))
        logger.info("session %s retired executor %s (pool %d, quiesced=%s, "
                    "rehomed=%d)", self.app_name, name, out["pool_size"],
                    out["quiesced"], out["rehomed"])
        return out["pool_size"]

    def autoscale(self, min_size: Optional[int] = None,
                  max_size: Optional[int] = None):
        """Start (or return) the pool's autoscale controller
        (:class:`~raydp_tpu_torch.etl.autoscale.PoolAutoscaler`): grows under
        sustained queued demand up to ``max_size`` (default
        ``RDT_POOL_MAX``), drains idle executors down to ``min_size``
        (default ``RDT_POOL_MIN``), with hysteresis. Stopped by
        :meth:`stop`."""
        if self.engine is None:
            raise RuntimeError("session is not started")
        if self._autoscaler is None:
            from raydp_tpu_torch.etl.autoscale import PoolAutoscaler
            self._autoscaler = PoolAutoscaler(
                self, min_size=min_size, max_size=max_size).start()
        elif min_size is not None or max_size is not None:
            # a second call adjusts the LIVE controller's bounds (they are
            # re-read every tick) instead of silently keeping the old caps
            self._autoscaler.set_bounds(min_size=min_size, max_size=max_size)
        return self._autoscaler

    def _grow_executor(self):
        """Spawn one executor and admit it to the live pool once the
        ``RDT_EXECUTOR_WAIT_S`` readiness probe absorbs its warm-up; None
        when the spawn or the probe fails (the half-started worker is
        reaped, never admitted)."""
        from raydp_tpu_torch import knobs
        with self._scale_lock:
            try:
                h = self._launch_executor(block=False)
            except Exception:
                logger.warning("executor spawn failed", exc_info=True)
                return None
            try:
                h.wait_ready(timeout=float(knobs.get("RDT_EXECUTOR_WAIT_S")))
            except Exception:
                logger.warning("executor %s never became ready; reaping it",
                               h.name, exc_info=True)
                self.cluster.remove_worker(h)
                return None
            if self.engine is not None:
                host = self._executor_hosts().get(h.name)
                self.engine.pool.add_executor(h, host_id=host)
            return h

    def _shrink_candidate(self) -> Optional[str]:
        """The newest non-draining executor — the reverse of spawn order,
        like Spark's kill-newest dynamic allocation; None when only one
        would remain."""
        if self.engine is None:
            return None
        draining = set(self.engine.pool.draining_names())
        names = [h.name for h in self.executors
                 if h.name and h.name not in draining]
        return names[-1] if len(names) > 1 else None

    def _rehome_blocks(self, name: str) -> int:
        """Drain re-homing: every cached frame partition homed on the
        retiring executor is rebuilt on a survivor from its lineage recipe
        (``warm_block`` reads the frame's pinned store blobs through the
        ranged-fetch plane) and the frame's preferred-executor map is
        repointed. Best-effort per block: a block that fails to re-home is
        simply abandoned — the next read rebuilds it via ``CachedSource``
        recovery. Returns the number of blocks re-homed."""
        survivors = [h for h in self.executors if h.name and h.name != name]
        if not survivors:
            return 0
        moved = 0
        rr = 0
        for cached in self._cached_frames.values():
            for i, owner in enumerate(cached.executors):
                if owner != name:
                    continue
                target = survivors[rr % len(survivors)]
                rr += 1
                try:
                    target.call("warm_block", cached.cache_keys[i],
                                cached.recover_tasks[i], timeout=120.0)
                    cached.executors[i] = target.name
                    moved += 1
                except Exception:
                    logger.warning(
                        "re-home of block %s onto %s failed; it will "
                        "rebuild on read", cached.cache_keys[i], target.name,
                        exc_info=True)
        return moved

    def stop(self, cleanup_data: bool = True) -> None:
        """Idempotent; a later ``stop(cleanup_data=True)`` after a keep-data stop
        still reaps the master (parity: ray_cluster_master.py:236-247)."""
        if not self._stopped:
            self._stopped = True
            if self._autoscaler is not None:
                self._autoscaler.stop()
                self._autoscaler = None
            if self.cluster is not None:
                self.cluster.stop(cleanup_master=False)
        if cleanup_data and self.master is not None:
            if self.cluster is not None:
                self.cluster.stop(cleanup_master=True)
            else:
                try:
                    self.master.kill(no_restart=True)
                except Exception:
                    pass
            self.master = None
        logger.info("session %s stopped (cleanup_data=%s)",
                    self.app_name, cleanup_data)

    # ---- frame constructors -------------------------------------------------
    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    def range(self, start: int, stop: Optional[int] = None, step: int = 1,
              num_partitions: Optional[int] = None) -> DataFrame:
        if stop is None:
            start, stop = 0, start
        n = num_partitions or max(1, min(len(self.executors),
                                         (stop - start) // 1000 + 1))
        return DataFrame(self, P.RangeScan(start, stop, step, n))

    def createDataFrame(
        self,
        data: Union[pd.DataFrame, pa.Table, List[dict]],
        num_partitions: Optional[int] = None,
    ) -> DataFrame:
        if isinstance(data, list):
            table = pa.Table.from_pylist(data)
        elif isinstance(data, pd.DataFrame):
            table = pa.Table.from_pandas(data, preserve_index=False)
        elif isinstance(data, pa.Table):
            table = data
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        n = num_partitions or max(1, min(len(self.executors),
                                         table.num_rows or 1))
        from raydp_tpu_torch.runtime.object_store import get_client
        client = get_client()
        rows = table.num_rows
        per = max(1, -(-rows // n))
        chunks = [table.slice(i, per) for i in range(0, max(rows, 1), per)]
        # one batched seal for all N chunks instead of one RPC each
        refs = client.put_arrow_many(chunks, owner=self.master_name)
        schema = table.schema.serialize().to_pybytes()
        return DataFrame(self, P.InMemory(refs, schema), schema=table.schema)

    create_frame = createDataFrame

    # ---- cached-frame registry (recoverable conversions) --------------------
    def register_cached(self, frame_id: str, cached: P.CachedScan) -> None:
        self._cached_frames[frame_id] = cached

    def release_cached(self, frame_id: str) -> None:
        """Drop a persisted frame's blocks (parity: ``releaseRecoverableRDD``,
        ObjectStoreWriter.scala:211-216)."""
        cached = self._cached_frames.pop(frame_id, None)
        if cached is None:
            return
        for h in self.executors:
            try:
                h.drop_block_prefix(f"block_{frame_id}_")
            except Exception:
                pass
        if cached.pinned_refs:
            from raydp_tpu_torch.runtime.object_store import get_client
            try:
                get_client().free(cached.pinned_refs)
            except Exception:
                pass

    def cached_frames(self) -> List[str]:
        return list(self._cached_frames)


class DataFrameReader:
    def __init__(self, session: Session):
        self._session = session
        self._options: Dict[str, str] = {}

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def format(self, fmt: str) -> "DataFrameReader":
        self._format = fmt
        return self

    def load(self, path: str) -> DataFrame:
        fmt = getattr(self, "_format", "parquet")
        return getattr(self, fmt)(path)

    def csv(self, path: Union[str, List[str]],
            num_partitions: Optional[int] = None,
            options: Optional[dict] = None) -> DataFrame:
        """``options``: ``delimiter`` (default ','), ``column_names`` (for
        headerless files, e.g. Criteo TSV), ``convert`` (pyarrow
        ConvertOptions kwargs)."""
        paths = _expand_paths(path, (".csv", ".tsv", ".txt"))
        return DataFrame(self._session,
                         P.CsvScan(paths, num_partitions=num_partitions,
                                   options=options))

    def parquet(self, path: Union[str, List[str]],
                columns: Optional[List[str]] = None) -> DataFrame:
        """Read parquet; silently skips non-parquet files in a directory
        (parity: reference ``read_spark_parquet`` filtering, tests/test_read_parquet.py)."""
        paths = _expand_paths(path, (".parquet", ".pq"))
        return DataFrame(self._session, P.ParquetScan(paths, columns=columns))


def _expand_paths(path: Union[str, List[str]], suffixes) -> List[str]:
    import glob
    import os
    if isinstance(path, list):
        candidates = path
    elif os.path.isdir(path):
        candidates = sorted(glob.glob(os.path.join(path, "*")))
        candidates = [p for p in candidates
                      if p.endswith(suffixes) or "part-" in os.path.basename(p)]
    else:
        candidates = sorted(glob.glob(path)) or [path]
    if not candidates:
        raise FileNotFoundError(f"no input files match {path!r}")
    for p in candidates:
        if p.startswith("file://"):
            raise ValueError("strip the file:// prefix; local paths only")
    return candidates
