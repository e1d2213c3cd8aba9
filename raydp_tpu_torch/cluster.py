"""Generic cluster ABCs: the external-engine plug surface.

Parity: the reference keeps its Spark bring-up behind engine-agnostic ABCs so
other data engines can ride the same actor substrate ("such as SparkCluster,
FlinkCluster" — reference services.py:22-90 ``Cluster``/``ClusterMaster``,
implemented by ``SparkCluster``/``RayClusterMaster``). This module is that
surface for the port: a master-service + worker-gang lifecycle contract
over the actor runtime, with the built-in ETL engine expressed through it
(:class:`EtlCluster`, which :class:`~raydp_tpu_torch.etl.session.Session` drives) —
so a different engine plugs in by subclassing ``Cluster`` exactly as the
reference intends, inheriting supervised actors, placement, and the
distributed object store without touching the session machinery.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime.actor import ActorHandle

logger = get_logger("cluster")


class ClusterMaster(ABC):
    """The master service of an engine (reference services.py:74-90)."""

    @abstractmethod
    def start_up(self) -> None:
        """Create/boot the master service."""

    @abstractmethod
    def get_master_url(self) -> str:
        """How workers address the master (e.g. a named-actor name)."""

    @abstractmethod
    def get_host(self) -> str:
        """The host the master runs on."""

    @abstractmethod
    def stop(self) -> None:
        """Tear the master service down."""


class Cluster(ABC):
    """A master + worker-gang lifecycle on the actor runtime
    (reference services.py:22-72).

    Subclasses implement ``_set_up_master`` / ``_set_up_worker`` /
    ``get_cluster_url`` / ``stop``; ``add_worker`` wraps worker bring-up with
    the reference's fail-safe contract (a failed worker tears the cluster
    down rather than leaking a half-started gang).
    """

    def __init__(self, master_resources_requirement: Optional[Dict[str, float]]):
        # the master lives beside the driver; workers are counted
        self._num_nodes = 0
        self._set_up_master(master_resources_requirement or {}, {})

    @abstractmethod
    def _set_up_master(self, resources: Dict[str, float],
                       kwargs: Dict[Any, Any]) -> None:
        """Set up the master service."""

    def add_worker(self, resources_requirement: Dict[str, float],
                   **kwargs: Any) -> None:
        """Add one worker; on failure stop the whole cluster and re-raise
        (reference services.py:40-52)."""
        try:
            self._set_up_worker(resources_requirement, kwargs)
            self._num_nodes += 1
        except BaseException:
            self.stop()
            raise

    @abstractmethod
    def _set_up_worker(self, resources: Dict[str, float],
                       kwargs: Dict[str, Any]) -> None:
        """Set up one worker service."""

    @property
    def num_workers(self) -> int:
        return self._num_nodes

    @abstractmethod
    def get_cluster_url(self) -> str:
        """The cluster address workers/clients connect to."""

    @abstractmethod
    def stop(self) -> None:
        """Stop every service of this cluster."""


class EtlClusterMaster(ClusterMaster):
    """The built-in engine's master: one named EtlMaster actor (the role
    RayClusterMaster plays for the reference's Spark engine)."""

    def __init__(self, app_name: str, resources: Dict[str, float],
                 max_concurrency: int = 8):
        self._app_name = app_name
        self._resources = dict(resources)
        self._max_concurrency = max_concurrency
        self.handle: Optional[ActorHandle] = None

    @property
    def name(self) -> str:
        return f"{self._app_name}_MASTER"

    def start_up(self) -> None:
        from raydp_tpu_torch.etl.master import EtlMaster
        from raydp_tpu_torch.runtime import get_runtime

        self.handle = get_runtime().create_actor(
            EtlMaster, (self._app_name,), name=self.name,
            resources=self._resources, max_restarts=0,
            max_concurrency=self._max_concurrency)

    def get_master_url(self) -> str:
        return self.name  # named-actor registry IS the address space

    def get_host(self) -> str:
        from raydp_tpu_torch.runtime import get_runtime
        rt = get_runtime()
        rec = getattr(rt, "records", {}).get(
            self.handle.actor_id) if self.handle else None
        return rec.address[0] if rec is not None and rec.address else "127.0.0.1"

    def stop(self) -> None:
        if self.handle is not None:
            try:
                self.handle.kill(no_restart=True)
            except Exception:
                pass
            self.handle = None


class EtlCluster(Cluster):
    """The built-in ETL engine expressed through the generic ABCs; the
    Session drives its lifecycle through this object, so an external engine
    subclassing :class:`Cluster` slots into the same machinery."""

    def __init__(self, app_name: str,
                 master_resources: Optional[Dict[str, float]] = None):
        self.app_name = app_name
        self.master: Optional[EtlClusterMaster] = None
        self.workers: List[ActorHandle] = []
        self._worker_index = 0
        super().__init__(master_resources)

    # -- master ---------------------------------------------------------------
    def _set_up_master(self, resources: Dict[str, float],
                       kwargs: Dict[Any, Any]) -> None:
        self.master = EtlClusterMaster(self.app_name, resources)
        self.master.start_up()

    # -- workers --------------------------------------------------------------
    def _set_up_worker(self, resources: Dict[str, float],
                       kwargs: Dict[str, Any]) -> None:
        from raydp_tpu_torch.etl.executor import EtlExecutor
        from raydp_tpu_torch.runtime import get_runtime

        i = self._worker_index
        self._worker_index += 1
        handle = get_runtime().create_actor(
            EtlExecutor, (self.master.name,),
            name=f"rdt-executor-{self.app_name}-{i}",
            resources=dict(resources),
            max_restarts=kwargs.get("max_restarts", -1),
            max_concurrency=kwargs.get("max_concurrency", 2),
            # the card stays visible: the ETL imports no torch, so an
            # executor holds no CUDA context until a serving replica loads
            # into it (serve_load), and that replica then serves on the card
            placement_group=kwargs.get("placement_group"),
            bundle_index=kwargs.get("bundle_index"),
            block=kwargs.get("block", True),
        )
        self.workers.append(handle)

    def remove_worker(self, handle: Optional[ActorHandle] = None
                      ) -> Optional[ActorHandle]:
        """Shrink by one — dynamic allocation's kill side. ``handle`` picks
        a specific worker (the graceful-drain reap path); default is the
        newest."""
        if not self.workers:
            return None
        if handle is None:
            handle = self.workers.pop()
        elif handle in self.workers:
            self.workers.remove(handle)
        else:
            return None
        self._num_nodes = max(0, self._num_nodes - 1)
        try:
            handle.kill(no_restart=True)
        except Exception:
            pass
        return handle

    def get_cluster_url(self) -> str:
        return self.master.get_master_url() if self.master else ""

    def stop(self, cleanup_master: bool = True) -> None:
        for handle in self.workers:
            try:
                handle.kill(no_restart=True)
            except Exception:
                pass
        self.workers = []
        self._num_nodes = 0
        if cleanup_master and self.master is not None:
            self.master.stop()
            self.master = None
