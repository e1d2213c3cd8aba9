"""Client (attach) mode: a driver joining a standalone head's cluster.

Parity: the reference runs its whole test matrix in both direct mode and
Ray-client mode (reference conftest.py:77-140 parametrizes ``ray.init`` vs
``ray.init("ray://...")``), and its data survives driver exit because the Ray
head outlives drivers. Here a standalone head process
(``python -m raydp_tpu_torch.runtime.head --listen``) owns the cluster — actors,
names, placement, and the object-store table — and any number of sequential
or concurrent drivers attach with
``adopt_runtime(ClientContext("host:port"))``.
Detaching (or crashing) a driver leaves the head, its actors, and the store
intact; a later driver can resolve the same named actors and read the same
objects (ownership-transferred datasets survive exactly like
``stop_spark(cleanup_data=False)``, reference dataset.py:137-158).

:class:`ClientContext` implements the slice of the RuntimeContext protocol the
rest of the framework uses (``create_actor`` / ``get_actor`` / store client /
session metadata), routed over the head RPC instead of in-process calls.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, Optional

from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime import object_store as objstore
from raydp_tpu_torch.runtime.actor import ActorHandle, ActorSpec, dump_spec
from raydp_tpu_torch.runtime.object_store import ObjectStoreClient
from raydp_tpu_torch.runtime.rpc import connect_with_retry

logger = get_logger("client")


class _StoreTableProxy:
    """Forwards ObjectStoreServer table methods to the head over RPC (same
    shape as the actor bootstrap's proxy, actor_main.py)."""

    def __init__(self, head):
        self._head = head

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        method = f"store_{item}"

        def _call(*args):
            return self._head.call(method, *args)

        return _call


class _ResourceManagerProxy:
    """The ResourceManager slice a client-mode driver needs — placement
    groups created/removed on the HEAD's resource model over RPC (parity:
    the reference's pg pre-allocation works under Ray client,
    reference context.py:119-140 + conftest.py:77-140)."""

    def __init__(self, head):
        self._head = head

    def create_group(self, bundles, strategy):
        from raydp_tpu_torch.runtime.placement import group_from_dict
        strategy = getattr(strategy, "value", strategy)
        d = self._head.call("create_placement_group", list(bundles),
                            str(strategy), timeout=60.0)
        return group_from_dict(d)

    def get_group(self, group_id: str):
        from raydp_tpu_torch.runtime.placement import group_from_dict
        d = self._head.call("get_placement_group", group_id)
        return group_from_dict(d) if d else None

    def remove_group(self, group_id: str) -> None:
        self._head.call("remove_placement_group", group_id)


class ClientContext:
    """A driver attached to a standalone head. Runtime-protocol compatible
    where the framework needs it; everything rides the head RPC."""

    is_client = True

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self.address = (host, int(port))
        self.head = connect_with_retry(self.address)
        info = self.head.call("attach_driver",
                              f"driver-{uuid.uuid4().hex[:8]}")
        self.session_id = info["session_id"]
        self.session_dir = info["session_dir"]
        self.driver_id = info["driver_id"]
        #: empty on purpose: records live in the head; locality helpers
        #: degrade gracefully (Session._executor_hosts finds no entries)
        self.records: Dict[str, Any] = {}
        self.resource_manager = _ResourceManagerProxy(self.head)
        self._lock = threading.RLock()

        # data plane: on the head's machine we map its shared memory
        # zero-copy; from another machine we fall back to head-mediated
        # payload RPCs (the store's explicit remote mode)
        same_machine = host in ("127.0.0.1", "localhost") \
            or host == self.head.local_host
        self.store_client = ObjectStoreClient(
            _StoreTableProxy(self.head), self.session_id,
            default_owner=objstore.DRIVER_OWNER,
            remote=not same_machine)
        objstore.set_client(self.store_client)

        # liveness: the head reaps a driver's still-bound actors when its
        # heartbeats stop without a detach (Ray driver-lifetime semantics).
        # The cadence comes from the head (reap window / 4) so a tight
        # window cannot spuriously reap a live-but-slow-beating driver.
        self._beat_interval = float(info.get("heartbeat_interval_s", 5.0))
        self._stopped = threading.Event()
        self._beat_thread = threading.Thread(
            target=self._heartbeat, daemon=True, name="driver-heartbeat")
        self._beat_thread.start()
        logger.info("attached to head at %s (session %s, %s)",
                    address, self.session_id[:12],
                    "same-machine" if same_machine else "remote")

    def _heartbeat(self) -> None:
        from raydp_tpu_torch.runtime.rpc import ConnectionLost
        while not self._stopped.wait(self._beat_interval):
            try:
                known = self.head.call("driver_heartbeat", self.driver_id,
                                       timeout=10.0)
            except ConnectionLost:
                return  # head gone; this client is dead anyway
            except Exception:
                continue  # transient (e.g. busy dispatch pool): keep beating
            if not known:
                # the head already reaped this driver (network stall past the
                # window, or a head restart): say so loudly once and stop —
                # subsequent actor calls will fail, this is the cause
                logger.error(
                    "head no longer recognizes driver %s: this session was "
                    "reaped (heartbeat gap exceeded the head's reap window); "
                    "its actors are gone — re-attach to continue",
                    self.driver_id)
                return

    # ---- actors (the subset RuntimeContext exposes in-process) --------------
    def create_actor(
        self,
        cls,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        *,
        name: Optional[str] = None,
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_concurrency: int = 2,
        env: Optional[Dict[str, str]] = None,
        node_id: Optional[str] = None,
        placement_group: Optional[str] = None,
        bundle_index: Optional[int] = None,
        block: bool = True,
    ) -> ActorHandle:
        cls_bytes, args_bytes = dump_spec(cls, args, kwargs or {})
        spec = ActorSpec(
            actor_id=f"actor-{uuid.uuid4().hex[:12]}",
            name=name,
            cls_bytes=cls_bytes,
            args_bytes=args_bytes,
            resources=dict(resources or {}),
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            env=dict(env or {}),
            node_id=node_id,
            placement_group_id=placement_group,
            bundle_index=bundle_index,
        )
        actor_id = self.head.call("create_actor", spec.__dict__, False,
                                  self.driver_id, timeout=60.0)
        handle = ActorHandle(actor_id, name, self.address)
        if block:
            handle.wait_ready()
        return handle

    def get_actor(self, name: str) -> Optional[ActorHandle]:
        actor_id = self.head.call("get_named_actor", name)
        if actor_id is None:
            return None
        return ActorHandle(actor_id, name, self.address)

    def store_host_of_node(self, node_id: Optional[str]) -> str:
        return objstore.HEAD_HOST

    def list_nodes(self):
        return self.head.call("list_nodes")

    # ---- lifecycle ----------------------------------------------------------
    def shutdown(self) -> None:
        """Graceful detach: remaining actors are UNBOUND on the head (they
        survive for the next driver); the head and store stay up — this is
        the whole point of attach mode."""
        self._stopped.set()
        try:
            self.head.call("detach_driver", self.driver_id, timeout=10.0)
        except Exception:
            pass
        try:
            self.store_client.close()
        except Exception:
            pass
        objstore.set_client(None)
        try:
            self.head.close()
        except Exception:
            pass
        logger.info("detached from head (session %s)", self.session_id[:12])
