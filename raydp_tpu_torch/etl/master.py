"""The ETL master actor.

Parity: ``RayDPSparkMaster`` + ``RayAppMaster`` collapsed into one native actor —
executor registration and executor-id assignment (RayAppMaster.scala:133-167), the
restarted-executor old↔new id map consulted by conversions
(RayAppMaster.scala:48,192-209; ObjectStoreWriter.scala:183-191), and the
object-holder role for the reverse data path: the master owns objects handed to
``to_frame`` so they outlive the frames/executors that produced them
(ray_cluster_master.py:222-226 ``add_objects``/``get_object``; dataset.py:137-158
ownership transfer).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime.object_store import ObjectRef

logger = get_logger("etl.master")


class EtlMaster:
    def __init__(self, app_name: str):
        self.app_name = app_name
        self._lock = threading.Lock()
        self._next_executor_id = 0
        # executor_id -> actor name
        self._executors: Dict[int, str] = {}
        # restarted actor bookkeeping: actor name -> list of its executor ids
        self._ids_by_actor: Dict[str, List[int]] = {}
        # new executor id -> old executor id (RayAppMaster.scala:48)
        self._restarted: Dict[int, int] = {}
        # object holder: df_id -> refs (ray_cluster_master.py:222-226)
        self._held_objects: Dict[str, List[ObjectRef]] = {}

    # -- registration ---------------------------------------------------------
    def register_executor(self, actor_name: str, was_restarted: bool) -> int:
        with self._lock:
            executor_id = self._next_executor_id
            self._next_executor_id += 1
            self._executors[executor_id] = actor_name
            history = self._ids_by_actor.setdefault(actor_name, [])
            if was_restarted and history:
                old_id = history[-1]
                self._restarted[executor_id] = old_id
                self._executors.pop(old_id, None)
                logger.info("executor %s re-registered: id %d -> %d",
                            actor_name, old_id, executor_id)
            history.append(executor_id)
            return executor_id

    def resolve_executor(self, executor_id: int) -> Optional[str]:
        """Actor name for an executor id, following restart remapping
        (parity: ObjectStoreWriter.scala:183-191)."""
        with self._lock:
            if executor_id in self._executors:
                return self._executors[executor_id]
            # an old id may have been superseded by a restart
            for new_id, old_id in self._restarted.items():
                if old_id == executor_id:
                    return self._executors.get(new_id)
            return None

    def executors(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._executors)

    def remove_executor(self, actor_name: str) -> None:
        """Reap an executor record (parity: onDisconnected,
        RayAppMaster.scala:212-214)."""
        with self._lock:
            victims = [i for i, n in self._executors.items() if n == actor_name]
            for i in victims:
                del self._executors[i]

    # -- object holder --------------------------------------------------------
    def add_objects(self, holder_id: str, refs: List[ObjectRef]) -> None:
        with self._lock:
            self._held_objects[holder_id] = list(refs)

    def get_object(self, holder_id: str, index: int) -> ObjectRef:
        with self._lock:
            return self._held_objects[holder_id][index]

    def get_objects(self, holder_id: str) -> List[ObjectRef]:
        with self._lock:
            return list(self._held_objects.get(holder_id, []))

    def drop_objects(self, holder_id: str) -> List[ObjectRef]:
        with self._lock:
            return self._held_objects.pop(holder_id, [])

    def holders(self) -> List[str]:
        with self._lock:
            return list(self._held_objects)

    def ping(self) -> str:
        return "pong"
