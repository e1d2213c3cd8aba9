"""Placement groups and the node/resource model.

Parity: Ray placement groups as used by the reference — ``init_spark`` pre-allocates
one ``{CPU, memory}`` bundle per executor and passes the group + bundle indexes down
to actor creation (reference context.py:119-140, RayAppMaster.scala:290-303
round-robins executors over bundles); the MPI subsystem uses ``STRICT_SPREAD`` to pin
one peer per node (mpi/mpi_job.py:192-222). TPU specifics: chips are host-granular —
a bundle that requests the ``TPU`` resource must land on a whole host (one JAX
process owns all chips of a host), so fractional TPU bundles are rejected.

CUDA cards: a node's ``GPU`` resource counts its cards, and a bundle that
asks for ``GPU`` takes whole cards — a fractional ``GPU`` bundle is refused
as a fractional ``TPU`` one is. Placing the group hands each such bundle the
ids of the cards it holds on its node (``Bundle.gpu_ids``, indexes into the
node's visible cards), which the SPMD gang turns into each rank's
``CUDA_VISIBLE_DEVICES``; removing the group gives them back. The ids are
the node's own, so only a process on that node can name the cards: a rank
is spawned with its ids (:data:`ENV_GPU_IDS`), and the process that spawns
it — the driver, or the node agent that holds the bundle — reads them
through its own ``CUDA_VISIBLE_DEVICES`` (:func:`set_visible_cards`).

Nodes here are *logical*: a single machine can register several virtual nodes to
simulate multi-host topologies in tests, the same trick the reference's test suite
plays with ``ray.cluster_utils.Cluster`` (test_spark_cluster.py:90-110).
"""

from __future__ import annotations

import enum
import itertools
import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


#: a spawned rank's card ids on its node (``Bundle.gpu_ids``, comma-joined)
ENV_GPU_IDS = "RDT_SPMD_GPU_IDS"


def set_visible_cards(env: Dict[str, str]) -> None:
    """Set a child environment's ``CUDA_VISIBLE_DEVICES`` from its
    :data:`ENV_GPU_IDS`: the ids index the cards THIS process sees — its
    own ``CUDA_VISIBLE_DEVICES`` when it has one, else the node's cards
    ``0..n-1``. The one rule of a rank spawned by the driver and of one
    spawned by a node agent; an environment without ids is left as it
    is."""
    ids = env.get(ENV_GPU_IDS)
    if not ids:
        return
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = visible.split(",") if visible else None
    env["CUDA_VISIBLE_DEVICES"] = ",".join(
        names[int(i)] if names else str(int(i)) for i in ids.split(","))


class PlacementStrategy(str, enum.Enum):
    PACK = "PACK"
    SPREAD = "SPREAD"
    STRICT_PACK = "STRICT_PACK"
    STRICT_SPREAD = "STRICT_SPREAD"


@dataclass
class NodeInfo:
    node_id: str
    address: str
    resources: Dict[str, float]
    available: Dict[str, float] = field(default_factory=dict)
    alive: bool = True

    def __post_init__(self):
        if not self.available:
            self.available = dict(self.resources)
        # every node carries its affinity label, parity with Ray's node:<ip>
        label = f"node:{self.address}"
        self.resources.setdefault(label, 1.0)
        self.available.setdefault(label, 1.0)


@dataclass
class Bundle:
    index: int
    resources: Dict[str, float]
    node_id: Optional[str] = None  # assigned at group creation
    #: the node's card ids this bundle holds (one per unit of ``GPU``)
    gpu_ids: List[int] = field(default_factory=list)


@dataclass
class PlacementGroup:
    group_id: str
    strategy: PlacementStrategy
    bundles: List[Bundle]
    created: bool = False

    def bundle_node(self, index: int) -> Optional[str]:
        return self.bundles[index].node_id


def group_from_dict(d: Dict) -> PlacementGroup:
    """Rebuild a PlacementGroup from its RPC wire form (head._group_to_dict):
    the client-mode driver works with the same dataclass the in-process
    runtime hands out."""
    return PlacementGroup(
        group_id=d["group_id"],
        strategy=PlacementStrategy(d["strategy"]),
        bundles=[Bundle(b["index"], dict(b["resources"]), b.get("node_id"),
                        list(b.get("gpu_ids", ())))
                 for b in d["bundles"]],
        created=True,
    )


class ResourceManager:
    """Tracks logical nodes, allocates actor/bundle resources, places groups."""

    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[str, NodeInfo] = {}
        self._groups: Dict[str, PlacementGroup] = {}
        self._rr = itertools.count()
        #: node id -> the ids of its cards no placed bundle holds
        self._free_cards: Dict[str, List[int]] = {}

    # -- nodes ---------------------------------------------------------------
    def add_node(self, address: str, resources: Dict[str, float]) -> str:
        with self._lock:
            node_id = f"node-{len(self._nodes)}-{uuid.uuid4().hex[:6]}"
            self._nodes[node_id] = NodeInfo(node_id, address, dict(resources))
            self._free_cards[node_id] = list(
                range(int(resources.get("GPU", 0))))
            return node_id

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node:
                node.alive = False

    def nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self._nodes.values() if n.alive]

    def get_node(self, node_id: str) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(node_id)

    # -- allocation ----------------------------------------------------------
    def _fits(self, node: NodeInfo, resources: Dict[str, float]) -> bool:
        if not node.alive:
            return False
        for k, v in resources.items():
            if v > 0 and node.available.get(k, 0.0) + 1e-9 < v:
                return False
        return True

    def _take(self, node: NodeInfo, resources: Dict[str, float]) -> None:
        for k, v in resources.items():
            if v > 0:
                node.available[k] = node.available.get(k, 0.0) - v

    def _give(self, node: NodeInfo, resources: Dict[str, float]) -> None:
        for k, v in resources.items():
            if v > 0:
                node.available[k] = node.available.get(k, 0.0) + v

    def allocate(self, resources: Dict[str, float],
                 node_id: Optional[str] = None) -> Optional[str]:
        """Reserve ``resources`` on a node (round-robin over feasible nodes when
        ``node_id`` is not pinned). Returns the node id, or None if infeasible."""
        with self._lock:
            if node_id is not None:
                node = self._nodes.get(node_id)
                if node is not None and self._fits(node, resources):
                    self._take(node, resources)
                    return node_id
                return None
            alive = [n for n in self._nodes.values() if n.alive]
            if not alive:
                return None
            start = next(self._rr) % len(alive)
            for i in range(len(alive)):
                node = alive[(start + i) % len(alive)]
                if self._fits(node, resources):
                    self._take(node, resources)
                    return node.node_id
            return None

    def release(self, node_id: str, resources: Dict[str, float]) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                self._give(node, resources)

    # -- placement groups ----------------------------------------------------
    def create_group(self, bundles: List[Dict[str, float]],
                     strategy: PlacementStrategy) -> PlacementGroup:
        """Assign every bundle to a node per strategy, reserving resources.

        Raises ValueError if the group cannot be placed (parity: ``pg.ready()``
        would hang in Ray; we fail fast instead, context.py:133-140 waits then
        passes the group down).
        """
        with self._lock:
            for b in bundles:
                if 0 < b.get("TPU", 0) < 1:
                    raise ValueError(
                        "fractional TPU bundles are not placeable: TPU chips are "
                        "host-granular (one JAX process per host)")
                gpus = b.get("GPU", 0)
                if gpus and gpus != int(gpus):
                    raise ValueError(
                        f"fractional GPU bundles are not placeable ({gpus}): "
                        "a bundle holds whole CUDA cards")
            group = PlacementGroup(
                group_id=f"pg-{uuid.uuid4().hex[:8]}",
                strategy=PlacementStrategy(strategy),
                bundles=[Bundle(i, dict(b)) for i, b in enumerate(bundles)],
            )
            placed: List[Bundle] = []
            try:
                if group.strategy in (PlacementStrategy.STRICT_PACK,):
                    # all bundles on one node
                    total: Dict[str, float] = {}
                    for b in group.bundles:
                        for k, v in b.resources.items():
                            total[k] = total.get(k, 0.0) + v
                    node_id = self.allocate(total)
                    if node_id is None:
                        raise ValueError("STRICT_PACK group does not fit on any node")
                    for b in group.bundles:
                        b.node_id = node_id
                    placed = []  # released as a whole below if needed
                else:
                    used_nodes: set = set()
                    for b in group.bundles:
                        node_id = None
                        if group.strategy == PlacementStrategy.STRICT_SPREAD:
                            for n in self._nodes.values():
                                if n.node_id in used_nodes:
                                    continue
                                if self._fits(n, b.resources):
                                    node_id = n.node_id
                                    self._take(n, b.resources)
                                    break
                            if node_id is None:
                                raise ValueError(
                                    "STRICT_SPREAD group needs more nodes than available")
                        else:
                            node_id = self.allocate(b.resources)
                            if node_id is None:
                                raise ValueError("placement group bundle does not fit")
                        b.node_id = node_id
                        used_nodes.add(node_id)
                        placed.append(b)
            except ValueError:
                for b in placed:
                    self.release(b.node_id, b.resources)
                raise
            for b in group.bundles:
                n = int(b.resources.get("GPU", 0))
                if n:
                    free = self._free_cards[b.node_id]
                    b.gpu_ids, free[:] = free[:n], free[n:]
            group.created = True
            self._groups[group.group_id] = group
            return group

    def get_group(self, group_id: str) -> Optional[PlacementGroup]:
        with self._lock:
            return self._groups.get(group_id)

    def remove_group(self, group_id: str) -> None:
        with self._lock:
            group = self._groups.pop(group_id, None)
            for b in group.bundles if group is not None else ():
                if b.gpu_ids:
                    self._free_cards[b.node_id] = sorted(
                        self._free_cards[b.node_id] + b.gpu_ids)
                    b.gpu_ids = []
        if group is not None:
            if group.strategy == PlacementStrategy.STRICT_PACK:
                total: Dict[str, float] = {}
                for b in group.bundles:
                    for k, v in b.resources.items():
                        total[k] = total.get(k, 0.0) + v
                if group.bundles and group.bundles[0].node_id:
                    self.release(group.bundles[0].node_id, total)
            else:
                for b in group.bundles:
                    if b.node_id:
                        self.release(b.node_id, b.resources)

    def groups(self) -> List[PlacementGroup]:
        with self._lock:
            return list(self._groups.values())
