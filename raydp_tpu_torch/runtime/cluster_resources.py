"""Resource-satisfaction query over the runtime's nodes.

Parity: ``ClusterResources`` (reference ray_cluster_resources.py:25-79) — a
cached per-node snapshot with ``satisfy(request)`` returning the node labels
whose *available* resources cover the request, ``total_alive_nodes``, and the
``num_cpus``→``CPU`` key aliasing. Labels are ``node:<address>`` strings like
the reference's ``node:<ip>`` custom resources.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

ITEM_KEYS_MAPPING = {"num_cpus": "CPU", "num_gpus": "GPU"}


class ClusterResources:
    """Per-node availability snapshots, refreshed at most every
    ``refresh_interval`` seconds (reference: 0.1 s class-level cache)."""

    refresh_interval = 0.1

    def __init__(self, runtime=None):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._snapshot: List[Dict] = []
        self._last_refresh = time.monotonic() - self.refresh_interval

    def _rt(self):
        if self._runtime is not None:
            return self._runtime
        from raydp_tpu_torch.runtime import get_runtime
        return get_runtime()

    def _refresh(self) -> None:
        with self._lock:
            now = time.monotonic()
            if now - self._last_refresh < self.refresh_interval:
                return
            self._snapshot = [
                {"node_id": n.node_id, "label": f"node:{n.address}",
                 "available": dict(n.available), "resources": dict(n.resources)}
                for n in self._rt().resource_manager.nodes() if n.alive
            ]
            self._last_refresh = now

    def total_alive_nodes(self) -> int:
        self._refresh()
        return len(self._snapshot)

    def satisfy(self, request: Dict[str, float]) -> List[str]:
        """Labels (``node:<address>``) of nodes whose available resources
        cover ``request`` (keys accept ``num_cpus`` aliasing)."""
        self._refresh()
        out = []
        for node in self._snapshot:
            if self._covers(node["available"], request):
                out.append(node["label"])
        return out

    @staticmethod
    def _covers(available: Dict[str, float], request: Dict[str, float]) -> bool:
        for key, need in request.items():
            key = ITEM_KEYS_MAPPING.get(key, key)
            if available.get(key, 0.0) < need:
                return False
        return True
