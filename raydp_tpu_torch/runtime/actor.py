"""Actors: subprocesses hosting a user object behind the RPC server.

Parity: Ray actors as the reference uses them — named actors resolvable from any
process (``ray.get_actor("raydp-executor-<id>")``, dataset.py:70-78), creation with
``maxRestarts=-1`` / ``maxConcurrency`` (RayExecutorUtils.java:37-62), detection of
"I was restarted" inside the actor (``wasCurrentActorRestarted``,
RayDPExecutor.scala:82-94), and deliberate-kill vs crash-restart distinction
(ApplicationInfo.scala:119-130).

An actor process is spawned as ``python -m raydp_tpu_torch.runtime.actor_main`` with the
head address in env; it fetches its pickled spec from the head, instantiates the
class, serves its methods over :class:`~raydp_tpu_torch.runtime.rpc.RpcServer`, and
reports its bound address back. Handles resolve name→address through the head and
transparently re-resolve after a restart.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import cloudpickle

from raydp_tpu_torch.runtime.rpc import ConnectionLost, RpcClient

# actor lifecycle states
PENDING = "PENDING"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


@dataclass
class ActorSpec:
    actor_id: str
    name: Optional[str]
    cls_bytes: bytes                      # cloudpickled class
    args_bytes: bytes                     # cloudpickled (args, kwargs)
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0                 # -1 = infinite (RayExecutorUtils.java:58)
    max_concurrency: int = 2              # RayExecutorUtils.java:60
    env: Dict[str, str] = field(default_factory=dict)
    node_id: Optional[str] = None
    placement_group_id: Optional[str] = None
    bundle_index: Optional[int] = None


class ActorContext:
    """Process-local context available to code running inside an actor."""

    def __init__(self, actor_id: str, name: Optional[str], node_id: str,
                 was_restarted: bool, restart_count: int, head_client: RpcClient,
                 session_id: str):
        self.actor_id = actor_id
        self.name = name
        self.node_id = node_id
        self.was_restarted = was_restarted
        self.restart_count = restart_count
        self.head = head_client
        self.session_id = session_id


_actor_context: Optional[ActorContext] = None


def actor_context(ctx: Optional[ActorContext]) -> None:
    global _actor_context
    _actor_context = ctx


def current_actor_context() -> Optional[ActorContext]:
    """None when called from the driver; the context inside an actor process."""
    return _actor_context


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method: str):
        self._handle = handle
        self._method = method

    def __call__(self, *args, **kwargs):
        return self._handle.call(self._method, *args, **kwargs)

    def submit(self, *args, **kwargs) -> Future:
        return self._handle.submit(self._method, *args, **kwargs)


class ActorHandle:
    """Client-side handle; picklable (re-resolves through the head on unpickle)."""

    def __init__(self, actor_id: str, name: Optional[str], head_address):
        self.actor_id = actor_id
        self.name = name
        self._head_address = tuple(head_address)
        self._lock = threading.Lock()
        self._head: Optional[RpcClient] = None
        self._client: Optional[RpcClient] = None
        self._address = None

    # -- pickling: drop live sockets ------------------------------------------
    def __getstate__(self):
        return {"actor_id": self.actor_id, "name": self.name,
                "_head_address": self._head_address}

    def __setstate__(self, state):
        self.actor_id = state["actor_id"]
        self.name = state["name"]
        self._head_address = tuple(state["_head_address"])
        self._lock = threading.Lock()
        self._head = None
        self._client = None
        self._address = None

    def _head_client(self) -> RpcClient:
        if self._head is None or self._head._closed:
            self._head = RpcClient(self._head_address)
        return self._head

    def _resolve(self, refresh: bool = False) -> RpcClient:
        with self._lock:
            if self._client is not None and not refresh and not self._client._closed:
                return self._client
            try:
                address = self._head_client().call(
                    "get_actor_address", self.actor_id, timeout=60.0)
            except ConnectionLost:
                # transient head-connection reset: retry once, fresh socket
                # (lock already held — do not route through _head_call)
                if self._head is not None:
                    self._head.close()
                    self._head = None
                address = self._head_client().call(
                    "get_actor_address", self.actor_id, timeout=60.0)
            if address is None:
                raise ConnectionLost(
                    f"actor {self.name or self.actor_id} is not alive")
            if self._client is not None:
                self._client.close()
            self._address = tuple(address)
            self._client = RpcClient(self._address)
            return self._client

    def call(self, method: str, *args, timeout: Optional[float] = None, **kwargs):
        """Synchronous call; one transparent retry after restart-driven reconnect."""
        try:
            return self._resolve().call(method, *args, timeout=timeout, **kwargs)
        except ConnectionLost:
            client = self._resolve(refresh=True)
            return client.call(method, *args, timeout=timeout, **kwargs)

    def submit(self, method: str, *args, **kwargs) -> Future:
        try:
            return self._resolve().submit(method, *args, **kwargs)
        except ConnectionLost:
            return self._resolve(refresh=True).submit(method, *args, **kwargs)

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item)

    def _head_call(self, method: str, *args,
                   timeout: Optional[float] = None):
        """Head calls from handles are idempotent registry reads/commands; a
        transient connection reset (rare but observed under churn) is retried
        once over a fresh connection instead of failing the caller."""
        try:
            return self._head_client().call(method, *args, timeout=timeout)
        except ConnectionLost:
            with self._lock:
                if self._head is not None:
                    self._head.close()
                    self._head = None
            return self._head_client().call(method, *args, timeout=timeout)

    def state(self) -> str:
        return self._head_call("get_actor_state", self.actor_id)

    def kill(self, no_restart: bool = True) -> None:
        """Deliberate kill — distinguished from a crash so the supervisor does not
        revive it (parity: ApplicationInfo.scala:119-130 kill/retry pathology)."""
        self._head_call("kill_actor", self.actor_id, no_restart)

    def wait_ready(self, timeout: float = 120.0) -> "ActorHandle":
        import time as _time

        deadline = _time.monotonic() + timeout
        try:
            self._head_client().call("wait_actor_ready", self.actor_id,
                                     timeout, timeout=timeout + 10.0)
        except ConnectionLost:
            # transient reset: retry with only the REMAINING budget so the
            # caller's timeout contract holds
            with self._lock:
                if self._head is not None:
                    self._head.close()
                    self._head = None
            remaining = max(1.0, deadline - _time.monotonic())
            self._head_client().call("wait_actor_ready", self.actor_id,
                                     remaining, timeout=remaining + 10.0)
        return self


def dump_spec(cls, args, kwargs) -> tuple:
    return cloudpickle.dumps(cls), cloudpickle.dumps((args, kwargs))
