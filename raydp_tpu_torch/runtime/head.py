"""The head: driver-side control plane of the actor runtime.

This is the GCS-of-one-process that replaces what the reference gets from Ray's
head services: the named-actor registry, actor supervision/restart, node + resource
accounting, placement groups, and the object-store table (SURVEY.md §1 L1). It runs
as threads inside the driver process; actor processes talk to it over one RPC
connection (address handed down via environment).

Supervision parity: executor actors are created with ``max_restarts=-1`` and revived
on crash (RayExecutorUtils.java:58-59); deliberate kills do not revive
(ApplicationInfo.scala:119-130); a dead owner's objects are swept from the store
unless ownership was transferred (dataset.py:137-158).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import cloudpickle

from raydp_tpu_torch import config as cfg
from raydp_tpu_torch.config import Config
from raydp_tpu_torch.log import get_logger, init_logging
from raydp_tpu_torch.runtime import object_store as objstore
from raydp_tpu_torch.runtime.actor import (
    ALIVE, DEAD, PENDING, RESTARTING, ActorHandle, ActorSpec, dump_spec,
)
from raydp_tpu_torch.runtime.object_store import ObjectStoreClient, ObjectStoreServer
from raydp_tpu_torch.runtime.placement import PlacementGroup, PlacementStrategy, ResourceManager
from raydp_tpu_torch import knobs
from raydp_tpu_torch.runtime.rpc import MethodDispatcher, RpcServer

logger = get_logger("head")

ENV_HEAD = "RAYDP_TPU_HEAD"
ENV_ACTOR_ID = "RAYDP_TPU_ACTOR_ID"
ENV_SESSION = "RAYDP_TPU_SESSION"
ENV_SESSION_DIR = "RAYDP_TPU_SESSION_DIR"


def session_root() -> str:
    """Parent of every session directory: ``raydp_tpu_torch`` under the
    temp dir (``TMPDIR`` when set)."""
    return os.path.join(tempfile.gettempdir(), "raydp_tpu_torch")


class _RemoteProcess:
    """Popen-shaped handle to a process spawned by a node agent.

    ``poll`` is throttled (one RPC per second per actor) so the supervisor's
    tight loop stays cheap; a lost agent connection reads as exit code -1 with
    ``lost`` set, which the supervisor escalates to node death.
    """

    _POLL_INTERVAL = 1.0

    def __init__(self, agent, pid: int, node_id: str):
        self._agent = agent
        self.pid = pid
        self.node_id = node_id
        self.lost = False
        self._last_poll = 0.0
        self._last_code: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.lost or self._last_code is not None:
            return self._last_code if self._last_code is not None else -1
        now = time.monotonic()
        if now - self._last_poll < self._POLL_INTERVAL:
            return None
        self._last_poll = now
        try:
            code = self._agent.call("poll", self.pid, timeout=10.0)
        except Exception:
            self.lost = True
            self._last_code = -1
            return -1
        if code is not None:
            self._last_code = int(code)
            # the exit is observed exactly once: have the agent harvest the
            # zombie and drop its process-table entry, so an agent that
            # scales executors up and down all day never accumulates dead
            # entries (best-effort — a missed reap only leaks bookkeeping)
            try:
                self._agent.call("reap", self.pid, timeout=10.0)
            except Exception:
                pass
        return self._last_code

    def kill(self) -> None:
        try:
            self._agent.call("kill", self.pid, timeout=10.0)
        except Exception:
            self.lost = True


@dataclass
class ActorRecord:
    spec: ActorSpec
    state: str = PENDING
    process: Optional[Any] = None  # subprocess.Popen or _RemoteProcess
    address: Optional[tuple] = None
    node_id: Optional[str] = None
    restart_count: int = 0
    was_restarted: bool = False
    deliberate_kill: bool = False
    ready: threading.Event = field(default_factory=threading.Event)
    resources_held: Dict[str, float] = field(default_factory=dict)
    #: attach mode: the client driver this actor belongs to. A graceful
    #: detach unbinds (actor survives for the next driver); a driver that
    #: stops heartbeating without detaching gets its actors reaped — the
    #: Ray semantics of non-detached actors dying with their driver.
    driver_id: Optional[str] = None


class HeadService:
    """RPC surface of the head. One instance serves driver helpers and all actors."""

    def __init__(self, runtime: "RuntimeContext"):
        self._rt = runtime

    # ---- object store table (proxied verbatim) ------------------------------
    def store_seal(self, *a):
        return self._rt.store_server.seal(*a)

    def store_seal_batch(self, *a):
        return self._rt.store_server.seal_batch(*a)

    def store_lookup(self, *a):
        return self._rt.store_server.lookup(*a)

    def store_lookup_batch(self, *a):
        return self._rt.store_server.lookup_batch(*a)

    def store_fetch_ranges(self, *a):
        return self._rt.store_server.fetch_ranges(*a)

    def store_op_counts(self, *a):
        return self._rt.store_server.op_counts(*a)

    def store_reset_op_counts(self, *a):
        return self._rt.store_server.reset_op_counts(*a)

    def store_contains(self, *a):
        return self._rt.store_server.contains(*a)

    def store_free(self, *a):
        return self._rt.store_server.free(*a)

    def store_transfer_ownership(self, *a):
        return self._rt.store_server.transfer_ownership(*a)

    def store_free_owned_by(self, *a):
        return self._rt.store_server.free_owned_by(*a)

    def store_stats(self, *a):
        return self._rt.store_server.stats(*a)

    def store_owned_by(self, *a):
        return self._rt.store_server.owned_by(*a)

    def store_arena_info(self, *a):
        return self._rt.store_server.arena_info(*a)

    def store_arena_stats(self, *a):
        return self._rt.store_server.arena_stats(*a)

    def store_arena_reap(self, *a):
        return self._rt.store_server.arena_reap(*a)

    def store_fetch_payload(self, *a):
        return self._rt.store_server.fetch_payload(*a)

    def store_store_payload(self, *a):
        return self._rt.store_server.store_payload(*a)

    def store_locations(self, *a):
        return self._rt.store_server.locations(*a)

    def store_residency(self, *a):
        return self._rt.store_server.residency(*a)

    def store_eviction_hints(self, *a):
        return self._rt.store_server.eviction_hints(*a)

    def store_derive_budgets(self, *a):
        return self._rt.store_server.derive_budgets(*a)

    # pipelined-shuffle seal notifications: poll may return a DeferredReply
    # (the head's RPC server resolves it when events arrive or the poll
    # timeout lapses), so a long-polling reducer never parks a dispatcher
    def store_stream_begin(self, *a):
        return self._rt.store_server.stream_begin(*a)

    def store_stream_publish(self, *a):
        return self._rt.store_server.stream_publish(*a)

    def store_stream_poll(self, *a):
        return self._rt.store_server.stream_poll(*a)

    def store_stream_abort(self, *a):
        return self._rt.store_server.stream_abort(*a)

    def store_stream_close(self, *a):
        return self._rt.store_server.stream_close(*a)

    def register_store_host(self, node_id: str, arena_segment,
                            shm_budget=None):
        """A node agent announces its machine-local payload plane."""
        return self._rt.register_store_host(node_id, arena_segment,
                                            shm_budget)

    # ---- actor lifecycle ----------------------------------------------------
    def fetch_actor_spec(self, actor_id: str) -> Dict[str, Any]:
        rec = self._rt.record(actor_id)
        return {
            "cls_bytes": rec.spec.cls_bytes,
            "args_bytes": rec.spec.args_bytes,
            "name": rec.spec.name,
            "max_concurrency": rec.spec.max_concurrency,
            "node_id": rec.node_id,
            "was_restarted": rec.was_restarted,
            "restart_count": rec.restart_count,
            "session_id": self._rt.session_id,
            "session_dir": self._rt.session_dir,
            "log_level": self._rt.config.get(cfg.LOG_LEVEL_KEY, "INFO"),
        }

    def actor_ready(self, actor_id: str, host: str, port: int) -> None:
        self._rt.on_actor_ready(actor_id, (host, port))

    def get_actor_address(self, actor_id: str):
        rec = self._rt.records.get(actor_id)
        if rec is None or rec.state == DEAD:
            return None
        if rec.ready.is_set():
            return rec.address
        # restart in flight: wait WITHOUT parking this dispatcher thread —
        # the reply completes when the actor reports ready (or 60s grace
        # lapses), so a mass-restart flurry cannot starve unrelated traffic
        return self._rt.add_ready_waiter(actor_id, 60.0, mode="address")

    def get_actor_state(self, actor_id: str) -> str:
        rec = self._rt.records.get(actor_id)
        return rec.state if rec else DEAD

    def wait_actor_ready(self, actor_id: str, timeout: float):
        rec = self._rt.record(actor_id)
        if rec.ready.is_set():
            return True
        return self._rt.add_ready_waiter(actor_id, timeout, mode="ready")

    def get_named_actor(self, name: str) -> Optional[str]:
        """Resolve a LIVE named actor (the in-process ``get_actor`` liveness
        contract: dead actors don't resolve)."""
        handle = self._rt.get_actor(name)
        return handle.actor_id if handle is not None else None

    def create_actor(self, spec_fields: Dict[str, Any], block: bool = False,
                     driver_id: Optional[str] = None) -> str:
        spec = ActorSpec(**spec_fields)
        handle = self._rt.launch_actor(spec, block=block, driver_id=driver_id)
        return handle.actor_id

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self._rt.kill_actor(actor_id, no_restart)

    def list_actors(self) -> List[Dict[str, Any]]:
        out = []
        for aid, rec in self._rt.records.items():
            out.append({
                "actor_id": aid, "name": rec.spec.name, "state": rec.state,
                "node_id": rec.node_id, "restart_count": rec.restart_count,
                "resources": rec.spec.resources,
            })
        return out

    # ---- nodes / resources / placement --------------------------------------
    def list_nodes(self) -> List[Dict[str, Any]]:
        return [
            {"node_id": n.node_id, "address": n.address, "alive": n.alive,
             "resources": dict(n.resources), "available": dict(n.available)}
            for n in self._rt.resource_manager.nodes()
        ]

    def add_node(self, resources: Dict[str, float], address: Optional[str] = None) -> str:
        return self._rt.resource_manager.add_node(address or "127.0.0.1", resources)

    def remove_node(self, node_id: str) -> None:
        self._rt.remove_node(node_id)

    def register_node_agent(self, host: str, port: int,
                            resources: Dict[str, float],
                            address: str,
                            store_isolated: bool = False) -> Dict[str, Any]:
        """A node agent joins: its machine becomes a schedulable node whose
        actor processes the head spawns through the agent (parity: a Ray
        raylet registering with the GCS, SURVEY.md §1 L1)."""
        return self._rt.register_node_agent(host, port, resources, address,
                                            store_isolated)

    def create_placement_group(self, bundles: List[Dict[str, float]],
                               strategy: str) -> Dict[str, Any]:
        group = self._rt.resource_manager.create_group(
            bundles, PlacementStrategy(strategy))
        return _group_to_dict(group)

    def remove_placement_group(self, group_id: str) -> None:
        self._rt.resource_manager.remove_group(group_id)

    def get_placement_group(self, group_id: str) -> Optional[Dict[str, Any]]:
        group = self._rt.resource_manager.get_group(group_id)
        return _group_to_dict(group) if group else None

    def list_placement_groups(self) -> List[Dict[str, Any]]:
        return [_group_to_dict(g) for g in self._rt.resource_manager.groups()]

    def ping(self) -> str:
        return "pong"

    # ---- attach/client mode -------------------------------------------------
    def attach_driver(self, driver_id: str) -> Dict[str, Any]:
        """A driver joins this (standalone) head as a client — parity with
        Ray-client mode in the reference's test matrix (conftest.py:77-140).
        Names and stored objects belong to the head's session; actors the
        driver creates are bound to it until it detaches (graceful detach
        unbinds them to survive; a crashed driver's actors are reaped after
        its heartbeats stop — the Ray driver-lifetime semantics)."""
        self._rt.register_driver(driver_id)
        return {"session_id": self._rt.session_id,
                "session_dir": self._rt.session_dir,
                "driver_id": driver_id,
                # clients derive their beat cadence from the head's reap
                # window so a small window cannot spuriously reap live
                # drivers that beat too slowly
                "heartbeat_interval_s": max(
                    1.0, self._rt.driver_reap_after_s / 4.0)}

    def driver_heartbeat(self, driver_id: str) -> bool:
        return self._rt.driver_heartbeat(driver_id)

    def detach_driver(self, driver_id: str) -> bool:
        return self._rt.detach_driver(driver_id)


def _terminate(proc) -> None:
    """Kill a local Popen (whole process group) or a remote agent process."""
    if isinstance(proc, _RemoteProcess):
        proc.kill()
        return
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                proc.kill()
            except ProcessLookupError:
                pass


def _group_to_dict(group: PlacementGroup) -> Dict[str, Any]:
    return {
        "group_id": group.group_id,
        "strategy": group.strategy.value,
        "bundles": [
            {"index": b.index, "resources": b.resources, "node_id": b.node_id,
             "gpu_ids": list(b.gpu_ids)}
            for b in group.bundles
        ],
    }


class RuntimeContext:
    """Singleton runtime: head services + supervisor + driver-side store client."""

    def __init__(self, config: Optional[Config] = None,
                 virtual_nodes: Optional[List[Dict[str, float]]] = None,
                 listen_host: str = "127.0.0.1", listen_port: int = 0):
        self.config = config or Config()
        self.session_id = uuid.uuid4().hex
        self.session_dir = os.path.join(
            session_root(), f"session_{self.session_id[:12]}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        init_logging("driver", self.config.get(cfg.LOG_LEVEL_KEY, "INFO"),
                     os.path.join(self.session_dir, "logs"), self.session_id)

        arena = self._create_arena()
        # eviction/spill budget: configured value, else the arena capacity
        # (no arena → default arena size); "0" disables spilling
        budget = self.config.get_memory(
            cfg.SPILL_BUDGET_KEY,
            default=(arena.size if arena is not None
                     else _default_arena_size()))
        spill_dir = (self.config.get(cfg.SPILL_DIR_KEY)
                     or os.path.join(self.session_dir, "spill")) \
            if budget > 0 else None
        self.store_server = ObjectStoreServer(
            self.session_id, arena=arena,
            spill_dir=spill_dir, shm_budget=budget or None)
        self.resource_manager = ResourceManager()
        if virtual_nodes:
            for res in virtual_nodes:
                self.resource_manager.add_node("127.0.0.1", res)
        else:
            self.resource_manager.add_node(
                "127.0.0.1", {**_default_node_resources(),
                              "GPU": float(visible_cards())})

        self.records: Dict[str, ActorRecord] = {}
        self.names: Dict[str, str] = {}
        self.node_agents: Dict[str, Any] = {}  # node_id → agent RpcClient
        self.store_hosts: Dict[str, Optional[str]] = {}  # node_id → arena seg
        # distributed data plane: payloads on agent machines are released /
        # head-mediated-fetched through the owning node's agent RPC
        self.store_server.node_release = self._node_store_release
        self.store_server.node_fetch = self._node_store_fetch
        self.store_server.node_spill = self._node_store_spill
        self.store_server.node_fault_in = self._node_store_fault_in
        self.store_server.node_remove_spill = self._node_store_remove_spill
        self._lock = threading.RLock()
        # guarded-by: _waiters_lock; (deadline, timeout, id, fut, mode)
        self._waiters: List[tuple] = []
        self._waiters_lock = threading.Lock()
        #: attach-mode drivers: driver_id → last heartbeat monotonic time
        self._drivers: Dict[str, float] = {}  # guarded-by: _lock
        self.driver_reap_after_s = float(knobs.get("RDT_DRIVER_REAP_S"))
        #: lazy warm-fork manager for the LOCAL spawn path (1-elem ref so the
        #: shared spawn glue can create it on first use); agents own their own
        self._warm_fork: List[Any] = [None]
        self._stopped = threading.Event()

        self.service = HeadService(self)
        self.server = RpcServer(MethodDispatcher(self.service),
                                host=listen_host, port=listen_port,
                                max_concurrency=16, name="head")
        self.store_client = ObjectStoreClient(self.store_server, self.session_id,
                                              default_owner=objstore.DRIVER_OWNER)
        objstore.set_client(self.store_client)

        self._supervisor = threading.Thread(target=self._supervise, daemon=True,
                                            name="actor-supervisor")
        self._supervisor.start()
        logger.info("runtime head started at %s (session %s)",
                    self.server.url, self.session_id[:12])

    def _create_arena(self):
        """Native store arena, per ``raydp.tpu.object_store.native``:
        ``auto`` (default) uses it when the C++ core builds, ``on`` requires
        it, ``off`` forces per-object segments."""
        mode = (self.config.get(cfg.NATIVE_OBJECT_STORE_KEY, "auto") or
                "auto").strip().lower()
        if mode in ("0", "false", "off", "no"):
            return None
        required = mode in ("1", "true", "on", "yes")
        try:
            from raydp_tpu_torch.native.arena import Arena
            size = self.config.get_memory(
                cfg.OBJECT_STORE_MEMORY_KEY, default=_default_arena_size())
            arena = Arena.create(f"rdt{self.session_id[:8]}_arena", size)
            logger.info("native object store arena: %s (%d MiB)",
                        arena.segment, size >> 20)
            return arena
        except Exception as e:
            if required:
                raise RuntimeError(
                    f"native object store requested but unavailable: {e}") from e
            logger.warning("native store arena unavailable (%s); "
                           "using per-object segments", e)
            return None

    # ---- actor management ---------------------------------------------------
    def record(self, actor_id: str) -> ActorRecord:
        rec = self.records.get(actor_id)
        if rec is None:
            raise KeyError(f"unknown actor {actor_id}")
        return rec

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
        return self.launch_actor(spec, block=block)

    # ---- attach-mode driver lifetime ----------------------------------------
    def register_driver(self, driver_id: str) -> None:
        with self._lock:
            self._drivers[driver_id] = time.monotonic()
        logger.info("driver %s attached", driver_id)

    def driver_heartbeat(self, driver_id: str) -> bool:
        with self._lock:
            if driver_id not in self._drivers:
                return False
            self._drivers[driver_id] = time.monotonic()
            return True

    def detach_driver(self, driver_id: str) -> bool:
        """Graceful detach: the driver's remaining actors are UNBOUND — they
        survive for the next driver (this is what carries the master of a
        ``stop(cleanup_data=False)`` session across drivers)."""
        with self._lock:
            present = self._drivers.pop(driver_id, None) is not None
            for rec in self.records.values():
                if rec.driver_id == driver_id:
                    rec.driver_id = None
        if present:
            logger.info("driver %s detached", driver_id)
        return present

    def _reap_dead_drivers(self) -> None:
        """A driver that stopped heartbeating without detaching crashed: its
        still-bound actors are reaped (Ray's non-detached-actor lifetime),
        so a crashing client cannot leak sessions on a long-lived head."""
        now = time.monotonic()
        with self._lock:
            dead = [d for d, beat in self._drivers.items()
                    if now - beat > self.driver_reap_after_s]
            for d in dead:
                del self._drivers[d]
            victims = [rec.spec.actor_id for rec in self.records.values()
                       if rec.driver_id in dead and rec.state != DEAD] \
                if dead else []
        for d in dead:
            logger.warning("driver %s stopped heartbeating; reaping its "
                           "actors", d)
        for actor_id in victims:
            self.kill_actor(actor_id, no_restart=True)

    def launch_actor(self, spec: ActorSpec, block: bool = True,
                     driver_id: Optional[str] = None) -> ActorHandle:
        if driver_id is not None:
            # a client creating actors is self-evidently alive: re-register
            # it if a heartbeat stall already reaped it, so its new actors
            # stay reapable instead of leaking bound to an unknown driver
            with self._lock:
                if driver_id not in self._drivers:
                    self._drivers[driver_id] = time.monotonic()
                    logger.info("driver %s re-registered via create_actor",
                                driver_id)
        with self._lock:
            if spec.name is not None and spec.name in self.names:
                existing = self.records.get(self.names[spec.name])
                if existing is not None and existing.state != DEAD:
                    raise ValueError(f"actor name {spec.name!r} already taken")
            if spec.placement_group_id is not None and spec.bundle_index is not None:
                # bundle resources were pre-reserved at group creation: run on
                # the bundle's node without charging the node a second time
                # (parity: actors scheduled *into* bundles, context.py:119-140)
                group = self.resource_manager.get_group(spec.placement_group_id)
                if group is None:
                    raise ValueError(
                        f"unknown placement group {spec.placement_group_id}")
                node_id = group.bundle_node(spec.bundle_index)
                held: Dict[str, float] = {}
            else:
                node_id = self.resource_manager.allocate(spec.resources,
                                                         spec.node_id)
                if node_id is None:
                    raise ValueError(
                        f"cannot place actor {spec.name or spec.actor_id}: "
                        f"resources {spec.resources} not available")
                held = dict(spec.resources)
            rec = ActorRecord(spec=spec, node_id=node_id, resources_held=held,
                              driver_id=driver_id)
            self.records[spec.actor_id] = rec
            if spec.name is not None:
                self.names[spec.name] = spec.actor_id
            self._spawn(rec)
        handle = ActorHandle(spec.actor_id, spec.name, self.server.address)
        if block:
            handle.wait_ready()
        return handle

    def _spawn(self, rec: ActorRecord) -> None:
        log_name = (f"{rec.spec.name or rec.spec.actor_id}"
                    f"-r{rec.restart_count}")
        agent = self.node_agents.get(rec.node_id) if rec.node_id else None
        if agent is not None:
            # the node is served by an agent: spawn there (real multi-node
            # placement — node affinity resolves to that machine's processes)
            overrides = dict(rec.spec.env)
            overrides[ENV_HEAD] = self.server.url
            overrides[ENV_ACTOR_ID] = rec.spec.actor_id
            overrides[ENV_SESSION] = self.session_id
            overrides[ENV_SESSION_DIR] = self.session_dir
            # data-plane env (RDT_STORE_HOST_ID / PAYLOAD_ADDR / ARENA) is
            # injected by the agent itself at spawn: children on an isolated
            # node write to and read from that machine's own payload plane
            # forward the driver's import path: cloudpickle pickles classes
            # by reference, so the child must resolve the driver's modules
            # (the agent appends its own path after these)
            driver_path = [p for p in sys.path if p]
            if overrides.get("PYTHONPATH"):
                driver_path.append(overrides["PYTHONPATH"])
            overrides["PYTHONPATH"] = os.pathsep.join(driver_path)
            # one bounded (30s) hop to a peer whose spawn handler never
            # calls back into the head's pool — no self-deadlock feedback
            # rdtlint: allow[dispatcher-blocking] bounded agent spawn hop
            pid = agent.call("spawn", overrides, log_name, timeout=30.0)
            rec.process = _RemoteProcess(agent, pid, rec.node_id)
        else:
            env = dict(os.environ)
            env.update(rec.spec.env)
            env[ENV_HEAD] = self.server.url
            env[ENV_ACTOR_ID] = rec.spec.actor_id
            env[ENV_SESSION] = self.session_id
            env[ENV_SESSION_DIR] = self.session_dir
            # child must resolve every module the driver can (cloudpickle
            # pickles classes by reference): prepend the driver's sys.path
            driver_path = [p for p in sys.path if p]
            existing = env.get("PYTHONPATH")
            if existing:
                driver_path.append(existing)
            env["PYTHONPATH"] = os.pathsep.join(driver_path)
            log_path = os.path.join(self.session_dir, "logs",
                                    f"{log_name}.out")
            proc = None
            if bool(knobs.get("RDT_WARM_FORK")):
                # fork-fast scale-up: clone the pre-imported prototype
                # instead of paying a cold interpreter + import chain; any
                # warm-plane failure falls through to the cold Popen below
                from raydp_tpu_torch.runtime import warm_fork
                proc = warm_fork.warm_spawn(
                    self._warm_fork, os.path.join(self.session_dir, "logs"),
                    env, log_path, log_name)
            if proc is None:
                out = open(log_path, "ab")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "raydp_tpu_torch.runtime.actor_main"],
                    env=env, stdout=out, stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
                out.close()
            rec.process = proc
        rec.state = PENDING if rec.restart_count == 0 else RESTARTING

    def on_actor_ready(self, actor_id: str, address: tuple) -> None:
        rec = self.record(actor_id)
        rec.address = tuple(address)
        rec.state = ALIVE
        rec.ready.set()
        self._resolve_waiters()
        logger.info("actor %s ready at %s (restart %d)",
                    rec.spec.name or actor_id, address, rec.restart_count)

    # ---- non-blocking ready waits -------------------------------------------
    def add_ready_waiter(self, actor_id: str, timeout: float, mode: str):
        """A deferred reply completed by ``on_actor_ready`` / the supervisor
        tick instead of a parked RPC thread. ``mode='address'`` resolves to
        the address or None (get_actor_address contract); ``mode='ready'``
        resolves to True or raises TimeoutError (wait_actor_ready)."""
        from concurrent.futures import Future

        from raydp_tpu_torch.runtime.rpc import DeferredReply

        fut: Future = Future()
        with self._waiters_lock:
            self._waiters.append(
                (time.monotonic() + timeout, timeout, actor_id, fut, mode))
        # the actor may have turned ready between the check and registration
        self._resolve_waiters()
        return DeferredReply(fut)

    def _resolve_waiters(self) -> None:
        now = time.monotonic()
        with self._waiters_lock:
            waiters, self._waiters = self._waiters, []
        keep = []
        for deadline, timeout, actor_id, fut, mode in waiters:
            if fut.done():
                continue
            rec = self.records.get(actor_id)
            if rec is not None and rec.ready.is_set() and rec.state == ALIVE:
                fut.set_result(tuple(rec.address) if mode == "address"
                               else True)
            elif rec is None or rec.state == DEAD:
                if mode == "address":
                    fut.set_result(None)
                else:
                    fut.set_exception(TimeoutError(
                        f"actor {actor_id} died while waiting "
                        f"(state={rec.state if rec else 'unknown'})"))
            elif now >= deadline:
                if mode == "address":
                    fut.set_result(None)
                else:
                    fut.set_exception(TimeoutError(
                        f"actor {rec.spec.name or actor_id} not ready after "
                        f"{timeout}s (state={rec.state})"))
            else:
                keep.append((deadline, timeout, actor_id, fut, mode))
        if keep:
            with self._waiters_lock:
                self._waiters.extend(keep)

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        with self._lock:
            rec = self.records.get(actor_id)
            if rec is None:
                return
            rec.deliberate_kill = no_restart
            proc = rec.process
        if proc is not None:
            _terminate(proc)
        # supervisor loop will observe the exit and apply restart-vs-dead policy

    def owner_key(self, rec: ActorRecord) -> str:
        return rec.spec.name or rec.spec.actor_id

    def _supervise(self) -> None:
        while not self._stopped.is_set():
            try:
                self._supervise_once()
                self._resolve_waiters()
                self._reap_dead_drivers()
            except Exception:  # noqa: BLE001 - the supervisor must never die
                logger.exception("supervisor tick failed; continuing")
            time.sleep(0.1)

    def _supervise_once(self) -> None:
        with self._lock:
            items = list(self.records.items())
        for actor_id, rec in items:
            if rec.state == DEAD or rec.process is None:
                continue
            code = rec.process.poll()
            if code is None:
                continue
            if (isinstance(rec.process, _RemoteProcess)
                    and rec.process.lost):
                # unreachable agent = node death: reap the whole node so
                # every actor on it reroutes, not just this one
                self._agent_lost(rec.process.node_id)
            with self._lock:
                if rec.state == DEAD:
                    continue
                rec.ready.clear()
                rec.address = None
                if rec.node_id and rec.resources_held:
                    self.resource_manager.release(rec.node_id, rec.resources_held)
                    rec.resources_held = {}
                limit = rec.spec.max_restarts
                can_restart = (not rec.deliberate_kill
                               and (limit == -1 or rec.restart_count < limit))
                if can_restart:
                    rec.restart_count += 1
                    rec.was_restarted = True
                    rec.state = RESTARTING
                    node_id, held = self._replacement_node(rec)
                    if node_id is None:
                        # leave RESTARTING: retried next tick (pending resources)
                        rec.process = None
                        continue
                    rec.node_id = node_id
                    rec.resources_held = held
                    logger.warning(
                        "actor %s exited with code %s; restarting (attempt %d)",
                        rec.spec.name or actor_id, code, rec.restart_count)
                    self._spawn_supervised(rec)
                else:
                    rec.state = DEAD
                    rec.process = None
                    logger.info("actor %s exited with code %s; dead",
                                rec.spec.name or actor_id, code)
                    self.store_server.free_owned_by(self.owner_key(rec))
        # pending RESTARTING actors with no process: retry placement — unless
        # a deliberate kill arrived while the record had no process to
        # terminate (e.g. a dead driver's reaped executor awaiting resources):
        # resurrecting it would leak the actor forever
        dead_now: List[ActorRecord] = []
        with self._lock:
            for rec in self.records.values():
                if rec.state == RESTARTING and rec.process is None:
                    if rec.deliberate_kill:
                        rec.state = DEAD
                        dead_now.append(rec)
                        continue
                    node_id, held = self._replacement_node(rec)
                    if node_id is not None:
                        rec.node_id = node_id
                        rec.resources_held = held
                        self._spawn_supervised(rec)
        for rec in dead_now:
            logger.info("actor %s killed while awaiting restart; dead",
                        rec.spec.name or rec.spec.actor_id)
            self.store_server.free_owned_by(self.owner_key(rec))

    def _spawn_supervised(self, rec: ActorRecord) -> None:
        """Spawn from the supervisor thread: a failed spawn (e.g. the target
        node's agent just died) must not kill the supervisor — the record
        stays RESTARTING and is re-placed next tick, and an unreachable
        agent's node is reaped."""
        try:
            self._spawn(rec)
        except Exception as e:  # noqa: BLE001 - supervisor must survive
            from raydp_tpu_torch.runtime.rpc import RemoteError

            logger.warning("spawn of %s on %s failed (%s); will re-place",
                           rec.spec.name or rec.spec.actor_id, rec.node_id, e)
            if (rec.node_id in self.node_agents
                    and not isinstance(e, RemoteError)):
                # transport failure → the agent itself is unreachable
                self._agent_lost(rec.node_id)
            if rec.node_id and rec.resources_held:
                self.resource_manager.release(rec.node_id, rec.resources_held)
                rec.resources_held = {}
            rec.process = None
            rec.state = RESTARTING

    def _replacement_node(self, rec: ActorRecord):
        """Node for a restarting actor: its placement-group bundle if the group
        (and that node) is still alive, else a fresh allocation."""
        spec = rec.spec
        if spec.placement_group_id is not None and spec.bundle_index is not None:
            group = self.resource_manager.get_group(spec.placement_group_id)
            if group is not None:
                node_id = group.bundle_node(spec.bundle_index)
                node = self.resource_manager.get_node(node_id) if node_id else None
                if node is not None and node.alive:
                    return node_id, {}
        node_id = self.resource_manager.allocate(spec.resources, spec.node_id)
        return node_id, (dict(spec.resources) if node_id is not None else {})

    # ---- nodes --------------------------------------------------------------
    def node_is_remote(self, node) -> bool:
        """True when processes on ``node`` cannot map this host's shared
        memory (the node is another machine) — the single source of the
        data-plane locality rule for both actor and SPMD-rank spawns."""
        return node.address not in ("127.0.0.1", self.server.address[0])

    def register_node_agent(self, host: str, port: int,
                            resources: Dict[str, float],
                            address: str,
                            store_isolated: bool = False) -> Dict[str, Any]:
        from raydp_tpu_torch.runtime.rpc import RpcClient

        client = RpcClient((host, int(port)))
        node_id = self.resource_manager.add_node(address, resources)
        node = self.resource_manager.get_node(node_id)
        # another machine cannot share this host's /dev/shm: its agent must
        # host its own payload plane (tests force this with RDT_STORE_ISOLATED)
        isolated = bool(store_isolated) or (node is not None
                                            and self.node_is_remote(node))
        with self._lock:
            self.node_agents[node_id] = client
        logger.info("node agent registered: %s at %s:%d (%s, store=%s)",
                    node_id, host, port, resources,
                    "isolated" if isolated else "shared")
        return {"node_id": node_id, "session_id": self.session_id,
                "session_dir": self.session_dir,
                "store_mode": "isolated" if isolated else "shared"}

    def register_store_host(self, node_id: str,
                            arena_segment: Optional[str],
                            shm_budget: Optional[int] = None) -> bool:
        with self._lock:
            self.store_hosts[node_id] = arena_segment
        self.store_server.register_node_budget(node_id, shm_budget)
        return True

    def store_host_of_node(self, node_id: Optional[str]) -> str:
        """The data-plane host id for processes on ``node_id`` — the node id
        itself when its agent hosts an isolated payload plane, else the head
        machine's shared plane."""
        if node_id is not None and node_id in self.store_hosts:
            return node_id
        return objstore.HEAD_HOST

    def _node_store_release(self, host_id: str, items,
                            defer_segments: bool = False) -> None:
        agent = self.node_agents.get(host_id)
        if agent is not None:
            agent.call("store_release", items, defer_segments, timeout=30.0)

    def _node_store_fetch(self, host_id: str, segment: str, offset: int,
                          size: int) -> bytes:
        agent = self.node_agents.get(host_id)
        if agent is None:
            raise KeyError(f"node {host_id} is gone; payload unreadable")
        return agent.call("store_fetch", segment, offset, size, timeout=60.0)

    def _node_store_spill(self, host_id: str, object_id: str, segment: str,
                          offset: int, size: int) -> bool:
        agent = self.node_agents.get(host_id)
        if agent is None:
            raise KeyError(f"node {host_id} is gone")
        return agent.call("store_spill", object_id, segment, offset, size,
                          timeout=120.0)

    def _node_store_fault_in(self, host_id: str, object_id: str,
                             seg_name: str):
        agent = self.node_agents.get(host_id)
        if agent is None:
            raise KeyError(f"node {host_id} is gone")
        return agent.call("store_fault_in", object_id, seg_name,
                          timeout=120.0)

    def _node_store_remove_spill(self, host_id: str, object_ids) -> None:
        agent = self.node_agents.get(host_id)
        if agent is not None:
            agent.call("store_remove_spill", list(object_ids), timeout=30.0)

    def _agent_lost(self, node_id: str) -> None:
        agent = self.node_agents.pop(node_id, None)
        if agent is None:
            return
        try:
            agent.close()
        except Exception:
            pass
        logger.warning("node agent for %s unreachable; removing node", node_id)
        self.remove_node(node_id)

    def _purge_node_store(self, node_id: str) -> None:
        """Node death: its payload plane is gone — drop its table entries so
        readers fail into lineage recovery instead of timing out."""
        with self._lock:
            hosted = self.store_hosts.pop(node_id, "__absent__")
        if hosted != "__absent__":
            self.store_server.purge_host(node_id)

    def remove_node(self, node_id: str) -> None:
        """Fault injection: node death kills its actors; restartable actors are
        revived on surviving nodes (parity: test_spark_cluster.py:262-299)."""
        self._purge_node_store(node_id)
        self.resource_manager.remove_node(node_id)
        with self._lock:
            victims = [rec for rec in self.records.values()
                       if rec.node_id == node_id and rec.state != DEAD]
        for rec in victims:
            rec.spec.node_id = None  # allow re-placement anywhere
            self.kill_actor(rec.spec.actor_id, no_restart=False)

    def get_actor(self, name: str) -> Optional[ActorHandle]:
        actor_id = self.names.get(name)
        if actor_id is None:
            return None
        rec = self.records.get(actor_id)
        if rec is None or rec.state == DEAD:
            return None
        return ActorHandle(actor_id, name, self.server.address)

    # ---- shutdown -----------------------------------------------------------
    def shutdown(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        with self._lock:
            recs = list(self.records.values())
        for rec in recs:
            rec.deliberate_kill = True
            if rec.process is not None:
                _terminate(rec.process)
            rec.state = DEAD
        self._resolve_waiters()  # every record is DEAD now: fail the waiters
        if self._warm_fork[0] is not None:
            # after the workers above are terminated: the prototype's death
            # cascades (pdeathsig) to any forked worker still exiting
            try:
                self._warm_fork[0].stop()
            except Exception:
                pass
        self.store_client.close()
        # store shutdown BEFORE agent teardown: node-hosted payload releases
        # ride the still-open agent connections
        self.store_server.shutdown()
        for node_id, agent in list(self.node_agents.items()):
            try:
                agent.call("shutdown", timeout=5.0)
            except Exception:
                pass
            try:
                agent.close()
            except Exception:
                pass
        self.node_agents.clear()
        self.server.stop()
        objstore.set_client(None)
        logger.info("runtime head shut down (session %s)", self.session_id[:12])


def _default_arena_size() -> int:
    """Default arena capacity: a quarter of /dev/shm free space, capped at 4 GiB
    and floored at 64 MiB (objects overflowing the arena fall back to dedicated
    segments, so undersizing degrades gracefully)."""
    try:
        st = os.statvfs("/dev/shm")
        free = st.f_bavail * st.f_frsize
    except OSError:
        free = 1 << 30
    return max(64 << 20, min(4 << 30, free // 4))


def _default_node_resources() -> Dict[str, float]:
    try:
        import psutil
        mem = int(psutil.virtual_memory().total * 0.8)
    except Exception:
        mem = 8 << 30
    cpus = float(os.cpu_count() or 1)
    return {"CPU": max(cpus, 4.0), "memory": float(mem)}


def visible_cards() -> int:
    """The CUDA cards this process sees (0 without CUDA): the head node's
    ``GPU`` resource, which gang ranks with ``gpus_per_process`` take."""
    import torch

    return torch.cuda.device_count()


# -- module-global singleton --------------------------------------------------------
_runtime: Optional[RuntimeContext] = None
_runtime_lock = threading.RLock()


def init_runtime(config: Optional[Config] = None,
                 virtual_nodes: Optional[List[Dict[str, float]]] = None) -> RuntimeContext:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = RuntimeContext(config=config, virtual_nodes=virtual_nodes)
        return _runtime


def adopt_runtime(rt) -> None:
    """Install a runtime-protocol object as the process-global runtime — the
    attach path (a :class:`~raydp_tpu_torch.runtime.client.ClientContext`
    connected to a standalone head)."""
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            raise RuntimeError("runtime already initialized in this process")
        _runtime = rt


def get_runtime() -> RuntimeContext:
    if _runtime is None:
        raise RuntimeError("runtime not initialized; call init_runtime() first")
    return _runtime


def runtime_initialized() -> bool:
    return _runtime is not None


def shutdown_runtime() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def main() -> None:
    """Standalone head: a cluster that outlives (and is shared by) drivers.

    ``python -m raydp_tpu_torch.runtime.head --listen [--port N] [--host H]``
    prints ``RDT_HEAD_READY <host:port>`` once serving; drivers attach with
    ``adopt_runtime(ClientContext("host:port"))``. Parity: the Ray head node
    the reference's client-mode matrix connects to (conftest.py:77-140) and
    the driver-outliving cluster of test_spark_cluster.py:113-134."""
    import argparse

    ap = argparse.ArgumentParser(
        description="raydp_tpu_torch standalone head (attach/client mode)")
    ap.add_argument("--listen", action="store_true", required=True,
                    help="serve until killed")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed on stdout)")
    ap.add_argument("--cpus", type=float, default=None,
                    help="CPU resource of the head node (default: all)")
    args = ap.parse_args()

    virtual_nodes = None
    if args.cpus is not None:
        virtual_nodes = [{"CPU": args.cpus,
                          "memory": _default_node_resources()["memory"]}]
    rt = RuntimeContext(listen_host=args.host, listen_port=args.port,
                        virtual_nodes=virtual_nodes)
    print(f"RDT_HEAD_READY {rt.server.url}", flush=True)
    try:
        while True:
            time.sleep(3600.0)
    except KeyboardInterrupt:
        pass
    finally:
        rt.shutdown()


if __name__ == "__main__":
    main()
