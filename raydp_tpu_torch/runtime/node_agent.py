"""Node agent: the per-machine daemon that gives the head real multi-node
placement (``python -m raydp_tpu_torch.runtime.node_agent --head HOST:PORT``).

This supplies the substrate role Ray's raylet plays for the reference (SURVEY.md
§1 L1; the reference adopts real node/raylet addresses in
ray_cluster_master.py:185-203): it registers the machine as a node with the
head, then spawns/polls/kills actor processes on request, so ``node_id``
affinity and placement-group bundles resolve to real processes on the agent's
machine instead of bookkeeping entries at 127.0.0.1. The head supervises the
agent connection; an unreachable agent is node death — its actors are killed
from the records and restartable ones revive on surviving nodes.

Object-store note: the agent is also its machine's payload plane in the
distributed data plane. Agents on the head's machine share the head's
shared-memory segments zero-copy; an agent on ANOTHER machine (or forced with
``RDT_STORE_ISOLATED=1``) runs its own :class:`PayloadHost` — a node-local
arena/segment namespace where its actors write payloads, served to readers on
other machines with one direct RPC (never through the head). Parity: the
per-node plasma store a raylet hosts for the reference
(RayDPExecutor.scala:271-287 ``getBlockLocations``).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from raydp_tpu_torch import knobs
from raydp_tpu_torch.log import get_logger, init_logging
from raydp_tpu_torch.runtime.rpc import MethodDispatcher, RpcServer, connect_with_retry

logger = get_logger("node_agent")


try:  # load libc at import: CDLL inside a post-fork preexec_fn can
    # deadlock/fail silently in a threaded parent (malloc locks)
    import ctypes

    _LIBC = ctypes.CDLL("libc.so.6", use_errno=True)
except Exception:  # pragma: no cover - non-glibc platform
    _LIBC = None


def _die_with_parent():
    """PR_SET_PDEATHSIG: actor processes die with their agent, the way a
    node's workers die with its raylet — killing the agent IS node death,
    and no orphan keeps serving a stale actor address. Runs between fork and
    exec; must only make async-signal-safe calls (the prctl syscall is)."""
    if _LIBC is not None:
        _LIBC.prctl(1, signal.SIGKILL)  # 1 = PR_SET_PDEATHSIG


class NodeAgentService:
    """RPC surface the head drives: spawn/poll/kill actor processes here."""

    def __init__(self, agent: "NodeAgent"):
        self._agent = agent

    def spawn(self, env_overrides: Dict[str, str], log_name: str,
              argv: Optional[list] = None) -> int:
        return self._agent.spawn(env_overrides, log_name, argv)

    def poll(self, pid: int) -> Optional[int]:
        return self._agent.poll(pid)

    def kill(self, pid: int) -> bool:
        return self._agent.kill(pid)

    def reap(self, pid: int) -> Optional[int]:
        """Kill ``pid`` (if still running) and, once it has exited, harvest
        the zombie and drop it from the process table — the scale-down
        reaper's bookkeeping twin of :meth:`kill`, which leaves a dead
        entry behind forever. Returns the exit code, or None while the
        process has not exited yet (callers poll; this handler never parks
        a dispatcher waiting on an exit)."""
        return self._agent.reap(pid)

    def list_pids(self) -> Dict[int, Optional[int]]:
        return {pid: self._agent.poll(pid) for pid in list(self._agent.procs)}

    def shutdown(self) -> bool:
        threading.Thread(target=self._agent.stop, daemon=True).start()
        return True

    def ping(self) -> str:
        return "pong"

    # ---- telemetry (doc/observability.md) -----------------------------------
    def telemetry(self):
        """This agent process's full observability state — spans, thread
        names, metrics, and flight-recorder events — the node-agent twin of
        the actor ``__rdt_spans__`` intrinsic, for trace collection."""
        from raydp_tpu_torch import metrics, profiler
        out = profiler.export_spans()
        out.update(metrics.export_state())
        return out

    def metrics_state(self):
        """Metrics + events only (``__rdt_metrics__`` twin) — what the
        metrics/blackbox harvests want; the span ring (up to
        RDT_PROFILER_MAX_SPANS entries) would be pure transfer weight
        there and megabytes of dead JSON in a blackbox bundle."""
        from raydp_tpu_torch import metrics
        return metrics.export_state()

    def clock_ns(self) -> int:
        """The driver's clock-offset handshake (``__rdt_clock__`` twin)."""
        return time.time_ns()

    # ---- node-local payload plane (isolated store mode) ---------------------
    def store_fetch(self, segment: str, offset: int, size: int) -> bytes:
        """Serve payload bytes hosted on this machine to a reader elsewhere —
        the one-hop node-to-node transfer of the distributed data plane."""
        return self._agent.payload_host.fetch(segment, offset, size)

    def store_fetch_ranges(self, items) -> list:
        """Many byte ranges of payloads hosted here in ONE RPC — the batched
        reduce-side read of the consolidated shuffle path: a reduce task
        fetches its bucket's slice of every map output on this machine with
        a single round-trip instead of one per blob. Each item is
        ``(segment, base, start, size)``: the payload's table offset (arena
        offset, -1 for a dedicated segment) and the range offset within it."""
        return [self._agent.payload_host.fetch_range(seg, int(base),
                                                     int(start), int(size))
                for seg, base, start, size in items]

    def store_release(self, items, defer_segments: bool = False) -> int:
        return self._agent.payload_host.release(
            [(seg, int(off)) for seg, off in items],
            defer_segments=defer_segments)

    def store_reap(self) -> bool:
        return self._agent.payload_host.reap()

    def store_arena_info(self):
        return self._agent.payload_host.arena_info()

    def store_arena_stats(self):
        return self._agent.payload_host.arena_stats()

    # ---- node-local eviction/spill (head-directed) --------------------------
    def store_spill(self, object_id: str, segment: str, offset: int,
                    size: int) -> bool:
        """Copy a payload hosted here to this machine's spill dir (the head
        owns the table and the LRU decision; the bytes never leave the node).
        The shm is NOT released here — the head releases it exactly once,
        after confirming the table entry survived the write (a concurrent
        free() would otherwise double-release the same arena offset)."""
        agent = self._agent
        data = agent.payload_host.fetch(segment, int(offset), int(size))
        os.makedirs(agent.spill_dir, exist_ok=True)
        path = os.path.join(agent.spill_dir, object_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return True

    def store_fault_in(self, object_id: str, seg_name: str):
        """Bring a spilled payload back into this machine's shm; returns the
        new ``(segment, offset)``. The spill file is kept — the head removes
        it only after its table commits the new location (a lost reply must
        leave the object recoverable)."""
        agent = self._agent
        path = os.path.join(agent.spill_dir, object_id)
        with open(path, "rb") as f:
            data = f.read()
        return agent.payload_host.write(data, seg_name)

    def store_remove_spill(self, object_ids) -> int:
        n = 0
        for oid in object_ids:
            try:
                os.remove(os.path.join(self._agent.spill_dir, oid))
                n += 1
            except OSError:
                pass
        return n


class NodeAgent:
    def __init__(self, head_url: str, resources: Dict[str, float],
                 log_dir: Optional[str] = None):
        self.head_url = head_url
        self.resources = resources
        host, port = head_url.rsplit(":", 1)
        self.head = connect_with_retry((host, int(port)))
        self.server = RpcServer(MethodDispatcher(NodeAgentService(self)),
                                host=self.head.local_host, port=0,
                                max_concurrency=8, name="node-agent")
        self.procs: Dict[int, subprocess.Popen] = {}
        self._lock = threading.Lock()
        #: lazy per-agent warm-fork manager (1-elem ref for the shared glue)
        self._warm_fork: list = [None]
        self._stopped = threading.Event()

        store_isolated = bool(knobs.get("RDT_STORE_ISOLATED"))
        reply = self.head.call(
            "register_node_agent", self.server.address[0],
            self.server.address[1], dict(resources), self.head.local_host,
            store_isolated)
        self.node_id = reply["node_id"]
        self.session_id = reply["session_id"]
        self.session_dir = reply["session_dir"]
        self.log_dir = log_dir or os.path.join(self.session_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)

        # distributed data plane: on another machine (or when forced for
        # tests) this agent hosts its own payload plane — node-local arena +
        # segments, served over this agent's RPC
        from raydp_tpu_torch.runtime.object_store import PayloadHost
        self.store_isolated = reply.get("store_mode") == "isolated"
        self.payload_host = PayloadHost(
            self._create_arena() if self.store_isolated else None)
        self.spill_dir = os.path.join(self.session_dir,
                                      f"spill-{self.node_id}")
        if self.store_isolated:
            info = self.payload_host.arena_info()
            # this machine's shm budget: objects past it LRU-spill to the
            # node's spill dir under the head's direction
            budget = knobs.get("RDT_NODE_SHM_BUDGET")
            if budget is None:
                budget = info["size"] if info else (1 << 30)
            budget = int(budget)
            self.head.call("register_store_host", self.node_id,
                           info["segment"] if info else None, budget)
        logger.info("node agent %s registered with %s (resources=%s, store=%s)",
                    self.node_id, head_url, resources,
                    "isolated" if self.store_isolated else "shared")

    def _create_arena(self):
        """Node-local arena for this machine's payloads; per-object segment
        fallback when the native core is unavailable."""
        try:
            from raydp_tpu_torch.native.arena import Arena
            from raydp_tpu_torch.runtime.head import _default_arena_size
            size = knobs.get("RDT_NODE_ARENA_SIZE")
            size = int(size) if size is not None else _default_arena_size()
            arena = Arena.create(f"rdt{self.session_id[:8]}_n{os.getpid()}",
                                 size)
            logger.info("node-local store arena: %s (%d MiB)",
                        arena.segment, size >> 20)
            return arena
        except Exception as e:
            logger.warning("node arena unavailable (%s); per-object segments",
                           e)
            return None

    # ---- process management (driven by the head) ----------------------------
    def spawn(self, env_overrides: Dict[str, str], log_name: str,
              argv: Optional[list] = None) -> int:
        """Spawn a runtime process here; ``argv`` defaults to the actor
        bootstrap but callers may launch other entry points (e.g. SPMD gang
        ranks). An override valued ``None`` removes
        the variable from the child env (same contract as the local spawn
        path, SPMDJob._spawn_rank)."""
        env = dict(os.environ)
        for k, v in env_overrides.items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = v
        if self.store_isolated:
            # children write payloads into THIS machine's plane and read
            # same-machine objects zero-copy; explicit overrides win
            from raydp_tpu_torch.runtime import object_store as objstore
            info = self.payload_host.arena_info()
            defaults = {
                objstore.ENV_STORE_HOST_ID: self.node_id,
                objstore.ENV_STORE_PAYLOAD_ADDR:
                    f"{self.server.address[0]}:{self.server.address[1]}",
            }
            if info:
                defaults[objstore.ENV_STORE_ARENA] = info["segment"]
            for k, v in defaults.items():
                if k not in env_overrides:
                    env[k] = v
        # the child resolves driver-pickled classes by reference: the head's
        # forwarded PYTHONPATH (driver sys.path) takes precedence — matching
        # local-spawn semantics so one session never runs two code versions —
        # with this agent's own import path appended as fallback
        paths = ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
        paths.extend(p for p in sys.path if p)
        env["PYTHONPATH"] = os.pathsep.join(paths)
        log_path = os.path.join(self.log_dir, f"{log_name}.out")
        proc = None
        if argv is None and bool(knobs.get("RDT_WARM_FORK")):
            # fork-fast scale-up for the default actor bootstrap only (SPMD
            # ranks and other entry points keep their exec semantics); any
            # warm-plane failure falls through to the cold Popen below
            from raydp_tpu_torch.runtime import warm_fork
            proc = warm_fork.warm_spawn(self._warm_fork, self.log_dir,
                                        env, log_path, log_name)
        if proc is None:
            out = open(log_path, "ab")
            cmd = [sys.executable] + (
                list(argv) if argv
                else ["-m", "raydp_tpu_torch.runtime.actor_main"])
            proc = subprocess.Popen(
                cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True, preexec_fn=_die_with_parent)
            out.close()
        with self._lock:
            self.procs[proc.pid] = proc
        logger.info("spawned actor process %d (%s)", proc.pid, log_name)
        return proc.pid

    def poll(self, pid: int) -> Optional[int]:
        with self._lock:
            proc = self.procs.get(pid)
        if proc is None:
            return -1  # unknown pid: report dead
        return proc.poll()

    def kill(self, pid: int) -> bool:
        with self._lock:
            proc = self.procs.get(pid)
        if proc is None or proc.poll() is not None:
            return False
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                proc.kill()
            except ProcessLookupError:
                pass
        return True

    def reap(self, pid: int) -> Optional[int]:
        """Kill + harvest: SIGKILL the group if still alive, then (without
        blocking) poll; once exited, the Popen's poll() has waitpid'ed the
        zombie and the table entry is dropped so a long-lived agent that
        scales executors up and down all day never accumulates dead
        entries. Returns the exit code, None while still exiting."""
        with self._lock:
            proc = self.procs.get(pid)
        if proc is None:
            return -1
        self.kill(pid)
        code = proc.poll()
        if code is not None:
            with self._lock:
                self.procs.pop(pid, None)
        return code

    # ---- lifecycle ----------------------------------------------------------
    def serve_forever(self) -> None:
        """Heartbeat the head; die (reaping children) when it goes away."""
        try:
            while not self._stopped.is_set():
                self.head.call("ping", timeout=30.0)
                time.sleep(2.0)
        except Exception:
            logger.warning("head connection lost; shutting down")
        finally:
            self.stop()

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        with self._lock:
            procs = list(self.procs.values())
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    try:
                        proc.kill()
                    except ProcessLookupError:
                        pass
        if self._warm_fork[0] is not None:
            try:
                self._warm_fork[0].stop()
            except Exception:
                pass
        self.server.stop()
        try:
            self.payload_host.shutdown()
        except Exception:
            pass
        import shutil
        shutil.rmtree(self.spill_dir, ignore_errors=True)
        logger.info("node agent %s stopped", self.node_id)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="raydp_tpu_torch node agent: joins a head as a schedulable node")
    ap.add_argument("--head", required=True, help="head RPC address host:port")
    ap.add_argument("--cpus", type=float, default=float(os.cpu_count() or 4))
    ap.add_argument("--memory", type=float, default=None,
                    help="bytes; default 80%% of RAM")
    ap.add_argument("--resource", action="append", default=[],
                    metavar="NAME=AMOUNT",
                    help="extra custom resource (repeatable)")
    ap.add_argument("--log-dir", default=None)
    args = ap.parse_args()

    mem = args.memory
    if mem is None:
        try:
            import psutil
            mem = float(int(psutil.virtual_memory().total * 0.8))
        except Exception:
            mem = float(8 << 30)
    resources = {"CPU": args.cpus, "memory": mem}
    for item in args.resource:
        name, _, amount = item.partition("=")
        resources[name] = float(amount or 1.0)

    init_logging("node-agent", str(knobs.get("RDT_LOG_LEVEL")), None, None)
    agent = NodeAgent(args.head, resources, log_dir=args.log_dir)
    agent.serve_forever()


if __name__ == "__main__":
    main()
