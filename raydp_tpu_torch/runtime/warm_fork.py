"""Warm-start executor plane: fork workers from a pre-imported prototype.

Cold executor spawn pays a fresh interpreter plus the heavy import chain
(torch, pyarrow, pandas) on every scale-up — seconds of wall-clock between the
autoscaler's decision and a worker that can take tasks. This module keeps ONE
long-lived prototype process per spawner (the head's local spawn path, or a
node agent) that has already paid those imports, and serves each spawn by
``os.fork()``-ing the prototype: the child inherits the warm import state
copy-on-write and goes straight into the actor bootstrap
(:mod:`raydp_tpu_torch.runtime.actor_main`). Parity: the reference rides Ray's
prestarted worker pool for exactly this reason (SURVEY.md §4 — executor
creation is on the job's critical path when AQE re-plans stage widths).

Topology and failure containment:

- The prototype is spawned with ``PR_SET_PDEATHSIG`` against its owner
  (driver or node agent), and every forked worker sets it against the
  prototype. A hard-killed driver therefore takes the prototype down, and the
  prototype's death takes its forked workers down: ZERO orphans, the same
  guarantee the cold path gets from process groups + agent pdeathsig. The
  deliberate flip side: a crashed prototype kills its living forked workers —
  that is node-death-shaped, the supervisor restarts them (cold, because the
  manager latches failed).
- Any warm-plane failure (prototype won't start, handshake timeout, protocol
  error) raises :class:`WarmForkError`; callers degrade LOUDLY to the cold
  spawn path (a warning plus a degraded ``warm_fork`` event) and the manager
  latches failed. The latch is supervised, not permanent: after
  ``RDT_WARM_REFRESH_COOLDOWN_S`` the next fork request re-warms a fresh
  prototype (bounded by ``RDT_WARM_FORK_RETRIES`` restarts, each counted by
  ``pool_warm_refreshes_total``), so long sessions stay fork-fast. Warm
  start is an accelerator, never a correctness dependency.
- A forked child that dies before its readiness handshake is reaped by the
  prototype's ``waitpid`` loop (no zombie) and reported dead through
  :meth:`WarmForkManager.poll_child` (no phantom ALIVE worker).

The prototype protocol is newline-delimited JSON over stdin/stdout:
``{"op": "fork", "env": {...}, "log": path}`` → ``{"pid": n}``;
``{"op": "poll", "pid": n}`` → ``{"exit": code|null}``; ``{"op": "ping"}``.
The prototype stays single-threaded (fork safety) and reaps exited children
opportunistically on every loop tick.
"""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from raydp_tpu_torch import faults, knobs, metrics
from raydp_tpu_torch.log import get_logger

logger = get_logger("warm_fork")

try:  # load libc at import: CDLL post-fork can deadlock in a threaded parent
    import ctypes

    _LIBC = ctypes.CDLL("libc.so.6", use_errno=True)
except Exception:  # pragma: no cover - non-glibc platform
    _LIBC = None


def _set_pdeathsig() -> None:
    """PR_SET_PDEATHSIG(SIGKILL): die with the parent. Applied twice along
    the chain (owner→prototype, prototype→worker) so a hard-killed owner
    cascades all the way down — the zero-orphan invariant of the warm plane."""
    if _LIBC is not None:
        _LIBC.prctl(1, signal.SIGKILL)  # 1 = PR_SET_PDEATHSIG


class WarmForkError(RuntimeError):
    """The warm plane is unavailable; callers fall back to cold spawn."""


class _LineReader:
    """Deadline-bounded newline framing over a raw fd (no buffered reader:
    the poller must see exactly what we have not consumed). ``poll``, not
    ``select``: in a long-lived owner the pipe fd can land past FD_SETSIZE
    (1024), where ``select`` hard-fails with ValueError."""

    def __init__(self, fd: int):
        self._fd = fd
        self._buf = b""
        self._poll = select.poll()
        self._poll.register(fd, select.POLLIN)

    def readline(self, timeout: float) -> Optional[bytes]:
        """One line without its newline; None on timeout, b"" on EOF."""
        deadline = time.monotonic() + timeout
        while b"\n" not in self._buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            ready = self._poll.poll(min(remaining, 1.0) * 1000.0)
            if not ready:
                continue
            chunk = os.read(self._fd, 65536)
            if not chunk:
                return b""
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return line


# ---- prototype process (python -m raydp_tpu_torch.runtime.warm_fork) ---------------


def _preimport() -> list:
    """Pay the heavy imports once, in the prototype. A module that fails to
    import is skipped with a warning — the fork still works, just colder."""
    names = []
    spec = str(knobs.get("RDT_WARM_IMPORTS") or "")
    for name in (n.strip() for n in spec.split(",")):
        if not name:
            continue
        try:
            __import__(name)
            names.append(name)
        except Exception as e:
            print(f"warm-fork prototype: import {name} failed: {e}",
                  file=sys.stderr, flush=True)
    return names


def require_cuda_uninitialized() -> None:
    """Refuse to fork from a process whose torch has initialised CUDA: a
    child forked after that cannot use the card. The prototype imports torch
    (``RDT_WARM_IMPORTS``) and never touches a device, so this holds unless
    an import started CUDA."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            "warm-fork prototype has initialised CUDA; a worker forked from "
            "it could not use the card")


def _child_exec(env: Dict[str, str], log_path: str) -> None:
    """Runs in the forked worker: become what an exec'd actor_main would be.
    Only this child's thread survives the fork, so state is rebuilt, not
    trusted: fresh session, new env, reseeded PRNG, re-armed fault plane."""
    os.setsid()  # own process group: the owner's killpg(pid) contract holds
    _set_pdeathsig()  # against the PROTOTYPE: its death reaps this worker
    os.environ.clear()
    os.environ.update(env)
    os.environ["RDT_WARM_FORKED"] = "1"  # spawn provenance for telemetry
    # wire stdio the way the cold Popen does: log file out, devnull in
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    if fd > 2:
        os.close(fd)
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)
    if devnull > 2:
        os.close(devnull)
    # an exec would honor PYTHONPATH; a fork must splice it into sys.path
    # (cloudpickle resolves driver classes by reference)
    for p in reversed((env.get("PYTHONPATH") or "").split(os.pathsep)):
        if p and p not in sys.path:
            sys.path.insert(0, p)
    import random

    random.seed()  # forked twins must not share a PRNG stream
    faults.reset()  # re-arm from THIS worker's env, not the prototype's
    metrics.reset()  # a fresh process starts with fresh counters
    rc = 0
    try:
        from raydp_tpu_torch.runtime import actor_main

        actor_main.main()
    except SystemExit as e:
        rc = int(e.code or 0)
    except BaseException:
        import traceback

        traceback.print_exc()
        rc = 1
    finally:
        # skip interpreter finalization: atexit/threads belong to the
        # prototype image, not this worker
        os._exit(rc)


def prototype_main() -> None:
    _set_pdeathsig()  # against the owner (driver/agent): die with it
    imports = _preimport()
    exits: Dict[int, int] = {}

    def _reap() -> None:
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            exits[pid] = os.waitstatus_to_exitcode(status)

    def _reply(obj) -> None:
        os.write(1, (json.dumps(obj) + "\n").encode())

    _reply({"ready": True, "pid": os.getpid(), "imports": imports})
    reader = _LineReader(0)
    while True:
        line = reader.readline(timeout=1.0)
        _reap()  # every tick: a pre-readiness death never lingers as a zombie
        if line is None:
            continue
        if line == b"":
            break  # owner closed the pipe: clean shutdown
        try:
            req = json.loads(line)
            op = req.get("op")
            if op == "fork":
                env = {str(k): str(v) for k, v in req["env"].items()}
                require_cuda_uninitialized()
                pid = os.fork()
                if pid == 0:
                    _child_exec(env, req["log"])  # never returns
                _reply({"pid": pid})
            elif op == "poll":
                pid = int(req["pid"])
                code = exits.get(pid)
                if code is None:
                    try:
                        wpid, status = os.waitpid(pid, os.WNOHANG)
                        if wpid == pid:
                            code = os.waitstatus_to_exitcode(status)
                            exits[pid] = code
                    except ChildProcessError:
                        code = -1  # not our child: report dead
                _reply({"exit": code})
            elif op == "ping":
                _reply({"ok": True})
            else:
                _reply({"error": f"unknown op {op!r}"})
        except SystemExit:
            raise
        except BaseException as e:  # a broken request must not kill the plane
            _reply({"error": repr(e)})


# ---- manager (lives in the spawner: head local path or node agent) -----------


class ForkedChild:
    """Popen-shaped handle to a warm-forked worker (a grandchild, so only the
    prototype can ``waitpid`` it — poll routes through the manager). Matches
    every surface the supervisor/agent code touches on a cold Popen:
    ``pid``, ``returncode``, ``poll``, ``wait``, ``kill``/``terminate``."""

    def __init__(self, manager: "WarmForkManager", pid: int):
        self._manager = manager
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            self.returncode = self._manager.poll_child(self.pid)
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("warm-fork-child", timeout)
            time.sleep(0.05)
        return self.returncode  # type: ignore[return-value]

    def kill(self) -> None:
        try:
            os.killpg(self.pid, signal.SIGKILL)  # child setsid()s: pgid==pid
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(self.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    terminate = kill


class WarmForkManager:
    """Owns one prototype process and serves fork-fast spawns from it.

    Failure latch + supervised refresh: a start/protocol failure marks the
    manager failed — forks inside the latch raise immediately and the caller
    cold-spawns (a flapping prototype must not turn scale-up into a retry
    storm). But the latch is no longer permanent: once
    ``RDT_WARM_REFRESH_COOLDOWN_S`` has passed, the next fork request
    re-warms a fresh prototype (a ``warm_fork`` re-warm event +
    ``pool_warm_refreshes_total``), bounded by ``RDT_WARM_FORK_RETRIES``
    restarts per manager — long sessions return to fork-fast instead of
    paying cold spawns forever after one transient prototype death."""

    def __init__(self, log_dir: str):
        self._log_dir = log_dir
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[_LineReader] = None
        self._ready = False
        self._failed = False
        self._failed_at = 0.0
        self._refreshes = 0

    # ---- lifecycle ----------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._proc is not None or self._failed:
            return
        os.makedirs(self._log_dir, exist_ok=True)
        log = open(os.path.join(self._log_dir, "warm-fork-prototype.out"),
                   "ab")
        try:
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "raydp_tpu_torch.runtime.warm_fork"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                start_new_session=True, env=dict(os.environ))
        finally:
            log.close()
        self._reader = _LineReader(self._proc.stdout.fileno())
        logger.info("warm-fork prototype started (pid %d)", self._proc.pid)

    def _await_ready(self, timeout: float) -> None:
        if self._ready:
            return
        line = self._reader.readline(timeout=timeout)
        if not line:  # timeout or EOF: either way the plane is unusable
            raise WarmForkError(
                f"prototype not ready within {timeout:.1f}s")
        handshake = json.loads(line)
        if not handshake.get("ready"):
            raise WarmForkError(f"bad prototype handshake: {handshake!r}")
        self._ready = True
        logger.info("warm-fork prototype ready (imports: %s)",
                    ",".join(handshake.get("imports", [])) or "none")

    def _request(self, obj, timeout: float = 10.0):
        try:
            self._proc.stdin.write((json.dumps(obj) + "\n").encode())
            self._proc.stdin.flush()
        except (OSError, ValueError) as e:
            raise WarmForkError(f"prototype pipe write failed: {e}") from e
        line = self._reader.readline(timeout=timeout)
        if not line:
            raise WarmForkError("prototype stopped answering")
        reply = json.loads(line)
        if "error" in reply:
            raise WarmForkError(f"prototype error: {reply['error']}")
        return reply

    def _fail(self) -> None:
        """Latch failed and put the prototype down; its pdeathsig'd children
        go with it, which the supervisor sees as worker death and restarts
        through the cold path."""
        self._failed = True
        self._failed_at = time.monotonic()
        self._ready = False
        proc, self._proc = self._proc, None
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait(timeout=5.0)

    def _refresh_allowed(self) -> bool:
        """May a latched-failed plane re-warm a prototype NOW? Bounded by
        RDT_WARM_FORK_RETRIES restarts per manager, rate-limited by
        RDT_WARM_REFRESH_COOLDOWN_S since the latch (requests inside the
        cooldown cold-spawn rather than hammer a crashing prototype)."""
        if not self._failed:
            return False
        if self._refreshes >= max(0, int(knobs.get("RDT_WARM_FORK_RETRIES"))):
            return False
        cooldown = max(0.0, float(knobs.get("RDT_WARM_REFRESH_COOLDOWN_S")))
        return time.monotonic() - self._failed_at >= cooldown

    @property
    def available(self) -> bool:
        return not self._failed or self._refresh_allowed()

    # ---- spawn path ---------------------------------------------------------
    def fork(self, env: Dict[str, str], log_path: str,
             key: str = "") -> ForkedChild:
        """Fork one worker with ``env`` writing to ``log_path``. Raises
        :class:`WarmForkError` when the plane is down — the caller's cue to
        cold-spawn. Chaos: ``pool.fork`` fires here; the ``crash`` action
        kills the fresh fork BEFORE its readiness handshake (modeling a
        worker that dies in bootstrap), other actions degrade the fork
        itself (``raise`` → cold-spawn fallback, ``delay`` → slow plane)."""
        rule = faults.check("pool.fork", key=key)
        kill_after = rule is not None and rule.action == "crash"
        if rule is not None and not kill_after:
            faults.apply(rule, "pool.fork")
        with self._lock:
            if self._failed:
                if not self._refresh_allowed():
                    raise WarmForkError("warm-fork plane is latched failed")
                # supervised prototype restart: clear the latch and let
                # _ensure_started below warm a fresh prototype — fork-fast
                # returns without a new manager
                self._refreshes += 1
                self._failed = False
                self._ready = False
                self._proc = None
                self._reader = None
                logger.warning("warm-fork plane re-warming prototype "
                               "(refresh %d)", self._refreshes)
                metrics.inc("pool_warm_refreshes_total")
                metrics.record_event("warm_fork", rewarm=True,
                                     refresh=self._refreshes, key=key)
            if self._proc is not None and self._proc.poll() is not None:
                logger.warning("warm-fork prototype died (exit %s)",
                               self._proc.returncode)
                self._fail()
                raise WarmForkError("prototype died")
            try:
                self._ensure_started()
                self._await_ready(float(knobs.get("RDT_WARM_FORK_WAIT_S")))
                reply = self._request({"op": "fork", "env": env,
                                       "log": log_path})
            except WarmForkError:
                self._fail()
                raise
            pid = int(reply["pid"])
        if kill_after:
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        metrics.inc("pool_warm_forks_total")
        metrics.record_event("warm_fork", pid=pid, key=key,
                             injected_death=kill_after)
        return ForkedChild(self, pid)

    def poll_child(self, pid: int) -> Optional[int]:
        with self._lock:
            if self._proc is not None and self._ready and not self._failed:
                try:
                    return self._request({"op": "poll", "pid": pid})["exit"]
                except WarmForkError:
                    self._fail()
        # prototype gone: its pdeathsig killed the child — probe to confirm
        try:
            os.kill(pid, 0)
            return None  # still exiting (or pdeathsig mid-flight)
        except ProcessLookupError:
            return -9
        except PermissionError:  # pragma: no cover - pid reuse by other user
            return -9

    def stop(self) -> None:
        """Shutdown-time teardown. Living forked workers die with the
        prototype (pdeathsig) — call only after the spawner has terminated
        its workers, exactly like killing a node agent last."""
        with self._lock:
            proc, self._proc = self._proc, None
            self._ready = False
            if proc is None:
                return
            try:
                proc.stdin.close()  # EOF: clean prototype exit
            except OSError:
                pass
            try:
                proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
                proc.wait(timeout=5.0)


def warm_spawn(manager_ref: list, log_dir: str, env: Dict[str, str],
               log_path: str, key: str) -> Optional[ForkedChild]:
    """Shared spawn-side glue for the head and the node agent: lazily create
    the manager in ``manager_ref[0]``, try a warm fork, and degrade loudly
    (warning + ``warm_fork`` degraded event) to None — the caller's cue to
    cold-spawn. Never raises."""
    try:
        if manager_ref[0] is None:
            manager_ref[0] = WarmForkManager(log_dir)
        if not manager_ref[0].available:
            return None
        return manager_ref[0].fork(env, log_path, key=key)
    except WarmForkError as e:
        logger.warning("warm fork for %s degraded to cold spawn: %s", key, e)
        metrics.record_event("warm_fork", key=key, degraded=True,
                             error=str(e))
        return None
    except Exception as e:  # pragma: no cover - defensive: never block spawns
        logger.warning("warm fork for %s failed unexpectedly (%s); "
                       "cold spawn", key, e)
        metrics.record_event("warm_fork", key=key, degraded=True,
                             error=repr(e))
        return None


if __name__ == "__main__":
    prototype_main()
