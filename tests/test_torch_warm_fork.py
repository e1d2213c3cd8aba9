"""The port's warm-start fork plane (raydp_tpu_torch.runtime.warm_fork): the
scenarios of the reference's test_warm_fork.py against the copy, and the
rule the copy adds — the prototype forks only while CUDA is uninitialised,
since a child forked from a process with a live CUDA context cannot use the
card."""

import os
import socket
import sys
import types

import pytest

from raydp_tpu_torch import faults, metrics
from raydp_tpu_torch.runtime import warm_fork
from raydp_tpu_torch.runtime.head import ENV_ACTOR_ID, ENV_HEAD, ENV_SESSION


@pytest.fixture
def fast_prototype(monkeypatch):
    """No heavy pre-imports: the prototype handshake is near-instant."""
    monkeypatch.setenv("RDT_WARM_IMPORTS", "")
    monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "10")
    metrics.reset()
    yield
    metrics.reset()


def _bootstrap_env(head_url="127.0.0.1:1"):
    """An env whose actor bootstrap dies fast (unreachable head)."""
    return {ENV_HEAD: head_url, ENV_ACTOR_ID: "a-test",
            ENV_SESSION: "s-test", "PYTHONPATH": os.getcwd()}


def _warm_events(**match):
    return [e for e in metrics.events() if e["kind"] == "warm_fork"
            and all(e.get(k) == v for k, v in match.items())]


def test_pre_readiness_death_is_reaped(fast_prototype, tmp_path):
    """A fork that dies before its handshake is reported dead, reaped (no
    zombie) and does not latch the plane."""
    mgr = warm_fork.WarmForkManager(str(tmp_path))
    try:
        child = mgr.fork({}, str(tmp_path / "w0.log"), key="w0")
        assert child.wait(timeout=15.0) == 1
        assert not os.path.exists(f"/proc/{child.pid}")
        assert mgr.available
        assert mgr.fork({}, str(tmp_path / "w1.log"),
                        key="w1").wait(timeout=15.0) == 1
        kinds = _warm_events()
        assert len(kinds) == 2 and not any(e.get("degraded") for e in kinds)
    finally:
        mgr.stop()


def test_forked_child_kill_contract(fast_prototype, tmp_path):
    """``ForkedChild`` honours the Popen surface: ``poll()`` is None while
    alive, ``kill()`` lands, the death reads as -SIGKILL."""
    trap = socket.socket()
    trap.bind(("127.0.0.1", 0))
    trap.listen(1)
    mgr = warm_fork.WarmForkManager(str(tmp_path))
    try:
        env = _bootstrap_env("127.0.0.1:%d" % trap.getsockname()[1])
        child = mgr.fork(env, str(tmp_path / "w0.log"), key="w0")
        assert child.poll() is None
        child.kill()
        assert child.wait(timeout=15.0) == -9
    finally:
        mgr.stop()
        trap.close()


def test_pool_fork_crash_fault_kills_fresh_fork(fast_prototype, tmp_path):
    faults.clear()
    faults.inject("pool.fork", "crash", times=1)
    mgr = warm_fork.WarmForkManager(str(tmp_path))
    try:
        child = mgr.fork(_bootstrap_env(), str(tmp_path / "w0.log"),
                         key="victim")
        assert child.wait(timeout=15.0) not in (None, 0)
        assert mgr.available
        assert any(e.get("injected_death") for e in _warm_events())
        c2 = mgr.fork({}, str(tmp_path / "w1.log"), key="w1")
        assert c2.wait(timeout=15.0) == 1
        assert not [e for e in _warm_events(key="w1")
                    if e.get("injected_death")]
    finally:
        faults.clear()
        mgr.stop()


def test_broken_prototype_degrades_loudly(fast_prototype, monkeypatch,
                                          tmp_path):
    """A prototype that cannot start: ``warm_spawn`` returns None, records a
    degraded event and latches the manager."""
    monkeypatch.setattr(warm_fork.sys, "executable", "/bin/false")
    monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "2")
    ref = [None]
    assert warm_fork.warm_spawn(ref, str(tmp_path), {},
                                str(tmp_path / "w0.log"), "w0") is None
    assert ref[0] is not None and not ref[0].available
    assert any(e.get("degraded") and e.get("error") for e in _warm_events())
    assert warm_fork.warm_spawn(ref, str(tmp_path), {},
                                str(tmp_path / "w1.log"), "w1") is None
    ref[0].stop()


def _refreshes() -> int:
    return int(metrics.snapshot()["counters"]
               .get("pool_warm_refreshes_total", {}).get("", 0))


def test_latched_plane_refreshes_and_forks_again(fast_prototype, monkeypatch,
                                                 tmp_path):
    """latch -> refresh -> fork again, bounded by RDT_WARM_FORK_RETRIES."""
    monkeypatch.setenv("RDT_WARM_REFRESH_COOLDOWN_S", "0")
    monkeypatch.setenv("RDT_WARM_FORK_RETRIES", "2")
    monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "2")
    real_exe = warm_fork.sys.executable
    monkeypatch.setattr(warm_fork.sys, "executable", "/bin/false")
    mgr = warm_fork.WarmForkManager(str(tmp_path))
    try:
        with pytest.raises(warm_fork.WarmForkError):
            mgr.fork({}, str(tmp_path / "w0.log"), key="w0")
        assert mgr._failed and mgr.available
        monkeypatch.setattr(warm_fork.sys, "executable", real_exe)
        monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "10")
        assert mgr.fork({}, str(tmp_path / "w1.log"),
                        key="w1").wait(timeout=15.0) == 1
        assert not mgr._failed
        assert _refreshes() == 1
        assert any(e.get("rewarm") and e.get("refresh") == 1
                   for e in _warm_events())
        assert mgr.fork({}, str(tmp_path / "w2.log"),
                        key="w2").wait(timeout=15.0) == 1
    finally:
        mgr.stop()


def test_refresh_budget_exhausts_to_permanent_latch(fast_prototype,
                                                    monkeypatch, tmp_path):
    monkeypatch.setenv("RDT_WARM_REFRESH_COOLDOWN_S", "0")
    monkeypatch.setenv("RDT_WARM_FORK_RETRIES", "1")
    monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "2")
    monkeypatch.setattr(warm_fork.sys, "executable", "/bin/false")
    mgr = warm_fork.WarmForkManager(str(tmp_path))
    try:
        for key in ("w0", "w1"):
            with pytest.raises(warm_fork.WarmForkError):
                mgr.fork({}, str(tmp_path / f"{key}.log"), key=key)
        assert _refreshes() == 1
        assert not mgr.available
        with pytest.raises(warm_fork.WarmForkError):
            mgr.fork({}, str(tmp_path / "w2.log"), key="w2")
        assert _refreshes() == 1
    finally:
        mgr.stop()


def test_fork_raise_fault_degrades_to_cold(fast_prototype, tmp_path):
    faults.clear()
    faults.inject("pool.fork", "raise", times=1)
    ref = [None]
    try:
        assert warm_fork.warm_spawn(ref, str(tmp_path), {},
                                    str(tmp_path / "w.log"), "w0") is None
        assert any(e.get("degraded") for e in _warm_events())
    finally:
        faults.clear()
        if ref[0] is not None:
            ref[0].stop()


# ---- the prototype and CUDA -------------------------------------------------


def test_require_cuda_uninitialized(monkeypatch):
    """The check reads torch's own flag: quiet without torch or with CUDA
    untouched, an error once CUDA is initialised."""
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: False))
    monkeypatch.setitem(sys.modules, "torch", fake)
    warm_fork.require_cuda_uninitialized()
    fake.cuda.is_initialized = lambda: True
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        warm_fork.require_cuda_uninitialized()
    monkeypatch.delitem(sys.modules, "torch")
    warm_fork.require_cuda_uninitialized()


def test_prototype_with_cuda_initialised_refuses_to_fork(
        fast_prototype, monkeypatch, tmp_path):
    """A prototype whose pre-imports initialised CUDA forks nothing: the
    fork fails with the reason, and ``warm_spawn`` degrades loudly to the
    cold path (a degraded event naming CUDA)."""
    (tmp_path / "starts_cuda.py").write_text(
        "import torch\ntorch.cuda.is_initialized = lambda: True\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.getcwd(), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("RDT_WARM_IMPORTS", "torch,starts_cuda")
    monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "60")
    ref = [None]
    try:
        assert warm_fork.warm_spawn(ref, str(tmp_path), _bootstrap_env(),
                                    str(tmp_path / "w0.log"), "w0") is None
        assert any(e.get("degraded") and "CUDA" in str(e.get("error"))
                   for e in _warm_events())
    finally:
        if ref[0] is not None:
            ref[0].stop()
