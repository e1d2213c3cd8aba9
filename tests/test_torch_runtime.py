"""The port's actor runtime and object store (raydp_tpu_torch.runtime): the
scenarios of the reference's test_runtime.py run against the copy, plus what
the copy must add — its actors run the port's code (no ``raydp_tpu`` and no
``jax`` in their ``sys.modules``, cold or warm-forked) and its warm-fork
prototype never initialises CUDA.

The fixtures start the port's runtime; conftest's ``runtime`` fixture starts
the reference's, and the two never run at once.
"""

import os
import time
import uuid

import pyarrow as pa
import pytest

from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime


@pytest.fixture
def rt():
    """A bare port runtime, torn down after the test."""
    runtime = init_runtime()
    yield runtime
    shutdown_runtime()


@pytest.fixture
def rt_3nodes():
    """Three virtual nodes for placement and fault tests."""
    runtime = init_runtime(virtual_nodes=[
        {"CPU": 4.0, "memory": float(2 << 30)},
        {"CPU": 4.0, "memory": float(2 << 30)},
        {"CPU": 4.0, "memory": float(2 << 30), "accel": 1.0},
    ])
    yield runtime
    shutdown_runtime()


class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value

    def whoami(self):
        from raydp_tpu_torch.runtime import current_actor_context
        ctx = current_actor_context()
        return {"name": ctx.name, "restart_count": ctx.restart_count,
                "was_restarted": ctx.was_restarted}

    def crash(self):
        os._exit(17)

    def put_table(self, n):
        from raydp_tpu_torch.runtime.object_store import get_client
        table = pa.table({"x": list(range(n))})
        return get_client().put(table)

    def modules(self):
        """What this process imported of the reference or JAX, and the
        module it was started as (``python -m ...``)."""
        import sys

        from raydp_tpu_torch import knobs
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "raydp_tpu")
                     or m.startswith(("jax.", "raydp_tpu.")))
        main = sys.modules["__main__"]
        return {"bad": bad, "main": (main.__spec__.name, main.__file__),
                "warm_forked": knobs.get("RDT_WARM_FORKED"),
                "torch": "torch" in sys.modules}

    def cuda_initialized(self):
        import torch
        return torch.cuda.is_initialized()


def _wait_dead(handle, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline and handle.state() != "DEAD":
        time.sleep(0.1)
    return handle.state()


def test_method_dispatcher_unknown_method_lists_surface():
    from raydp_tpu_torch.runtime.rpc import MethodDispatcher

    dispatch = MethodDispatcher(Counter())
    assert dispatch("incr", (), {}) == 1
    with pytest.raises(AttributeError) as ei:
        dispatch("inrc", (), {})
    msg = str(ei.value)
    assert "Counter has no remote method 'inrc'" in msg
    assert ("remote surface: crash, cuda_initialized, get, incr, modules, "
            "put_table, whoami") in msg
    with pytest.raises(AttributeError) as ei:
        dispatch("_private", (), {})
    assert "not remotely callable" in str(ei.value)
    assert "remote surface" not in str(ei.value)


def test_object_store_roundtrip(rt):
    client = rt.store_client
    ref = client.put({"a": 1, "b": [1, 2, 3]})
    assert client.get(ref) == {"a": 1, "b": [1, 2, 3]}

    table = pa.table({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    tref = client.put(table)
    assert tref.kind == "arrow"
    assert client.get(tref).equals(table)

    assert client.contains(tref)
    client.free([ref, tref])
    assert not client.contains(tref)


def test_actor_basic_call_and_named_lookup(rt):
    h = rt.create_actor(Counter, (5,), name="counter")
    assert h.call("get") == 5
    assert h.incr(3) == 8
    info = h.whoami()
    assert info["name"] == "counter"
    assert info["restart_count"] == 0
    h2 = rt.get_actor("counter")
    assert h2 is not None
    assert h2.get() == 8


def test_actor_submit_future(rt):
    h = rt.create_actor(Counter, name="fut-counter")
    futs = [h.submit("incr", 1) for _ in range(10)]
    assert sorted(f.result(timeout=30) for f in futs) == list(range(1, 11))


def test_actor_restart_on_crash(rt):
    h = rt.create_actor(Counter, (1,), name="phoenix", max_restarts=-1)
    assert h.get() == 1
    with pytest.raises(Exception):
        h.call("crash")
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            if h.get() == 1:
                break
        except Exception:
            time.sleep(0.2)
    info = h.whoami()
    assert info["was_restarted"] is True
    assert info["restart_count"] >= 1


def test_actor_deliberate_kill_no_restart(rt):
    h = rt.create_actor(Counter, name="victim", max_restarts=-1)
    assert h.get() == 0
    h.kill(no_restart=True)
    assert _wait_dead(h) == "DEAD"
    assert rt.get_actor("victim") is None


def test_actor_object_ownership_sweep(rt):
    h = rt.create_actor(Counter, name="owner-actor")
    ref = h.put_table(100)
    client = rt.store_client
    assert client.get(ref).num_rows == 100
    # transfer to the driver, then kill the actor: only ref2 survives
    ref2 = h.put_table(50)
    client.transfer_ownership([ref2], "__driver__")
    h.kill(no_restart=True)
    assert _wait_dead(h) == "DEAD"
    time.sleep(0.3)
    assert not client.contains(ref)
    assert client.get(ref2).num_rows == 50


def test_fractional_cpu_resources(rt):
    h1 = rt.create_actor(Counter, name="frac1", resources={"CPU": 0.5})
    h2 = rt.create_actor(Counter, name="frac2", resources={"CPU": 0.5})
    assert h1.get() == 0 and h2.get() == 0


def test_placement_group_strategies(rt_3nodes):
    rm = rt_3nodes.resource_manager
    spread = rm.create_group([{"CPU": 1.0}] * 3, "STRICT_SPREAD")
    assert len({b.node_id for b in spread.bundles}) == 3
    pack = rm.create_group([{"CPU": 1.0}] * 2, "STRICT_PACK")
    assert len({b.node_id for b in pack.bundles}) == 1
    with pytest.raises(ValueError):
        rm.create_group([{"CPU": 1.0}] * 4, "STRICT_SPREAD")  # only 3 nodes
    rm.remove_group(spread.group_id)
    rm.remove_group(pack.group_id)
    assert rm.groups() == []
    for n in rm.nodes():
        assert n.available["CPU"] == n.resources["CPU"]


def test_placement_group_tpu_host_granular(rt_3nodes):
    """Copied unchanged: a fractional ``TPU`` bundle is refused."""
    with pytest.raises(ValueError):
        rt_3nodes.resource_manager.create_group([{"TPU": 0.5}], "PACK")


def test_node_affinity(rt_3nodes):
    h = rt_3nodes.create_actor(Counter, name="affine",
                               resources={"accel": 1.0})
    rec = rt_3nodes.record(h.actor_id)
    node = rt_3nodes.resource_manager.get_node(rec.node_id)
    assert node.resources.get("accel") == 1.0


def test_remove_node_respawns_actor(rt_3nodes):
    h = rt_3nodes.create_actor(Counter, (9,), name="migrant",
                               max_restarts=-1, resources={"CPU": 1.0})
    first_node = rt_3nodes.record(h.actor_id).node_id
    rt_3nodes.remove_node(first_node)
    deadline = time.time() + 30
    ok = False
    while time.time() < deadline:
        try:
            if h.get() == 9:
                ok = True
                break
        except Exception:
            time.sleep(0.2)
    assert ok, "actor did not come back after node removal"
    assert rt_3nodes.record(h.actor_id).node_id != first_node


def test_cluster_resources_satisfy(rt_3nodes):
    from raydp_tpu_torch.runtime import ClusterResources

    cr = ClusterResources(rt_3nodes)
    cr.refresh_interval = 0.0
    assert cr.total_alive_nodes() == 3
    assert len(cr.satisfy({"num_cpus": 4})) == 3
    assert cr.satisfy({"CPU": 5}) == []
    assert len(cr.satisfy({"accel": 1.0})) == 1
    assert rt_3nodes.resource_manager.allocate({"CPU": 3.0}) is not None
    assert len(cr.satisfy({"num_cpus": 4})) == 2
    assert all(lbl.startswith("node:") for lbl in cr.satisfy({"CPU": 1}))


def test_driver_heartbeat_reap_sweeps_actors_and_objects(rt):
    from raydp_tpu_torch.runtime.actor import ActorSpec, dump_spec

    rt.driver_reap_after_s = 3600.0
    rt.register_driver("hb-driver")
    assert rt.driver_heartbeat("hb-driver") is True
    cls_bytes, args_bytes = dump_spec(Counter, (3,), {})
    spec = ActorSpec(actor_id=f"actor-{uuid.uuid4().hex[:12]}",
                     name="hb-actor", cls_bytes=cls_bytes,
                     args_bytes=args_bytes, resources={"CPU": 1.0},
                     max_restarts=-1)
    h = rt.launch_actor(spec, block=True, driver_id="hb-driver")
    ref = h.put_table(25)
    assert rt.store_client.contains(ref)

    assert rt.driver_heartbeat("hb-driver") is True  # the last beat
    rt.driver_reap_after_s = 1.0
    assert _wait_dead(h, 30.0) == "DEAD", "reap never killed the actor"
    deadline = time.time() + 10
    while time.time() < deadline and rt.store_client.contains(ref):
        time.sleep(0.1)
    assert not rt.store_client.contains(ref)
    assert rt.driver_heartbeat("hb-driver") is False

    rt.driver_reap_after_s = 3600.0
    rt.register_driver("hb-driver")
    assert rt.driver_heartbeat("hb-driver") is True
    spec2 = ActorSpec(actor_id=f"actor-{uuid.uuid4().hex[:12]}",
                      name="hb-actor-2", cls_bytes=cls_bytes,
                      args_bytes=args_bytes, resources={"CPU": 1.0})
    h2 = rt.launch_actor(spec2, block=True, driver_id="hb-driver")
    assert h2.call("get") == 3
    rt.detach_driver("hb-driver")


class SlowInit:
    """An actor whose ``__init__`` stalls, so it reports ready late."""
    SLEEP_S = 4.0

    def __init__(self):
        time.sleep(self.SLEEP_S)

    def ok(self):
        return True


def test_ready_waiters_do_not_starve_dispatcher(rt):
    """20 concurrent ``wait_actor_ready`` calls on a slow-starting actor do
    not park the head's 16-thread RPC pool: a store lookup issued while they
    wait returns at once, and the waiters complete when the actor is up."""
    from raydp_tpu_torch.runtime.rpc import RpcClient

    h = rt.create_actor(SlowInit, name="slowpoke", block=False)
    clients = [RpcClient(rt.server.address) for _ in range(4)]
    try:
        futs = [clients[i % 4].submit("wait_actor_ready", h.actor_id, 60.0)
                for i in range(20)]
        time.sleep(0.5)
        assert not any(f.done() for f in futs)
        t0 = time.monotonic()
        assert isinstance(clients[0].call("store_stats", timeout=5.0), dict)
        assert time.monotonic() - t0 < 2.0
        for f in futs:
            assert f.result(timeout=60.0) is True
        assert h.ok()
    finally:
        for c in clients:
            c.close()


# ---- what the copy adds -----------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_forked"])
def test_port_actor_runs_the_port_and_no_jax(rt, monkeypatch, warm):
    """A port actor, spawned cold or forked from the warm prototype (which
    pre-imports torch by default), bootstraps through the port's own
    ``actor_main`` and has neither ``raydp_tpu`` nor ``jax`` in its
    ``sys.modules``; the prototype left CUDA uninitialised."""
    if warm:
        monkeypatch.setenv("RDT_WARM_FORK", "1")
        monkeypatch.delenv("RDT_WARM_IMPORTS", raising=False)
        # the prototype imports torch: give a loaded machine time for it
        monkeypatch.setenv("RDT_WARM_FORK_WAIT_S", "120")
    h = rt.create_actor(Counter, name=f"port-{'warm' if warm else 'cold'}")
    info = h.modules()
    assert info["bad"] == []
    # a cold actor is `python -m ...actor_main`; a warm one is forked from
    # the prototype, `python -m ...warm_fork`
    module = "warm_fork" if warm else "actor_main"
    assert info["main"][0] == f"raydp_tpu_torch.runtime.{module}"
    assert info["main"][1].endswith(
        os.path.join("raydp_tpu_torch", "runtime", f"{module}.py"))
    assert info["warm_forked"] is warm
    if warm:
        assert info["torch"], "the prototype did not pre-import torch"
        assert h.cuda_initialized() is False
    assert rt.store_client.get(h.put_table(3)).num_rows == 3


def test_session_dir_is_the_ports_own(rt):
    """Sessions live under the temp dir's ``raydp_tpu_torch``, never under
    the reference's ``/tmp/raydp_tpu``; the arena segment is this
    session's."""
    import tempfile

    assert rt.session_dir.startswith(
        os.path.join(tempfile.gettempdir(), "raydp_tpu_torch") + os.sep)
    info = rt.store_server.arena_info()
    if info is not None:
        assert info["segment"] == f"rdt{rt.session_id[:8]}_arena"


def test_shutdown_leaves_no_segment_of_the_session():
    """After shutdown no shared-memory segment of the session remains (the
    arena and the per-object segments are all named ``rdt<session>``)."""
    runtime = init_runtime()
    try:
        h = runtime.create_actor(Counter, name="seg-writer")
        refs = [h.put_table(1000) for _ in range(3)]
        assert all(runtime.store_client.contains(r) for r in refs)
        prefix = f"rdt{runtime.session_id[:8]}"
        assert any(f.startswith(prefix) for f in os.listdir("/dev/shm"))
    finally:
        shutdown_runtime()
    assert not [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
