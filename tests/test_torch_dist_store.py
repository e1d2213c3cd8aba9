"""Distributed data plane: per-node payload hosting + direct owner fetch.

Parity model: the reference gives every node its own plasma store; readers
fetch blocks from the node that holds them and the scheduler sees locality
(RayDPExecutor.scala:271-287 ``getBlockLocations``, RayDatasetRDD.scala:48-56
preferred locations). Here a node agent in isolated-store mode hosts its
machine's payload plane; these tests prove payload bytes are written on the
owning node, served node→node without transiting the head, purged on node
death, and that the engine schedules ref-reading tasks onto the owner's node.

The port's twin of ``tests/test_dist_store.py``: its cases, data, sizes and
assertions, run against ``raydp_tpu_torch``, whose copies of these planes
they guard against drift.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pytest

from raydp_tpu_torch.runtime.object_store import HEAD_HOST
from tests.torch_fixtures import runtime  # noqa: F401


class Writer:
    def put_table(self, n):
        from raydp_tpu_torch.runtime.object_store import get_client
        t = pa.table({"x": np.arange(n, dtype=np.int64)})
        return get_client().put(t)

    def read_rows(self, ref):
        from raydp_tpu_torch.runtime.object_store import get_client
        return get_client().get(ref).num_rows

    def host_id(self):
        from raydp_tpu_torch.runtime.object_store import get_client
        return get_client().host_id


def _start_agent(head_url, log_path, cpus=4.0, isolated=True,
                 env_extra=None):
    """``python -m raydp_tpu_torch.runtime.node_agent`` in a session of its
    own, logging to ``log_path``; ``isolated`` gives it its own payload
    plane, ``env_extra`` adds to its environment."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    if isolated:
        env["RDT_STORE_ISOLATED"] = "1"
        env["RDT_ARENA_FREE_GRACE_S"] = "0"  # immediate reclamation for asserts
    else:
        env.pop("RDT_STORE_ISOLATED", None)
    env.update(env_extra or {})
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "raydp_tpu_torch.runtime.node_agent",
             "--head", head_url, "--cpus", str(cpus)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)


def _kill(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        try:
            proc.kill()
        except ProcessLookupError:
            pass
    proc.wait(timeout=30)


def _wait_store_host(rt, timeout=30.0):
    """The agent's node id once its payload plane is announced."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if rt.store_hosts:
            return next(iter(rt.store_hosts))
        time.sleep(0.2)
    raise TimeoutError("agent never registered its store host")


def test_payloads_live_on_owner_node_and_transfer_direct(runtime, tmp_path):
    """An actor on an isolated node writes locally; the driver reads the
    payload with ONE hop to the agent — the head's payload RPC counter stays
    flat, and the bytes demonstrably occupy the node's arena."""
    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        node_id = _wait_store_host(rt)
        h = rt.create_actor(Writer, name="w-iso", node_id=node_id,
                            resources={"CPU": 1.0})
        assert h.host_id() == node_id  # data-plane env reached the child

        ref = h.put_table(4096)
        seg, size, kind, offset, host_id, payload_addr = \
            rt.store_server.lookup(ref.id)
        assert host_id == node_id
        assert payload_addr, "isolated writer must record its payload server"

        agent_client = rt.node_agents[node_id]
        stats = agent_client.call("store_arena_stats")
        if stats is not None:  # native arena present on the node
            assert offset >= 0
            assert stats["bytes_in_use"] >= size

        base = rt.store_server.payload_rpc_count
        table = rt.store_client.get(ref)  # driver read: direct node fetch
        assert table.num_rows == 4096
        assert table["x"][4095].as_py() == 4095
        assert rt.store_server.payload_rpc_count == base, \
            "payload transited the head"

        # same-node reader maps it zero-copy (no cross-machine hop at all)
        assert h.read_rows(ref) == 4096

        # free releases the payload ON the owning node
        rt.store_client.free([ref])
        assert not rt.store_client.contains(ref)
        if stats is not None:
            agent_client.call("store_reap")
            after = agent_client.call("store_arena_stats")
            assert after["bytes_in_use"] < stats["bytes_in_use"]
    finally:
        _kill(agent)


def test_head_objects_still_readable_from_isolated_node(runtime, tmp_path):
    """The reverse direction: a driver-written object is fetched by an
    isolated-node actor from the head's plane (the head IS that object's
    owner node — one hop, by design)."""
    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        node_id = _wait_store_host(rt)
        t = pa.table({"x": np.arange(128, dtype=np.int64)})
        ref = rt.store_client.put(t)
        _, _, _, _, host_id, _ = rt.store_server.lookup(ref.id)
        assert host_id == HEAD_HOST
        h = rt.create_actor(Writer, name="r-iso", node_id=node_id,
                            resources={"CPU": 1.0})
        assert h.read_rows(ref) == 128
    finally:
        _kill(agent)


def test_node_death_purges_hosted_objects(runtime, tmp_path):
    """Killing the agent is node death: its payloads are unreachable, so the
    head drops their table entries — readers fail fast into lineage recovery
    instead of timing out against a dead payload server."""
    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        node_id = _wait_store_host(rt)
        h = rt.create_actor(Writer, name="w-dying", node_id=node_id,
                            resources={"CPU": 1.0}, max_restarts=0)
        ref = h.put_table(256)
        assert rt.store_client.contains(ref)

        _kill(agent)
        deadline = time.time() + 60.0
        while time.time() < deadline:
            if not rt.store_client.contains(ref):
                break
            time.sleep(0.5)
        assert not rt.store_client.contains(ref), \
            "dead node's objects still in the table"
    finally:
        _kill(agent)


def test_engine_locality_prefers_owner_node(runtime, tmp_path):
    """Ref-reading tasks schedule onto an executor on the machine holding the
    refs (parity: RayDatasetRDD preferred locations). Compile-level check
    against the real location table — the pool spans two machines."""
    from raydp_tpu_torch.etl import plan as P
    from raydp_tpu_torch.etl.engine import Engine, ExecutorPool

    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        node_id = _wait_store_host(rt)
        w = rt.create_actor(Writer, name="w-loc", node_id=node_id,
                            resources={"CPU": 1.0})
        remote_ref = w.put_table(512)
        local_ref = rt.store_client.put(
            pa.table({"x": np.arange(512, dtype=np.int64)}))

        class _H:  # name-only handle stub; compile never submits tasks
            def __init__(self, name):
                self.name = name

        pool = ExecutorPool(
            [_H("ex-local"), _H("ex-remote")],
            hosts_by_name={"ex-local": HEAD_HOST, "ex-remote": node_id})
        engine = Engine(pool)
        schema = pa.schema([("x", pa.int64())]).serialize().to_pybytes()
        _, preferred = engine._compile(
            P.InMemory([remote_ref, local_ref], schema), temps=[])
        assert preferred == ["ex-remote", "ex-local"]

        # the reverse-conversion path reads through the same locality-routed
        # plan: to_frame emits exactly this InMemory node over the dataset's
        # refs (parity: RayDatasetRDD.getPreferredLocations over block owner
        # addresses, RayDatasetRDD.scala:48-56 — the reference's raw-bytes
        # second branch collapses into the single store here)
        from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset

        ds = DistributedDataset(
            [BlockMeta(num_rows=512, ref=remote_ref),
             BlockMeta(num_rows=512, ref=local_ref)],
            pa.schema([("x", pa.int64())]))

        class _Master:
            def add_objects(self, holder_id, refs):
                self.held = (holder_id, refs)

        class _Session:
            master = _Master()
            master_name = None
            engine = None

        from raydp_tpu_torch.data.dataset import to_frame
        frame = to_frame(ds, session=_Session())
        assert isinstance(frame._plan, P.InMemory)
        assert frame._plan.refs == [remote_ref, local_ref]
        _, preferred2 = engine._compile(frame._plan, temps=[])
        assert preferred2 == ["ex-remote", "ex-local"]
    finally:
        _kill(agent)


def test_to_frame_executor_reads_node_local(runtime, tmp_path):
    """End-to-end reverse-conversion READ path: a
    block written on an isolated node, wrapped by to_frame, is consumed by a
    real ETL executor actor ON that node — and the payload bytes never
    transit the head (the reference's executors likewise read RayDatasetRDD
    partitions from their node's plasma store via the partition's owner
    address, spark/dataset.py:271-291, RayDatasetRDD.scala:48-56)."""
    import cloudpickle

    from raydp_tpu_torch.etl import plan as P
    from raydp_tpu_torch.etl import tasks as T
    from raydp_tpu_torch.etl.engine import Engine, ExecutorPool
    from raydp_tpu_torch.etl.executor import EtlExecutor

    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        node_id = _wait_store_host(rt)
        w = rt.create_actor(Writer, name="w-e2e", node_id=node_id,
                            resources={"CPU": 1.0})
        ref = w.put_table(1024)
        _, _, _, _, host_id, _ = rt.store_server.lookup(ref.id)
        assert host_id == node_id

        ex = rt.create_actor(EtlExecutor, name="ex-e2e", node_id=node_id,
                             resources={"CPU": 1.0})

        # the exact task to_frame's InMemory plan compiles to, scheduled (per
        # engine._locality) onto the owner node's executor

        class _H:
            def __init__(self, name):
                self.name = name

        pool = ExecutorPool([_H("ex-e2e"), _H("ex-head")],
                            hosts_by_name={"ex-e2e": node_id,
                                           "ex-head": HEAD_HOST})
        engine = Engine(pool)
        schema = pa.schema([("x", pa.int64())]).serialize().to_pybytes()
        tasks, preferred = engine._compile(P.InMemory([ref], schema),
                                           temps=[])
        assert preferred == ["ex-e2e"]

        base = rt.store_server.payload_rpc_count
        out = ex.run_task(cloudpickle.dumps(
            tasks[0].with_output(output=T.COLLECT)))
        table = pa.ipc.open_stream(pa.py_buffer(out["ipc"])).read_all()
        assert table.num_rows == 1024
        assert table["x"][1023].as_py() == 1023
        assert rt.store_server.payload_rpc_count == base, \
            "to_frame block read transited the head instead of the node plane"
    finally:
        _kill(agent)


def test_shared_machine_agent_keeps_zero_copy_plane(runtime, tmp_path):
    """An agent WITHOUT isolation (same machine as the head) shares the
    head's plane: actor writes land under the head host id and reads stay
    machine-local — no RPC hops are introduced where shm works."""
    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"),
                         cpus=2.0, isolated=False)
    try:
        deadline = time.time() + 30.0
        while time.time() < deadline and not rt.node_agents:
            time.sleep(0.2)
        node_id = next(iter(rt.node_agents))
        assert node_id not in rt.store_hosts  # shared mode: no own plane
        h = rt.create_actor(Writer, name="w-shared", node_id=node_id,
                            resources={"CPU": 1.0})
        ref = h.put_table(64)
        _, _, _, _, host_id, _ = rt.store_server.lookup(ref.id)
        assert host_id == HEAD_HOST
        assert rt.store_client.get(ref).num_rows == 64
    finally:
        _kill(agent)


def test_node_hosted_spill_under_budget(runtime, tmp_path):
    """Node-hosted payloads past the node's shm budget LRU-spill to the
    NODE's spill dir (head directs, the bytes never leave the machine) and
    fault back in transparently when read — plasma eviction parity for the
    distributed plane, not just the head host."""
    rt = runtime
    agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"),
                         env_extra={
                             "RDT_NODE_ARENA_SIZE": str(2 << 20),  # 2 MiB
                             "RDT_NODE_SHM_BUDGET": str(2 << 20),  # = budget
                         })
    try:
        node_id = _wait_store_host(rt)
        h = rt.create_actor(Writer, name="w-spill", node_id=node_id,
                            resources={"CPU": 1.0})
        # ~50k int64 rows ≈ 0.4 MiB/object; 10 objects = 2× the 2 MiB budget
        refs = [h.put_table(50_000) for _ in range(10)]
        stats = rt.store_server.stats()
        assert stats["spilled_objects"] > 0, "nothing spilled on the node"
        with rt.store_server._lock:
            node_bytes = rt.store_server._host_bytes.get(node_id, 0)
        assert node_bytes <= (2 << 20) + 500_000, node_bytes

        # every object reads back (driver side: direct node fetch after the
        # head faults the payload back onto the node)
        for ref in refs:
            assert rt.store_client.get(ref).num_rows == 50_000
        # and the budget still holds after the reads
        with rt.store_server._lock:
            node_bytes = rt.store_server._host_bytes.get(node_id, 0)
        assert node_bytes <= (2 << 20) + 500_000, node_bytes

        rt.store_client.free(refs)
        after = rt.store_server.stats()
        assert after["spilled_bytes"] == 0
    finally:
        _kill(agent)
