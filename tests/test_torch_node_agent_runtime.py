"""Node agents under the port's runtime: real multi-node actor placement.

Two agent daemons (``python -m raydp_tpu_torch.runtime.node_agent``) join a
head; node-affinity actors land in the agents' processes; a killed agent
reads as node death and its restartable actors reroute; a slow actor start
on an agent is absorbed by the readiness probe and its reap leaves no
orphan process and no store entry.

The port's twin of the three runtime cases of ``tests/test_node_agent.py``
(``test_torch_node_agent.py`` holds its gang cases), with the same
assertions. Every agent logs to a file of the test's own and is killed in a
``finally`` (its process group).
"""

import os
import signal
import subprocess
import sys
import time

from tests.torch_fixtures import runtime  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Echo:
    def pids(self):
        return {"pid": os.getpid(), "ppid": os.getppid()}

    def get(self, x):
        return x


class SlowStart:
    """Actor whose __init__ stalls — the seeded stand-in for the import
    storm a fresh executor pays on a cold node."""

    def __init__(self, delay_s: float = 3.0):
        time.sleep(delay_s)

    def pid(self) -> int:
        return os.getpid()

    def put_marker(self, owner: str) -> str:
        import pyarrow as pa

        from raydp_tpu_torch.runtime.object_store import get_client
        ref = get_client().put_arrow(pa.table({"a": [1]}), owner=owner)
        return ref.id


def _start_agent(head_url, log_path, cpus=4.0):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
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


def _wait_nodes(rt, n, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        alive = [x for x in rt.resource_manager.nodes() if x.alive]
        if len(alive) >= n:
            return alive
        time.sleep(0.2)
    raise TimeoutError(f"never saw {n} alive nodes")


def test_agents_join_and_affinity_placement(runtime, tmp_path):
    rt = runtime
    a1 = _start_agent(rt.server.url, str(tmp_path / "agent1.log"))
    a2 = _start_agent(rt.server.url, str(tmp_path / "agent2.log"))
    try:
        _wait_nodes(rt, 3)  # driver node + 2 agent nodes
        agent_nodes = sorted(rt.node_agents)
        assert len(agent_nodes) == 2

        # node-affinity: the actor must land in agent #2's process tree
        target = agent_nodes[1]
        h = runtime.create_actor(Echo, name="remote-echo", node_id=target,
                                 resources={"CPU": 1.0})
        info = h.pids()
        agent_pids = {a1.pid, a2.pid}
        assert info["ppid"] in agent_pids, (
            f"actor parent {info['ppid']} is not a node agent {agent_pids}")
        assert info["ppid"] != os.getpid()
        # and specifically the agent serving `target`
        listed = rt.node_agents[target].call("list_pids")
        assert info["pid"] in {int(p) for p in listed}
    finally:
        for p in (a1, a2):
            _kill(p)


def test_agent_death_reroutes_restartable_actor(runtime, tmp_path):
    rt = runtime
    a1 = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        _wait_nodes(rt, 2)
        (agent_node,) = list(rt.node_agents)
        h = runtime.create_actor(Echo, name="nomad", node_id=agent_node,
                                 resources={"CPU": 1.0}, max_restarts=-1)
        first = h.pids()
        assert first["ppid"] == a1.pid

        # node death: kill the agent (its children die with it)
        os.killpg(a1.pid, signal.SIGKILL)

        deadline = time.time() + 60.0
        second = None
        while time.time() < deadline:
            try:
                got = h.pids()
                if got["pid"] != first["pid"]:
                    second = got
                    break
            except Exception:
                pass
            time.sleep(0.5)
        assert second is not None, "actor never revived after agent death"
        # revived on the surviving (driver) node: parent is this process
        assert second["ppid"] == os.getpid()
        assert second["pid"] != first["pid"]
        # the dead agent's node is gone from the alive set
        node = rt.resource_manager.get_node(agent_node)
        assert node is None or not node.alive
        assert agent_node not in rt.node_agents
    finally:
        _kill(a1)


def test_spawn_then_reap_roundtrip_under_slow_warmup(runtime, tmp_path):
    """The scale-up/scale-down round trip through a node agent.
    Spawn-side: a seeded slow actor __init__ (the import-storm model) is
    absorbed by the RDT_EXECUTOR_WAIT_S readiness probe — the actor is
    admitted only once genuinely ready. Reap-side: the kill goes through
    the head to the agent, the agent's ``reap`` RPC harvests the
    process-table entry, and neither an orphan process nor the dead owner's
    store entries survive."""
    from raydp_tpu_torch import knobs
    from raydp_tpu_torch.runtime.object_store import ObjectRef

    rt = runtime
    agent_proc = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
    try:
        _wait_nodes(rt, 2)
        (agent_node,) = list(rt.node_agents)

        warmup = 3.0
        t0 = time.monotonic()
        h = rt.create_actor(SlowStart, (warmup,), name="slow-warmup",
                            node_id=agent_node, resources={"CPU": 1.0},
                            max_restarts=0, block=False)
        h.wait_ready(timeout=float(knobs.get("RDT_EXECUTOR_WAIT_S")))
        assert time.monotonic() - t0 >= warmup, (
            "readiness reported before the warm-up finished")

        pid = h.pid()
        listed = rt.node_agents[agent_node].call("list_pids")
        assert pid in {int(p) for p in listed}
        oid = h.put_marker("slow-warmup")
        assert rt.store_client.contains(ObjectRef(id=oid))

        # reap: deliberate kill through the head (the agent kills the
        # process group), then the agent-side table harvest
        h.kill(no_restart=True)
        agent = rt.node_agents[agent_node]
        code = None
        deadline = time.time() + 30
        while time.time() < deadline:
            code = agent.call("reap", pid)
            if code is not None:
                break
            time.sleep(0.2)
        assert code is not None, "reaped process never exited"
        # no orphan: the process is gone AND its table entry harvested
        assert not os.path.exists(f"/proc/{pid}")
        assert pid not in {int(p) for p in agent.call("list_pids")}
        # the dead owner's store entries are swept by the head
        deadline = time.time() + 30
        while time.time() < deadline \
                and rt.store_client.contains(ObjectRef(id=oid)):
            time.sleep(0.2)
        assert not rt.store_client.contains(ObjectRef(id=oid)), (
            "reap left the dead actor's store entries behind")
    finally:
        _kill(agent_proc)
