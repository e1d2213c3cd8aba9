"""Node agents under the port's gang: ranks spawned by an agent process
(``raydp_tpu_torch.runtime.node_agent``) that joined the driver's head as a
node of its own — ``tests/test_node_agent.py``'s two gang scenarios with
the same assertions, and the card ids of a rank placed on an agent.

- A rank's bundle ``gpu_ids`` number the cards of the node that holds the
  bundle, so they are read through THAT node's ``CUDA_VISIBLE_DEVICES``: an
  agent started under ``CUDA_VISIBLE_DEVICES=3`` with ``--resource GPU=1``
  hands its rank card 3, whatever the driver sees (the driver here runs
  under ``CUDA_VISIBLE_DEVICES=0,1``). Nothing opens a card: the rank only
  reports its environment, without ``torch.distributed``.
- ``fit_gang`` with one of its two ranks under an agent (SPREAD placement
  over the head's node and the agent's): the reference test's check — the
  gang's train losses equal the port's in-process fit's within its rtol
  2e-4, one rank's parent is the agent and the other's is this process —
  and the port against the reference: started from the Flax init that
  ``FlaxEstimator`` draws (``PRNGKey(0)``, carried across with
  ``mlp_variables_from_flax``), the gang's train losses equal the
  reference's in-process ``FlaxEstimator.fit`` on the same rows in the same
  order within the same 2e-4 (SGD, so no Adam rounding enters).
- A SPREAD job with plain ranks puts one rank on the agent and one here.

Every agent is this file's own, started with its own head and killed in a
``finally`` (its process group, as the reference's test does). The
reference's session runs first and is stopped before the port's starts:
the two runtimes never run at once.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-4            # the reference test's
SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")


def _start_agent(head_url, log_path, cpus=4.0, env=None, resources=()):
    """``python -m raydp_tpu_torch.runtime.node_agent`` in a session of its
    own, as the reference test starts its agent; ``env`` adds to this
    process's environment and ``resources`` are ``--resource`` items."""
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = REPO + os.pathsep + child_env.get(
        "PYTHONPATH", "")
    child_env.update(env or {})
    argv = [sys.executable, "-m", "raydp_tpu_torch.runtime.node_agent",
            "--head", head_url, "--cpus", str(cpus)]
    for item in resources:
        argv += ["--resource", item]
    with open(log_path, "ab") as log:
        return subprocess.Popen(argv, env=child_env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _kill(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        proc.kill()
    proc.wait(timeout=30)


def _wait_nodes(rt, n, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        alive = [x for x in rt.resource_manager.nodes() if x.alive]
        if len(alive) >= n:
            return alive
        time.sleep(0.2)
    raise TimeoutError(f"never saw {n} alive nodes")


# ---------------------------------------------------------------------------
# the card ids of a rank on an agent
# ---------------------------------------------------------------------------

def test_rank_on_an_agent_sees_the_agent_s_card(monkeypatch, tmp_path):
    """The head's node has no card here; the agent holds one, card 3 of its
    machine. A one-rank ``gpus_per_process=1`` job lands on the agent, and
    its rank sees card 3 — not the driver's card 0, which another rank of
    the driver's own node may hold."""
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime
    from raydp_tpu_torch.spmd import create_spmd_job

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    rt = init_runtime()
    agent = None
    try:
        agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"),
                             env={"CUDA_VISIBLE_DEVICES": "3"},
                             resources=["GPU=1"])
        _wait_nodes(rt, 2)
        (agent_node,) = list(rt.node_agents)
        job = create_spmd_job("t-agent-card", world_size=1,
                              gpus_per_process=1, timeout=60)
        job.start()
        try:
            got = job.run(lambda ctx: (os.environ.get("CUDA_VISIBLE_DEVICES"),
                                       os.getppid()), timeout=60)
            group = rt.resource_manager.get_group(job._placement_group_id)
            assert group.bundles[0].node_id == agent_node
            assert group.bundles[0].gpu_ids == [0]
        finally:
            job.stop()
        assert got == [("3", agent.pid)], (got, agent.pid)
    finally:
        if agent is not None:
            _kill(agent)
        shutdown_runtime()


# ---------------------------------------------------------------------------
# tests/test_node_agent.py's gang scenarios
# ---------------------------------------------------------------------------

def _linear_pdf():
    """The reference test's rows."""
    rng = np.random.RandomState(0)
    x = rng.random_sample((1024, 2))
    y = x @ np.array([2.0, -3.0]) + 1.0
    return pd.DataFrame({"x1": x[:, 0], "x2": x[:, 1], "y": y})


def _flax_init():
    """The variables ``FlaxEstimator`` draws for the reference test's MLP."""
    import jax
    import jax.numpy as jnp

    from raydp_tpu.models import MLP as JaxMLP

    model = JaxMLP(features=(8,), use_batch_norm=False)
    return model, jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))


def _reference_history(pdf):
    """The reference's in-process fit of the reference test's estimator on
    the same rows in the same order; its session is stopped after."""
    import optax

    import raydp_tpu
    from raydp_tpu.data.dataset import from_frame
    from raydp_tpu.train import FlaxEstimator

    model, _ = _flax_init()
    s = raydp_tpu.init("pytest-agent-ref", **SESSION)
    try:
        ds = from_frame(s.createDataFrame(pdf, num_partitions=4))
        return FlaxEstimator(
            model=model, optimizer=optax.sgd(5e-2), loss="mse",
            feature_columns=["x1", "x2"], label_column="y", batch_size=64,
            num_epochs=2, shuffle=False).fit(ds).history
    finally:
        raydp_tpu.stop()


def test_fit_gang_trains_through_node_agent(tmp_path):
    """The full multi-node training path: a 2-rank ``TorchEstimator`` gang
    where one rank spawns on a node agent (SPREAD placement) — the remote
    rank joins the process group through the published rendezvous and
    reads its data shard from the store. Losses must match the local run,
    and the reference's."""
    import raydp_tpu_torch
    from raydp_tpu_torch.data.dataset import from_frame
    from raydp_tpu_torch.models import MLP, mlp_variables_from_flax
    from raydp_tpu_torch.runtime import get_runtime
    from raydp_tpu_torch.train import TorchEstimator

    pdf = _linear_pdf()
    reference = _reference_history(pdf)
    _, variables = _flax_init()
    init_state = mlp_variables_from_flax(variables)

    session = raydp_tpu_torch.init("pytest-agent-gang", **SESSION)
    agent = None
    try:
        rt = get_runtime()
        agent = _start_agent(rt.server.url, str(tmp_path / "agent.log"),
                             cpus=4.0)
        _wait_nodes(rt, 2)
        ds = from_frame(session.createDataFrame(pdf, num_partitions=4))

        marker_dir = str(tmp_path / "markers")
        os.makedirs(marker_dir)

        def record_parent(report):
            # runs inside every rank once per epoch: record who spawned us
            path = os.path.join(marker_dir, f"ppid-{os.getpid()}")
            with open(path, "w") as f:
                f.write(str(os.getppid()))

        def make_est(callbacks=None):
            model = MLP(2, (8,), use_batch_norm=False, device="cpu")
            model.load_state_dict(init_state)
            return TorchEstimator(
                model=model,
                optimizer=lambda p: torch.optim.SGD(p, lr=5e-2), loss="mse",
                feature_columns=["x1", "x2"], label_column="y",
                batch_size=64, num_epochs=2, shuffle=False,
                callbacks=callbacks, device="cpu")

        r_local = make_est().fit(ds)
        r_gang = make_est([record_parent]).fit_gang(ds, num_workers=2,
                                                    run_timeout=300.0)

        gang_losses = [h["train_loss"] for h in r_gang.history]
        np.testing.assert_allclose(
            gang_losses, [h["train_loss"] for h in r_local.history],
            rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            gang_losses, [h["train_loss"] for h in reference],
            rtol=LOSS_RTOL, err_msg="the gang against the reference's fit")
        # one rank ran under the agent, one locally (SPREAD over 2 nodes)
        ppids = {int(open(os.path.join(marker_dir, f)).read())
                 for f in os.listdir(marker_dir) if f.startswith("ppid-")}
        assert agent.pid in ppids, (ppids, agent.pid)
        assert os.getpid() in ppids
    finally:
        if agent is not None:
            _kill(agent)
        raydp_tpu_torch.stop()


def test_spmd_ranks_spawn_on_agent_nodes(tmp_path):
    """A gang with SPREAD placement fans its ranks out across node agents —
    one rank process per machine, mpirun-hosts style."""
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime
    from raydp_tpu_torch.spmd import create_spmd_job

    rt = init_runtime()
    a1 = None
    try:
        a1 = _start_agent(rt.server.url, str(tmp_path / "agent.log"))
        _wait_nodes(rt, 2)
        job = create_spmd_job("agent-gang", world_size=2,
                              placement_strategy="SPREAD")
        job.start()
        try:
            ppids = job.run(lambda ctx: os.getppid(), timeout=120)
        finally:
            job.stop()
        assert a1.pid in ppids, (ppids, a1.pid)      # one rank on the agent
        assert os.getpid() in ppids                  # one rank local
    finally:
        if a1 is not None:
            _kill(a1)
        shutdown_runtime()
