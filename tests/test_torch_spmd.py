"""The port's gang-SPMD job runner (``raydp_tpu_torch.spmd``) — eight of
``tests/test_spmd.py``'s nine scenarios with the same assertions: start/run/
stop and restart of one job object, env propagation, rank addressing, a
failing rank, placement-group accounting, ranks reading the object store,
stop's SIGKILL escalation, and the process group: the reference's
``jax_distributed`` psum across two ranks becomes a ``torch_distributed``
gloo ``all_reduce`` (``[3.0, 3.0]`` on both ranks). The ring-attention case
is in ``tests/test_torch_seq_sharded.py``.

The ``rt`` fixture starts the port's runtime; conftest's ``runtime``
fixture starts the reference's, and the two never run at once. Then the
``GPU`` placement rule, the backend rule, the cards a rank sees, and the
port's ``examples/spmd_job.py``.
"""

import os

import numpy as np
import pytest

from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime
from raydp_tpu_torch.spmd import create_spmd_job
from raydp_tpu_torch.spmd.job import gang_backend


@pytest.fixture
def rt():
    """A bare port runtime, torn down after the test."""
    runtime = init_runtime()
    yield runtime
    shutdown_runtime()


def test_start_run_stop_restart():
    job = create_spmd_job("t-basic", world_size=3, timeout=60)
    job.start()
    try:
        results = job.run(lambda ctx: ctx.rank * 10)
        assert results == [0, 10, 20]
        # in-order sequencing: a second broadcast works
        results = job.run(lambda ctx: ctx.world_size)
        assert results == [3, 3, 3]
    finally:
        job.stop()
    # the same object restarts cleanly (parity: test_mpi.py restart case)
    job.start()
    try:
        assert job.run(lambda ctx: ctx.job_id) == ["t-basic"] * 3
    finally:
        job.stop()


def test_env_propagation():
    job = create_spmd_job("t-env", world_size=2,
                          env={"RDT_TEST_MARKER": "hello"}, timeout=60)
    job.start()
    try:
        # rdtlint: allow[knob-registry] probes extra_env propagation, not a knob
        got = job.run(lambda ctx: os.environ.get("RDT_TEST_MARKER"))
        assert got == ["hello", "hello"]
    finally:
        job.stop()


def test_rank_addresses():
    job = create_spmd_job("t-addr", world_size=2, timeout=60)
    job.start()
    try:
        addrs = job.rank_addresses()
        assert set(addrs) == {0, 1}
        assert all(len(a) == 2 for a in addrs.values())
    finally:
        job.stop()


def test_failure_surfaces_rank_and_traceback():
    job = create_spmd_job("t-fail", world_size=2, timeout=60)
    job.start()
    try:
        def boom(ctx):
            if ctx.rank == 1:
                raise ValueError("rank 1 exploded")
            return "ok"

        with pytest.raises(RuntimeError, match="rank 1"):
            job.run(boom)
        # the gang survives a function failure and keeps sequencing
        assert job.run(lambda ctx: ctx.rank) == [0, 1]
    finally:
        job.stop()


def test_placement_group_accounting(rt):
    job = create_spmd_job("t-pg", world_size=2, cpus_per_process=1.0,
                          timeout=60)
    job.start()
    try:
        assert job._placement_group_id is not None
        assert rt.resource_manager.get_group(job._placement_group_id) \
            is not None
    finally:
        job.stop()
    # pg removed on stop (parity: pg-leak check, test_spark_cluster.py:219-259)
    assert rt.resource_manager.get_group("t-pg") is None


def test_ranks_share_object_store(rt):
    """Ranks inherit the head env and can exchange data through the store —
    parity with every MPI rank joining Ray (mpi_worker.py:159-160)."""
    import pyarrow as pa

    table = pa.table({"x": np.arange(64, dtype=np.int64)})
    ref = rt.store_client.put(table)

    job = create_spmd_job("t-store", world_size=2, timeout=60)
    job.start()
    try:
        def read_sum(ctx, ref=ref):
            from raydp_tpu_torch.runtime.object_store import get_client
            t = get_client().get(ref)
            return int(np.asarray(t["x"]).sum())

        assert job.run(read_sum) == [2016, 2016]
    finally:
        job.stop()


def test_stop_escalation_sigkills_straggler_and_job_restarts():
    """Gang teardown robustness (parity: the reference's test_mpi restart
    case, mpi_job.py:344-395): (1) a rank SIGKILLed mid-life must not wedge
    ``stop()`` or the next ``start()``; (2) a rank that ignores the stop RPC
    (simulated with SIGSTOP) is SIGKILLed by the 5s escalation poll; (3) the
    same job object runs a full start→run→stop cycle after each."""
    import signal
    import time

    job = create_spmd_job("t-killrank", world_size=2, timeout=60)

    # cycle 1: kill a rank outright, then stop + restart
    job.start()
    try:
        assert job.run(lambda ctx: ctx.rank) == [0, 1]
        victim = job._procs[0]
        os.killpg(victim.pid, signal.SIGKILL)
        deadline = time.time() + 10
        while victim.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert victim.poll() is not None
    finally:
        job.stop()

    # cycle 2: restart works after rank death; then wedge a rank so the stop
    # RPC is never processed — the escalation must SIGKILL it within ~5s
    job.start()
    try:
        assert job.run(lambda ctx: ctx.rank * 2) == [0, 2]
        straggler = job._procs[1]
        os.kill(straggler.pid, signal.SIGSTOP)
    finally:
        t0 = time.time()
        job.stop()
        elapsed = time.time() - t0
    assert elapsed < 30, f"stop() took {elapsed:.1f}s against a straggler"
    deadline = time.time() + 10
    while straggler.poll() is None and time.time() < deadline:
        time.sleep(0.05)
    assert straggler.poll() is not None, "straggler survived stop()"

    # cycle 3: the object still restarts cleanly after the escalated stop
    job.start()
    try:
        assert job.run(lambda ctx: ctx.job_id) == ["t-killrank"] * 2
    finally:
        job.stop()


def test_torch_distributed_gang():
    """world=2 ranks form one torch.distributed process group (gloo: the
    ranks run on the CPU); an all_reduce returns the world sum on every
    rank — the torch replacement for the reference's psum over the global
    mesh."""
    job = create_spmd_job("t-torchdist", world_size=2,
                          torch_distributed=True, timeout=180)
    job.start()
    try:
        def allreduce(ctx):
            import torch
            import torch.distributed as dist

            assert dist.get_world_size() == ctx.world_size
            assert dist.get_rank() == ctx.rank
            x = torch.full((2,), float(ctx.rank + 1))
            dist.all_reduce(x)
            return x.tolist(), dist.get_backend()

        assert job.run(allreduce, timeout=180) == [([3.0, 3.0], "gloo")] * 2
        assert job.backend == "gloo"
    finally:
        job.stop()


# ---------------------------------------------------------------------------
# the port's additions: the backend rule, GPU bundles and a rank's cards
# ---------------------------------------------------------------------------

def test_backend_rule():
    """nccl only when each rank holds a card of its own; gloo for CPU ranks
    and ranks sharing a node's cards (NCCL refuses two ranks on one card)."""
    assert gang_backend(1) == "nccl"
    assert gang_backend(0) == "gloo"
    assert create_spmd_job("t-rule", 2, torch_distributed=True,
                           gpus_per_process=1).backend == "nccl"
    assert create_spmd_job("t-rule", 2, torch_distributed=True).backend \
        == "gloo"
    assert create_spmd_job("t-rule", 2).backend is None
    with pytest.raises(ValueError, match="whole CUDA cards"):
        create_spmd_job("t-rule", 2, gpus_per_process=0.5)


def test_gpu_bundles_hold_whole_cards_and_give_them_back():
    """A node's ``GPU`` counts its cards; bundles take distinct card ids,
    fractional ones are refused as fractional TPU bundles are, and removing
    the group frees its cards."""
    from raydp_tpu_torch.runtime.placement import (
        PlacementStrategy, ResourceManager,
    )

    rm = ResourceManager()
    node = rm.add_node("127.0.0.1", {"CPU": 8.0, "GPU": 2.0})
    with pytest.raises(ValueError, match="fractional GPU"):
        rm.create_group([{"CPU": 1.0, "GPU": 0.5}], PlacementStrategy.PACK)
    group = rm.create_group([{"CPU": 1.0, "GPU": 1.0}] * 2,
                            PlacementStrategy.PACK)
    assert sorted(b.gpu_ids[0] for b in group.bundles) == [0, 1]
    with pytest.raises(ValueError):
        rm.create_group([{"CPU": 1.0, "GPU": 1.0}], PlacementStrategy.PACK)
    rm.remove_group(group.group_id)
    again = rm.create_group([{"CPU": 1.0, "GPU": 2.0}],
                            PlacementStrategy.PACK)
    assert again.bundles[0].gpu_ids == [0, 1]
    assert again.bundles[0].node_id == node


def test_rank_sees_its_bundle_card(monkeypatch):
    """With ``gpus_per_process=1`` each rank's ``CUDA_VISIBLE_DEVICES`` is
    its bundle's card, read through the driver's own list. (Nothing here
    opens a card: the ranks only report their environment.)"""
    runtime = init_runtime(virtual_nodes=[{"CPU": 4.0, "GPU": 2.0,
                                           "memory": float(2 << 30)}])
    try:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
        job = create_spmd_job("t-cards", world_size=2, gpus_per_process=1,
                              timeout=60)
        job.start()
        try:
            got = job.run(lambda ctx: os.environ["CUDA_VISIBLE_DEVICES"])
            group = runtime.resource_manager.get_group(
                job._placement_group_id)
            assert group.bundles[0].resources["GPU"] == 1.0
        finally:
            job.stop()
        assert sorted(got) == ["5", "7"]
    finally:
        shutdown_runtime()


def test_four_ranks_on_a_four_card_node_take_four_cards(monkeypatch):
    """A node that declares 4 ``GPU``: a 4-rank ``gpus_per_process=1`` gang
    is an nccl gang (the backend rule), and its ranks see four distinct
    cards, each one of the driver's own list. (Nothing here opens a card:
    the ranks only report their environment.)"""
    runtime = init_runtime(virtual_nodes=[{"CPU": 8.0, "GPU": 4.0,
                                           "memory": float(2 << 30)}])
    try:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1,6,2")
        assert create_spmd_job("t-four", 4, torch_distributed=True,
                               gpus_per_process=1).backend \
            == gang_backend(1) == "nccl"
        job = create_spmd_job("t-four", world_size=4, gpus_per_process=1,
                              timeout=60)
        job.start()
        try:
            got = job.run(lambda ctx: os.environ["CUDA_VISIBLE_DEVICES"])
            group = runtime.resource_manager.get_group(
                job._placement_group_id)
            assert sorted(b.gpu_ids[0] for b in group.bundles) \
                == [0, 1, 2, 3]
        finally:
            job.stop()
        assert sorted(got) == ["1", "2", "3", "6"]
    finally:
        shutdown_runtime()


def test_spmd_job_example_means_and_counts_every_row():
    """``examples/spmd_job.py``: two gloo ranks average their values with
    one all_reduce and count the rows of an ETL frame from the store."""
    from raydp_tpu_torch.examples import spmd_job

    out = spmd_job.main(["--world-size", "2", "--rows", "2000"])
    assert out["means"] == [1.5, 1.5]
    assert sum(out["counts"]) == out["rows"] > 0
