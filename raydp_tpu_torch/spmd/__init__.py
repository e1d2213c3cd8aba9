"""Gang-scheduled SPMD jobs — the port of :mod:`raydp_tpu.spmd`, the
reference's MPI pillar.

The reference runs arbitrary MPI programs on its cluster: a gRPC control plane
broadcasts cloudpickled functions to mpirun-launched ranks and gathers results
(reference: python/raydp/mpi/__init__.py:36-91, mpi_job.py:165-338,
mpi_worker.py:144-214). Here the external process gang is a
``torch.distributed`` process group: one process per rank, joined by
``init_process_group`` at rank 0's ``tcp://`` rendezvous (the rendezvous
replaces mpirun's wire-up), with in-program collectives over ``nccl`` (one
card a rank) or ``gloo`` (CPU ranks, or ranks sharing a card).

    job = create_spmd_job("train", world_size=4)
    job.start()
    results = job.run(lambda ctx: ctx.rank * 2)
    job.stop()
"""

from raydp_tpu_torch.spmd.job import SPMDJob, WorkerContext, create_spmd_job

__all__ = ["create_spmd_job", "SPMDJob", "WorkerContext"]
