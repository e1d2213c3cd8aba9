"""Gang-SPMD job example — the port's copy of ``examples/spmd_job.py``, the
MPI-pillar analogue (reference doc/mpi.md, mpi/mpi_job.py): gang-start N
rank processes under one ``torch.distributed`` process group, broadcast
functions, gather world-size results, and read ETL output from the object
store inside the ranks.

    python raydp_tpu_torch/examples/spmd_job.py [--world-size 2]

The ranks run on the CPU under gloo, so it works anywhere; ranks that each
hold a card of their own (``gpus_per_process=1``) run under NCCL.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def global_mean_step(ctx):
    """Each rank contributes its own value; one all_reduce averages them
    across the gang (the reference's jitted mean over the global mesh)."""
    import torch
    import torch.distributed as dist

    x = torch.tensor([float(ctx.rank + 1)])
    dist.all_reduce(x)
    return {"rank": ctx.rank, "world_size": dist.get_world_size(),
            "global_mean": float(x) / dist.get_world_size()}


def count_rows(payload):
    """A closure over a portable dataset handle: every rank re-opens the
    dataset from the object store (parity: each MPI rank joins Ray and reads
    the data plane, mpi_worker.py:159-160)."""

    def _fn(ctx):
        from raydp_tpu_torch.data.dataset import DistributedDataset

        ds = DistributedDataset.from_portable(payload)
        # each rank counts a round-robin share of the blocks
        mine = [i for i in range(ds.num_blocks())
                if i % ctx.world_size == ctx.rank]
        return sum(ds.get_block(i).num_rows for i in mine)

    return _fn


def main(argv=None) -> dict:
    """Runs the example; returns ``{"means", "counts", "rows"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--rows", type=int, default=20_000)
    args = ap.parse_args(argv)

    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame
    from raydp_tpu_torch.examples.generate_nyctaxi import generate
    from raydp_tpu_torch.spmd import create_spmd_job

    session = raydp_tpu_torch.init("spmd-example", num_executors=2,
                                   executor_cores=1, executor_memory="512MB")
    try:
        csv = os.path.join(tempfile.mkdtemp(prefix="rdt-spmd-"), "taxi.csv")
        generate(args.rows).to_csv(csv, index=False)
        df = session.read.csv(csv, num_partitions=4)
        payload = from_frame(df).portable()

        job = create_spmd_job("example", args.world_size,
                              torch_distributed=True)
        job.start()
        try:
            results = job.run(global_mean_step, timeout=300)
            for r in results:
                print(f"rank {r['rank']}: world {r['world_size']}, "
                      f"mean={r['global_mean']}")
            counts = job.run(count_rows(payload), timeout=300)
            print(f"rows counted across the gang: {sum(counts)} "
                  f"(per-rank {counts})")
            rows = df.count()
            if sum(counts) != rows:
                raise RuntimeError(f"the gang counted {sum(counts)} rows of "
                                   f"{rows}")
        finally:
            job.stop()
    finally:
        raydp_tpu_torch.stop()
    return {"means": [r["global_mean"] for r in results], "counts": counts,
            "rows": rows}


if __name__ == "__main__":
    main()
