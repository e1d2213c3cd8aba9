"""Long-context LM training demo: sequence parallelism over the mesh's seq
axis — the port's copy of ``examples/longcontext_lm.py``.

Trains a small decoder-only transformer over sequences split across a gang
of ``torch.distributed`` ranks, one rank a mesh position: ring attention
rotates K/V blocks between the seq ranks while each rank attends for its
own queries, so a rank's memory stays O(T / seq_ranks). Run with:

    python raydp_tpu_torch/examples/longcontext_lm.py --seq-len 512 \\
        --steps 20 --seq-parallel 2 [--device cpu]

The gang has one rank a card (``nccl``), or, with more mesh positions than
cards, ranks that share the cards (``gloo``); ``--device cpu`` runs the
ranks on the CPU. ``--tensor-parallel`` splits the parameters Megatron
style within each seq rank (each rank rings its own heads).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seq-parallel", type=int, default=0,
                   help="ranks on the seq axis (0 = one a card)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="ranks on the tensor axis (Megatron param split)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the ranks run")
    return p.parse_args(argv)


def rank_main(ctx, args, sizes, init_state=None):
    """One rank: the LM over the mesh, its block of the tokens, AdamW 3e-4
    (optax.adamw's defaults); returns the global losses, the tokens a
    second and the flash launches of the steps."""
    import torch
    import torch.distributed as dist

    from raydp_tpu_torch import resolve_device
    from raydp_tpu_torch.models import (
        TransformerLM, lm_loss, transformer_param_rules,
    )
    from raydp_tpu_torch.ops import flash_attention as fa
    from raydp_tpu_torch.parallel import ShardedModule, make_mesh

    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // ctx.world_size))
    mesh = make_mesh(sizes, device_type=device.type)
    seq_par, tp = sizes["seq"], sizes["tensor"]
    model = TransformerLM(
        vocab_size=args.vocab, dim=args.dim, num_heads=args.heads,
        num_layers=args.layers,
        attention="ring" if seq_par > 1 else "auto", mesh=mesh,
        device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    if init_state is not None:
        model.load_state_dict(init_state)
    rng = np.random.RandomState(0)
    start = rng.randint(0, args.vocab, size=(args.batch, 1))
    tokens = (start + np.arange(args.seq_len)[None]) % args.vocab
    # the rank's block: rows over data, positions over seq
    rows = args.batch // sizes["data"]
    cols = args.seq_len // seq_par
    r, c = mesh.coords["data"], mesh.coords["seq"]
    local = torch.tensor(tokens[r * rows:(r + 1) * rows,
                                c * cols:(c + 1) * cols], device=device)
    sm = ShardedModule(model, mesh,
                       transformer_param_rules("tensor") if tp > 1 else None)
    opt = torch.optim.AdamW(sm.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    losses = []
    fa.FWD_LAUNCHES = fa.DKDV_LAUNCHES = fa.DQ_LAUNCHES = 0
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(sm(local), local, mesh)
        loss.backward()
        sm.reduce_grads()
        opt.step()
        losses.append(loss.item())
    dt = time.perf_counter() - t0
    return {"losses": losses, "seconds": dt,
            "tokens_per_s": args.batch * args.seq_len * args.steps / dt,
            "launches": {"flash_attention_fwd": fa.FWD_LAUNCHES,
                         "flash_attention_bwd_dkdv": fa.DKDV_LAUNCHES,
                         "flash_attention_bwd_dq": fa.DQ_LAUNCHES}}


def main(argv=None, init_state=None) -> dict:
    """Runs the example; returns rank 0's ``{"losses", "tokens_per_s",
    ...}`` with the ``mesh`` sizes and every rank's ``ranks`` entry.
    ``init_state`` (a ``TransformerLM`` state_dict) replaces the seeded
    initial weights."""
    args = parse_args(argv)
    import torch

    from raydp_tpu_torch.parallel import AXES, MeshSpec
    from raydp_tpu_torch.spmd import create_spmd_job

    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    tp = args.tensor_parallel
    n_dev = max(cards, 1)
    if tp < 1 or (args.seq_parallel == 0 and n_dev % tp):
        raise SystemExit(f"--tensor-parallel must be >= 1 and divide the "
                         f"device count ({n_dev})")
    seq_par = args.seq_parallel or n_dev // tp
    world = max(n_dev, seq_par * tp)
    spec = MeshSpec(data=world // (seq_par * tp), seq=seq_par, tensor=tp)
    sizes = spec.sizes(world)
    sizes = {a: sizes[a] for a in AXES}        # the mesh's axis order
    print(f"devices={n_dev} mesh={sizes}")

    job = create_spmd_job("longcontext-lm", world, torch_distributed=True,
                          gpus_per_process=1 if 0 < world <= cards else 0,
                          timeout=180)
    job.start()
    try:
        ranks = job.run(lambda ctx: rank_main(ctx, args, sizes, init_state),
                        timeout=3600)
    finally:
        job.stop()
    out = dict(ranks[0], mesh=sizes, ranks=ranks)
    for i, loss in enumerate(out["losses"]):
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.4f}")
    print(f"{out['tokens_per_s']:.0f} tokens/s over {world} ranks on "
          f"{n_dev} device(s) (seq_parallel={seq_par}, T={args.seq_len})")
    return out


if __name__ == "__main__":
    main()
