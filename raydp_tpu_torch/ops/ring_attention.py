"""Ring attention: exact attention over sequence-sharded inputs — the port
of :mod:`raydp_tpu.ops.ring_attention`.

The sequence is split over the mesh's ``seq`` axis, one block a rank: each
rank passes its local ``[B, T/n, H, D]`` slice of q, k and v (the
reference's per-device shape under ``shard_map``; with one process a
device, this is how a rank already holds its shard). K and V rotate around
the ring with the neighbour exchange
(:func:`~raydp_tpu_torch.parallel.shard.exchange`, ``lax.ppermute``) while
each rank folds every passing block into its queries' attention, so the
whole ``[T, T]`` score matrix never exists and memory stays O(T/n).

One ``torch.autograd.Function`` runs the whole ring:

- the forward folds each block with the flash forward
  (:func:`raydp_tpu_torch.ops.flash_attention._fwd`: the Hopper kernel on
  CUDA, its plain version on the CPU; causal on the diagonal block, full on
  a past one) and merges the block's ``(out, lse)`` into the running pair
  by log-sum-exp in float32. Under ``causal`` a block from a later rank is
  skipped — the exchange still runs, as the reference's ``lax.cond`` skips
  only the update;
- the backward is a second ring: dq stays home while K, V and the float32
  dk/dv accumulators travel together, each block's gradients computed by
  the two flash backward kernels against the rank's *global* ``out`` and
  ``lse``; after ``n`` hops dk/dv are back with their owner.

``chunk_size`` keeps the reference's meaning, the live score block
``[B, H, T/n, chunk]``: the CPU block forward folds ``chunk_size`` keys at a
time, the ragged tail padded and masked, as ``_folded_block_update`` does
(and the plain backward walks keys in blocks of it). The CUDA kernels'
tiles bound their memory by themselves, so there the argument only
validates. A world of 1 is exactly :func:`flash_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch

from raydp_tpu_torch.ops import flash_attention as fa


def _fold_plain(q3, k3, v3, scale: float, causal: bool, chunk: int):
    """Plain block forward, ``chunk`` keys at a time: q3 [BH, Tq, D] against
    k3/v3 [BH, Tk, D] → (out [BH, Tq, D], lse [BH, Tq] f32). The key dim is
    zero-padded to a chunk multiple and the pad keys masked, so the live
    score block is [BH, Tq, chunk] whatever Tk is."""
    bh, tq, d = q3.shape
    tk = k3.shape[1]
    n = -(-tk // chunk)
    pad = n * chunk - tk
    if pad:
        k3 = torch.nn.functional.pad(k3, (0, 0, 0, pad))
        v3 = torch.nn.functional.pad(v3, (0, 0, 0, pad))
    qf = q3.float()
    q_pos = torch.arange(tq, device=q3.device)
    m = torch.full((bh, tq), float("-inf"), device=q3.device)
    l = torch.zeros((bh, tq), device=q3.device)
    acc = torch.zeros((bh, tq, d), device=q3.device)
    for i in range(n):
        keys = slice(i * chunk, (i + 1) * chunk)
        s = torch.einsum("bqd,bkd->bqk", qf, k3[:, keys].float()) * scale
        offsets = torch.arange(i * chunk, (i + 1) * chunk, device=q3.device)
        valid = (offsets < tk)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= offsets[None, :])
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # a row whose keys are all masked so far keeps exp() finite
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - safe[..., None])
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqk,bkd->bqd", p, v3[:, keys].float())
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.to(q3.dtype), m + torch.log(l)


def _fold(q3, k3, v3, scale: float, causal: bool, chunk: Optional[int]):
    """One K/V block's (out, lse): the flash forward, or on the CPU the
    chunked fold when ``chunk`` is shorter than the block."""
    if q3.device.type == "cpu" and chunk is not None and chunk < k3.shape[1]:
        return _fold_plain(q3, k3, v3, scale, causal, chunk)
    return fa._fwd(q3, k3, v3, scale, causal)


def _merge(out, lse, blk_out, blk_lse):
    """Merge a block's (out, lse) into the running float32 pair."""
    if out is None:
        return blk_out.float(), blk_lse
    new = torch.logaddexp(lse, blk_lse)
    out = out * torch.exp(lse - new)[..., None] \
        + blk_out.float() * torch.exp(blk_lse - new)[..., None]
    return out, new


class _Ring(torch.autograd.Function):
    """The ring over [BH, T/n, D] blocks (see the module docstring)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, axis, mesh, scale, causal, chunk):
        from raydp_tpu_torch.parallel.mesh import axis_index
        from raydp_tpu_torch.parallel.shard import exchange

        n, me = mesh.shape[axis], axis_index(mesh, axis)
        kv = torch.stack([k3, v3])
        out = lse = None
        for step in range(n):
            src = (me - step) % n
            if not (causal and src > me):
                out, lse = _merge(out, lse, *_fold(
                    q3, kv[0], kv[1], scale, causal and src == me, chunk))
            if step < n - 1:
                kv = exchange([kv], axis, mesh)[0]
        out = out.to(q3.dtype)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.axis, ctx.mesh, ctx.scale, ctx.causal, ctx.chunk = \
            axis, mesh, scale, causal, chunk
        return out

    @staticmethod
    def backward(ctx, g):
        from raydp_tpu_torch.parallel.mesh import axis_index
        from raydp_tpu_torch.parallel.shard import exchange

        q3, k3, v3, out, lse = ctx.saved_tensors
        axis, mesh = ctx.axis, ctx.mesh
        n, me = mesh.shape[axis], axis_index(mesh, axis)
        do = g.contiguous()
        blk = ctx.chunk or fa.DEFAULT_BLOCK_K
        dq = torch.zeros_like(q3, dtype=torch.float32)
        kv = torch.stack([k3, v3])
        dkv = torch.zeros_like(kv, dtype=torch.float32)
        for step in range(n):
            src = (me - step) % n
            if not (ctx.causal and src > me):
                dq_b, dk_b, dv_b = fa._bwd(
                    q3, kv[0], kv[1], out, lse, do, ctx.scale,
                    ctx.causal and src == me, blk)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            # dk/dv travel with their block; the n-th hop takes them home
            if step < n - 1:
                kv, dkv = exchange([kv, dkv], axis, mesh)
            else:
                dkv = exchange([dkv], axis, mesh)[0]
        return (dq.to(q3.dtype), dkv[0].to(k3.dtype), dkv[1].to(v3.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, mesh, axis_name: str = "seq",
                   causal: bool = True, scale: Optional[float] = None,
                   chunk_size: Optional[int] = 2048):
    """Exact attention over q/k/v whose sequence dim is split over
    ``axis_name`` of ``mesh``; every rank of the axis calls it with its
    local slice. Shapes per rank: q, k, v = [B, T_local, H, D] → [B,
    T_local, H, D]; rank ``i`` holds global positions ``[i·T_local,
    (i+1)·T_local)``. ``chunk_size`` caps the CPU fold's live score block
    at [B, H, T_local, chunk_size] (None = each block in one piece)."""
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1 or None, got {chunk_size}")
    b, t, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if mesh.shape[axis_name] == 1:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)

    def to3(x):
        # at B = 1 the reshape is a strided view; the kernels read rows
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    out3 = _Ring.apply(to3(q), to3(k), to3(v), axis_name, mesh, scale,
                       causal, chunk_size)
    return out3.reshape(b, h, t, d).transpose(1, 2)


def ring_attention_sharded(q, k, v, mesh, causal: bool = True,
                           seq_axis: str = "seq",
                           batch_axes=("data", "fsdp"),
                           head_axis: str = "tensor",
                           chunk_size: Optional[int] = 2048):
    """The reference's ``shard_map`` wrapper: [B, T, H, D] laid out with the
    batch over ``batch_axes``, the sequence over ``seq_axis`` and the heads
    over ``head_axis`` (where present). One process a device already holds
    its tile, so each rank passes its own and gets its own back: the ring
    runs over ``seq_axis`` among the ranks of the same batch and head
    blocks, so ring and head sharding compose — each (seq, tensor) tile
    ships only its own heads' K/V around the ring."""
    del batch_axes, head_axis  # the layout of the tile the rank holds
    return ring_attention(q, k, v, mesh, axis_name=seq_axis, causal=causal,
                          chunk_size=chunk_size)


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Unsharded reference attention. q/k/v: [B, T, H, D] → [B, T, H, D];
    f32 scores, ``-inf`` causal mask, softmax, output in the input type."""
    b, t, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
