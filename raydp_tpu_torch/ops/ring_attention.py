"""Port of :mod:`raydp_tpu.ops.ring_attention` — so far only the unsharded
reference ``dense_attention``; the sequence-sharded ring over
``torch.distributed`` comes with a later slice of the port."""

from __future__ import annotations

from typing import Optional

import torch


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
