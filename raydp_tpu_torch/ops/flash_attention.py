"""Flash attention: the port of :mod:`raydp_tpu.ops.flash_attention`.

The forward is a CUDA kernel written for Hopper
(``raydp_tpu_torch/csrc/flash_attention_fwd.cu``), the counterpart of the
Pallas TPU kernel ``_fwd_kernel``: one thread block per (batch·head, q tile)
walks the k tiles with the online-softmax state in registers, applies the
causal block skip and masks a ragged sequence end itself, and writes the
output and the per-row log-sum-exp.

Dispatch is by where the tensors lie, never by what fails: CPU tensors take
the plain PyTorch version (``_fwd_plain``, the math of the reference's
``_fwd_jnp``), CUDA tensors launch the kernel or raise. The backward kernels
are not ported yet; differentiating through CUDA tensors raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from raydp_tpu_torch.device import require_cuda
from raydp_tpu_torch.ops import _build

# The reference's block defaults (TPU VMEM-sized). Kept for the signature; the
# CUDA kernel uses its own compiled 64 x 64 tile.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)          # the kernel's compiled head_dim instances
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

FWD_LAUNCHES = 0  # launches of the forward kernel (chip_smoke.py reads it)


def _fwd_plain(q3, k3, v3, scale: float, causal: bool):
    """Plain forward, q3/k3/v3 [BH, T, D] → (out [BH, T, D], lse [BH, T] f32):
    f32 scores, ``-1e30`` causal mask, log-sum-exp, output in the input type."""
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        t = q3.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q3.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p, v3.float())
    return out.to(q3.dtype), lse


@functools.cache
def _fwd_entry():
    fn = _build.load("flash_attention_fwd").raydp_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fwd_cuda(q3, k3, v3, scale: float, causal: bool):
    """Launch the Hopper forward kernel; same contract as :func:`_fwd_plain`.

    Raises on anything the kernel does not take: tensors off CUDA, mixed or
    unsupported dtypes, non-contiguous or mismatched [BH, T, D] shapes, a
    head_dim outside :data:`HEAD_DIMS`, or a launch the runtime refuses."""
    global FWD_LAUNCHES
    if q3.dim() != 3 or not (q3.shape == k3.shape == v3.shape):
        raise ValueError("flash forward takes q/k/v of one shape [BH, T, D], "
                         f"got {tuple(q3.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype) or q3.dtype not in _KERNEL_DTYPES:
        raise ValueError("flash forward kernel takes q/k/v all bfloat16 or "
                         f"all float32, got {q3.dtype}, {k3.dtype}, {v3.dtype}")
    bh, t, d = q3.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash forward kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if not 1 <= bh <= 65535 or t < 1:
        raise ValueError(f"flash forward kernel takes 1 <= BH <= 65535 and "
                         f"T >= 1, got BH={bh}, T={t}")
    device = require_cuda("flash forward", q3, k3, v3)
    if not (q3.is_contiguous() and k3.is_contiguous() and v3.is_contiguous()):
        raise ValueError("flash forward kernel takes contiguous q/k/v")

    out = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _fwd_entry()(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, d, scale, int(causal),
            _KERNEL_DTYPES[q3.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{err} at BH={bh}, T={t}, D={d}, {q3.dtype}")
    FWD_LAUNCHES += 1
    return out, lse


def _fwd(q3, k3, v3, scale: float, causal: bool):
    if q3.device.type == "cpu":
        return _fwd_plain(q3, k3, v3, scale, causal)
    return _fwd_cuda(q3, k3, v3, scale, causal)


def _fit_block(t: int, blk: int) -> int:
    """Shrink blk by halving until it divides t (down to 1), so the grid and
    the blockwise backward always cover the full sequence."""
    blk = min(blk, t)
    while t % blk:
        blk //= 2
    return max(blk, 1)


class _Flash(torch.autograd.Function):
    """Mirror of the reference's ``custom_vjp`` ``_flash``: the forward saves
    (q, k, v, out, lse) for a recompute backward. On CUDA the backward kernels
    are not ported yet and differentiating raises; on the CPU the backward
    differentiates the plain forward."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float, causal: bool):
        out, lse = _fwd(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, _, _ = ctx.saved_tensors
        if q3.device.type != "cpu":
            raise NotImplementedError(
                "flash backward kernels: ROADMAP queue 2 items 2-3")
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (q3, k3, v3)]
            out, _ = _fwd_plain(*inputs, ctx.scale, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None


def flash_attention_fwd(q3, k3, v3, causal: bool = True,
                        scale: Optional[float] = None):
    """Forward on the [BH, T, D] layout → (out [BH, T, D], lse [BH, T] f32).
    The backward (next port slice) reads ``lse``; tests check it too."""
    scale = scale if scale is not None else 1.0 / (q3.shape[-1] ** 0.5)
    return _fwd(q3, k3, v3, scale, causal)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Memory-efficient exact attention. q/k/v: [B, T, H, D] → [B, T, H, D].

    ``block_q``/``block_k`` keep the reference's signature; the CUDA kernel
    runs its own compiled 64 x 64 tile and the CPU path is unblocked, so
    neither changes the result."""
    b, t, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d)

    out3 = _Flash.apply(to3(q), to3(k), to3(v), scale, causal)
    return out3.reshape(b, h, t, d).transpose(1, 2)
