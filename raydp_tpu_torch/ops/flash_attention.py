"""Flash attention: the port of :mod:`raydp_tpu.ops.flash_attention`.

The forward is a CUDA kernel written for Hopper
(``raydp_tpu_torch/csrc/flash_attention_fwd.cu``), the counterpart of the
Pallas TPU kernel ``_fwd_kernel``: one thread block per (batch·head, q tile)
walks the k tiles with the online-softmax state in registers, applies the
causal block skip and masks a ragged sequence end itself, and writes the
output and the per-row log-sum-exp. For bf16 it runs on the tensor cores
(``wgmma`` on bf16 tiles fed by a ``cp.async`` ring, p rounded to bf16
before p·v as the Pallas kernel does; see :func:`_fwd_rounding_bound`); for
f32 it is FMA on the CUDA cores.

The backward is a pure recompute from (q, k, v, out, lse), as in the
reference: two CUDA kernels (``csrc/flash_attention_bwd.cu``), the
counterparts of ``_bwd_dkdv_kernel`` (one block per k tile walks the q tiles
and accumulates dk, dv) and ``_bwd_dq_kernel`` (one block per q tile walks
the k tiles and accumulates dq). For bf16 both run on the tensor cores
(warpgroup ``wgmma`` on bf16 tiles fed by a ``cp.async`` ring, p and ds
rounded to bf16 before the second product as the Pallas kernels do); for
f32 they are FMA on the CUDA cores, so that f32 stays f32 and not TF32.

Dispatch is by where the tensors lie, never by what fails: CPU tensors take
the plain PyTorch versions (``_fwd_plain``, the math of the reference's
``_fwd_jnp``; ``_bwd_plain``, the math of its ``_bwd_blockwise``), CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from raydp_tpu_torch.device import require_cuda
from raydp_tpu_torch.ops import _build

# The reference's block defaults (TPU VMEM-sized). ``block_k`` blocks the plain
# backward's k loop, as in the reference; the CUDA kernels use their own
# compiled tiles (f32 kernels 64 x 64; bf16 kernels 128 owned rows a block
# against walked tiles of 64).
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)          # the kernels' compiled head_dim instances
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel (chip_smoke.py sets them to 0 and reads them)
FWD_LAUNCHES = 0
DKDV_LAUNCHES = 0
DQ_LAUNCHES = 0


def _check_kernel_inputs(name: str, *tensors) -> torch.device:
    """Raise unless the kernels take these [BH, T, D] tensors: one shape, all
    bfloat16 or all float32, a head_dim in :data:`HEAD_DIMS`, 1 <= BH <=
    65535, T >= 1, contiguous, on one CUDA device; return that device."""
    shapes = [tuple(x.shape) for x in tensors]
    if tensors[0].dim() != 3 or len(set(shapes)) != 1:
        raise ValueError(f"{name} takes tensors of one shape [BH, T, D], "
                         f"got {shapes}")
    dtypes = {x.dtype for x in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} kernel takes tensors all bfloat16 or all "
                         f"float32, got {[str(x.dtype) for x in tensors]}")
    bh, t, d = shapes[0]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if not 1 <= bh <= 65535 or t < 1:
        raise ValueError(f"{name} kernel takes 1 <= BH <= 65535 and T >= 1, "
                         f"got BH={bh}, T={t}")
    device = require_cuda(name, *tensors)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    return device


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


def _fwd_bind(lib: ctypes.CDLL):
    """The entry of a library built from ``flash_attention_fwd.cu``, with
    its C signature declared."""
    fn = lib.raydp_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fwd_entry():
    """The entry of the forward library (:func:`_fwd_bind`)."""
    return _fwd_bind(_build.load("flash_attention_fwd"))


def _fwd_cuda(q3, k3, v3, scale: float, causal: bool):
    """Launch the Hopper forward kernel; same contract as :func:`_fwd_plain`
    (in bf16 up to the rounding of p, :func:`_fwd_rounding_bound`).

    Raises on anything the kernel does not take: tensors off CUDA, mixed or
    unsupported dtypes, non-contiguous or mismatched [BH, T, D] shapes, a
    head_dim outside :data:`HEAD_DIMS`, or a launch the runtime refuses."""
    global FWD_LAUNCHES
    device = _check_kernel_inputs("flash forward", q3, k3, v3)
    bh, t, d = q3.shape
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


def _bwd_plain(q3, k3, v3, out, lse, do, scale: float, causal: bool,
               blk_k: int = DEFAULT_BLOCK_K):
    """Plain backward → (dq, dk, dv), the math of the reference's
    ``_bwd_blockwise``: f32 throughout, one k block of ``_fit_block(t,
    blk_k)`` keys at a time (memory O(T·blk)), ``p`` recomputed from ``lse``
    under the ``-1e30`` causal mask, results in the input dtypes."""
    bh, t, d = q3.shape
    blk = _fit_block(t, blk_k)
    qf, dof = q3.float(), do.float()
    delta = (dof * out.float()).sum(-1)                        # [BH, T]
    q_pos = torch.arange(t, device=q3.device)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(qf)
    dv = torch.empty_like(qf)
    for start in range(0, t, blk):
        keys = slice(start, start + blk)
        kb, vb = k3[:, keys].float(), v3[:, keys].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        if causal:
            k_pos = torch.arange(start, start + blk, device=q3.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
        p = torch.exp(s - lse[..., None])                      # [BH, T, blk]
        dv[:, keys] = torch.einsum("bqk,bqd->bkd", p, dof)
        dp = torch.einsum("bqd,bkd->bqk", dof, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bqk,bkd->bqd", ds, kb)
        dk[:, keys] = torch.einsum("bqk,bqd->bkd", ds, qf)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _fwd_rounding_bound(q3, k3, v3, scale: float, causal: bool):
    """How far rounding p to bf16 before the p·v product can move ``out``
    from :func:`_fwd_plain`, which keeps p in f32: each rounded p errs by at
    most 2^-8 of itself (bf16's unit roundoff), whatever running max it was
    formed against, and the normaliser l is summed from the unrounded p, so
    acc / l errs by at most 2^-8 Σ p·|v| / l = 2^-8 softmax(s)·|v|
    elementwise. The Pallas kernel and the bf16 CUDA kernel round there;
    f32 → [BH, T, D]."""
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        t = q3.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q3.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return 2.0 ** -8 * torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1),
                                    v3.float().abs())


def _bwd_rounding_bound(q3, k3, v3, out, lse, do, scale: float, causal: bool,
                        blk_k: int = DEFAULT_BLOCK_K):
    """How far rounding p and ds to bf16 before the dv, dk and dq products
    can move (dq, dk, dv) from :func:`_bwd_plain`, which keeps them in f32:
    each rounded value errs by at most 2^-8 of itself (bf16's unit
    roundoff), so the products err by at most 2^-8 (|ds|·|k|, |ds|ᵀ·|q|,
    |p|ᵀ·|do|). The Pallas kernels and the bf16 CUDA kernels round there;
    f32 → [BH, T, D] each, blocked over keys as :func:`_bwd_plain` is."""
    bh, t, d = q3.shape
    blk = _fit_block(t, blk_k)
    qf, dof = q3.float(), do.float()
    delta = (dof * out.float()).sum(-1)
    q_pos = torch.arange(t, device=q3.device)
    bq = torch.zeros_like(qf)
    bk = torch.empty_like(qf)
    bv = torch.empty_like(qf)
    for start in range(0, t, blk):
        keys = slice(start, start + blk)
        kb, vb = k3[:, keys].float(), v3[:, keys].float()
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        if causal:
            k_pos = torch.arange(start, start + blk, device=q3.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqd,bkd->bqk", dof, vb)
        ds = (p * (dp - delta[..., None]) * scale).abs()
        bv[:, keys] = torch.einsum("bqk,bqd->bkd", p, dof.abs())
        bq += torch.einsum("bqk,bkd->bqd", ds, kb.abs())
        bk[:, keys] = torch.einsum("bqk,bqd->bkd", ds, qf.abs())
    return tuple(2.0 ** -8 * x for x in (bq, bk, bv))


def _bwd_bind(lib: ctypes.CDLL) -> dict:
    """{"dkdv": entry, "dq": entry} of a library built from
    ``flash_attention_bwd.cu``, with their C signatures declared."""
    entries = {"dkdv": lib.raydp_flash_attention_bwd_dkdv,
               "dq": lib.raydp_flash_attention_bwd_dq}
    tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    for name, n_out in (("dkdv", 2), ("dq", 1)):
        entries[name].argtypes = [ctypes.c_void_p] * (6 + n_out) + tail
        entries[name].restype = ctypes.c_int
    return entries


@functools.cache
def _bwd_entries():
    """The entries of the backward library (:func:`_bwd_bind`)."""
    return _bwd_bind(_build.load("flash_attention_bwd"))


def _launch_bwd(kernel: str, q3, k3, v3, do, lse, delta, outs, scale: float,
                causal: bool) -> None:
    """Launch one backward kernel on inputs :func:`_bwd_cuda` has checked:
    ``"dkdv"`` writes ``outs`` = (dk, dv), ``"dq"`` writes ``outs`` = (dq,).
    Counts the launch; raises if the runtime refuses it."""
    global DKDV_LAUNCHES, DQ_LAUNCHES
    bh, t, d = q3.shape
    with torch.cuda.device(q3.device):
        err = _bwd_entries()[kernel](
            *(x.data_ptr() for x in (q3, k3, v3, do, lse, delta, *outs)),
            bh, t, d, scale, int(causal), _KERNEL_DTYPES[q3.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash backward {kernel} kernel launch failed: "
                           f"CUDA error {err} at BH={bh}, T={t}, D={d}, "
                           f"{q3.dtype}")
    if kernel == "dkdv":
        DKDV_LAUNCHES += 1
    else:
        DQ_LAUNCHES += 1


def _bwd_cuda(q3, k3, v3, out, lse, do, scale: float, causal: bool):
    """Launch the Hopper dk/dv and dq kernels; same contract as
    :func:`_bwd_plain` (whose ``blk_k`` blocking the kernels do not need).

    Raises on anything the kernels do not take, as :func:`_fwd_cuda` does,
    and on an ``lse`` that is not the forward's contiguous [BH, T] f32."""
    if (lse.shape != q3.shape[:2] or lse.dtype != torch.float32
            or lse.device != q3.device or not lse.is_contiguous()):
        raise ValueError(f"flash backward takes the forward's contiguous lse "
                         f"[BH, T] float32 beside q, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    _check_kernel_inputs("flash backward", q3, k3, v3, out, do)
    delta = (do.float() * out.float()).sum(-1)                 # [BH, T] f32
    dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
    inputs = (q3, k3, v3, do, lse, delta)
    _launch_bwd("dkdv", *inputs, (dk, dv), scale, causal)
    _launch_bwd("dq", *inputs, (dq,), scale, causal)
    return dq, dk, dv


def _bwd(q3, k3, v3, out, lse, do, scale: float, causal: bool, blk_k: int):
    if q3.device.type == "cpu":
        return _bwd_plain(q3, k3, v3, out, lse, do, scale, causal, blk_k)
    return _bwd_cuda(q3, k3, v3, out, lse, do, scale, causal)


class _Flash(torch.autograd.Function):
    """Mirror of the reference's ``custom_vjp`` ``_flash``: the forward saves
    (q, k, v, out, lse) and the backward recomputes from them
    (``_flash_bwd``): the two backward kernels on CUDA, ``_bwd_plain`` on
    the CPU."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float, causal: bool, blk_k: int):
        out, lse = _fwd(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.scale, ctx.causal, ctx.blk_k = scale, causal, blk_k
        return out

    @staticmethod
    def backward(ctx, g):
        # the incoming gradient comes through the [B, H, T, D] -> [B, T, H, D]
        # transpose and may be strided; the kernels read contiguous rows, so
        # this is a plain copy when it is not
        dq, dk, dv = _bwd(*ctx.saved_tensors, g.contiguous(), ctx.scale,
                          ctx.causal, ctx.blk_k)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q3, k3, v3, causal: bool = True,
                        scale: Optional[float] = None):
    """Forward on the [BH, T, D] layout → (out [BH, T, D], lse [BH, T] f32),
    the residuals the backward recomputes from."""
    scale = scale if scale is not None else 1.0 / (q3.shape[-1] ** 0.5)
    return _fwd(q3, k3, v3, scale, causal)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Memory-efficient exact attention. q/k/v: [B, T, H, D] → [B, T, H, D].

    ``block_k`` blocks the plain backward's k loop as the reference's does;
    ``block_q`` keeps the reference's signature. The CUDA kernels run their
    own compiled tiles and the plain forward is unblocked, so neither changes
    the result beyond f32 summation order (and, in the bf16 kernels, the
    rounding of p, and in the backward of ds, to bf16 that the Pallas kernels
    also do; see :func:`_fwd_rounding_bound` and
    :func:`_bwd_rounding_bound`)."""
    b, t, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d)

    out3 = _Flash.apply(to3(q), to3(k), to3(v), scale, causal, block_k)
    return out3.reshape(b, h, t, d).transpose(1, 2)
