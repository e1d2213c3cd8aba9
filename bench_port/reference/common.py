"""What the plain references share: the precision a product is computed
in, the batches the program's feeds form, the optimizer a configuration
names (``optimizers/<name>.py``), and the loop that follows the first
training steps.

The batches are worked out again here, not taken from the program:

- resident (``DeviceEpochCache``): epoch ``e`` visits the rows in the order
  of ``torch.randperm(rows)`` drawn on the device from a generator seeded
  with :func:`epoch_seed` ``(seed, e)``; step ``k`` takes positions
  ``[k*B, (k+1)*B)`` of that order;
- streaming (``HostBatchIterator``): epoch ``e`` seeds numpy's
  ``RandomState`` with ``epoch_seed(seed, e + 1)``, shuffles the block list,
  permutes the rows inside each block in that order, and cuts the stream
  into batches of ``B`` rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_port import spec


def no_tf32() -> None:
    """Float32 products in float32 (TF32 off), for matrix products and
    convolutions alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- precision

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits (to nearest, ties to
    even), as a product's operands are rounded on the tensor cores."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Scale a tensor by its largest magnitude onto float8 e4m3's range
    (448), round to e4m3, scale back: a per-tensor scaled fp8 operand."""
    amax = x.abs().max()
    if float(amax) == 0.0:
        return x
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDING = {"float32": None, "tf32": _round_tf32, "fp8": _round_fp8}


class _LowMatmul(torch.autograd.Function):
    """``a @ b`` with both operands, and the backward's operands, rounded to
    a lower precision and the products summed in float32."""

    @staticmethod
    def forward(ctx, a, b, q):
        ctx.save_for_backward(a, b)
        ctx.q = q
        return q(a) @ q(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = ctx.q
        gq = q(g)
        return gq @ q(b).mT, q(a).mT @ gq, None


class _Round(torch.autograd.Function):
    """A value held in a lower precision: rounded forward, its gradient
    rounded backward."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


class Precision:
    """The precision the reference computes in: ``float32`` (the
    reference) or a lower one (the control, the reference put in the
    program's place one step down). ``mm`` rounds a product's operands;
    ``value`` rounds what a compute dtype holds between products (biases,
    layer outputs, looked-up rows): nothing under ``tf32``, which rounds
    only a product's operands, everything under ``fp8``."""

    def __init__(self, name: str = "float32"):
        if name not in ROUNDING:
            raise ValueError(f"unknown precision {name!r}; have "
                             f"{sorted(ROUNDING)}")
        self.name = name
        self._q = ROUNDING[name]
        self._v = None if name == "tf32" else self._q

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self._q is None:
            return a @ b
        return _LowMatmul.apply(a, b, self._q)

    def value(self, x: torch.Tensor) -> torch.Tensor:
        if self._v is None:
            return x
        return _Round.apply(x, self._v)


# ---------------------------------------------------------------- batches

def epoch_seed(base: int, epoch: int) -> int:
    """The per-epoch shuffle seed both feeds derive (frozen copy)."""
    return (base + epoch * 1000003) % (2**31 - 1)


def resident_rows(num_rows: int, batch: int, seed: int, steps: int,
                  device: torch.device, epoch: int = 0) -> List[torch.Tensor]:
    """The dataset rows of the first ``steps`` resident batches."""
    gen = torch.Generator(device=device).manual_seed(epoch_seed(seed, epoch))
    order = torch.randperm(num_rows, generator=gen, device=device)
    return [order[k * batch:(k + 1) * batch] for k in range(steps)]


def stream_rows(block_sizes: Sequence[int], batch: int, seed: int,
                steps: int, epoch: int = 0) -> List[np.ndarray]:
    """The dataset rows of the first ``steps`` streamed batches (shuffled,
    whole blocks, remainder dropped)."""
    rng = np.random.RandomState(epoch_seed(seed, epoch + 1))
    starts = np.cumsum([0] + list(block_sizes))
    parts = [(i, 0, n) for i, n in enumerate(block_sizes)]
    rng.shuffle(parts)
    out: List[np.ndarray] = []
    pending: List[np.ndarray] = []
    held = 0
    for block, off, length in parts:
        idx = off + rng.permutation(length) if length > 1 \
            else np.arange(off, off + length)
        pending.append(starts[block] + idx)
        held += length
        while held >= batch:
            joined = np.concatenate(pending)
            out.append(joined[:batch])
            if len(out) == steps:
                return out
            pending, held = [joined[batch:]], held - batch
    return out


# ---------------------------------------------------------------- optimizers

def make_optimizer(optimizer: Dict, params: Dict[str, torch.Tensor]):
    """The plain optimizer ``optimizers/<name>.py`` names, with the
    configuration's other keys as its arguments."""
    kw = {k: v for k, v in optimizer.items() if k != "name"}
    return spec.load("optimizers", optimizer["name"]).Plain(params, **kw)


# ---------------------------------------------------------------- the steps

@dataclass
class Trajectory:
    """What the first steps of a training run read: each step's loss (None
    for a step whose loss was not read: one inside a replayed chain), the
    first step's predictions (the forward of the starting weights), the
    norm of every leaf's first gradient, and the norm of every leaf's change
    over the steps and how many of its rows (slices along dim 0) moved."""

    losses: List[Optional[float]] = field(default_factory=list)
    first_preds: Optional[torch.Tensor] = None
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)
    moved_rows: Dict[str, int] = field(default_factory=dict)


def follow(params: Dict[str, torch.Tensor], loss_fn: Callable,
           batches: Sequence, optimizer: Dict) -> Trajectory:
    """Train ``params`` (the leaves, float32, taken over and changed) on
    ``batches`` in order with the named optimizer; ``loss_fn(params,
    batch)`` returns a batch's mean loss and its predictions."""
    start = {n: p.detach().clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    opt = make_optimizer(optimizer, params)
    out = Trajectory()
    names = list(params)
    for k, batch in enumerate(batches):
        loss, preds = loss_fn(params, batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        out.losses.append(float(loss.detach()))
        if k == 0:
            out.first_preds = preds.detach()
            out.grad_norms = {n: float(g.double().norm())
                              for n, g in grads.items()}
        opt.step(params, grads)
    out.change_norms = {n: float((params[n].detach() - start[n]).double()
                                 .norm()) for n in names}
    out.moved_rows = {n: moved_rows(params[n].detach(), start[n])
                      for n in names}
    return out


def moved_rows(now: torch.Tensor, start: torch.Tensor) -> int:
    """How many slices along dim 0 differ between two values of a leaf."""
    if now.dim() == 0:
        return int(bool(now != start))
    return int((now != start).reshape(now.shape[0], -1).any(1).sum())


def median(values) -> float:
    v = sorted(values)
    if not v:
        return math.nan
    m = len(v) // 2
    return v[m] if len(v) % 2 else 0.5 * (v[m - 1] + v[m])
