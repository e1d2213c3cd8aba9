"""The collectives of a training gang: one ``torch.distributed`` process
group of ``world`` ranks, each holding the whole (replicated) model and its
slice of every global batch.

The reference's gang runs one jitted program over a batch sharded across
processes, and XLA inserts its collectives: the gradient's all-reduce, and
BatchNorm's statistics over the global batch. The port's ranks run the same
eager (or graphed) step, so the step calls them by hand:

- :func:`all_reduce_` sums a tensor across the gang in place (the row
  count of a batch, the flat gradient buffer, an epoch's loss and metric
  sums);
- :func:`all_reduce_grad` sums a tensor across the gang as an autograd
  function whose backward sums the gradient across the gang too (what
  ``torch.distributed.nn.functional.all_reduce`` does): BatchNorm's
  statistics, once :func:`sync_batchnorm` switched them on.

Whether a fit is a gang's is decided by its caller (``fit_gang``'s ranks),
never read from the process's state: a plain ``fit`` inside a rank of a
process group (one fit a rank, a sweep) stays a fit of its own.
:data:`COMM` keeps the host wall of the collectives called eagerly (under
``gloo`` every one of them: gloo's collectives are synchronous), which a
gang's epoch report carries as ``allreduce_time_s``.
"""

from __future__ import annotations

import time

import torch
from torch import nn


def sync_batchnorm(model: nn.Module) -> nn.Module:
    """Switch every :class:`~raydp_tpu_torch.models.layers.BatchNorm` of
    ``model`` to the gang's global-batch statistics (what
    ``torch.nn.SyncBatchNorm.convert_sync_batchnorm`` does for torch's);
    returns ``model``."""
    from raydp_tpu_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.global_stats = True
    return model


class CommClock:
    """Host seconds spent in the gang's collectives since the last
    :meth:`take` (a capture's collectives count once, at the capture)."""

    def __init__(self):
        self.seconds = 0.0

    def take(self) -> float:
        seconds, self.seconds = self.seconds, 0.0
        return seconds


#: the process's clock of its collectives: one process group a process
COMM = CommClock()


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` across the gang, in place; returns ``t``."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.all_reduce(t)
    COMM.seconds += time.perf_counter() - t0
    return t


class _AllReduceSum(torch.autograd.Function):
    """``torch.distributed.nn.functional.all_reduce`` with the sum, which
    torch 2.13 deprecates: the forward sums a copy of the input across the
    gang, the backward sums the incoming gradient across the gang."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` across the gang, differentiable: the backward sums
    the incoming gradient across the gang (every rank's loss depends on
    every rank's contribution)."""
    return _AllReduceSum.apply(t)


def all_reduce_grads(params) -> None:
    """Sum the gradients of ``params`` across the gang with ONE collective
    over a flat buffer (a parameter without a gradient contributes zeros,
    so every rank reduces the same layout), then write the sums back."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat)
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(g)
        off += n

