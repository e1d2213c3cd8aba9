"""The collectives of a training gang: one ``torch.distributed`` process
group of ``world`` ranks laid out as a mesh
(:mod:`raydp_tpu_torch.parallel.mesh`), each feeding its slice of every
global batch.

The reference's gang runs one jitted program over a batch sharded across
processes, and XLA inserts its collectives: the gradient's all-reduce, and
BatchNorm's statistics over the global batch. The port's ranks run the same
eager (or graphed) step, so the step calls them by hand, each over the
process group it names — the ranks that saw different rows of the batch
(the mesh's data × fsdp group), never simply the world: ranks that differ
only along ``tensor`` or ``expert`` see the same rows, and summing over
them would count those rows twice. A ``group`` of None is a group of this
rank alone, and the collective is the identity.

- :func:`all_reduce_` sums a tensor across the group in place (the row
  count of a batch, the flat gradient buffer, an epoch's loss and metric
  sums);
- :func:`all_reduce_grad` sums a tensor across the group as an autograd
  function whose backward sums the gradient across the group too (what
  ``torch.distributed.nn.functional.all_reduce`` does): BatchNorm's
  statistics, once :func:`sync_batchnorm` switched them on.

Whether a fit is a gang's is decided by its caller (``fit_gang``'s ranks),
never read from the process's state: a plain ``fit`` inside a rank of a
process group (one fit a rank, a sweep) stays a fit of its own.

Every function here posts its collective without reading a device value
on the host, so a step that calls them can be captured into a CUDA graph
under ``nccl`` (:func:`~raydp_tpu_torch.train.step_graph.graphs_allowed`).
:data:`COMM` keeps the host wall of the collectives as they are called,
which a gang's epoch report carries as ``allreduce_time_s``. Under
``gloo`` that is their whole time (gloo's collectives are synchronous).
Under ``nccl`` it is only the time to enqueue them, and a captured
collective counts once, at the capture: it is no share of a step there,
which only a device trace shows.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch import nn


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Switch every :class:`~raydp_tpu_torch.models.layers.BatchNorm` of
    ``model`` to the global batch's statistics, summed over ``group`` (the
    ranks that feed different rows; what
    ``torch.nn.SyncBatchNorm.convert_sync_batchnorm`` does for torch's);
    returns ``model``."""
    from raydp_tpu_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.global_stats = True
            m.stats_group = group
    return model


@contextlib.contextmanager
def batch_rows(model: nn.Module, mask: Optional[torch.Tensor]):
    """Within the block, the global-statistics BatchNorms of ``model`` count
    only the rows ``mask`` marks (a padded batch's real rows); the block
    spans the forward and the backward, whose recompute (remat) must see
    the same rows."""
    from raydp_tpu_torch.models.layers import BatchNorm

    norms = [m for m in model.modules()
             if isinstance(m, BatchNorm) and m.global_stats]
    for m in norms:
        m.row_mask = mask
    try:
        yield
    finally:
        for m in norms:
            m.row_mask = None


class CommClock:
    """Host seconds spent calling the gang's collectives since the last
    :meth:`take`: their time under ``gloo``, their enqueue under ``nccl``
    (a capture's collectives count once, at the capture)."""

    def __init__(self):
        self.seconds = 0.0
        #: bytes this process sent by neighbour exchange
        #: (:func:`~raydp_tpu_torch.parallel.shard.ppermute`), never reset
        self.sent_bytes = 0

    def take(self) -> float:
        seconds, self.seconds = self.seconds, 0.0
        return seconds


#: the process's clock of its collectives: one process group a process
COMM = CommClock()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` across ``group``, in place; returns ``t``."""
    import torch.distributed as dist

    if group is None:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    COMM.seconds += time.perf_counter() - t0
    return t


class _AllReduceSum(torch.autograd.Function):
    """``torch.distributed.nn.functional.all_reduce`` with the sum, which
    torch 2.13 deprecates: the forward sums a copy of the input across the
    group, the backward sums the incoming gradient across the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` across ``group``, differentiable: the backward sums
    the incoming gradient across the group (every rank's loss depends on
    every rank's contribution)."""
    return _AllReduceSum.apply(t, group)


def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` across ``group`` with ONE collective
    over a flat buffer (a parameter without a gradient contributes zeros,
    so every rank reduces the same layout), then write the sums back."""
    params = list(params)
    if group is None or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group)
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(g)
        off += n

