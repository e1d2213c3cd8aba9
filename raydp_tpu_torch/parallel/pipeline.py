"""Pipeline parallelism: GPipe over the mesh's ``stage`` axis — the port of
:mod:`raydp_tpu.parallel.pipeline`.

The reference runs one compiled SPMD program under ``shard_map``: the
per-layer parameters stacked on a leading axis and split over ``stage``,
the microbatches marching through a ``lax.scan`` of ticks, activations
hopping stage → stage+1 with ``lax.ppermute``. The port's ranks hold one
device each and run the same schedule (eagerly, or captured in a CUDA
graph under ``nccl``): each rank applies its stage's contiguous run of
layers, and each tick hops the activations with the differentiable
neighbour exchange
(:func:`~raydp_tpu_torch.parallel.shard.ppermute`), whose backward is the
opposite hop — so autograd of the tick loop IS the reverse pipeline, and
one ``backward()`` trains the whole pipeline. Every rank runs every tick
(the bubble ticks compute on zeros, as the reference's do) and every
exchange feeds the graph on every rank, so each rank's backward posts the
same exchanges in the same order.

Total ticks = n_micro + n_stages − 1; the (n_stages − 1)-tick bubble is
the GPipe cost, amortized by more microbatches.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable

import torch

from raydp_tpu_torch.parallel.mesh import axis_index, data_axes
from raydp_tpu_torch.parallel.shard import (
    copy_to, gather_from, ppermute, scatter_to,
)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested mappings of tensors (one structure)."""
    first = trees[0]
    if isinstance(first, Mapping):
        for t in trees[1:]:
            if not isinstance(t, Mapping) or set(t) != set(first):
                raise ValueError("stage parameter trees differ in "
                                 f"structure: {sorted(first)} vs {t!r}")
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def stack_stage_params(param_trees) -> Any:
    """Stack per-stage parameter trees (nested mappings of tensors, e.g.
    ``dict(block.named_parameters())``) on a new leading 'stage' axis
    (stage-homogeneous layers: identical structure and shapes required)."""
    def stack(*xs):
        shapes = {tuple(x.shape) for x in xs}
        if len(shapes) != 1:
            raise ValueError(f"stage parameters differ in shape: "
                             f"{sorted(shapes)}")
        return torch.stack(xs, dim=0)

    return _tree_map(stack, *param_trees)


def stage_params_leading_dim(stage_params) -> int:
    return int(next(_leaves(stage_params)).shape[0])


class _FromLastStage(torch.autograd.Function):
    """The last stage's outputs, replicated over the stage axis (the
    reference's masked ``psum``). The backward hands the cotangent, which
    every stage holds alike, to the last stage's outputs once; the other
    stages' outputs get zeros (they fed no result)."""

    @staticmethod
    def forward(ctx, local, axis, mesh):
        from raydp_tpu_torch.parallel.shard import all_reduce_sum

        ctx.last = axis_index(mesh, axis) == mesh.shape[axis] - 1
        return all_reduce_sum(local if ctx.last else torch.zeros_like(local),
                              (axis,), mesh)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


def _gpipe(fn, stage_params, x_micro, mesh, stage_axis: str):
    """The schedule on one rank: ``stage_params`` leaves hold this stage's
    run of layers [layers_per_stage, ...]; ``x_micro`` [n_micro, ...]."""
    n_stages = mesh.shape[stage_axis]
    n_micro = int(x_micro.shape[0])
    s = axis_index(mesh, stage_axis)
    per_stage = stage_params_leading_dim(stage_params)

    def apply_stage(x):
        for i in range(per_stage):
            x = fn(_tree_map(lambda p: p[i], stage_params), x)
        return x

    # stage 0 injects microbatch t; the others take what arrived on the
    # last hop. A select (not a branch) on every rank keeps both operands
    # in the graph, so every exchange's backward runs everywhere
    # (a fill, not a host copy: a CUDA graph can capture it)
    first = torch.full((), s == 0, dtype=torch.bool, device=x_micro.device)
    state = torch.zeros_like(x_micro[0])
    ticks = n_micro + n_stages - 1
    outs = []
    for t in range(ticks):
        cur = torch.where(first, x_micro[min(t, n_micro - 1)], state)
        y = apply_stage(cur)
        # the last stage finishes microbatch t - (n_stages - 1)
        if t >= n_stages - 1:
            outs.append(y)
        if t < ticks - 1:
            state = ppermute(y, stage_axis, mesh, shift=1)
    return _FromLastStage.apply(torch.stack(outs), stage_axis, mesh)


def pipeline_apply(fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, mesh,
                   stage_axis: str = "stage", stage_local: bool = False,
                   split_data: bool = True) -> torch.Tensor:
    """Run ``x_micro`` ([n_micro, mb, ...]) through ``n_stages`` pipeline
    stages; ``fn(params, x) -> y`` is one layer (y must have x's
    shape/dtype — stage-homogeneous pipelines, the transformer-block case).

    ``stage_params`` leaves are stacked [n_layers, ...]
    (:func:`stack_stage_params`; ``n_layers`` must be a multiple of
    ``n_stages`` — each stage applies its contiguous run of layers in
    order), the whole stack on every rank; with ``stage_local`` each rank
    passes its stage's run only (a
    :class:`~raydp_tpu_torch.parallel.shard.ShardedModule`'s shard).
    Returns [n_micro, mb, ...] outputs, replicated over the stage axis.
    Every rank of the mesh calls it, in the same order.

    With ``split_data`` (the reference's layout) every rank passes the
    whole ``x_micro``; its microbatch dim (axis 1) is split over the mesh's
    data axes inside the pipeline — zero rows pad it to a divisible count
    (``train_padded_rows_total``) and are sliced off the outputs — and the
    outputs are gathered whole again, so pp×dp does dp-partitioned work per
    stage. Without it, ``x_micro`` is already the rank's block of rows.

    Differentiable end to end: the backward is the reverse pipeline; each
    stage's layers get their gradient on their stage, an input's gradient
    is summed over the stages (stage 0 alone consumed it), and under
    ``split_data`` the parameters' gradients are summed over the data axes.
    """
    n_stages = mesh.shape[stage_axis]
    n_layers = stage_params_leading_dim(stage_params) \
        * (n_stages if stage_local else 1)
    if n_stages > 1 and n_layers % n_stages != 0:
        raise ValueError(
            f"{n_layers} stacked layers cannot split over {n_stages} pipeline "
            f"stages (must divide evenly; each stage applies its contiguous "
            f"run of layers in order)")
    if n_stages <= 1:
        # no stage axis: plain sequential application of every layer
        def seq_apply(x):
            for i in range(n_layers):
                x = fn(_tree_map(lambda p: p[i], stage_params), x)
            return x
        return torch.stack([seq_apply(x) for x in x_micro])

    if not stage_local:
        per_stage = n_layers // n_stages
        s = axis_index(mesh, stage_axis)
        stage_params = _tree_map(
            lambda p: p[s * per_stage:(s + 1) * per_stage], stage_params)
    x_micro = copy_to(x_micro, (stage_axis,), mesh)
    daxes = tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)
    if not (split_data and daxes):
        return _gpipe(fn, stage_params, x_micro, mesh, stage_axis)

    dp = mesh.extent(daxes)
    mb = int(x_micro.shape[1])
    pad = (-mb) % dp
    if pad:
        # a microbatch the data extent does not divide: zero rows pad it
        # up and are sliced off the outputs — the pipeline stays
        # dp-split instead of replicating every microbatch
        from raydp_tpu_torch import metrics

        x_micro = torch.cat([x_micro, x_micro.new_zeros(
            (x_micro.shape[0], pad) + tuple(x_micro.shape[2:]))], dim=1)
        metrics.inc("train_padded_rows_total", pad * int(x_micro.shape[0]))
    stage_params = _tree_map(lambda p: copy_to(p, daxes, mesh), stage_params)
    out = _gpipe(fn, stage_params, scatter_to(x_micro, 1, daxes, mesh), mesh,
                 stage_axis)
    out = gather_from(out, 1, daxes, mesh)
    return out[:, :mb] if pad else out
