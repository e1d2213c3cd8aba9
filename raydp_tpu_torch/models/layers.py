"""Flax layers the port's models share, with Flax's parameter names, layouts,
default initializers and dtype rules.

- :class:`_Dense` — ``nn.Dense`` / ``DenseGeneral``: ``kernel`` of shape
  ``in_shape + out_shape`` (``[in, out]`` for a plain Dense), an optional
  ``bias``; input, kernel and bias are cast to ``dtype`` before the product
  (Flax ``promote_dtype``) and the bias is added after it;
- :class:`_Embed` — ``nn.Embed``: an f32 table, rows returned in ``dtype``;
- :class:`BatchNorm` — ``nn.BatchNorm`` as Flax computes it, which is not
  ``torch.nn.BatchNorm1d`` (see its docstring).

``dtype=None`` follows the input's dtype, as Flax's ``dtype or x.dtype``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch.parallel import gang

# std of a standard normal truncated to [-2, 2] (Flax's truncated_normal)
_TRUNC_STD = 0.87962566103423978


def init_parameters(root: nn.Module, generator: torch.Generator) -> None:
    """Draw every submodule's parameters from ``generator`` with Flax's
    initializers, in module order (one generator, one fixed sequence)."""
    with torch.no_grad():
        for module in root.modules():
            if module is not root and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)


class _Dense(nn.Module):
    """Flax ``Dense``/``DenseGeneral``: ``kernel`` has shape
    ``in_shape + out_shape`` and contracts the input's trailing
    ``len(in_shape)`` dims; input, kernel and bias are cast to ``dtype``
    first. ``split`` (set by :class:`~raydp_tpu_torch.parallel.shard.
    ShardedModule` on a tensor-split kernel) wraps the product in its
    collectives; None computes the whole product."""

    split = None

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: Optional[torch.dtype], device: torch.device,
                 use_bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(
            torch.empty(*in_shape, *out_shape, device=device))
        self.bias = (nn.Parameter(torch.empty(*out_shape, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Flax's default lecun_normal: truncated normal, variance 1/fan_in;
        # biases start at zero
        fan_in = math.prod(self.kernel.shape[:self.n_in])
        std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        if self.split is not None:
            x = self.split.enter(x)
        y = torch.tensordot(x.to(dtype), self.kernel.to(dtype),
                            dims=self.n_in)
        if self.split is not None:
            y = self.split.leave(y)
        if self.bias is not None:
            # a separate add, rounded to dtype after the product's rounding,
            # as Flax's `y += bias`
            y = y + self.bias.to(dtype)
        return y


class _Embed(nn.Module):
    """Flax ``Embed``: an f32 table, rows returned in ``dtype``. ``split``
    (set by :class:`~raydp_tpu_torch.parallel.shard.ShardedModule` on a
    table split by rows or columns) looks the ids up in the rank's shard."""

    split = None

    def __init__(self, num: int, dim: int, dtype: Optional[torch.dtype],
                 device: torch.device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Flax's default_embed_init: normal with variance 1/dim
        nn.init.normal_(self.embedding, 0.0, 1.0 / math.sqrt(
            self.embedding.shape[1]), generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        rows = (F.embedding(tokens, self.embedding) if self.split is None
                else self.split.lookup(tokens, self.embedding))
        return rows if self.dtype is None else rows.to(self.dtype)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the last axis, with Flax's defaults
    (``momentum=0.99``, ``epsilon=1e-5``, ``use_fast_variance=True``,
    ``force_float32_reductions=True``).

    In training mode (``module.train()``, Flax's ``use_running_average=
    False``) the statistics are taken over every axis but the last, in f32:
    ``mean = E[x]``, ``var = max(0, E[x²] − E[x]²)`` — the *biased* batch
    variance — and the running buffers move as ``momentum · running +
    (1 − momentum) · batch``. ``torch.nn.BatchNorm1d`` differs on both
    counts (its momentum weighs the batch by 0.1 and it stores the unbiased
    variance). In eval mode the running buffers are used. Either way the
    output is ``(x − mean) · (rsqrt(var + ε) · scale) + bias`` in f32, cast
    to ``dtype`` once at the end. Parameters ``scale``/``bias`` and buffers
    ``mean``/``var`` are f32 and named as Flax names them.

    With ``global_stats`` (set on a gang rank's model by
    :func:`~raydp_tpu_torch.parallel.gang.sync_batchnorm`) the statistics
    are the GLOBAL batch's, as the reference's gang takes them over its
    sharded batch: each rank sums ``Σx``, ``Σx²`` and its row count, one
    differentiable all-reduce over ``stats_group`` (the ranks that feed
    different rows) sums them (its backward sums the gradients too), and
    Flax's formula follows; the running buffers then move alike on every
    rank. While ``row_mask`` is set (a padded train batch's validity mask,
    :func:`~raydp_tpu_torch.parallel.gang.batch_rows`) the sums and the
    count take only the real rows."""

    #: take the statistics across ``stats_group``'s ranks
    global_stats = False
    stats_group = None
    #: the 0/1 mask of the rows the statistics count (None: every row)
    row_mask = None

    def __init__(self, features: int, dtype: Optional[torch.dtype],
                 device: torch.device, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            axes = tuple(range(x.ndim - 1))
            if self.global_stats:
                mean, var = self._gang_statistics(xf, axes)
            else:
                mean = xf.mean(axes)
                var = torch.clamp_min((xf * xf).mean(axes) - mean * mean,
                                      0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean) * mul + self.bias
        return y.to(self.dtype or x.dtype)

    def _gang_statistics(self, xf: torch.Tensor, axes: tuple):
        """The global batch's ``(mean, var)`` across ``stats_group``."""
        mask = self.row_mask
        if mask is None:
            # a fill, not a host copy: a CUDA graph can capture it
            rows = xf.new_full((1,), float(xf[..., 0].numel()))
            xs = xf
        else:
            m = mask.to(xf.dtype).reshape(mask.shape + (1,) * (
                xf.ndim - mask.ndim))
            rows = (m.sum() * (xf[..., 0].numel() // mask.numel()))[None]
            xs = xf * m
        sums = gang.all_reduce_grad(torch.cat(
            [xs.sum(axes), (xs * xf).sum(axes), rows]), self.stats_group)
        f = xf.shape[-1]
        count = sums[2 * f]
        mean = sums[:f] / count
        var = torch.clamp_min(sums[f:2 * f] / count - mean * mean, 0.0)
        return mean, var
