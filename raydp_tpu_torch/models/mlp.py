"""MLP models for tabular regression/classification — port of
:mod:`raydp_tpu.models.mlp`.

``NYCTaxiModel`` is the NYC-taxi fare network: Dense 256→128→64→16→1, each
hidden Dense followed by ReLU and then BatchNorm. Parameters keep Flax's
names and layout (``Dense_i.kernel`` ``[in, out]``, ``Dense_i.bias``,
``BatchNorm_i.scale``/``bias``, buffers ``BatchNorm_i.mean``/``var``), so
:func:`raydp_tpu_torch.models.convert.mlp_variables_from_flax` carries a
Flax init across. Flax infers the input width at ``init``; a torch module
is built with it (``in_features``).

Training vs inference is the module's mode (``model.train()`` /
``model.eval()``), Flax's ``train`` argument.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.models.layers import BatchNorm, _Dense, init_parameters


class MLP(nn.Module):
    """Generic MLP: hidden widths, optional batch-norm, single head. Returns
    float32 ``[..., out_features]``.

    ``dtype`` is the compute dtype (None: the input's); parameters are f32.
    They are created on ``device`` (default CUDA; raises without it) and
    drawn from ``generator`` (default: a generator on ``device`` seeded with
    0) with Flax's default initializers."""

    def __init__(self, in_features: int, features: Sequence[int],
                 out_features: int = 1, use_batch_norm: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.num_hidden = len(features)
        self.use_batch_norm = use_batch_norm
        width = in_features
        for i, out in enumerate(features):
            self.add_module(f"Dense_{i}", _Dense((width,), (out,), dtype,
                                                 device, use_bias=True))
            if use_batch_norm:
                self.add_module(f"BatchNorm_{i}",
                                BatchNorm(out, dtype, device))
            width = out
        self.add_module(f"Dense_{self.num_hidden}",
                        _Dense((width,), (out_features,), dtype, device,
                               use_bias=True))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype)
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            if self.use_batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
        x = getattr(self, f"Dense_{self.num_hidden}")(x)
        return x.float()


def NYCTaxiModel(in_features: int, dtype: Optional[torch.dtype] = None,
                 use_batch_norm: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> MLP:
    """The NYC-taxi fare network (256-128-64-16-1, ReLU then BatchNorm)."""
    return MLP(in_features, (256, 128, 64, 16), out_features=1,
               use_batch_norm=use_batch_norm, dtype=dtype, device=device,
               generator=generator)
