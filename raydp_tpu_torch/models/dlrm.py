"""DLRM (Criteo click-through) — port of :mod:`raydp_tpu.models.dlrm`.

13 dense features → bottom MLP; 26 categorical features → one embedding
table each; the pairwise dot interaction of the (1 + 26) vectors, flattened
to its strict lower triangle and padded with one zero column; top MLP to one
logit (trained with BCE-with-logits). Parameters keep Flax's names and
layout (bottom ``Dense_0..``, ``embedding_i.embedding``, top ``Dense_*``
continuing the count), so
:func:`raydp_tpu_torch.models.convert.dlrm_params_from_flax` carries a Flax
init across. Dense products, the gathers and the interaction are plain
torch calls: on the TPU they are XLA-generated, not Pallas kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.models.layers import _Dense, _Embed, init_parameters


def _tril_indices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    rows = np.array([i for i in range(n) for _ in range(i)], dtype=np.int32)
    cols = np.array([j for i in range(n) for j in range(i)], dtype=np.int32)
    return rows, cols


class DotInteraction(nn.Module):
    """Pairwise dot products among ``num_vectors`` feature vectors,
    concatenated with the bottom-MLP output and one zero pad column. The
    tril indices live on the module's device (a non-persistent buffer), so a
    forward copies nothing from the host."""

    def __init__(self, num_vectors: int, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        rows, cols = _tril_indices(num_vectors)
        self.register_buffer("rows", torch.from_numpy(rows).long().to(device),
                             persistent=False)
        self.register_buffer("cols", torch.from_numpy(cols).long().to(device),
                             persistent=False)

    def forward(self, vectors: torch.Tensor,
                bottom_out: torch.Tensor) -> torch.Tensor:
        # vectors: [B, n, D]; bottom_out: [B, D]
        inter = torch.bmm(vectors, vectors.transpose(1, 2))    # [B, n, n]
        flat = inter[:, self.rows, self.cols]                   # [B, n(n-1)/2]
        pad = flat.new_zeros((flat.shape[0], 1))
        return torch.cat([bottom_out, flat, pad], dim=1)


class DLRM(nn.Module):
    """``inputs = {"dense": [B, num_dense] float, "sparse": [B, num_tables]
    int}`` → float32 logits ``[B, top_mlp[-1]]``. ``bottom_mlp[-1]`` must
    equal ``embedding_dim``. ``dtype`` is the compute dtype (None: the dense
    input's); parameters are f32, created on ``device`` (default CUDA;
    raises without it) and drawn from ``generator`` (default: a generator
    on ``device`` seeded with 0) with Flax's default initializers."""

    def __init__(self, categorical_sizes: Sequence[int], num_dense: int = 13,
                 embedding_dim: int = 32,
                 bottom_mlp: Sequence[int] = (512, 128, 32),
                 top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1),
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if bottom_mlp[-1] != embedding_dim:
            raise ValueError(f"bottom_mlp[-1]={bottom_mlp[-1]} must equal "
                             f"embedding_dim={embedding_dim}")
        self.dtype = dtype
        self.num_tables = len(categorical_sizes)
        self.num_bottom = len(bottom_mlp)
        self.num_top = len(top_mlp)
        width = num_dense
        for i, out in enumerate(bottom_mlp):
            self.add_module(f"Dense_{i}", _Dense((width,), (out,), dtype,
                                                 device, use_bias=True))
            width = out
        for i, vocab in enumerate(categorical_sizes):
            self.add_module(f"embedding_{i}",
                            _Embed(vocab, embedding_dim, dtype, device))
        n = 1 + self.num_tables
        self.DotInteraction_0 = DotInteraction(n, device)
        width = embedding_dim + n * (n - 1) // 2 + 1
        for j, out in enumerate(top_mlp):
            self.add_module(f"Dense_{self.num_bottom + j}",
                            _Dense((width,), (out,), dtype, device,
                                   use_bias=True))
            width = out
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_parameters(self, generator)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        dense, sparse = inputs["dense"], inputs["sparse"]
        x = dense.to(self.dtype or dense.dtype)
        for i in range(self.num_bottom):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        bottom_out = x                                   # [B, D]
        embs = [getattr(self, f"embedding_{i}")(sparse[:, i])
                for i in range(self.num_tables)]
        vectors = torch.stack([bottom_out] + embs, dim=1)  # [B, 1+T, D]
        z = self.DotInteraction_0(vectors, bottom_out)
        for j in range(self.num_top):
            z = getattr(self, f"Dense_{self.num_bottom + j}")(z)
            if j < self.num_top - 1:
                z = torch.relu(z)
        return z.float()


def dlrm_param_rules(axis: str = "expert"):
    """Sharding rules: embedding tables row-sharded over ``axis``; MLPs
    replicated (pass to TorchEstimator(param_rules=...)). A rank then holds
    its block of every table's rows and looks up the ids in it
    (:class:`~raydp_tpu_torch.parallel.shard.TensorSplit`)."""
    return [("embedding", (axis, None))]


def criteo_batch_preprocessor(num_dense: int = 13):
    """Split the estimator's flat batch into DLRM's dense/sparse dict: the
    first ``num_dense`` feature columns as float32, the rest as int64
    indices (label ``_c0``, dense ``_c1.._c13``, categorical
    ``_c14.._c39``)."""

    def prep(batch):
        feats = batch["features"]
        dense = feats[:, :num_dense].float()
        sparse = feats[:, num_dense:].long()
        return {"dense": dense, "sparse": sparse}, batch["label"]

    return prep
