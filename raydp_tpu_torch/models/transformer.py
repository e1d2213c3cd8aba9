"""Decoder-only Transformer LM — port of :mod:`raydp_tpu.models.transformer`:
the model, ``lm_loss`` and ``lm_loss_fused``, forward and backward (training
runs ``torch.optim.Adam`` / ``AdamW`` over ``model.parameters()``, as the
reference runs optax over its params).

Same architecture and numerics as the reference: pre-RMSNorm blocks, rotary
position embeddings, SwiGLU MLP; ``dtype`` sets the activations while the
parameters stay float32. Parameters keep the reference's Flax layout and
names (``block_0.attn.q.kernel`` is ``params["block_0"]["attn"]["q"]
["kernel"]``), so :func:`raydp_tpu_torch.models.convert.transformer_params_from_flax`
carries weights across unchanged. Where the reference's dtype rules are
subtle the port copies them:

- a ``Dense`` casts its input and its f32 kernel to ``dtype`` before the
  product (Flax ``promote_dtype``);
- ``RMSNorm`` rounds to the input's type and then multiplies by an f32
  scale, so under bf16 its output is float32;
- RoPE angles are float32, the result is cast back to the input's type;
- the materialized head runs in ``dtype`` and casts the logits to float32,
  while :func:`lm_loss_fused` multiplies the float32 hidden states by the
  float32 kernel.

Attention: ``"ring"`` (exact attention over a sequence split across the
``seq`` axis of ``mesh``: :func:`~raydp_tpu_torch.ops.ring_attention.
ring_attention`), ``"flash"`` (the Hopper kernel on CUDA, its plain version
on the CPU), ``"dense"`` (reference path), ``"auto"`` (ring when ``mesh``
has a ``seq`` extent above 1, else flash on CUDA, dense on the CPU).

Under a ``mesh`` with a ``seq`` extent above 1 every rank of the axis feeds
its block of each sequence (``tokens[:, i·T/n:(i+1)·T/n]`` on seq rank
``i``) and gets its block of the logits: RoPE takes the tokens' global
positions, attention is the ring, and :func:`lm_loss` /
:func:`lm_loss_fused` with ``mesh=`` take the next rank's first token as the
last position's target and divide by the global count (the data axes'
rows too), which the reference's GSPMD gives implicitly. The ranks compute
different tokens, so a replicated parameter's gradient sums over ``seq``
(``token_axes``, read by
:meth:`~raydp_tpu_torch.parallel.shard.ShardedModule.reduce_grads`).
:func:`transformer_param_rules` splits the model over a mesh's ``tensor``
axis (:mod:`raydp_tpu_torch.parallel.shard`); with ``seq`` each (seq,
tensor) rank rings only its own heads.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.models.layers import _Dense, _Embed, init_parameters
from raydp_tpu_torch.ops.flash_attention import flash_attention
from raydp_tpu_torch.ops.ring_attention import dense_attention, ring_attention
from raydp_tpu_torch.parallel.mesh import axis_index, data_axes, seq_extent
from raydp_tpu_torch.parallel.shard import ppermute, sum_partials

_ATTENTION_KINDS = ("auto", "ring", "flash", "dense")


def _seq_split(mesh) -> bool:
    """Whether ``mesh`` splits the sequence (a ``seq`` extent above 1)."""
    return mesh is not None and seq_extent(mesh) > 1


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     base: float = 10000.0) -> torch.Tensor:
    """Apply RoPE. x: [B, T, H, D]; positions: [T] global token positions."""
    d_half = x.shape[-1] // 2
    freqs = torch.from_numpy(1.0 / (base ** (np.arange(0, d_half) / d_half)))
    freqs = freqs.to(device=x.device, dtype=torch.float32)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]  # [T, D/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device: DeviceLike = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim,
                                             device=resolve_device(device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        # bf16 x times an f32 tensor promotes to f32, as in the reference
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attention: str = "auto",
                 mesh: Any = None, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        if attention not in _ATTENTION_KINDS:
            raise ValueError(f"attention must be one of {_ATTENTION_KINDS}, "
                             f"got {attention!r}")
        if attention == "ring" and mesh is None:
            raise ValueError("attention='ring' needs the mesh whose seq axis "
                             "splits the sequence")
        if attention in ("flash", "dense") and _seq_split(mesh):
            raise ValueError(
                f"attention={attention!r} on {mesh!r} would attend within "
                "the rank's block of the sequence only: use 'ring' or 'auto'")
        self.attention = attention
        self.mesh = mesh
        head_dim = dim // num_heads
        for name in ("q", "k", "v"):
            self.add_module(name, _Dense((dim,), (num_heads, head_dim),
                                         dtype, device))
        self.o = _Dense((num_heads, head_dim), (dim,), dtype, device)

    def tensor_pairs(self):
        """The column layers whose head-split outputs feed the row layer
        directly: under :func:`transformer_param_rules` a tensor rank's
        attention runs on its own heads."""
        return [(("q", "k", "v"), "o")]

    def _dispatch(self, device: torch.device) -> str:
        if self.attention != "auto":
            return self.attention
        if _seq_split(self.mesh):
            return "ring"
        return "flash" if device.type == "cuda" else "dense"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        q, k, v = self.q(x), self.k(x), self.v(x)
        # global positions: seq rank i holds tokens [i·t, (i+1)·t)
        start = axis_index(self.mesh, "seq") * t if _seq_split(self.mesh) \
            else 0
        positions = torch.arange(start, start + t, device=x.device)
        q = rotary_embedding(q, positions)
        k = rotary_embedding(k, positions)
        kind = self._dispatch(x.device)
        if kind == "ring":
            out = ring_attention(q, k, v, self.mesh, causal=True)
        elif kind == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = dense_attention(q, k, v, causal=True)
        return self.o(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 attention: str = "auto", mesh: Any = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        hidden = mlp_ratio * dim
        self.ln1 = RMSNorm(dim, device=device)
        self.attn = Attention(dim, num_heads, attention, mesh, dtype, device)
        self.ln2 = RMSNorm(dim, device=device)
        self.gate = _Dense((dim,), (hidden,), dtype, device)
        self.up = _Dense((dim,), (hidden,), dtype, device)
        self.down = _Dense((hidden,), (dim,), dtype, device)

    def tensor_pairs(self):
        """The MLP's column layers (gate, up), whose hidden-split outputs
        feed the row layer (down) directly."""
        return [(("gate", "up"), "down")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        gate = self.gate(h)
        # SwiGLU. jax.nn.silu lowers to x * (1 / (1 + exp(-x))) with every op
        # rounded to dtype; torch.sigmoid rounds once and differs under bf16
        silu = gate * (1 / (1 + torch.exp(-gate)))
        return x + self.down(silu * self.up(h))


class TransformerLM(nn.Module):
    """Causal LM: tokens [B, T] (int) → logits [B, T, vocab] float32.

    Parameters are created on ``device`` (default CUDA; raises without it)
    and drawn from ``generator`` (default: a generator on ``device`` seeded
    with 0) with the reference's Flax initializers; the values differ from a
    JAX init, so parity tests load converted Flax weights instead.

    With a ``mesh`` that splits the sequence, each seq rank passes its
    block of the tokens [B, T/n] (see the module docstring)."""

    def __init__(self, vocab_size: int, dim: int = 256, num_heads: int = 4,
                 num_layers: int = 2, mlp_ratio: int = 4,
                 attention: str = "auto", mesh: Any = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        #: the mesh axes over which the ranks compute different tokens
        self.token_axes = ("seq",) if _seq_split(mesh) else ()
        self.embed = _Embed(vocab_size, dim, dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", Block(
                dim, num_heads, mlp_ratio, attention, mesh, dtype, device))
        self.ln_f = RMSNorm(dim, device=device)
        self.lm_head = _Dense((dim,), (vocab_size,), dtype, device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_parameters(self, generator)

    def forward(self, tokens: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        """``return_hidden=True`` yields the post-norm hidden states [B,T,D]
        for :func:`lm_loss_fused`; ``self.lm_head(hidden).float()`` is then
        exactly the logits this call would return."""
        x = self.embed(tokens)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.lm_head(x).float()


def transformer_param_rules(axis: str = "tensor"):
    """Megatron-style tensor-parallel sharding rules for
    :class:`TransformerLM` (for ``TorchEstimator(param_rules=...)`` /
    ``param_sharding_rules``), the reference's as written.

    Column-parallel up-projections (q/k/v over heads, gate/up over hidden)
    and row-parallel down-projections (o, down): one all-reduce per
    attention block and one per MLP block, the classic split, and a tensor
    rank's attention runs on its own heads. Embedding and lm_head split the
    feature/vocab dim."""
    return [
        ("attn/q/kernel", (None, axis, None)),
        ("attn/k/kernel", (None, axis, None)),
        ("attn/v/kernel", (None, axis, None)),
        ("attn/o/kernel", (axis, None, None)),
        ("gate/kernel", (None, axis)),
        ("up/kernel", (None, axis)),
        ("down/kernel", (axis, None)),
        ("embed/embedding", (None, axis)),
        ("lm_head/kernel", (None, axis)),
    ]


def _row_axes(mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` over which ranks hold different tokens of the
    batch: the data axes and ``seq``, where above 1."""
    if mesh is None:
        return ()
    return tuple(a for a in (*data_axes(mesh), "seq") if mesh.shape[a] > 1)


def _next_targets(tokens: torch.Tensor, mesh) -> Tuple[torch.Tensor, int]:
    """Each local position's next-token target [B, T_local] and how many
    positions score: under a sequence split the last position's target is
    the next seq rank's first token, and the last rank's final position has
    none."""
    if not _seq_split(mesh):
        return tokens[:, 1:].long(), tokens.shape[1] - 1
    first_of_next = ppermute(tokens[:, :1].contiguous(), "seq", mesh,
                             shift=-1)
    targets = torch.cat([tokens[:, 1:], first_of_next], dim=1).long()
    last = axis_index(mesh, "seq") == seq_extent(mesh) - 1
    return targets, tokens.shape[1] - int(last)


def _global_count(tokens: torch.Tensor, mesh) -> int:
    """B·(T−1) of the global batch the rank holds a block of."""
    b, t = tokens.shape
    return b * mesh.extent(data_axes(mesh)) * (t * seq_extent(mesh) - 1)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy (shifted); tokens [B, T], logits [B, T, V].

    With a ``mesh`` whose data or seq axes split the batch, tokens and
    logits are the rank's block (rows over the data axes, positions over
    ``seq``) and the result is the GLOBAL loss, the mean over the global
    batch's B·(T−1) positions, on every rank; each rank's backward gives
    its own positions' share of the gradient (sum them over those axes, as
    :meth:`~raydp_tpu_torch.parallel.shard.ShardedModule.reduce_grads`
    does)."""
    vocab = logits.shape[-1]
    axes = _row_axes(mesh)
    if not axes:
        return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                               tokens[:, 1:].reshape(-1).long())
    targets, n = _next_targets(tokens, mesh)
    total = F.cross_entropy(logits[:, :n].reshape(-1, vocab),
                            targets[:, :n].reshape(-1), reduction="sum")
    return sum_partials(total / _global_count(tokens, mesh), axes, mesh)


def _chunk_ce_sum(x: torch.Tensor, kernel: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy of one chunk: hidden [B, C, D] @ kernel [D, V]."""
    logits = (x @ kernel).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1), reduction="sum")


def lm_loss_fused(hidden: torch.Tensor, lm_head_kernel: torch.Tensor,
                  tokens: torch.Tensor, chunk: int = 1024,
                  remat: bool = True, mesh=None) -> torch.Tensor:
    """Next-token cross entropy with the lm_head applied per T-chunk, so the
    [B, T, V] float32 logits never exist at once (peak B×chunk×V).

    With ``remat`` (the reference's ``jax.checkpoint``) each chunk runs under
    ``torch.utils.checkpoint``: the backward recomputes the chunk's logits
    instead of keeping them, so training holds B×chunk×V at a time for one
    extra head matmul. ``remat=False`` keeps every chunk's logits for the
    backward. The last chunk may be shorter; the reference pads it and masks
    the padding out, which has the same value and gradient.
    ``hidden`` [B, T, D] from ``model(tokens, return_hidden=True)``;
    ``lm_head_kernel`` [D, V] = ``model.lm_head.kernel``. ``mesh`` as in
    :func:`lm_loss`."""
    axes = _row_axes(mesh)
    y, n = _next_targets(tokens, mesh)
    count = _global_count(tokens, mesh) if axes \
        else tokens.shape[0] * n
    x, y = hidden[:, :n], y[:, :n]
    kernel = lm_head_kernel.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, n, chunk):
        args = (x[:, start:start + chunk], kernel, y[:, start:start + chunk])
        if remat:
            total = total + checkpoint(
                _chunk_ce_sum, *args, use_reentrant=False)
        else:
            total = total + _chunk_ce_sum(*args)
    if axes:
        return sum_partials(total / count, axes, mesh)
    return total / count
