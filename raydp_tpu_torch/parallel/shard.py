"""The sharded train state and the collectives of a sharded step.

The collectives along a dim (:func:`gather_dim`, :func:`reduce_scatter_dim`)
and the neighbour exchange (:func:`ppermute`, ``lax.ppermute``: the ring's
K/V rotation and the pipeline's stage hop) come first, then their
autograd forms.

The reference places each leaf of its train state under a
``NamedSharding`` and lets GSPMD insert the collectives. The port's rank
holds one device, so :class:`ShardedModule` holds, for every parameter of a
module, the shard its spec (:func:`~raydp_tpu_torch.parallel.mesh.
param_sharding_rules`) gives this rank's mesh position, as the module's own
``nn.Parameter`` under its own name: the optimizer built over
``parameters()`` keeps its state (Adam's moments) shard for shard, and
``state_dict()`` holds the shards under the unsharded names. Its forward
runs the module through ``torch.func.functional_call`` with the parameters
it needs whole gathered first, each through an autograd function whose
backward hands the shard its gradient:

- a dim split over ``fsdp`` (or ``data``) is gathered before the use and
  its gradient reduce-scattered after the backward: those ranks saw
  different rows, so their gradients sum;
- a dim split over ``expert`` or ``tensor`` that the module does not
  compute split is gathered too, and its gradient is the rank's own block:
  those ranks saw the same rows and hold the same gradient;
- the ``tensor`` split of a :class:`~raydp_tpu_torch.models.layers._Dense`
  kernel and the ``expert`` or ``tensor`` split of an
  :class:`~raydp_tpu_torch.models.layers._Embed` table stay split: the
  layer computes on its shard (:class:`TensorSplit`). A column split
  (an output dim) sums its input's gradient over the tensor ranks and
  gathers its output; a row split (an input dim) takes its block of the
  input and sums its output over the tensor ranks, Megatron's ``f`` and
  ``g``. A module's ``tensor_pairs()`` names column layers whose split
  output feeds a row layer directly (q/k/v into o, gate/up into down): the
  pair keeps the activations split between them, so attention runs on
  the rank's own heads. A table split by rows looks up the ids in its
  block, zero elsewhere, and sums the rows over the ranks.

A leaf split over ``stage`` on its leading dim (a
:class:`~raydp_tpu_torch.train.torch_estimator.PipelineModel`'s
``stage_stack``) stays split: the rank applies its stage's run of layers
(:mod:`raydp_tpu_torch.parallel.pipeline`).

After the backward, :meth:`ShardedModule.reduce_grads` sums each gradient
over the batch axes (data, fsdp, and the module's ``token_axes``) its spec
does not split — what the gather's backward has not summed yet — with one
collective per group. An
explicit spec that does not divide its dim raises, as the reference's
``device_put`` does; the role policy never produces one.

Nothing here reads a device value on the host or branches on one: every
shape, block and peer is the mesh's, known on the host, so a sharded step
can be captured into a CUDA graph under ``nccl`` with its collectives
inside (``tests/test_torch_sharded_capture.py`` guards it on the CPU).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch.parallel import gang
from raydp_tpu_torch.parallel.mesh import (
    Mesh, _axes_of, data_axes, param_sharding_rules, shard_index,
)

#: the axes over which ranks feed different rows: gradients sum over them
BATCH_AXES = ("data", "fsdp")


# ---- collectives along one dim of a tensor ----------------------------------

def _timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its host wall added to
    :data:`~raydp_tpu_torch.parallel.gang.COMM` (under ``nccl`` the
    enqueue only)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    gang.COMM.seconds += time.perf_counter() - t0
    return out


def _block(t: torch.Tensor, dim: int, axes: Sequence[str], mesh: Mesh,
           rank: Optional[int] = None) -> torch.Tensor:
    """The block of ``t``'s ``dim`` that ``rank`` (this one) holds when the
    dim is split over ``axes``."""
    n = t.shape[dim] // mesh.extent(axes)
    b = mesh.block(axes) if rank is None else mesh.block_of(rank, axes)
    return t.narrow(dim, b * n, n)


def gather_dim(t: torch.Tensor, dim: int, axes: Sequence[str],
               mesh: Mesh) -> torch.Tensor:
    """The whole of ``t``'s ``dim`` split over ``axes``: every member's
    block, in block order."""
    import torch.distributed as dist

    group = mesh.group(axes)
    members = mesh.members(axes)
    if group is None or len(members) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in members]
    _timed(dist.all_gather, parts, t, group=group)
    order = sorted(range(len(members)),
                   key=lambda i: mesh.block_of(members[i], axes))
    return torch.cat([parts[i] for i in order], dim=dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, axes: Sequence[str],
                       mesh: Mesh) -> torch.Tensor:
    """This rank's block of the sum of ``t`` over ``axes``' ranks."""
    import torch.distributed as dist

    group = mesh.group(axes)
    members = mesh.members(axes)
    if group is None or len(members) == 1:
        return _block(t, dim, axes, mesh)
    inputs = [_block(t, dim, axes, mesh, r).contiguous() for r in members]
    out = torch.empty_like(inputs[0])
    _timed(dist.reduce_scatter, out, inputs, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, axes: Sequence[str],
                   mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over ``axes``' ranks (a new tensor)."""
    return gang.all_reduce_(t.contiguous().clone(), mesh.group(axes))


def exchange(tensors: Sequence[torch.Tensor], axis: str, mesh: Mesh,
             shift: int = 1) -> List[torch.Tensor]:
    """Send each of ``tensors`` to the rank ``shift`` places on along
    ``axis`` and receive the same shapes from the rank ``shift`` places
    back, cyclically — one ``batch_isend_irecv`` for all of them. Under
    ``gloo`` a CUDA tensor travels through the host (gloo's point-to-point
    moves host memory); under ``nccl`` it stays on the card. A size-1 axis
    (or a whole turn) hands the tensors back."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if n == 1 or shift % n == 0:
        return list(tensors)
    members = mesh.members((axis,))
    me = mesh.coords[axis]
    dst, src = members[(me + shift) % n], members[(me - shift) % n]
    group = mesh.group((axis,))
    staged = any(t.is_cuda for t in tensors) \
        and dist.get_backend(group) == "gloo"
    sends = [(t.cpu() if staged else t).contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends] + \
        [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    t0 = time.perf_counter()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    gang.COMM.seconds += time.perf_counter() - t0
    gang.COMM.sent_bytes += sum(t.numel() * t.element_size() for t in sends)
    if staged:
        recvs = [r.to(t.device) for r, t in zip(recvs, tensors)]
    return recvs


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` by a cyclic shift along one axis; its transpose is
    the opposite shift."""

    @staticmethod
    def forward(ctx, t, axis, mesh, shift):
        ctx.axis, ctx.mesh, ctx.shift = axis, mesh, shift
        return exchange([t], axis, mesh, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return (exchange([g], ctx.axis, ctx.mesh, -ctx.shift)[0], None,
                None, None)


def ppermute(t: torch.Tensor, axis: str, mesh: Mesh,
             shift: int = 1) -> torch.Tensor:
    """The neighbour exchange (``lax.ppermute`` with the permutation
    ``i -> i + shift``): rank ``i`` along ``axis`` sends ``t`` to
    ``i + shift`` and returns what ``i - shift`` sent, cyclically.
    Differentiable: the backward is the same exchange with ``-shift``.
    Every rank of the axis must call it, in the same order; a size-1 axis
    is the identity."""
    if mesh.shape[axis] == 1:
        return t
    return _PPermute.apply(t, axis, mesh, shift)


class _GatherParam(torch.autograd.Function):
    """A parameter's dim gathered for its use; the backward hands the shard
    its gradient: reduce-scattered over the batch axes of the split (ranks
    that saw different rows), the rank's own block over the others."""

    @staticmethod
    def forward(ctx, t, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return gather_dim(t, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        dim, axes, mesh = ctx.dim, ctx.axes, ctx.mesh
        summed = tuple(a for a in axes if a in BATCH_AXES)
        if summed == tuple(axes):
            return reduce_scatter_dim(g, dim, axes, mesh), None, None, None
        if summed:
            g = all_reduce_sum(g, summed, mesh)
        return (_block(g, dim, axes, mesh).contiguous(), None, None, None)


class _CopyToSplit(torch.autograd.Function):
    """Megatron's ``f``: the forward passes a whole activation into a split
    product; the backward sums its gradient over the split's ranks (each
    computed its part)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return all_reduce_sum(g, s.axes, s.mesh), None


class _ReduceFromSplit(torch.autograd.Function):
    """Megatron's ``g``: the forward sums the ranks' partial results; the
    backward passes the (replicated) gradient through."""

    @staticmethod
    def forward(ctx, y, split):
        return all_reduce_sum(y, split.axes, split.mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromSplit(torch.autograd.Function):
    """A split activation gathered whole along ``split.pos``; the backward
    takes the rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return gather_dim(y, y.ndim + split.pos, split.axes, split.mesh)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return _block(g, g.ndim + s.pos, s.axes, s.mesh).contiguous(), None


class _ScatterToSplit(torch.autograd.Function):
    """A whole activation cut to the rank's block along ``split.pos``; the
    backward gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _block(x, x.ndim + split.pos, split.axes,
                      split.mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return gather_dim(g, g.ndim + s.pos, s.axes, s.mesh), None


class _Along:
    """The layout the split autograd functions read: ``axes``, ``mesh`` and
    ``pos``, the split dim counted from the end."""

    def __init__(self, axes: Sequence[str], mesh: Mesh, pos: int = -1):
        self.axes, self.mesh, self.pos = tuple(axes), mesh, pos


def copy_to(t: torch.Tensor, axes: Sequence[str], mesh: Mesh
            ) -> torch.Tensor:
    """``t``, replicated over ``axes``, used by ranks that compute different
    parts: the backward sums its gradient over those ranks."""
    return _CopyToSplit.apply(t, _Along(axes, mesh))


def sum_partials(t: torch.Tensor, axes: Sequence[str], mesh: Mesh
                 ) -> torch.Tensor:
    """The sum of the ranks' partial ``t`` over ``axes``; the backward hands
    each partial the (replicated) gradient."""
    return _ReduceFromSplit.apply(t, _Along(axes, mesh))


def scatter_to(t: torch.Tensor, dim: int, axes: Sequence[str], mesh: Mesh
               ) -> torch.Tensor:
    """The rank's block of ``t``'s ``dim`` split over ``axes``; the backward
    gathers the blocks' gradients."""
    return _ScatterToSplit.apply(t, _Along(axes, mesh, dim - t.ndim))


def gather_from(t: torch.Tensor, dim: int, axes: Sequence[str], mesh: Mesh
                ) -> torch.Tensor:
    """The blocks of ``t``'s ``dim`` split over ``axes``, gathered whole;
    the backward takes the rank's block of the (replicated) gradient."""
    return _GatherFromSplit.apply(t, _Along(axes, mesh, dim - t.ndim))


class TensorSplit:
    """How a layer computes on its shard (set as the layer's ``split``).

    ``kind``: ``column`` (a Dense kernel split on an output dim), ``row``
    (on an input dim), ``rows`` (an embedding table's rows) or
    ``features`` (its columns). ``pos`` is the split dim of the activation
    it touches, counted from the end. ``gather_output`` / ``scatter_input``
    are cleared on the members of a column → row pair, whose activations
    stay split between them."""

    def __init__(self, mesh: Mesh, axis: str, kind: str, pos: int):
        self.mesh, self.axes, self.kind, self.pos = mesh, (axis,), kind, pos
        self.gather_output = True
        self.scatter_input = True

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "column":
            return _CopyToSplit.apply(x, self)
        if self.kind == "row" and self.scatter_input:
            return _ScatterToSplit.apply(x, self)
        return x

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "column" and self.gather_output:
            return _GatherFromSplit.apply(y, self)
        if self.kind == "row":
            return _ReduceFromSplit.apply(y, self)
        return y

    def lookup(self, tokens: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
        if self.kind == "features":
            return _GatherFromSplit.apply(F.embedding(tokens, table), self)
        n = table.shape[0]
        local = tokens - self.mesh.block(self.axes) * n
        valid = (local >= 0) & (local < n)
        rows = F.embedding(torch.where(valid, local, 0), table)
        return _ReduceFromSplit.apply(
            rows * valid.unsqueeze(-1).to(rows.dtype), self)


def _compute_split(owner: nn.Module, attr: str, spec: tuple
                   ) -> Optional[Tuple[int, str]]:
    """``(dim, axis)`` of the parameter's split that its layer computes on,
    or None (every split is gathered for the use)."""
    from raydp_tpu_torch.models.layers import _Dense, _Embed

    if spec and spec[0] == "stage":
        # a pipeline's stage-stacked leaf: the stage applies its own run
        return 0, "stage"
    if isinstance(owner, _Dense) and attr == "kernel":
        for d, entry in enumerate(spec):
            if entry == "tensor":
                return d, "tensor"
    if isinstance(owner, _Embed):
        if spec and spec[0] in ("expert", "tensor"):
            return 0, spec[0]
        if len(spec) > 1 and spec[1] == "tensor":
            return 1, "tensor"
    return None


def _split_of(owner: nn.Module, dim: int, axis: str, mesh: Mesh
              ) -> TensorSplit:
    from raydp_tpu_torch.models.layers import _Dense

    if isinstance(owner, _Dense):
        ndim = owner.kernel.ndim
        if dim >= owner.n_in:
            return TensorSplit(mesh, axis, "column", dim - ndim)
        return TensorSplit(mesh, axis, "row", dim - owner.n_in)
    return TensorSplit(mesh, axis, "rows" if dim == 0 else "features", -1)


def _pair_splits(module: nn.Module) -> None:
    """Keep the activations split between the column and row layers each
    module's ``tensor_pairs()`` names, where both are split on the same
    axis along the same activation dim and the columns carry no bias."""
    for m in module.modules():
        pairs = getattr(m, "tensor_pairs", None)
        if pairs is None:
            continue
        for columns, row in pairs():
            cols = [getattr(m, c) for c in columns]
            r = getattr(m, row)
            rs = r.split
            if rs is None or rs.kind != "row" or any(
                    c.split is None or c.split.kind != "column"
                    or c.bias is not None or c.split.axes != rs.axes
                    or c.split.pos != rs.pos for c in cols):
                continue
            for c in cols:
                c.split.gather_output = False
            rs.scatter_input = False


class _ParamPlan:
    """One parameter's placement: its global shape and spec, the dims
    gathered for its use (``(dim, axes)``), and the axes its spec splits."""

    def __init__(self, shape, spec, gathered, axes):
        self.shape, self.spec = tuple(shape), spec
        self.gathered, self.axes = gathered, axes


class ShardedModule(nn.Module):
    """``module`` with its parameters held as this rank's shards under
    ``mesh`` (see the module docstring). ``specs`` maps each parameter's
    name to its spec; ``state_dict()`` and ``load_state_dict()`` are the
    wrapped module's, so a checkpoint keeps the unsharded names."""

    def __init__(self, module: nn.Module, mesh: Mesh,
                 rules: Optional[List[Tuple[str, tuple]]] = None):
        super().__init__()
        self.module = module
        self.mesh = mesh
        self.specs: Dict[str, tuple] = param_sharding_rules(mesh, rules)(
            module)
        self._plans: Dict[str, _ParamPlan] = {}
        for name, p in list(module.named_parameters()):
            spec = self.specs[name]
            index = shard_index(p.shape, spec, mesh)  # raises when uneven
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            computed = _compute_split(owner, attr, spec)
            if computed is not None and computed[1] != "stage":
                owner.split = _split_of(owner, *computed, mesh)
            gathered = [(d, _axes_of(e)) for d, e in enumerate(spec)
                        if e is not None
                        and (computed is None or d != computed[0])]
            self._plans[name] = _ParamPlan(
                p.shape, spec, gathered,
                {a for e in spec for a in _axes_of(e)})
            with torch.no_grad():
                shard = p[index].clone()
            setattr(owner, attr, nn.Parameter(shard,
                                              requires_grad=p.requires_grad))
        _pair_splits(module)

    def forward(self, *args, **kwargs):
        from torch.func import functional_call

        whole = {}
        for name, p in self.module.named_parameters():
            t = p
            for dim, axes in self._plans[name].gathered:
                t = _GatherParam.apply(t, dim, axes, self.mesh)
            if t is not p:
                whole[name] = t
        return functional_call(self.module, whole, args, kwargs)

    def state_dict(self, *args, **kwargs):
        return self.module.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        return self.module.load_state_dict(state_dict, strict, assign)

    def reduce_grads(self) -> None:
        """Sum each gradient over the batch axes its spec does not split
        (one flat all-reduce per group of parameters): the data axes, and
        the axes the module names in ``token_axes`` (a sequence-split LM's
        ``seq``: its ranks compute different tokens)."""
        axes = data_axes(self.mesh) + tuple(
            getattr(self.module, "token_axes", ()))
        batch = [a for a in dict.fromkeys(axes) if self.mesh.shape[a] > 1]
        by_rest: Dict[tuple, list] = {}
        for name, p in self.module.named_parameters():
            if p.requires_grad:
                rest = tuple(a for a in batch
                             if a not in self._plans[name].axes)
                by_rest.setdefault(rest, []).append(p)
        for rest, params in by_rest.items():
            if rest:
                gang.all_reduce_grads(params, self.mesh.group(rest))

    # ---- the state's layout: checkpoints and the gathered state ------------
    def tensor_specs(self, optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> Dict[str, tuple]:
        """The spec of every tensor of the train state's ``state_dict`` —
        ``{"model": ..., "optimizer": ...}`` — by its checkpoint key path:
        each parameter's, each optimizer-state tensor shaped like its
        parameter's shard inherits the parameter's, everything else
        (buffers, step counters) is replicated."""
        from raydp_tpu_torch.train.checkpoint import _keystr

        specs = {_keystr(("model", n)): self.specs[n]
                 for n, _ in self.module.named_parameters()}
        if optimizer is not None:
            names = {id(p): n for n, p in self.module.named_parameters()}
            order = [p for g in optimizer.param_groups for p in g["params"]]
            for i, p in enumerate(order):
                for k, v in optimizer.state.get(p, {}).items():
                    if isinstance(v, torch.Tensor) and v.shape == p.shape:
                        specs[_keystr(("optimizer", "state", i, k))] = \
                            self.specs[names[id(p)]]
        return specs

    def gather_state(self, state: dict, optimizer=None) -> dict:
        """``state`` (the train state's ``state_dict``) with every sharded
        tensor gathered whole — a collective: every rank calls it."""
        from raydp_tpu_torch.train.checkpoint import map_tensors

        specs = self.tensor_specs(optimizer)

        def whole(key, t):
            for dim, entry in enumerate(specs.get(key, ())):
                if entry is not None:
                    t = gather_dim(t, dim, _axes_of(entry), self.mesh)
            return t

        return map_tensors(whole, state)

    def local_shapes(self) -> Dict[str, tuple]:
        return {n: tuple(p.shape) for n, p in self.module.named_parameters()}


def placement(spec: tuple, local_shape: Sequence[int], mesh: Mesh):
    """A sharded tensor's place in the checkpoint: ``(global shape,
    [[start, stop], ...], writes)``, where ``writes`` picks one rank of
    those that hold the same shard (the reference's ``replica_id == 0``:
    coordinate 0 on every axis the spec does not split)."""
    shape = list(local_shape)
    for d, entry in enumerate(spec):
        shape[d] *= mesh.extent(_axes_of(entry))
    index = shard_index(shape, spec, mesh)
    split = {a for e in spec for a in _axes_of(e)}
    writes = all(c == 0 for a, c in mesh.coords.items() if a not in split)
    return (tuple(shape), [[s.start, s.stop] for s in index], writes)
