"""The mesh and the partition specs — port of :mod:`raydp_tpu.parallel.mesh`.

Axis convention (sizes multiply to the number of ranks), the reference's:

- ``stage``   — pipeline parallel (:mod:`raydp_tpu_torch.parallel.pipeline`);
- ``data``    — data parallel: batch dim split, params replicated, grads
  summed;
- ``fsdp``    — params and optimizer state split over this axis, gathered
  before use; the batch is split over it too;
- ``expert``  — expert parallel (DLRM's embedding rows);
- ``seq``     — sequence parallel (ring attention,
  :mod:`raydp_tpu_torch.ops.ring_attention`);
- ``tensor``  — tensor parallel (Megatron-style column/row splits).

The reference runs one process over many devices and GSPMD inserts the
collectives from the shardings. Torch runs one device a process, so the
port's mesh spans the ranks of a ``torch.distributed`` process group:
:func:`make_mesh` lays the world out row-major over :data:`AXES` (rank
``r`` sits at ``np.unravel_index(r, sizes)``), builds the
``torch.distributed.device_mesh.DeviceMesh`` over it, and one process group
for every combination of axes of extent > 1, which the sharded step
(:mod:`raydp_tpu_torch.parallel.shard`) calls its collectives on. A process
without a process group has a world of 1.

A partition spec stays in the reference's vocabulary: a tuple with one
entry per dimension, each an axis name, a tuple of names or ``None`` —
``PartitionSpec`` as a plain tuple (``()`` is replicated). Specs are
computed from axis sizes alone, so :func:`param_sharding_rules` also takes
a plain ``dict`` of sizes and needs no process group. Ported from the
reference's module: :data:`AXES`, :class:`MeshSpec` (as it is),
:func:`make_mesh`, :func:`data_axes`, :func:`batch_sharding`,
:func:`seq_extent`, :func:`stage_extent`, :func:`replicated`,
:func:`axis_index` (``lax.axis_index``),
:func:`param_sharding_rules` and :func:`shard_params`. ``vary_manual`` is
not: it marks a value as varying over ``shard_map``'s manual axes, a JAX
type-system shim with nothing to mark in eager torch.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXES = ("stage", "data", "fsdp", "expert", "seq", "tensor")

#: a dimension's entry in a partition spec: an axis, a tuple of axes, None
SpecEntry = Union[None, str, Tuple[str, ...]]


@dataclass
class MeshSpec:
    """Sizes per axis; ``data=-1`` absorbs all remaining devices."""

    data: int = -1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    stage: int = 1

    def sizes(self, num_devices: int) -> Dict[str, int]:
        fixed = {"fsdp": self.fsdp, "expert": self.expert, "seq": self.seq,
                 "tensor": self.tensor, "stage": self.stage}
        known = int(np.prod(list(fixed.values())))
        data = self.data
        if data == -1:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by "
                    f"stage*fsdp*expert*seq*tensor={known}")
            data = num_devices // known
        total = data * known
        if total != num_devices:
            raise ValueError(
                f"mesh {dict(data=data, **fixed)} needs {total} devices, "
                f"have {num_devices}")
        return {"data": data, **fixed}


def as_mesh_spec(spec: Optional[Union[MeshSpec, Dict[str, int]]]
                 ) -> MeshSpec:
    """A :class:`MeshSpec` from one, a plain axis-size dict
    (``dict(fsdp=4, tensor=2)``) or None (``MeshSpec()``)."""
    if isinstance(spec, dict):
        unknown = set(spec) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"have {AXES}")
        return MeshSpec(**spec)
    return spec or MeshSpec()


def _axes_of(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A mesh over the ranks of a process group, one device a rank.

    ``shape`` maps every axis of :data:`AXES` to its extent (the
    reference's ``mesh.shape``), ``axis_names`` is :data:`AXES`, ``rank``
    is this process's rank and ``coords`` its position on each axis.
    ``device_mesh`` is the ``DeviceMesh`` :func:`make_mesh` built over the
    world (None for a world of 1). A mesh made directly from sizes
    (``Mesh(dict(fsdp=2), rank=1)``) describes a layout without a process
    group: specs, shard shapes and row ranges, but no collective."""

    axis_names = AXES

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 device_mesh=None, groups: Optional[dict] = None):
        unknown = set(sizes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"have {AXES}")
        self.shape = {a: int(sizes.get(a, 1)) for a in AXES}
        self.size = int(np.prod(self.dims))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = self.coords_of(rank)
        self.device_mesh = device_mesh
        self._groups = groups or {}

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in AXES)

    def __repr__(self) -> str:
        sized = {a: n for a, n in self.shape.items() if n > 1}
        return f"Mesh({sized or 'world 1'}, rank={self.rank})"

    def coords_of(self, rank: int) -> Dict[str, int]:
        return dict(zip(AXES, (int(c) for c in
                               np.unravel_index(rank, self.dims))))

    def extent(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def block_of(self, rank: int, axes: Sequence[str]) -> int:
        """The block ``rank`` holds of a dimension split over ``axes`` (in
        the entry's order, major to minor)."""
        coords = self.coords_of(rank)
        block = 0
        for a in axes:
            block = block * self.shape[a] + coords[a]
        return block

    def block(self, axes: Sequence[str]) -> int:
        return self.block_of(self.rank, axes)

    def members(self, axes: Sequence[str]) -> List[int]:
        """The ranks that differ from this one only along ``axes``, in
        rank order (the order of a process group's ranks)."""
        mine = self.coords
        return [r for r in range(self.size)
                if all(c == mine[a] for a, c in self.coords_of(r).items()
                       if a not in axes)]

    def group(self, axes: Sequence[str]):
        """The process group of :meth:`members` for ``axes``: the world's
        own group when they span the world (a world of 1 inside a process
        group included); None when no other rank is a member and no process
        group spans this one (the collective is the identity). Only a mesh
        from :func:`make_mesh` has groups."""
        key = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        if key in self._groups:
            return self._groups[key]
        if not key:
            return None
        if key not in self._groups:
            raise RuntimeError(
                f"{self!r} has no process group over {key}: build the mesh "
                "with make_mesh inside the ranks")
        return self._groups[key]


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(spec: Optional[Union[MeshSpec, Dict[str, int]]] = None,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``spec`` over the current process group's world (a
    world of 1 without a process group).

    ``spec`` may be a :class:`MeshSpec` or a plain axis-size dict
    (``dict(fsdp=4, tensor=2)``); sizes that do not multiply to the world
    raise the reference's ``ValueError``. Over a world of more than one
    rank every rank must call it, in the same order: it builds the
    ``DeviceMesh`` (``device_type``: ``"cuda"`` when CUDA is available,
    else ``"cpu"``) and a process group for every combination of the axes
    of extent > 1 (the world's own group for the combination that spans
    it)."""
    import torch.distributed as dist

    world, rank = _world()
    sizes = as_mesh_spec(spec).sizes(world)
    if world == 1:
        # inside a process group of one rank, the step's sums still run
        # over it (a graphed chain captures them, as on more ranks)
        return Mesh(sizes, groups={(): dist.group.WORLD}
                    if dist.is_available() and dist.is_initialized()
                    else None)
    from torch.distributed.device_mesh import DeviceMesh

    layout = Mesh(sizes, rank)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    device_mesh = DeviceMesh(device_type, torch.arange(world).reshape(
        layout.dims), mesh_dim_names=AXES)
    split = [a for a in AXES if sizes[a] > 1]
    groups = {}
    for n in range(1, len(split) + 1):
        for key in itertools.combinations(split, n):
            if layout.extent(key) == world:
                groups[key] = dist.group.WORLD
                continue
            # every rank creates every group of the partition, in order
            seen, mine = set(), None
            for r in range(world):
                ranks = tuple(Mesh(sizes, r).members(key))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if rank in ranks:
                    mine = g
            groups[key] = mine
    return Mesh(sizes, rank, device_mesh, groups)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Every axis's extent, from a :class:`Mesh` or a plain size dict."""
    if isinstance(mesh, Mesh):
        return dict(mesh.shape)
    unknown = set(mesh) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; have {AXES}")
    return {a: int(mesh.get(a, 1)) for a in AXES}


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch dimension is sharded over: data + fsdp (fsdp shards the
    batch too — params gather per layer, grads reduce-scatter)."""
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("data", "fsdp") if sizes[a] > 1) or ("data",)


def seq_extent(mesh) -> int:
    """Size of the mesh's ``seq`` axis — the gate every seq-sharding call
    site checks before extending specs past dim 0."""
    return mesh_sizes(mesh)["seq"]


def stage_extent(mesh) -> int:
    """Size of the mesh's ``stage`` axis — the gate the estimator checks
    before routing training through a pipeline schedule."""
    return mesh_sizes(mesh)["stage"]


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index`` under
    ``shard_map``): which block of a dim split over ``axis`` it holds."""
    return mesh.coords[axis]


def batch_sharding(mesh, extra_batch_axes: Sequence[str] = (),
                   seq: bool = False) -> tuple:
    """The spec of a batch-leading array: dim 0 over the data axes (plus
    any ``extra_batch_axes`` folded into the same dim); ``seq=True`` under
    a >1 ``seq`` extent adds dim 1 over ``seq`` (the sequence dim of a
    long-context batch, or the feature dim of a tabular one)."""
    axes = tuple(data_axes(mesh)) + tuple(extra_batch_axes)
    entry = axes if len(axes) > 1 else axes[0]
    if seq and seq_extent(mesh) > 1:
        return (entry, "seq")
    return (entry,)


def replicated(mesh) -> tuple:
    """The replicated spec (``PartitionSpec()``)."""
    mesh_sizes(mesh)
    return ()


def shard_shape(shape: Sequence[int], spec: tuple, mesh) -> Tuple[int, ...]:
    """The local shape of a ``shape`` array under ``spec``; raises
    ``ValueError`` when an axis does not divide its dimension (the
    reference's ``device_put`` refuses an uneven shard)."""
    sizes = mesh_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if out[d] % n:
            raise ValueError(
                f"spec {spec} splits dim {d} of shape {tuple(shape)} over "
                f"{axes} (extent {n}), which does not divide it")
        out[d] //= n
    return tuple(out)


def shard_index(shape: Sequence[int], spec: tuple, mesh
                ) -> Tuple[slice, ...]:
    """The slices of a ``shape`` array that ``mesh``'s rank holds under
    ``spec`` (every dimension, ``slice(0, n)`` where unsplit)."""
    local = shard_shape(shape, spec, mesh)
    index = []
    for d in range(len(shape)):
        axes = _axes_of(spec[d]) if d < len(spec) else ()
        start = mesh.block(axes) * local[d] if axes else 0
        index.append(slice(start, start + local[d]))
    return tuple(index)


def param_sharding_rules(mesh, rules: Optional[List[Tuple[str, tuple]]]
                         = None):
    """Compile path-pattern → spec rules into a function from a tree to
    the specs of its leaves.

    ``rules`` is an ordered list of ``(substring, spec_tuple)``; the first
    matching substring of the parameter path wins. Leaves no rule matches go
    to the role policy (:mod:`raydp_tpu_torch.parallel.roles` — embeddings
    over fsdp×tensor, kernels over fsdp/tensor by dimension, biases
    replicated; opt out with ``RDT_TRAIN_SHARD_ROLES=0`` for the legacy
    fallback: replicated, or fsdp on the largest divisible dim when an
    ``fsdp`` axis is present).

    ``mesh`` is a :class:`Mesh` or a plain axis-size dict. The returned
    function takes an ``nn.Module`` (its named parameters), a mapping of
    paths to tensors or shapes, or a pair ``(module, optimizer)`` (then the
    optimizer's state too, each tensor under its parameter's path:
    ``optimizer/state/<param path>/<name>``), and returns ``{path: spec}``
    with the tree's own paths."""
    from raydp_tpu_torch import knobs
    from raydp_tpu_torch.parallel.roles import role_partition_spec

    sizes = mesh_sizes(mesh)
    fsdp = sizes["fsdp"]
    use_roles = bool(knobs.get("RDT_TRAIN_SHARD_ROLES"))

    def spec_for(path: str, shape: Tuple[int, ...]) -> tuple:
        # the port's dotted names (block_0.attn.q.kernel) read as the
        # reference's slashed paths, so its rules match as written
        p = path.replace(".", "/")
        if rules:
            for pat, spec in rules:
                if pat in p:
                    return tuple(spec)
        if use_roles:
            return role_partition_spec(sizes, p, shape)
        if fsdp > 1 and shape:
            # shard the largest dim divisible by the fsdp axis
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % fsdp == 0 and shape[i] > 1:
                    spec: list = [None] * len(shape)
                    spec[i] = "fsdp"
                    return tuple(spec)
        return ()

    def specs_of(tree) -> Dict[str, tuple]:
        return {path: spec_for(path, shape)
                for path, shape in _leaf_shapes(tree)}

    return specs_of


def _leaf_shapes(tree):
    """``(path, shape)`` of each leaf of a module, a mapping of tensors or
    shapes, or a ``(module, optimizer)`` pair."""
    from collections.abc import Mapping

    from torch import nn

    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield name, tuple(p.shape)
    elif isinstance(tree, tuple) and len(tree) == 2 \
            and isinstance(tree[0], nn.Module):
        module, optimizer = tree
        yield from _leaf_shapes(module)
        names = {id(p): n for n, p in module.named_parameters()}
        for p, state in optimizer.state.items():
            for k, v in state.items():
                if isinstance(v, torch.Tensor):
                    yield (f"optimizer/state/{names[id(p)]}/{k}",
                           tuple(v.shape))
    elif isinstance(tree, Mapping):
        for path, leaf in tree.items():
            yield path, tuple(getattr(leaf, "shape", leaf))
    else:
        raise TypeError(f"cannot read the leaves of {type(tree).__name__}")


def shard_params(params, mesh: Mesh, rules=None) -> Dict[str, torch.Tensor]:
    """The shards of ``params`` (a module or a mapping of paths to tensors)
    that ``mesh``'s rank holds under the rules; raises ``ValueError`` where
    an explicit spec does not divide its dimension, as the reference's
    ``device_put`` does."""
    from torch import nn

    specs = param_sharding_rules(mesh, rules)(params)
    tensors = dict(params.named_parameters()) \
        if isinstance(params, nn.Module) else params
    return {path: t[shard_index(t.shape, specs[path], mesh)]
            for path, t in tensors.items()}
