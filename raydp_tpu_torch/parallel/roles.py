"""Parameter roles, the partition spec each role wants, and the remat
policy over them — port of :mod:`raydp_tpu.parallel.roles`.

Copied as they are: the role vocabulary (:func:`classify_param`,
:data:`STAGE_TOKENS`), the remat grammar (:data:`REMAT_MODES`,
:data:`REMAT_ROLES`, :func:`parse_remat_policy`, with the same
``ValueError`` texts) and :func:`remat_mode_for_role`.
:func:`role_partition_spec` is the reference's policy on axis sizes (a
:class:`~raydp_tpu_torch.parallel.mesh.Mesh` or a plain dict), returning
the spec as a plain tuple; the port keeps the Flax layout and names, so
its specs are the reference's leaf for leaf:

- embedding tables (path names an embedding, 2-D): rows over ``fsdp`` ×
  ``tensor`` when the product divides, else whichever axis does;
- kernels (≥ 2-D): ``tensor`` on the output (last) dim, ``fsdp`` on the
  largest remaining divisible dim;
- biases, norm scales, scalars (≤ 1-D): replicated.

An axis splits a dim only when its extent is > 1 and divides it, so the
policy never raises. Ported: :func:`segment_role`,
:func:`describe_roles` and :func:`addressable_nbytes` walk a module's named
parameters (and an optimizer's state) instead of a pytree — on a sharded
rank those tensors are its local shards, so :func:`addressable_nbytes`
counts only them — and :func:`apply_remat` wraps a forward in
``torch.utils.checkpoint.checkpoint`` instead of ``jax.checkpoint``:

- ``dots`` saves the outputs of the matrix products (``aten.mm``,
  ``addmm``, ``bmm``, ``baddbmm``: what ``jax.checkpoint_policies.
  checkpoint_dots`` saves) and recomputes the rest, through
  ``create_selective_checkpoint_contexts``;
- ``full`` saves nothing but the region's inputs;
- ``none`` returns the forward untouched.

A JAX forward is pure, so recomputing it cannot move a BatchNorm's running
statistics; a torch module may update its buffers in place in its forward
(the port's BatchNorm, ``torch.nn.BatchNorm1d``, any user module). The
recompute of a region wrapped here therefore snapshots the buffers of every
module passed to the region and restores them when the recompute ends,
however it ends, so a step moves them once under every mode.
Checkpointing does not stash the RNG state (``preserve_rng_state=False``): no model of the port
draws random numbers in its forward, and reading the CUDA generator would
break the capture of the step into a CUDA graph.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

#: path substrings that mark an embedding table (lowercased match). "embed"
#: catches the port's ``embedding_<i>.embedding`` and the conventional
#: ``embedding`` / ``embed_tokens`` / ``token_embedder`` spellings.
EMBEDDING_TOKENS = ("embed",)

#: path substrings that mark a stage-stacked leaf (a pipeline's per-layer
#: parameters stacked on a leading axis): the leading dim shards over
#: ``stage``, the rest classifies as the unstacked leaf would
STAGE_TOKENS = ("stage_stack",)

REPLICATED = "replicated"
EMBEDDING = "embedding"
KERNEL = "kernel"


def classify_param(path: str, shape: Tuple[int, ...]) -> str:
    """The role of one leaf: ``embedding`` | ``kernel`` | ``replicated``.

    Works on parameter paths AND their optimizer-state mirrors; scalars
    (step counts) and 1-D leaves (biases, norm scales) replicate.
    """
    ndim = len(shape)
    if ndim <= 1:
        return REPLICATED
    low = path.lower()
    if ndim == 2 and any(tok in low for tok in EMBEDDING_TOKENS):
        return EMBEDDING
    return KERNEL


def _divides(dim: int, size: int) -> bool:
    return size > 1 and dim > 1 and dim % size == 0


def role_partition_spec(mesh, path: str, shape: Tuple[int, ...]) -> tuple:
    """The spec the leaf's role wants on ``mesh`` (a mesh or its axis
    sizes); total: degrades to replicated whenever an axis is absent, of
    size 1, or does not divide.

    Stage-stacked leaves (path contains a :data:`STAGE_TOKENS` token) put
    the ``stage`` axis on their leading dim when it divides, then classify
    the inner shape through the ordinary policy. Optimizer-state mirrors
    inherit their parameter's spec: their paths carry the same names."""
    from raydp_tpu_torch.parallel.mesh import mesh_sizes

    sizes = mesh_sizes(mesh)
    low = path.lower()
    if any(tok in low for tok in STAGE_TOKENS) and len(shape) >= 1:
        head = "stage" if _divides(shape[0], sizes["stage"]) else None
        inner_path = low
        for tok in STAGE_TOKENS:
            inner_path = inner_path.replace(tok, "")
        return (head, *role_partition_spec(sizes, inner_path,
                                           tuple(shape[1:])))

    fsdp, tensor = sizes["fsdp"], sizes["tensor"]
    role = classify_param(path, shape)
    if role == REPLICATED or (fsdp <= 1 and tensor <= 1):
        return ()

    spec: list = [None] * len(shape)
    if role == EMBEDDING:
        # rows (vocab) over the fsdp×tensor product when it divides; else
        # whichever single axis does; embedding dim stays replicated
        rows = shape[0]
        if _divides(rows, fsdp * tensor) and fsdp > 1 and tensor > 1:
            spec[0] = ("fsdp", "tensor")
        elif _divides(rows, fsdp):
            spec[0] = "fsdp"
        elif _divides(rows, tensor):
            spec[0] = "tensor"
        return tuple(spec)

    # kernels: tensor on the output (last) dim, fsdp on the largest
    # remaining divisible dim (deterministic tie-break: lower index wins)
    if _divides(shape[-1], tensor):
        spec[-1] = "tensor"
    if fsdp > 1:
        order = sorted(range(len(shape)), key=lambda i: (-shape[i], i))
        for i in order:
            if spec[i] is None and _divides(shape[i], fsdp):
                spec[i] = "fsdp"
                break
    return tuple(spec)


#: the remat policy vocabulary (RDT_TRAIN_REMAT / TorchEstimator remat=)
REMAT_MODES = ("none", "dots", "full")

#: the roles a remat policy may key on: the param-role vocabulary plus
#: ``default`` (the fallback mode — a bare mode string is sugar for
#: ``default=<mode>``).
REMAT_ROLES = (REPLICATED, EMBEDDING, KERNEL, "default")


def parse_remat_policy(spec: str) -> Dict[str, str]:
    """``RDT_TRAIN_REMAT`` / ``remat=`` grammar → a total role→mode map.

    Accepts either a bare mode (``"dots"`` — the default policy for every
    role) or a comma-separated ``role=mode`` list
    (``"embedding=none,kernel=dots,default=full"``). Roles come from
    :data:`REMAT_ROLES`, modes from :data:`REMAT_MODES`; anything else
    raises ``ValueError``, before any step runs. The returned dict always
    carries a ``default`` entry (``none`` unless the spec set one)."""
    spec = (spec or "none").strip()
    policy: Dict[str, str] = {}
    if "=" not in spec:
        if spec not in REMAT_MODES:
            raise ValueError(
                f"unknown remat mode {spec!r}: expected one of {REMAT_MODES} "
                f"or a 'role=mode,...' policy over roles {REMAT_ROLES}")
        policy["default"] = spec
        return policy
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad remat policy entry {part!r} in {spec!r}: expected "
                f"role=mode")
        role, _, mode = (p.strip() for p in part.partition("="))
        if role not in REMAT_ROLES:
            raise ValueError(
                f"unknown remat role {role!r} in {spec!r}: expected one of "
                f"{REMAT_ROLES}")
        if mode not in REMAT_MODES:
            raise ValueError(
                f"unknown remat mode {mode!r} for role {role!r} in {spec!r}: "
                f"expected one of {REMAT_MODES}")
        if role in policy:
            raise ValueError(f"duplicate remat role {role!r} in {spec!r}")
        policy[role] = mode
    policy.setdefault("default", "none")
    return policy


def remat_mode_for_role(policy: Dict[str, str], role: str) -> str:
    """The mode a parsed policy assigns to one param role (``default``
    fallback — the policy map is total by construction)."""
    return policy.get(role, policy["default"])


def _named_tensors(tree, prefix: str = "", buffers: bool = False
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor of ``tree``: a module's named
    parameters (and, with ``buffers``, its buffers; ``.`` in their names
    read as ``/``, the pytree path separator), an optimizer's state, or any
    nesting of mappings and sequences of these."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        named = list(tree.named_parameters())
        if buffers:
            named += list(tree.named_buffers())
        for name, t in named:
            yield prefix + name.replace(".", "/"), t
    elif isinstance(tree, torch.optim.Optimizer):
        for i, per_param in enumerate(tree.state.values()):
            yield from _named_tensors(per_param, f"{prefix}state/{i}/")
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _named_tensors(v, f"{prefix}{k}/", buffers)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_tensors(v, f"{prefix}{i}/", buffers)


def segment_role(tree) -> str:
    """The dominant param role of a module (or a mapping of named tensors),
    weighted by bytes — the role whose parameters own most of the memory
    decides which remat mode the forward runs under, exactly how the
    reference picks it from the params' pytree. Empty trees classify
    ``replicated``."""
    weights: Dict[str, int] = {}
    for path, t in _named_tensors(tree):
        role = classify_param(path.rstrip("/"), tuple(t.shape))
        weights[role] = weights.get(role, 0) + t.numel() * t.element_size()
    if not weights:
        return REPLICATED
    return max(weights.items(), key=lambda kv: (kv[1], kv[0]))[0]


def describe_roles(tree) -> dict:
    """Debug/bench helper: path → (role, shape) for every tensor of
    ``tree`` (a module's parameters, an optimizer's state, or nestings)."""
    out = {}
    for path, t in _named_tensors(tree):
        shape = tuple(t.shape)
        out[path] = (classify_param(path, shape), shape)
    return out


def addressable_nbytes(tree) -> int:
    """Bytes of the tensors of ``tree`` held by this process: a module's
    parameters and buffers, an optimizer's state, or any nesting of them
    (each tensor counted once). On a sharded rank those are its local
    shards; on one device, what the reference's replicated leaves
    occupy."""
    seen = set()
    total = 0
    for _, t in _named_tensors(tree, buffers=True):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


# ---- remat ------------------------------------------------------------------

@contextlib.contextmanager
def _buffers_kept(modules, inner):
    """``inner`` (a recompute context), after which the buffers of
    ``modules`` hold what they held when the recompute began. ``finally``:
    torch stops a recompute early, by an exception, once it has what the
    backward needs."""
    buffers = [b for m in modules for b in m.buffers()]
    saved = [b.clone() for b in buffers]
    try:
        with inner:
            yield
    finally:
        with torch.no_grad():
            for b, s in zip(buffers, saved):
                b.copy_(s)


#: the products ``dots`` saves: what XLA's dot_general lowers to here
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_dots)


def _full_contexts():
    return contextlib.nullcontext(), contextlib.nullcontext()


def apply_remat(fn, mode: str):
    """``fn`` wrapped in ``torch.utils.checkpoint.checkpoint`` under
    ``mode``'s policy (``none`` returns ``fn`` untouched). Applied to the
    train-step forward so the whole per-microbatch activation set obeys the
    policy. The buffers of the modules among the arguments leave a
    recompute as they entered it."""
    if mode not in REMAT_MODES:
        raise ValueError(
            f"unknown remat mode {mode!r}: expected one of {REMAT_MODES}")
    if mode == "none":
        return fn
    contexts = _dots_contexts if mode == "dots" else _full_contexts

    def remat_fn(*args, **kwargs):
        from torch.utils.checkpoint import checkpoint

        modules = [a for a in (*args, *kwargs.values())
                   if isinstance(a, nn.Module)]

        def context_fn():
            forward, recompute = contexts()
            return forward, _buffers_kept(modules, recompute)

        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn,
                          **kwargs)

    return remat_fn
