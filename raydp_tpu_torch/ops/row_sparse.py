"""Row-sparse table update: ``W_t[id] += alpha_t · Σ g`` over the rows a
step looked up, for many tables at once.

The step's lookups of all tables are packed into one int64 key each,
``(t << id_bits) | id``, and sorted once, stably (``torch.sort``: one
radix sort for every table, in place of one a table). A CUDA kernel
written for Hopper (``raydp_tpu_torch/csrc/row_sparse.cu``) then sums each
run of equal keys in sorted order, which is the lookups' original order
within a run, and updates each distinct row once; a long run (a hot id) is
cut into chunks of 64 lookups whose partial sums are added in chunk order,
so the result is the same bits on every run. No TPU kernel is replaced: the JAX
package hands the tables' dense gradient to optax.

Dispatch is by where the tensors lie: CPU tensors take the plain PyTorch
version (:func:`_apply_plain`), CUDA tensors launch the kernel or raise;
the kernel takes the tables :func:`takes` accepts (the estimator puts no
others on the row-sparse path).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from raydp_tpu_torch.device import require_cuda
from raydp_tpu_torch.ops import _build

#: the kernel's compiled limits (csrc/row_sparse.cu)
MAX_TABLES = 64
CHUNK = 64
#: the rows a table may have (an int64 key holds the id and the table)
MAX_ROWS = 1 << 56

#: calls of the kernel pair from Python: an eager step's, or the one a
#: graph's capture records (a replay launches the pair again without
#: counting here; ``chip_smoke.py`` counts the launches a fit makes on the
#: device trace)
LAUNCHES = 0


class _Tables(ctypes.Structure):
    """``Tables`` of ``csrc/row_sparse.cu``, field for field."""

    _fields_ = [("weight", ctypes.c_void_p * MAX_TABLES),
                ("values", ctypes.c_void_p * MAX_TABLES),
                ("offset", ctypes.c_longlong * MAX_TABLES),
                ("stride", ctypes.c_longlong * MAX_TABLES),
                ("alpha", ctypes.c_float * MAX_TABLES)]


def apply_rows(weights: Sequence[torch.Tensor],
               indices: Sequence[torch.Tensor],
               values: Sequence[torch.Tensor],
               alphas: Sequence[float]) -> None:
    """For each table ``t``: ``weights[t][i] += alphas[t] · Σ values[t][j]``
    over the lookups ``j`` with ``indices[t][j] == i``, in place. A table
    is ``[rows, dim]`` f32, its ids ``[nnz]`` int64 and its values
    ``[nnz, dim]`` f32 (a sparse COO gradient's ``_indices()[0]`` and
    ``_values()``). Rows not looked up do not move."""
    if not weights:
        return
    if weights[0].device.type == "cpu":
        _apply_plain(weights, indices, values, alphas)
    else:
        _apply_cuda(weights, indices, values, alphas)


def _apply_plain(weights, indices, values, alphas) -> None:
    """Plain version: each table's distinct ids, each id's rows summed in
    their original order (``index_add_`` into zeros), each distinct row
    updated once."""
    with torch.no_grad():
        for w, ids, vals, alpha in zip(weights, indices, values, alphas):
            rows, inverse = torch.unique(ids, return_inverse=True)
            sums = vals.new_zeros((len(rows), vals.shape[1]))
            sums.index_add_(0, inverse, vals)
            w.index_add_(0, rows, sums, alpha=alpha)


def _rounding_bound(exact, indices, values, alphas) -> List[torch.Tensor]:
    """How far an f32 update may lie from ``exact`` (the update computed in
    f64), elementwise, for any order of the sums (f64, one tensor a
    table). With ``u = 2^-24``, f32's unit roundoff: a run of ``n`` rows
    sums to within ``γ(n − 1) · Σ|g|`` of its exact sum (``γ(k) = k·u /
    (1 − k·u)``); ``alpha`` rounded to f32 and its product each err by at
    most ``u · |alpha| · Σ|g|``; the update rounds by at most ``u · |W'|``.
    The f64 reference errs by the same terms at ``2^-53``, added once
    more."""
    u, u64 = 2.0 ** -24, 2.0 ** -53
    out = []
    for w, ids, vals, alpha in zip(exact, indices, values, alphas):
        bound = (u + u64) * w.detach().abs().double()
        rows, inverse, counts = torch.unique(ids, return_inverse=True,
                                             return_counts=True)
        abs_sums = torch.zeros((len(rows), vals.shape[1]), dtype=torch.float64,
                               device=vals.device)
        abs_sums.index_add_(0, inverse, vals.abs().double())
        k = (counts - 1).double() * u
        terms = k / (1 - k) + 2 * u + (counts + 1).double() * u64
        bound[rows] += abs(alpha) * terms[:, None] * abs_sums
        out.append(bound)
    return out


def _bind(lib: ctypes.CDLL):
    fn = lib.raydp_row_sparse_apply
    fn.argtypes = [ctypes.POINTER(_Tables), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    """The entry of the library built from ``row_sparse.cu``."""
    return _bind(_build.load("row_sparse"))


def takes(weights: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel takes these tables: at most :data:`MAX_TABLES`
    f32 ``[rows, dim]`` tables of one ``dim``, a multiple of 4 (a lane moves
    a float4), each of at most :data:`MAX_ROWS` rows."""
    dims = {tuple(w.shape[1:]) for w in weights}
    return (0 < len(weights) <= MAX_TABLES and len(dims) == 1
            and len(next(iter(dims))) == 1 and weights[0].shape[1] % 4 == 0
            and all(w.dtype == torch.float32 and w.shape[0] <= MAX_ROWS
                    for w in weights))


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """``v`` if its rows start 16-byte aligned with unit column stride,
    else a contiguous copy (a fresh allocation is aligned)."""
    if v.stride(1) == 1 and v.stride(0) % 4 == 0 and v.data_ptr() % 16 == 0:
        return v
    return v.clone(memory_format=torch.contiguous_format)


def _check(weights, indices, values) -> torch.device:
    """Raise unless the kernel takes these tables (:func:`takes`), their
    ids and values; return their device."""
    if not takes(weights) or not all(
            w.is_contiguous() and w.data_ptr() % 16 == 0 for w in weights):
        raise ValueError(f"row-sparse kernel takes 1 to {MAX_TABLES} "
                         f"contiguous f32 [rows, dim] tables of one dim, a "
                         f"multiple of 4, got "
                         f"{[(tuple(w.shape), w.dtype) for w in weights]}")
    dim = weights[0].shape[1]
    for ids, vals in zip(indices, values):
        if ids.dtype != torch.int64 or ids.dim() != 1:
            raise ValueError(f"row-sparse kernel takes [nnz] int64 ids, got "
                             f"{ids.dtype} {tuple(ids.shape)}")
        if vals.dtype != torch.float32 or tuple(vals.shape) != (len(ids),
                                                                dim):
            raise ValueError(f"row-sparse kernel takes [nnz, {dim}] f32 "
                             f"values, got {vals.dtype} "
                             f"{tuple(vals.shape)}")
    return require_cuda("row-sparse kernel", *weights, *indices, *values)


def _apply_cuda(weights, indices, values, alphas) -> None:
    """One stable sort of the tables' packed keys (:func:`_prepare`), then
    the kernel pair (:func:`_run`)."""
    global LAUNCHES
    args = _prepare(weights, indices, values, alphas)
    if args is not None:
        _run(*args)
        LAUNCHES += 1


def _prepare(weights, indices, values, alphas) -> Optional[tuple]:
    """The kernel pair's arguments: the tables' ``Tables``, their packed
    int64 keys sorted stably with the flat positions, the id bits, the
    width, the values they point at, and the scratch (allocated with
    ``torch.empty``; nothing synchronises). None without lookups."""
    device = _check(weights, indices, values)
    dim = weights[0].shape[1]
    n = sum(len(i) for i in indices)
    if n == 0:
        return None
    id_bits = max(1, max(w.shape[0] - 1 for w in weights).bit_length())
    values = [_aligned(v) for v in values]
    keys = torch.empty(n, dtype=torch.int64, device=device)
    tabs = _Tables()
    offset = 0
    for t, (w, i, v, a) in enumerate(zip(weights, indices, values, alphas)):
        torch.add(i, t << id_bits, out=keys[offset:offset + len(i)])
        tabs.weight[t] = w.data_ptr()
        tabs.values[t] = v.data_ptr()
        tabs.offset[t] = offset
        tabs.stride[t] = v.stride(0)
        tabs.alpha[t] = float(a)
        offset += len(i)
    keys, perm = torch.sort(keys, stable=True)
    partials = torch.empty(-(-n // CHUNK) * 2 * dim, dtype=torch.float32,
                           device=device)
    return tabs, keys, perm, id_bits, dim, values, partials


def _run(tabs, keys, perm, id_bits: int, dim: int, values,
         partials) -> None:
    """Launch the kernel pair on the current stream; raise on a refused
    launch. ``values`` holds the rows ``tabs`` points at alive."""
    with torch.cuda.device(keys.device):
        err = _entry()(ctypes.byref(tabs), keys.data_ptr(), perm.data_ptr(),
                       len(keys), id_bits, dim, partials.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"row-sparse kernel launch failed: CUDA error "
                           f"{err} at {len(keys)} lookups, dim {dim}")
