"""Initial weights, drawn from the seed on the device, shared by the
program's model (written into its parameters) and the reference.

A leaf is ``(name, shape, init)`` with ``init`` one of ``("normal", std)``,
``("uniform", bound)`` or ``("const", value)``. Its rows are drawn in
chunks of :data:`CHUNK_ROWS`, each from a generator seeded by the run's
seed, the leaf's index and the chunk's index, so any chunk can be drawn
again alone (the program's readout and the reference each redraw the rows
they need without holding a second copy of a table).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

CHUNK_ROWS = 1 << 18

Leaf = Tuple[str, Tuple[int, ...], Tuple[str, float]]

_MASK = (1 << 64) - 1


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def chunk_seed(seed: int, leaf: int, chunk: int) -> int:
    """The generator seed of one chunk of one leaf (below 2**63)."""
    h = _splitmix(seed & _MASK)
    h = _splitmix(h ^ leaf)
    return _splitmix(h ^ (chunk << 20)) >> 1


def chunks(shape: Sequence[int]) -> Iterator[Tuple[int, int, int]]:
    """``(chunk index, first row, end row)`` over dim 0 of a leaf."""
    rows = int(shape[0]) if len(shape) else 1
    for i, start in enumerate(range(0, rows, CHUNK_ROWS)):
        yield i, start, min(rows, start + CHUNK_ROWS)


def fill_chunk(out: torch.Tensor, leaf: Leaf, index: int, chunk: int,
               seed: int) -> torch.Tensor:
    """Draw chunk ``chunk`` of leaf number ``index`` into ``out`` (a
    contiguous float32 tensor of that chunk's shape), in place."""
    kind, value = leaf[2]
    if kind == "const":
        return out.fill_(value)
    gen = torch.Generator(device=out.device)
    gen.manual_seed(chunk_seed(seed, index, chunk))
    if kind == "normal":
        return out.normal_(0.0, value, generator=gen)
    if kind == "uniform":
        return out.uniform_(-value, value, generator=gen)
    raise ValueError(f"unknown init {kind!r} of leaf {leaf[0]!r}")


def draw_leaf(leaf: Leaf, index: int, seed: int,
              device: torch.device) -> torch.Tensor:
    """The whole initial value of a leaf."""
    shape = tuple(leaf[1])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    view = out if len(shape) else out.view(1)
    for c, start, stop in chunks(shape):
        fill_chunk(view[start:stop], leaf, index, c, seed)
    return out


def draw_rows(leaf: Leaf, index: int, seed: int, rows: torch.Tensor
              ) -> torch.Tensor:
    """The initial values of the given rows of a 2-D leaf (``rows`` a
    sorted int64 tensor on the device to draw on), one chunk at a time."""
    dim = int(leaf[1][1])
    out = torch.empty((rows.numel(), dim), dtype=torch.float32,
                      device=rows.device)
    for c, start, stop in chunks(leaf[1]):
        lo = int(torch.searchsorted(rows, start))
        hi = int(torch.searchsorted(rows, stop))
        if lo == hi:
            continue
        block = fill_chunk(torch.empty((stop - start, dim),
                                       dtype=torch.float32,
                                       device=rows.device), leaf, index, c,
                           seed)
        out[lo:hi] = block[rows[lo:hi] - start]
    return out
