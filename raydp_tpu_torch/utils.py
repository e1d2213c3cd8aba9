"""Shared utilities — the port's copy of the parts of :mod:`raydp_tpu.utils`
it uses: memory-size parsing (reference utils.py:125-146) and the balanced
block→rank sharding kernel ``divide_blocks`` (utils.py:149-222). Semantics
match the reference's tests (python/raydp/tests/test_spark_utils.py).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_MEMORY_UNITS = {
    "": 1,
    "K": 2**10,
    "M": 2**20,
    "G": 2**30,
    "T": 2**40,
    "P": 2**50,
}


def parse_memory_size(memory_size) -> int:
    """Parse a human-readable memory size ("512m", "1.5 GB", 1024) into bytes.

    Same accepted grammar as the reference (utils.py:125-146): an optional unit
    letter K/M/G/T with an optional trailing B, case-insensitive, optional space.
    """
    if isinstance(memory_size, (int, float)):
        return int(memory_size)
    s = str(memory_size).strip().upper().replace(" ", "")
    m = re.fullmatch(r"([0-9]*\.?[0-9]+)([KMGTP]?)I?B?", s)
    if not m:
        raise ValueError(f"cannot parse memory size: {memory_size!r}")
    number, unit = m.group(1), m.group(2)
    return int(float(number) * _MEMORY_UNITS[unit])


def divide_blocks(
    blocks: Sequence[int],
    world_size: int,
    shuffle: bool = False,
    shuffle_seed: Optional[int] = None,
) -> Dict[int, List[Tuple[int, int]]]:
    """Balanced assignment of data blocks to ``world_size`` ranks.

    This is the data-sharding kernel that guarantees every rank sees exactly
    ``ceil(total_samples / world_size)`` samples — required so a SPMD training step
    (every device participates in every collective) never deadlocks on a short rank.
    Semantics follow the reference (utils.py:149-222): blocks are strided across
    ranks round-robin, short blocks are topped up by (seeded) resampling, and long
    tails are truncated to the per-rank quota. Returns ``{rank: [(block_index,
    num_samples_from_that_block), ...]}``.
    """
    blocks = list(blocks)
    if len(blocks) < world_size:
        raise ValueError(
            f"not enough blocks ({len(blocks)}) to divide over world_size {world_size}"
        )

    num_blocks_per_rank = math.ceil(len(blocks) / world_size)
    num_samples_per_rank = math.ceil(sum(blocks) / world_size)
    total_num_blocks = num_blocks_per_rank * world_size

    global_indexes = list(range(len(blocks)))
    # wrap around so every rank gets the same number of candidate blocks
    if len(global_indexes) != total_num_blocks:
        global_indexes += global_indexes[: total_num_blocks - len(global_indexes)]

    rng = np.random.RandomState(shuffle_seed if shuffle_seed is not None else 0)
    if shuffle:
        rng.shuffle(global_indexes)

    results: Dict[int, List[Tuple[int, int]]] = {}
    for rank in range(world_size):
        candidates = global_indexes[rank:total_num_blocks:world_size]
        selected: List[Tuple[int, int]] = []
        size = 0
        for idx in candidates:
            if size >= num_samples_per_rank:
                break
            take = min(blocks[idx], num_samples_per_rank - size)
            selected.append((idx, take))
            size += take
        # top up from random blocks until the rank hits its quota
        while size < num_samples_per_rank:
            idx = int(rng.choice(global_indexes))
            take = min(blocks[idx], num_samples_per_rank - size)
            selected.append((idx, take))
            size += take
        results[rank] = selected
    return results
