"""TableDataset: the read half of :class:`raydp_tpu.data.DistributedDataset`
over Arrow tables held in this process.

The reference's dataset is an immutable list of Arrow blocks in the
object store, fetched (and recovered from lineage) through the actor
runtime. The port has no runtime or object store yet, so this class stands
in for it: the same read interface (``schema``, ``num_blocks``, ``count``,
``block_sizes``, ``get_block``, ``blocks``, ``to_arrow``) over ``pa.Table``
blocks in memory. The feed and the estimator read only this interface, so
they take any object that has it, the reference's store-backed dataset
included.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import pyarrow as pa


class TableDataset:
    """An immutable list of Arrow blocks held in this process."""

    def __init__(self, blocks: Sequence[pa.Table],
                 schema: Optional[pa.Schema] = None):
        if schema is None:
            if not blocks:
                raise ValueError("an empty TableDataset needs a schema")
            schema = blocks[0].schema
        for i, block in enumerate(blocks):
            if not block.schema.equals(schema):
                raise ValueError(f"block {i} schema {block.schema} differs "
                                 f"from the dataset's {schema}")
        self._blocks = list(blocks)
        self._schema = schema

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_blocks(self) -> int:
        return len(self._blocks)

    def count(self) -> int:
        return sum(b.num_rows for b in self._blocks)

    def block_sizes(self) -> List[int]:
        return [b.num_rows for b in self._blocks]

    def get_block(self, i: int, zero_copy: bool = False) -> pa.Table:
        """Block ``i``. The tables are already in this process, so
        ``zero_copy`` (which the store-backed dataset honours) changes
        nothing: every call returns the same immutable table."""
        return self._blocks[i]

    def blocks(self) -> List[pa.Table]:
        return [self.get_block(i) for i in range(self.num_blocks())]

    def to_arrow(self) -> pa.Table:
        if not self._blocks:
            return self._schema.empty_table()
        return pa.concat_tables(self.blocks(), promote_options="permissive")
