"""Logical plan nodes for the lazy DataFrame.

A plan is a small immutable tree; the engine (:mod:`raydp_tpu_torch.etl.engine`) compiles
it into partition tasks, fusing narrow operators into one task chain and breaking
stages at wide (shuffle) operators — the same stage/shuffle split Spark performs on
the reference's DataFrames before they ever reach RayDP's conversion layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from raydp_tpu_torch.etl.expressions import Expr
from raydp_tpu_torch.runtime.object_store import ObjectRef


class PlanNode:
    def children(self) -> List["PlanNode"]:
        return []


# ==== leaves =======================================================================
@dataclass
class RangeScan(PlanNode):
    start: int
    stop: int
    step: int = 1
    num_partitions: int = 1
    column: str = "id"


@dataclass
class CsvScan(PlanNode):
    paths: List[str]
    num_partitions: Optional[int] = None
    options: Optional[dict] = None


@dataclass
class ParquetScan(PlanNode):
    paths: List[str]
    columns: Optional[List[str]] = None


@dataclass
class InMemory(PlanNode):
    """Partitions already in the object store."""

    refs: List[ObjectRef]
    schema: Optional[bytes] = None


@dataclass
class CachedScan(PlanNode):
    """A persisted frame: blocks cached on executors with lineage recipes.

    Parity: the persisted+pinned Arrow-batch RDD of ``prepareRecoverableRDD``
    (ObjectStoreWriter.scala:164-204).
    """

    frame_id: str
    cache_keys: List[str]
    executors: List[str]           # preferred executor actor-name per partition
    recover_tasks: List[bytes]     # cloudpickled lineage Task per partition
    schema: Optional[bytes] = None
    # shuffle intermediates the lineage recipes depend on, pinned until release
    # (parity: the recoverableRDDs GC pin, ObjectStoreWriter.scala:175-177)
    pinned_refs: List[ObjectRef] = field(default_factory=list)


# ==== unary ========================================================================
@dataclass
class Project(PlanNode):
    child: PlanNode
    columns: List[Tuple[str, Expr]]

    def children(self):
        return [self.child]


@dataclass
class Filter(PlanNode):
    child: PlanNode
    predicate: Expr

    def children(self):
        return [self.child]


@dataclass
class DropNa(PlanNode):
    child: PlanNode
    subset: Optional[List[str]] = None

    def children(self):
        return [self.child]


@dataclass
class Sample(PlanNode):
    child: PlanNode
    fraction: float
    seed: Optional[int] = None

    def children(self):
        return [self.child]


@dataclass
class SplitSelect(PlanNode):
    child: PlanNode
    lo: float
    hi: float
    seed: int

    def children(self):
        return [self.child]


@dataclass
class Limit(PlanNode):
    child: PlanNode
    n: int

    def children(self):
        return [self.child]


@dataclass
class Rename(PlanNode):
    child: PlanNode
    mapping: Dict[str, str]

    def children(self):
        return [self.child]


@dataclass
class Repartition(PlanNode):
    child: PlanNode
    num_partitions: int
    shuffle: bool = True

    def children(self):
        return [self.child]


@dataclass
class GroupAgg(PlanNode):
    child: PlanNode
    keys: List[str]
    aggs: List[Tuple[str, str, str]]  # (col, fn, out_name)

    def children(self):
        return [self.child]


@dataclass
class Sort(PlanNode):
    child: PlanNode
    keys: List[Tuple[str, str]]

    def children(self):
        return [self.child]


@dataclass
class WindowOp(PlanNode):
    """One window-function column: hash-shuffle by ``partition_keys``, sort
    each bucket by (partition, order) keys, compute ``fn`` executor-side.
    No partition keys → single-partition evaluation (Spark's "No Partition
    Defined" path)."""

    child: PlanNode
    partition_keys: List[str]
    order_keys: List[Tuple[str, str]]
    out_name: str
    fn: str
    arg_col: Optional[str] = None
    offset: int = 1
    default: object = None

    def children(self):
        return [self.child]


@dataclass
class Distinct(PlanNode):
    """Row dedupe over ``subset`` (None → all columns): hash-shuffle on the
    key columns, then local first-row-per-key dedupe in each bucket."""

    child: PlanNode
    subset: Optional[List[str]] = None

    def children(self):
        return [self.child]


# ==== n-ary ========================================================================
@dataclass
class Join(PlanNode):
    left: PlanNode
    right: PlanNode
    keys: List[str]
    right_keys: List[str]
    how: str = "inner"

    def children(self):
        return [self.left, self.right]


@dataclass
class Union(PlanNode):
    inputs: List[PlanNode] = field(default_factory=list)

    def children(self):
        return list(self.inputs)
