"""Rule-based logical-plan optimizer: move fewer bytes through the shuffle.

The reference leans on Spark's Catalyst doing real query optimization before any
row reaches RayDP's conversion layer; the seed engine compiled the user's plan
verbatim, so every wide operator (groupby/join/window/distinct) shuffled
full-width, full-row tables through the object store. This module rewrites the
plan tree before compilation:

1. **Predicate pushdown** — ``Filter`` sinks below ``Project`` (when the
   referenced columns are plain pass-throughs), ``Rename`` (predicate column
   names rewritten through the mapping), ``DropNa`` and ``Union``, so rows die
   before they are bucketed or projected. It does NOT commute with
   ``Sample``/``SplitSelect``: their draws are positional, so filtering first
   would select a different random row set.
2. **Projection pruning** — required-column sets walk the tree top-down
   (via :meth:`Expr.references`); wide operators narrow their shuffle input to
   key + referenced columns, ``ParquetScan`` prunes at the reader
   (``columns=``), and CSV / in-memory scans get a post-read prune ``Project``.

Map-side partial aggregation (the third shuffle-byte rule) lives in
``Engine._compile_groupagg`` because it is a physical rewrite of the shuffle
stage, not a plan-tree rewrite; it consults :func:`enabled` from here.

Opt-out: ``RDT_ETL_OPTIMIZER=0`` (read per action, so tests can flip it at
runtime) preserves the naive compile-verbatim path.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import List, Optional

import pyarrow as pa

from raydp_tpu_torch import knobs
from raydp_tpu_torch.etl import plan as P
from raydp_tpu_torch.etl.expressions import Column, Expr, col, substitute_columns

#: aggregate functions the engine can decompose into map-side partials +
#: a reduce-side merge (mean via sum+count); anything else falls back to the
#: single-phase shuffle-then-aggregate path
DECOMPOSABLE_AGGS = {"count", "sum", "min", "max", "mean"}


def enabled() -> bool:
    return bool(knobs.get("RDT_ETL_OPTIMIZER"))


# ==== adaptive query execution (AQE) knobs =========================================
# The static rules above plan blind; the engine's AQE layer re-plans at stage
# boundaries from MEASURED statistics (materialized bytes, the consolidated
# shuffle's per-bucket size index). The knobs live here beside the optimizer
# opt-out because they follow the same contract: read per action, so a test
# or bench can flip them at runtime. A threshold of 0 disables its rule.

def aqe_enabled() -> bool:
    """Adaptive-execution master switch (default ON, ``RDT_ETL_AQE=0`` off).
    Read per action like ``RDT_ETL_OPTIMIZER``."""
    return bool(knobs.get("RDT_ETL_AQE"))


def aqe_broadcast_max() -> int:
    """Broadcast-hash-join threshold: a join side whose MEASURED materialized
    bytes fit under this skips its shuffle entirely and replicates to every
    executor instead (default ~8MB, Spark's autoBroadcastJoinThreshold
    ballpark). 0 disables rule (a)."""
    return int(knobs.get("RDT_AQE_BROADCAST_MAX"))


def aqe_skew_factor() -> float:
    """Skew-mitigation trigger: a reduce bucket whose measured bytes exceed
    this multiple of the median bucket splits its byte-ranges across several
    reduce tasks. 0 disables rule (b)."""
    return float(knobs.get("RDT_AQE_SKEW_FACTOR"))


def aqe_coalesce_min() -> int:
    """Tiny-partition coalescing target: adjacent reduce buckets fuse into
    one reduce task until their combined measured bytes reach this (default
    1MB), so many-bucket configs stop paying a dispatch per kilobyte-sized
    bucket. Doubles as the floor under which a bucket is never worth skew-
    splitting. 0 disables rule (c) (and the split floor)."""
    return int(knobs.get("RDT_AQE_COALESCE_MIN"))


def estimate_plan_bytes(node: P.PlanNode) -> Optional[int]:
    """Static upper-bound estimate of a plan's materialized bytes, or None
    when nothing cheap is known. Used by the AQE pre-shuffle broadcast rule
    to decide whether materializing a join side is worth trying at all — the
    MEASURED size after materialization is what actually gates the
    broadcast, so an over-estimate only costs a missed opportunity and an
    under-estimate is corrected (the materialized refs shuffle as an
    in-memory side instead)."""
    if isinstance(node, P.InMemory):
        return sum(int(getattr(r, "size", 0) or 0) for r in node.refs)
    if isinstance(node, P.RangeScan):
        n = max(0, node.stop - node.start)
        return (n // max(node.step, 1) + 1) * 8
    if isinstance(node, (P.CsvScan, P.ParquetScan)):
        try:
            return sum(os.path.getsize(p) for p in node.paths)
        except OSError:
            return None
    if isinstance(node, P.Union):
        total = 0
        for child in node.inputs:
            est = estimate_plan_bytes(child)
            if est is None:
                return None
            total += est
        return total
    # row-preserving / row-shrinking unary ops: the child's bytes bound the
    # output (WindowOp adds one column — close enough for an upper bound)
    if isinstance(node, (P.Project, P.Rename, P.DropNa, P.Filter, P.Limit,
                         P.Sample, P.SplitSelect, P.Repartition, P.Sort,
                         P.Distinct, P.WindowOp)):
        return estimate_plan_bytes(node.child)
    # GroupAgg / Join / CachedScan outputs are not statically bounded; the
    # post-map fallback (measured map bytes) covers those sides instead
    return None


def optimize(node: P.PlanNode) -> P.PlanNode:
    """Apply all plan rewrites (no-op when the knob disables the optimizer)."""
    if not enabled():
        return node
    node = push_filters(node)
    node = prune_columns(node, None)
    return node


# ==== predicate pushdown ===========================================================
def _is_passthrough(expr: Expr) -> bool:
    return type(expr) is Column


def push_filters(node: P.PlanNode) -> P.PlanNode:
    """Sink every ``Filter`` as deep as the rewrite rules allow."""
    if isinstance(node, P.Filter):
        child = push_filters(node.child)
        return _sink_filter(node.predicate, child)
    return _rebuild(node, [push_filters(c) for c in node.children()])


def _sink_filter(pred: Expr, child: P.PlanNode) -> P.PlanNode:
    """``Filter(pred, child)`` with the filter pushed below ``child`` when a
    rule applies; otherwise the filter stays put."""
    if isinstance(child, P.Project):
        # push only when every referenced column is a plain pass-through of
        # the same name — a computed column must be evaluated before the
        # predicate can run (no expression inlining: UDFs are not pure-cheap)
        defs = dict(child.columns)
        refs = pred.references()
        ok = all(name in defs and _is_passthrough(defs[name])
                 and defs[name].name == name for name in refs)
        if ok:
            return P.Project(_sink_filter(pred, child.child), child.columns)
    elif isinstance(child, P.Rename):
        inverse = {new: old for old, new in child.mapping.items()}
        # un-invertible mapping (two olds renamed to one new) cannot rewrite
        if len(inverse) == len(child.mapping):
            renamed = substitute_columns(pred, inverse)
            return P.Rename(_sink_filter(renamed, child.child), child.mapping)
    elif isinstance(child, P.Union):
        # only sink when every input provably produces the predicate's
        # columns — permissive concat null-fills asymmetric schemas, and the
        # pushed filter would otherwise die on a missing column
        refs = pred.references()
        cols = [output_columns(c) for c in child.inputs]
        if all(c is not None and refs <= set(c) for c in cols):
            return P.Union([_sink_filter(pred, c) for c in child.inputs])
    elif isinstance(child, P.DropNa):
        # row-wise deterministic: commuting keeps the same surviving rows.
        # (Sample/SplitSelect do NOT commute — their draws are positional,
        # so filtering first would select a different random row set.)
        inner = _sink_filter(pred, child.child)
        return _rebuild(child, [inner])
    # NOTE: a filter must NOT leapfrog another filter. The inner predicate may
    # be a guard for the outer one (filter(b != 0).filter(a/b > 2)): Arrow
    # kernels raise eagerly (divide by zero) instead of yielding null, so
    # reordering a conjunction is observably unsafe here. Stacked filters
    # still sink as a unit: the inner one sinks first (push_filters recurses
    # bottom-up), and the outer sinks through whatever node the inner left on
    # top, landing directly ABOVE it — order preserved.
    return P.Filter(child, pred)


# ==== projection pruning ===========================================================
def output_columns(node: P.PlanNode) -> Optional[List[str]]:
    """Statically-known output column names of a plan node, or None when the
    schema cannot be derived without running anything."""
    if isinstance(node, P.RangeScan):
        return [node.column]
    if isinstance(node, P.ParquetScan):
        return list(node.columns) if node.columns is not None else None
    if isinstance(node, P.CsvScan):
        names = (node.options or {}).get("column_names")
        return list(names) if names else None
    if isinstance(node, (P.InMemory, P.CachedScan)):
        if node.schema is not None:
            return list(pa.ipc.read_schema(pa.py_buffer(node.schema)).names)
        return None
    if isinstance(node, P.Project):
        return [name for name, _ in node.columns]
    if isinstance(node, P.Rename):
        inner = output_columns(node.child)
        if inner is None:
            return None
        return [node.mapping.get(c, c) for c in inner]
    if isinstance(node, P.GroupAgg):
        # pyarrow's group_by().aggregate() emits the key columns first
        return list(node.keys) + [out for _, _, out in node.aggs]
    if isinstance(node, P.WindowOp):
        inner = output_columns(node.child)
        if inner is None:
            return None
        return [c for c in inner if c != node.out_name] + [node.out_name]
    if isinstance(node, P.Join):
        left = output_columns(node.left)
        right = output_columns(node.right)
        if left is None or right is None:
            return None
        # Arrow's join keeps left columns then the right's non-key columns
        return list(left) + [c for c in right if c not in node.right_keys]
    if isinstance(node, P.Union):
        cols = [output_columns(c) for c in node.inputs]
        if any(c is None for c in cols):
            return None
        out: List[str] = []
        for cs in cols:  # permissive concat unions schemas by name, in order
            for c in cs:
                if c not in out:
                    out.append(c)
        return out
    children = node.children()
    if len(children) == 1:  # row-only ops pass the schema through
        return output_columns(children[0])
    return None


def _ordered_union(*lists) -> List[str]:
    out: List[str] = []
    for lst in lists:
        for c in lst:
            if c not in out:
                out.append(c)
    return out


def _narrow(child: P.PlanNode, required: List[str]) -> P.PlanNode:
    """Prune ``child`` to ``required`` columns: recurse with the requirement,
    then — if the child may still be wider — insert a pass-through prune
    ``Project`` so shuffles above it carry only what is needed."""
    if not required:
        return prune_columns(child, None)
    pruned = prune_columns(child, list(required))
    cols = output_columns(pruned)
    if cols is not None and list(cols) == list(required):
        return pruned  # already exactly the required set
    if cols is not None:
        # known schema: keep the child's own column order, require only what
        # exists there (callers pass supersets when a side's schema is mixed)
        keep = [c for c in cols if c in required]
        if len(keep) == len(cols):
            return pruned
        return P.Project(pruned, [(c, col(c)) for c in keep])
    return P.Project(pruned, [(c, col(c)) for c in required])


def prune_columns(node: P.PlanNode,
                  required: Optional[List[str]]) -> P.PlanNode:
    """Top-down required-column walk. ``required=None`` means "everything the
    node produces is needed" (the root, and any consumer we cannot analyze)."""
    # ---- leaves ----
    if isinstance(node, P.ParquetScan):
        if required is not None and node.columns is None:
            return P.ParquetScan(node.paths, columns=list(required))
        return node
    if isinstance(node, (P.CsvScan, P.InMemory, P.CachedScan, P.RangeScan)):
        # CSV cannot prune at the reader (byte-sliced parse); in-memory blocks
        # are already materialized. A post-read prune Project (inserted by
        # _narrow) handles both; nothing to do at the leaf itself.
        return node

    if isinstance(node, P.Project):
        columns = node.columns
        if required is not None:
            keep = [(n, e) for n, e in columns if n in required]
            # a projection must keep producing at least one column
            columns = keep if keep else columns[:1]
        child_req = _ordered_union(*[sorted(e.references())
                                     for _, e in columns])
        if not child_req:
            # all-literal projection: the child still supplies the ROW COUNT,
            # so it must not be pruned to zero columns
            return P.Project(prune_columns(node.child, None), columns)
        return P.Project(prune_columns(node.child, child_req), columns)

    if isinstance(node, P.Filter):
        if required is None:
            return P.Filter(prune_columns(node.child, None), node.predicate)
        child_req = _ordered_union(required, sorted(node.predicate.references()))
        return P.Filter(prune_columns(node.child, child_req), node.predicate)

    if isinstance(node, P.Rename):
        if required is None:
            return P.Rename(prune_columns(node.child, None), node.mapping)
        inverse = {new: old for old, new in node.mapping.items()}
        child_req = [inverse.get(c, c) for c in required]
        return P.Rename(prune_columns(node.child, child_req), node.mapping)

    if isinstance(node, P.DropNa):
        if required is None or node.subset is None:
            return P.DropNa(prune_columns(node.child, None), node.subset)
        child_req = _ordered_union(required, node.subset)
        return P.DropNa(prune_columns(node.child, child_req), node.subset)

    if isinstance(node, (P.Sample, P.SplitSelect, P.Limit, P.Repartition)):
        child = (prune_columns(node.child, list(required))
                 if required is not None else prune_columns(node.child, None))
        if isinstance(node, P.Repartition) and node.shuffle \
                and required is not None:
            # narrow BELOW the shuffle so the repartition moves fewer bytes
            child = _narrow_if_known_node(child, list(required))
        return _rebuild(node, [child])

    if isinstance(node, P.Sort):
        key_names = [k for k, _ in node.keys]
        if required is None:
            return P.Sort(prune_columns(node.child, None), node.keys)
        child_req = _ordered_union(required, key_names)
        return P.Sort(prune_columns(node.child, child_req), node.keys)

    if isinstance(node, P.Distinct):
        # output is the full surviving row: every child column is needed, plus
        # the dedupe keys must survive any pruning below
        return P.Distinct(prune_columns(node.child, None), node.subset)

    if isinstance(node, P.GroupAgg):
        # the aggregate's input set is exact regardless of what is required
        # above: keys + aggregated columns. This is the big shuffle narrowing.
        child_req = _ordered_union(node.keys, [c for c, _, _ in node.aggs])
        return P.GroupAgg(_narrow(node.child, child_req), node.keys, node.aggs)

    if isinstance(node, P.WindowOp):
        if required is None:
            return _rebuild(node, [prune_columns(node.child, None)])
        child_req = _ordered_union(
            [c for c in required if c != node.out_name],
            node.partition_keys, [k for k, _ in node.order_keys],
            [node.arg_col] if node.arg_col and node.arg_col != "*" else [])
        if isinstance(node.child, P.WindowOp) and \
                list(node.child.partition_keys) == list(node.partition_keys):
            # keep same-spec window chains ADJACENT: the engine collapses
            # them into one shuffle, and a prune Project in between would
            # split that back into N shuffles
            return _rebuild(node, [prune_columns(node.child, child_req)])
        return _rebuild(node, [_narrow(node.child, child_req)])

    if isinstance(node, P.Join):
        lcols = output_columns(node.left)
        rcols = output_columns(node.right)
        left, right = node.left, node.right
        if required is not None and lcols is not None:
            lreq = _ordered_union([c for c in lcols
                                   if c in required], node.keys)
            left = _narrow(left, lreq)
        else:
            left = prune_columns(left, None)
        if required is not None and rcols is not None:
            rreq = _ordered_union(node.right_keys,
                                  [c for c in rcols if c in required
                                   and c not in node.right_keys])
            # keep the right side's own order, keys included where they sit
            rreq = [c for c in rcols if c in rreq]
            right = _narrow(right, rreq)
        else:
            right = prune_columns(right, None)
        return P.Join(left, right, node.keys, node.right_keys, node.how)

    if isinstance(node, P.Union):
        if required is not None:
            cols = [output_columns(c) for c in node.inputs]
            # only prune when every input provably produces the required set —
            # permissive concat null-fills asymmetric schemas, and a prune
            # Project would turn that into a missing-column error
            if all(c is not None and set(required) <= set(c) for c in cols):
                return P.Union([_narrow(c, list(required))
                                for c in node.inputs])
        return P.Union([prune_columns(c, None) for c in node.inputs])

    return _rebuild(node, [prune_columns(c, None) for c in node.children()])


def _narrow_if_known_node(child: P.PlanNode,
                          required: List[str]) -> P.PlanNode:
    cols = output_columns(child)
    if cols is not None and not set(cols) <= set(required):
        keep = [c for c in cols if c in required]
        if keep:
            return P.Project(child, [(c, col(c)) for c in keep])
    return child


# ==== helpers ======================================================================
def _rebuild(node: P.PlanNode, children: List[P.PlanNode]) -> P.PlanNode:
    """A copy of ``node`` with its children replaced (dataclass-generic)."""
    if not children:
        return node
    if isinstance(node, P.Join):
        return replace(node, left=children[0], right=children[1])
    if isinstance(node, P.Union):
        return replace(node, inputs=list(children))
    return replace(node, child=children[0])
