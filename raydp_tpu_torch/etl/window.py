"""Window functions over partitioned, ordered row frames.

PySpark-compatible surface (the reference gets these from Spark SQL):

    from raydp_tpu_torch.etl.window import Window
    from raydp_tpu_torch.etl import functions as F

    w = Window.partitionBy("user").orderBy("ts")
    df = df.withColumn("visit", F.row_number().over(w))
    df = df.withColumn("prev_amt", F.lag("amount", 1, 0.0).over(w))
    df = df.withColumn("user_total", F.sum("amount").over(
        Window.partitionBy("user")))

Execution is distributed: rows hash-shuffle by the partition keys (equal keys
share a bucket, so per-bucket evaluation is globally exact), each bucket sorts
by (partition, order) keys and computes the function executor-side
(:class:`raydp_tpu_torch.etl.tasks.WindowStep`). A spec with no ``partitionBy``
evaluates on a single partition — correct but unparallel, exactly Spark's
"No Partition Defined" behavior.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union


class WindowSpec:
    """Immutable (partition_keys, order_keys) pair."""

    def __init__(self, partition_keys: Tuple[str, ...] = (),
                 order_keys: Tuple[Tuple[str, str], ...] = ()):
        self.partition_keys = tuple(partition_keys)
        self.order_keys = tuple(order_keys)

    def partitionBy(self, *cols: str) -> "WindowSpec":
        return WindowSpec(tuple(_names(cols)), self.order_keys)

    def orderBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self.partition_keys, tuple(_order_keys(cols)))

    partition_by = partitionBy
    order_by = orderBy


def _names(cols) -> List[str]:
    out = []
    for c in cols:
        out.append(c if isinstance(c, str) else c._name())
    return out


def _order_keys(cols) -> List[Tuple[str, str]]:
    keys = []
    for c in cols:
        if isinstance(c, tuple):
            name, order = c
            keys.append((name if isinstance(name, str) else name._name(),
                         order))
        else:
            keys.append((c if isinstance(c, str) else c._name(), "ascending"))
    return keys


class Window:
    """Entry point, Spark-style: ``Window.partitionBy(...).orderBy(...)``."""

    @staticmethod
    def partitionBy(*cols: str) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)

    partition_by = partitionBy
    order_by = orderBy


#: window functions that need ``orderBy`` to mean anything
_ORDER_REQUIRED = {"row_number", "rank", "dense_rank", "lag", "lead"}


class WindowExpr:
    """A window function bound to a spec; assign via ``df.withColumn``."""

    def __init__(self, fn: str, spec: WindowSpec,
                 arg_col: Optional[str] = None, offset: int = 1,
                 default=None, name: Optional[str] = None):
        if fn in _ORDER_REQUIRED and not spec.order_keys:
            raise ValueError(f"window function {fn!r} requires an orderBy")
        self.fn = fn
        self.spec = spec
        self.arg_col = arg_col
        self.offset = offset
        self.default = default
        self.name = name or (f"{fn}({arg_col})" if arg_col else f"{fn}()")

    def _name(self) -> str:
        return self.name

    def alias(self, name: str) -> "WindowExpr":
        return WindowExpr(self.fn, self.spec, self.arg_col, self.offset,
                          self.default, name)


class WindowFunction:
    """An unbound window function: ``F.row_number()`` → ``.over(spec)``."""

    def __init__(self, fn: str, arg_col: Optional[str] = None,
                 offset: int = 1, default=None):
        self.fn = fn
        self.arg_col = arg_col
        self.offset = offset
        self.default = default

    def over(self, spec: WindowSpec) -> WindowExpr:
        return WindowExpr(self.fn, spec, self.arg_col, self.offset,
                          self.default)
