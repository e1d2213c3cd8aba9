"""Column functions with PySpark-compatible semantics.

The reference's feature pipelines import these from ``pyspark.sql.functions``
(examples/data_process.py:4): datetime components, ``abs``, ``lit``, ``udf``.
Semantics intentionally match Spark where Spark differs from Arrow — e.g.
``dayofweek`` is 1=Sunday..7=Saturday in Spark while Arrow counts 0=Monday — so
ported pipelines produce identical features.
"""

from __future__ import annotations

from typing import Optional, Union

import pyarrow.compute as pc

from raydp_tpu_torch.etl.expressions import (
    AggExpr, Column, Expr, Func, Literal, UdfExpr, _wrap, col, lit, udf, when,
)

__all__ = [
    "col", "lit", "when", "udf",
    "hour", "minute", "second", "year", "month", "quarter",
    "dayofmonth", "dayofweek", "dayofyear", "weekofyear",
    "abs", "sqrt", "exp", "log", "log1p", "pow", "floor", "ceil", "round",
    "upper", "lower", "trim", "length", "concat",
    "mean", "avg", "sum", "count", "max", "min", "stddev", "variance",
    "first", "last", "count_distinct",
    "row_number", "rank", "dense_rank", "lag", "lead",
]


def _c(x: Union[str, Expr]) -> Expr:
    return Column(x) if isinstance(x, str) else x


# -- datetime (Spark semantics) ------------------------------------------------------
def hour(c):
    return Func("hour", [_c(c)], name="hour")


def minute(c):
    return Func("minute", [_c(c)], name="minute")


def second(c):
    return Func("second", [_c(c)], name="second")


def year(c):
    return Func("year", [_c(c)], name="year")


def month(c):
    return Func("month", [_c(c)], name="month")


def quarter(c):
    return Func("quarter", [_c(c)], name="quarter")


def dayofmonth(c):
    return Func("day", [_c(c)], name="dayofmonth")


def dayofweek(c):
    # Arrow: Monday=0..Sunday=6 ; Spark: Sunday=1..Saturday=7
    arrow_dow = Func("day_of_week", [_c(c)], name="dayofweek")
    return ((arrow_dow + 1) % 7) + 1


def dayofyear(c):
    return Func("day_of_year", [_c(c)], name="dayofyear")


def weekofyear(c):
    return Func("iso_week", [_c(c)], name="weekofyear")


# -- math ---------------------------------------------------------------------------
def abs(c):  # noqa: A001 - Spark-compatible name
    return Func("abs", [_c(c)], name="abs")


def sqrt(c):
    return Func("sqrt", [_c(c)], name="sqrt")


def exp(c):
    return Func("exp", [_c(c)], name="exp")


def log(c):
    return Func("ln", [_c(c)], name="log")


def log1p(c):
    return Func("log1p", [_c(c)], name="log1p")


def pow(base, exponent):  # noqa: A001
    return Func("power", [_wrap(base), _wrap(exponent)], name="pow")


def floor(c):
    return Func("floor", [_c(c)], name="floor")


def ceil(c):
    return Func("ceil", [_c(c)], name="ceil")


def round(c, ndigits: int = 0):  # noqa: A001
    return Func("round", [_c(c)], options=pc.RoundOptions(ndigits=ndigits),
                name="round")


# -- strings ------------------------------------------------------------------------
def upper(c):
    return Func("utf8_upper", [_c(c)], name="upper")


def lower(c):
    return Func("utf8_lower", [_c(c)], name="lower")


def trim(c):
    return Func("utf8_trim_whitespace", [_c(c)], name="trim")


def length(c):
    return Func("utf8_length", [_c(c)], name="length")


def concat(*cols):
    return Func("binary_join_element_wise",
                [_c(c) for c in cols] + [Literal("")], name="concat")


# -- aggregations -------------------------------------------------------------------
def mean(c: str) -> AggExpr:
    return AggExpr("mean", c)


avg = mean


def sum(c: str) -> AggExpr:  # noqa: A001
    return AggExpr("sum", c)


def count(c: str = "*") -> AggExpr:
    return AggExpr("count", c)


def max(c: str) -> AggExpr:  # noqa: A001
    return AggExpr("max", c)


def min(c: str) -> AggExpr:  # noqa: A001
    return AggExpr("min", c)


def stddev(c: str) -> AggExpr:
    return AggExpr("stddev", c)


def variance(c: str) -> AggExpr:
    return AggExpr("variance", c)


def first(c: str) -> AggExpr:
    return AggExpr("first", c)


def last(c: str) -> AggExpr:
    return AggExpr("last", c)


def count_distinct(c: str) -> AggExpr:
    return AggExpr("count_distinct", c)


# -- window functions (Spark: F.row_number().over(Window...)) ------------------------
def row_number():
    from raydp_tpu_torch.etl.window import WindowFunction
    return WindowFunction("row_number")


def rank():
    from raydp_tpu_torch.etl.window import WindowFunction
    return WindowFunction("rank")


def dense_rank():
    from raydp_tpu_torch.etl.window import WindowFunction
    return WindowFunction("dense_rank")


def lag(c: str, offset: int = 1, default=None):
    from raydp_tpu_torch.etl.window import WindowFunction
    return WindowFunction("lag", arg_col=c, offset=offset, default=default)


def lead(c: str, offset: int = 1, default=None):
    from raydp_tpu_torch.etl.window import WindowFunction
    return WindowFunction("lead", arg_col=c, offset=offset, default=default)
