"""Column expressions compiled to ``pyarrow.compute`` kernels.

The surface mirrors the PySpark ``Column`` algebra the reference's examples lean on
(examples/data_process.py builds features with ``col`` arithmetic, comparisons,
casts and date functions). Expressions are small picklable trees; executors
evaluate them against an Arrow table partition with vectorized kernels — on the
CPU side of the pipeline there is no MXU to feed, so the win is staying columnar
and zero-copy end to end.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


class Expr:
    """Base expression node. Subclasses must implement ``evaluate`` and ``_name``."""

    def evaluate(self, table: pa.Table):
        raise NotImplementedError

    def _name(self) -> str:
        raise NotImplementedError

    # -- naming ---------------------------------------------------------------
    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other):
        return BinaryOp("add", self, _wrap(other))

    def __radd__(self, other):
        return BinaryOp("add", _wrap(other), self)

    def __sub__(self, other):
        return BinaryOp("subtract", self, _wrap(other))

    def __rsub__(self, other):
        return BinaryOp("subtract", _wrap(other), self)

    def __mul__(self, other):
        return BinaryOp("multiply", self, _wrap(other))

    def __rmul__(self, other):
        return BinaryOp("multiply", _wrap(other), self)

    def __truediv__(self, other):
        return BinaryOp("divide", self, _wrap(other))

    def __rtruediv__(self, other):
        return BinaryOp("divide", _wrap(other), self)

    def __mod__(self, other):
        return BinaryOp("mod", self, _wrap(other))

    def __neg__(self):
        return UnaryOp("negate", self)

    # -- comparisons ----------------------------------------------------------
    def __eq__(self, other):  # noqa: A003 - expression semantics over identity
        return BinaryOp("equal", self, _wrap(other))

    def __ne__(self, other):
        return BinaryOp("not_equal", self, _wrap(other))

    def __lt__(self, other):
        return BinaryOp("less", self, _wrap(other))

    def __le__(self, other):
        return BinaryOp("less_equal", self, _wrap(other))

    def __gt__(self, other):
        return BinaryOp("greater", self, _wrap(other))

    def __ge__(self, other):
        return BinaryOp("greater_equal", self, _wrap(other))

    # -- boolean --------------------------------------------------------------
    def __and__(self, other):
        return BinaryOp("and_kleene", self, _wrap(other))

    def __rand__(self, other):
        return BinaryOp("and_kleene", _wrap(other), self)

    def __or__(self, other):
        return BinaryOp("or_kleene", self, _wrap(other))

    def __ror__(self, other):
        return BinaryOp("or_kleene", _wrap(other), self)

    def __invert__(self):
        return UnaryOp("invert", self)

    def __hash__(self):
        return id(self)

    # -- analysis -------------------------------------------------------------
    def references(self) -> "set[str]":
        """Column names this expression reads — the optimizer's required-set
        primitive. The generic walk covers every node whose operands live in
        instance attributes (including tuples like ``When.branches``);
        :class:`Column` overrides it as the base case."""
        out: set = set()

        def visit(v):
            if isinstance(v, Expr):
                out.update(v.references())
            elif isinstance(v, (list, tuple)):
                for item in v:
                    visit(item)

        for v in self.__dict__.values():
            visit(v)
        return out

    # -- misc helpers ---------------------------------------------------------
    def is_null(self) -> "Expr":
        return UnaryOp("is_null", self)

    def is_not_null(self) -> "Expr":
        return UnaryOp("is_valid", self)

    def isin(self, values: Sequence) -> "Expr":
        return IsIn(self, list(values))

    def cast(self, dtype) -> "Expr":
        return Cast(self, dtype)

    def astype(self, dtype) -> "Expr":
        return Cast(self, dtype)

    def between(self, low, high) -> "Expr":
        return (self >= low) & (self <= high)

    def fill_null(self, value) -> "Expr":
        return FillNull(self, value)

    @property
    def dt(self) -> "_DtAccessor":
        return _DtAccessor(self)

    @property
    def str(self) -> "_StrAccessor":
        return _StrAccessor(self)


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


def _is_integer_like(v) -> bool:
    t = v.type if isinstance(v, (pa.Array, pa.ChunkedArray, pa.Scalar)) else None
    return t is not None and pa.types.is_integer(t)


def _modulo(left, right):
    """Python-semantics modulo (Arrow ships no kernel). Integers stay in int64
    (a float64 round-trip would corrupt values beyond 2^53); division by zero
    yields null, matching SQL/Spark."""
    import numpy as np

    if _is_integer_like(left) and _is_integer_like(right):
        l_arr, l_null = _to_np_int(left)
        r_arr, r_null = _to_np_int(right)
        l_arr, r_arr = np.broadcast_arrays(l_arr, r_arr)
        invalid = (r_arr == 0)
        for nm in (l_null, r_null):
            if nm is not None:
                invalid = invalid | np.broadcast_to(nm, invalid.shape)
        if invalid.ndim == 0:  # scalar % scalar
            if invalid:
                return pa.scalar(None, type=pa.int64())
            return pa.scalar(int(np.remainder(l_arr, r_arr)), type=pa.int64())
        safe_r = np.where(invalid, 1, r_arr)
        out = np.remainder(l_arr, safe_r)
        return pa.array(np.where(invalid, 0, out), type=pa.int64(),
                        mask=invalid if invalid.any() else None)
    quot = pc.floor(pc.divide(pc.cast(left, pa.float64(), safe=False),
                              pc.cast(right, pa.float64(), safe=False)))
    return pc.subtract(pc.cast(left, pa.float64(), safe=False),
                       pc.multiply(quot, pc.cast(right, pa.float64(), safe=False)))


def _to_np_int(v):
    """(int64 ndarray or 0-d, null-mask ndarray or None) for an Arrow value."""
    import numpy as np

    if isinstance(v, pa.Scalar):
        if v.as_py() is None:
            return np.int64(0), np.bool_(True)
        return np.int64(v.as_py()), None
    if isinstance(v, pa.ChunkedArray):
        v = v.combine_chunks()
    null_mask = None
    if v.null_count:
        null_mask = np.asarray(pc.is_null(v))
        v = pc.fill_null(v, 0)
    return np.asarray(pc.cast(v, pa.int64())), null_mask


class Column(Expr):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, table: pa.Table):
        return table.column(self.name)

    def _name(self) -> str:
        return self.name

    def references(self) -> "set[str]":
        return {self.name}

    def __repr__(self):
        return f"col({self.name!r})"


class Literal(Expr):
    def __init__(self, value: Any):
        self.value = value

    def evaluate(self, table: pa.Table):
        return pa.scalar(self.value)

    def _name(self) -> str:
        return str(self.value)


class Alias(Expr):
    def __init__(self, child: Expr, name: str):
        self.child = child
        self.name = name

    def evaluate(self, table: pa.Table):
        return self.child.evaluate(table)

    def _name(self) -> str:
        return self.name


class BinaryOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    def evaluate(self, table: pa.Table):
        left = self.left.evaluate(table)
        right = self.right.evaluate(table)
        if self.op == "mod":
            return _modulo(left, right)
        return getattr(pc, self.op)(left, right)

    def _name(self) -> str:
        return f"({self.left._name()} {self.op} {self.right._name()})"


class UnaryOp(Expr):
    def __init__(self, op: str, child: Expr):
        self.op = op
        self.child = child

    def evaluate(self, table: pa.Table):
        return getattr(pc, self.op)(self.child.evaluate(table))

    def _name(self) -> str:
        return f"{self.op}({self.child._name()})"


class IsIn(Expr):
    def __init__(self, child: Expr, values: List):
        self.child = child
        self.values = values

    def evaluate(self, table: pa.Table):
        return pc.is_in(self.child.evaluate(table), value_set=pa.array(self.values))

    def _name(self) -> str:
        return f"{self.child._name()} IN {self.values}"


class Cast(Expr):
    def __init__(self, child: Expr, dtype):
        self.child = child
        self.dtype = dtype

    def evaluate(self, table: pa.Table):
        return pc.cast(self.child.evaluate(table), _to_arrow_type(self.dtype),
                       safe=False)

    def _name(self) -> str:
        return self.child._name()


class FillNull(Expr):
    def __init__(self, child: Expr, value):
        self.child = child
        self.value = value

    def evaluate(self, table: pa.Table):
        return pc.fill_null(self.child.evaluate(table), self.value)

    def _name(self) -> str:
        return self.child._name()


class When(Expr):
    """``when(cond, value).when(...).otherwise(default)`` conditional."""

    def __init__(self, branches: List, default=None):
        self.branches = branches
        self.default = default

    def when(self, cond: Expr, value) -> "When":
        return When(self.branches + [(cond, _wrap(value))], self.default)

    def otherwise(self, value) -> "When":
        return When(self.branches, _wrap(value))

    def evaluate(self, table: pa.Table):
        conds = pa.table(
            {f"c{i}": _to_bool_array(c.evaluate(table), table.num_rows)
             for i, (c, _) in enumerate(self.branches)})
        cases = [v.evaluate(table) for _, v in self.branches]
        default = (self.default.evaluate(table) if self.default is not None
                   else pa.scalar(None))
        return pc.case_when(pc.make_struct(*conds.columns), *cases, default)

    def _name(self) -> str:
        return "CASE WHEN"


def _to_bool_array(v, length: int):
    if isinstance(v, pa.Scalar):
        return pa.array([v.as_py()] * length, type=pa.bool_())
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks()
    return v


class Func(Expr):
    """A named pyarrow.compute function over expressions, e.g. log1p, abs."""

    def __init__(self, fn: str, children: List[Expr], options=None,
                 name: Optional[str] = None):
        self.fn = fn
        self.children = children
        self.options = options
        self.name = name

    def evaluate(self, table: pa.Table):
        args = [c.evaluate(table) for c in self.children]
        kwargs = {"options": self.options} if self.options is not None else {}
        return getattr(pc, self.fn)(*args, **kwargs)

    def _name(self) -> str:
        return self.name or f"{self.fn}({', '.join(c._name() for c in self.children)})"


class UdfExpr(Expr):
    """A user-defined function over column expressions.

    Parity: PySpark ``@udf`` as the reference's feature engineering uses it
    (examples/data_process.py ``night``/``late_night``/``manhattan`` UDFs). The
    function is applied per-row over the evaluated child arrays; the result is
    cast to ``return_type``. Vectorized ``pyarrow.compute`` expressions are always
    preferred — UDFs are the escape hatch.
    """

    def __init__(self, fn: Callable, children: List[Expr], return_type,
                 name: Optional[str] = None):
        self.fn = fn
        self.children = children
        self.return_type = return_type
        self.name = name or getattr(fn, "__name__", "udf")

    def evaluate(self, table: pa.Table):
        cols = []
        for c in self.children:
            v = evaluate_to_array(c, table)
            cols.append(v.to_pylist())
        if not cols:
            out = [self.fn() for _ in range(table.num_rows)]
        else:
            out = [self.fn(*vals) for vals in zip(*cols)]
        return pa.array(out, type=_to_arrow_type(self.return_type))

    def _name(self) -> str:
        return self.name


def udf(return_type="string"):
    """``@udf("int")`` decorator; the wrapped fn accepts column names or exprs."""

    def deco(fn):
        def make(*cols):
            children = [c if isinstance(c, Expr) else Column(c) for c in cols]
            return UdfExpr(fn, children, return_type)
        make.__name__ = getattr(fn, "__name__", "udf")
        return make

    if callable(return_type):  # used bare: @udf
        fn, return_type = return_type, "string"
        return deco(fn)
    return deco


class AggExpr:
    """An aggregation spec for ``groupBy().agg(...)``: (fn, column, out name)."""

    def __init__(self, fn: str, column: str, name: Optional[str] = None):
        self.fn = fn
        self.column = column
        self.name = name or f"{self.fn}({column})"

    def alias(self, name: str) -> "AggExpr":
        return AggExpr(self.fn, self.column, name)

    def over(self, spec):
        """Evaluate this aggregate as a window function over ``spec``
        (Spark: ``F.sum("x").over(Window.partitionBy("k"))`` broadcasts the
        per-partition aggregate to every row)."""
        from raydp_tpu_torch.etl.window import WindowExpr

        supported = {"mean", "sum", "min", "max", "count"}
        if self.fn not in supported:
            raise ValueError(
                f"aggregate {self.fn!r} is not supported over a window; "
                f"have {sorted(supported)}")
        return WindowExpr(self.fn, spec, arg_col=self.column)


class _DtAccessor:
    """Datetime component extraction (examples/data_process.py uses dayofweek,
    hour, month etc. on pickup datetimes)."""

    def __init__(self, child: Expr):
        self._child = child

    def __getattr__(self, item: str):
        mapping = {
            "year": "year", "month": "month", "day": "day",
            "hour": "hour", "minute": "minute", "second": "second",
            "dayofweek": "day_of_week", "day_of_week": "day_of_week",
            "dayofyear": "day_of_year", "week": "iso_week",
        }
        if item not in mapping:
            raise AttributeError(item)
        return lambda: Func(mapping[item], [self._child], name=item)


class _StrAccessor:
    def __init__(self, child: Expr):
        self._child = child

    def lower(self):
        return Func("utf8_lower", [self._child])

    def upper(self):
        return Func("utf8_upper", [self._child])

    def strip(self):
        return Func("utf8_trim_whitespace", [self._child])

    def contains(self, pat: str):
        import pyarrow.compute as _pc
        return Func("match_substring", [self._child],
                    options=_pc.MatchSubstringOptions(pat))

    def startswith(self, pat: str):
        import pyarrow.compute as _pc
        return Func("starts_with", [self._child],
                    options=_pc.MatchSubstringOptions(pat))


_TYPE_ALIASES: Dict[str, Callable[[], pa.DataType]] = {
    "int": pa.int64, "long": pa.int64, "int64": pa.int64, "int32": pa.int32,
    "short": pa.int16, "byte": pa.int8, "float": pa.float32, "float32": pa.float32,
    "double": pa.float64, "float64": pa.float64, "bool": pa.bool_,
    "boolean": pa.bool_, "string": pa.string, "str": pa.string,
    "timestamp": lambda: pa.timestamp("us"), "date": pa.date32,
    "binary": pa.binary,
}


def _to_arrow_type(dtype) -> pa.DataType:
    if isinstance(dtype, pa.DataType):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _TYPE_ALIASES:
            return _TYPE_ALIASES[key]()
    if isinstance(dtype, type) and issubclass(dtype, (int, float, bool, str)):
        return {int: pa.int64(), float: pa.float64(), bool: pa.bool_(),
                str: pa.string()}[dtype]
    if isinstance(dtype, np.dtype) or (isinstance(dtype, type)
                                       and issubclass(dtype, np.generic)):
        return pa.from_numpy_dtype(np.dtype(dtype))
    raise ValueError(f"unsupported dtype: {dtype!r}")


def evaluate_to_array(expr: Expr, table: pa.Table):
    """Evaluate and materialize to a ChunkedArray of the table's length."""
    out = expr.evaluate(table)
    if isinstance(out, pa.Scalar):
        out = pa.chunked_array([pa.array([out.as_py()] * table.num_rows,
                                         type=out.type if out.type != pa.null() else None)])
    if isinstance(out, pa.Array):
        out = pa.chunked_array([out])
    return out


def _substitute_value(v, mapping: Dict[str, str]):
    if isinstance(v, Expr):
        return substitute_columns(v, mapping)
    if isinstance(v, tuple):
        return tuple(_substitute_value(x, mapping) for x in v)
    if isinstance(v, list):
        return [_substitute_value(x, mapping) for x in v]
    return v


def substitute_columns(expr: Expr, mapping: Dict[str, str]) -> Expr:
    """A structural copy of ``expr`` with every :class:`Column` renamed through
    ``mapping`` (names absent from the mapping are kept). Used by the plan
    optimizer to sink predicates below ``Rename`` nodes."""
    import copy

    if isinstance(expr, Column):
        return Column(mapping.get(expr.name, expr.name))
    clone = copy.copy(expr)
    for k, v in list(clone.__dict__.items()):
        clone.__dict__[k] = _substitute_value(v, mapping)
    return clone


# -- public constructors ------------------------------------------------------------
def col(name: str) -> Column:
    return Column(name)


def lit(value: Any) -> Literal:
    return Literal(value)


def when(cond: Expr, value) -> When:
    return When([(cond, _wrap(value))])
