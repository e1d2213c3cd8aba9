"""The lazy distributed DataFrame (the SparkDataFrame analogue).

Surface parity targets what the reference's examples exercise on Spark DataFrames
(examples/data_process.py, examples/pytorch_nyctaxi.py:58-67): ``select``,
``filter``/``where``, ``withColumn``, ``drop``, ``dropna``/``fillna``,
``groupBy().agg``, ``join``, ``randomSplit``, ``repartition``, ``count``,
``collect``/``toPandas``, ``schema``, ``write.parquet``. Plans are immutable;
every transformation returns a new frame sharing the session's engine.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence, Tuple, Union

import pyarrow as pa

from raydp_tpu_torch.etl import plan as P
from raydp_tpu_torch.etl.expressions import AggExpr, Column, Expr, _wrap, col
from raydp_tpu_torch.log import get_logger

logger = get_logger("etl.frame")


class DataFrame:
    def __init__(self, session, plan: P.PlanNode,
                 schema: Optional[pa.Schema] = None):
        self._session = session
        self._plan = plan
        self._schema: Optional[pa.Schema] = schema

    # ---- schema -------------------------------------------------------------
    @property
    def schema(self) -> pa.Schema:
        if self._schema is None:
            sample = self.limit(1)._collect_table()
            self._schema = sample.schema
        return self._schema

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    # ---- projections --------------------------------------------------------
    def _all_columns(self) -> List[Tuple[str, Expr]]:
        return [(name, col(name)) for name in self.columns]

    def select(self, *cols_) -> "DataFrame":
        columns: List[Tuple[str, Expr]] = []
        for c in cols_:
            if isinstance(c, str):
                columns.append((c, col(c)))
            elif isinstance(c, Expr):
                columns.append((c._name(), c))
            else:
                raise TypeError(f"cannot select {c!r}")
        return self._with(P.Project(self._plan, columns))

    def withColumn(self, name: str, expr) -> "DataFrame":
        from raydp_tpu_torch.etl.window import WindowExpr

        if isinstance(expr, WindowExpr):
            # window columns are a wide op (shuffle by partition keys), not a
            # per-partition projection. Replacing an existing column drops it
            # first (WindowStep appends) — unless the window itself reads it.
            base = self._plan
            if name in self.columns:
                used = set(expr.spec.partition_keys)
                used.update(k for k, _ in expr.spec.order_keys)
                if expr.arg_col:
                    used.add(expr.arg_col)
                if name in used:
                    raise ValueError(
                        f"withColumn({name!r}) would replace a column the "
                        "window function reads; use a different output name")
                base = self.drop(name)._plan
            # derive the output schema statically: without it, chaining a
            # second window column would run the first one's whole shuffle
            # just to list column names (the schema property's limit-1 probe)
            schema = None
            if self._schema is not None:
                from raydp_tpu_torch.etl.tasks import window_output_type
                arg_t = None
                if expr.arg_col and expr.arg_col != "*":
                    i = self._schema.get_field_index(expr.arg_col)
                    arg_t = self._schema.field(i).type if i >= 0 else None
                base_schema = self._schema
                if name in base_schema.names:
                    base_schema = base_schema.remove(
                        base_schema.get_field_index(name))
                schema = base_schema.append(
                    pa.field(name, window_output_type(expr.fn, arg_t)))
            return self._with(P.WindowOp(
                base, list(expr.spec.partition_keys),
                list(expr.spec.order_keys), name, expr.fn,
                expr.arg_col, expr.offset, expr.default), schema=schema)
        columns = [(n, e) for n, e in self._all_columns() if n != name]
        columns.append((name, _wrap(expr)))
        return self._with(P.Project(self._plan, columns))

    with_column = withColumn

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return self._with(P.Rename(self._plan, {old: new}))

    def drop(self, *names: str) -> "DataFrame":
        keep = [(n, e) for n, e in self._all_columns() if n not in names]
        return self._with(P.Project(self._plan, keep))

    def filter(self, predicate: Expr) -> "DataFrame":
        return self._with(P.Filter(self._plan, predicate))

    where = filter

    def dropna(self, subset: Optional[List[str]] = None) -> "DataFrame":
        return self._with(P.DropNa(self._plan, subset))

    def fillna(self, value, subset: Optional[List[str]] = None) -> "DataFrame":
        cols = subset or self.columns
        out = self
        for c in cols:
            out = out.withColumn(c, col(c).fill_null(value))
        return out

    def limit(self, n: int) -> "DataFrame":
        # local limit per partition; exact global limit applied at collect
        return self._with(P.Limit(self._plan, n), schema=self._schema)

    def sample(self, fraction: float, seed: Optional[int] = None) -> "DataFrame":
        return self._with(P.Sample(self._plan, fraction, seed),
                          schema=self._schema)

    def repartition(self, num_partitions: int) -> "DataFrame":
        return self._with(P.Repartition(self._plan, num_partitions, shuffle=True),
                          schema=self._schema)

    def coalesce(self, num_partitions: int) -> "DataFrame":
        return self._with(P.Repartition(self._plan, num_partitions, shuffle=False),
                          schema=self._schema)

    def union(self, other: "DataFrame") -> "DataFrame":
        return self._with(P.Union([self._plan, other._plan]),
                          schema=self._schema)

    def sort(self, *cols_, ascending: bool = True) -> "DataFrame":
        """Global sort. Columns are names, Column expressions, or
        ``(name, "ascending"|"descending")`` tuples for per-key direction."""
        keys = []
        for c in cols_:
            if isinstance(c, tuple):
                name, order = c
                keys.append((name if isinstance(name, str) else name._name(),
                             order))
            else:
                keys.append((c if isinstance(c, str) else c._name(),
                             "ascending" if ascending else "descending"))
        return self._with(P.Sort(self._plan, keys), schema=self._schema)

    orderBy = sort

    def distinct(self) -> "DataFrame":
        """Deduplicate whole rows (parity: Spark ``distinct``; reference
        usage examples/data_process.py). Executor-side hash-shuffle dedupe."""
        return self._with(P.Distinct(self._plan, None), schema=self._schema)

    def dropDuplicates(self, subset: Optional[Sequence[str]] = None
                       ) -> "DataFrame":
        """Keep one row per distinct value of ``subset`` (None → all
        columns); which row survives is unspecified, as in Spark."""
        return self._with(
            P.Distinct(self._plan, list(subset) if subset else None),
            schema=self._schema)

    drop_duplicates = dropDuplicates

    def describe(self, *cols: str) -> "DataFrame":
        """count/mean/stddev/min/max summary of numeric columns (parity:
        Spark ``describe``, reference usage examples/data_process.py). The
        executors reduce partitions to moment partials; the driver merges
        those tiny rows and returns a small local frame with a ``summary``
        column, so ``describe().show()`` works as in Spark."""
        names = list(cols)
        if not names:
            names = [f.name for f in self.schema
                     if pa.types.is_integer(f.type)
                     or pa.types.is_floating(f.type)]
        if not names:
            raise ValueError("describe: no numeric columns")
        stats = self._session.engine.describe(self._plan, names)
        rows = ["count", "mean", "stddev", "min", "max"]
        data = {"summary": rows}
        for c in names:
            data[c] = [float(stats[c][r]) if stats[c][r] is not None
                       else None for r in rows]
        import pandas as pd
        return self._session.createDataFrame(pd.DataFrame(data),
                                             num_partitions=1)

    def join(self, other: "DataFrame", on: Union[str, List[str]],
             how: str = "inner") -> "DataFrame":
        keys = [on] if isinstance(on, str) else list(on)
        return self._with(P.Join(self._plan, other._plan, keys, keys, how))

    def groupBy(self, *keys: str) -> "GroupedData":
        return GroupedData(self, list(keys))

    groupby = groupBy

    def randomSplit(self, weights: Sequence[float],
                    seed: Optional[int] = None) -> List["DataFrame"]:
        """Disjoint random splits via per-row uniform draws in weight bands
        (reference: utils.py random_split → df.randomSplit)."""
        total = float(sum(weights))
        seed = seed if seed is not None else 17
        out, lo = [], 0.0
        for w in weights:
            hi = lo + w / total
            out.append(self._with(P.SplitSelect(self._plan, lo, hi, seed),
                                  schema=self._schema))
            lo = hi
        return out

    random_split = randomSplit

    # ---- actions ------------------------------------------------------------
    def count(self) -> int:
        return self._session.engine.count(self._plan)

    def _collect_table(self) -> pa.Table:
        return self._session.engine.collect(self._plan)

    def collect(self) -> List[dict]:
        return self._collect_table().to_pylist()

    def to_arrow(self) -> pa.Table:
        return self._collect_table()

    def toPandas(self):
        return self._collect_table().to_pandas()

    to_pandas = toPandas

    def take(self, n: int) -> List[dict]:
        return self.limit(n)._collect_table().slice(0, n).to_pylist()

    def first(self) -> Optional[dict]:
        rows = self.take(1)
        return rows[0] if rows else None

    def show(self, n: int = 20) -> None:
        print(self.limit(n)._collect_table().slice(0, n).to_pandas())

    def num_partitions(self) -> int:
        return self._session.engine.num_partitions(self._plan)

    # ---- persistence --------------------------------------------------------
    def persist(self) -> "DataFrame":
        """Materialize into executor block caches with lineage (recoverable).

        Parity: ``df.toArrowBatchRdd.persist(); rdd.count()`` + GC pin inside
        ``prepareRecoverableRDD`` (ObjectStoreWriter.scala:164-204). The session
        tracks the cached frame so ``release`` can drop it later.
        """
        frame_id = f"f{uuid.uuid4().hex[:10]}"
        cached = self._session.engine.cache(self._plan, frame_id)
        self._session.register_cached(frame_id, cached)
        return self._with(cached, schema=self._schema)

    cache = persist

    def unpersist(self) -> None:
        if isinstance(self._plan, P.CachedScan):
            self._session.release_cached(self._plan.frame_id)

    @property
    def write(self) -> "DataFrameWriter":
        return DataFrameWriter(self)

    # ---- internals ----------------------------------------------------------
    def _with(self, plan: P.PlanNode,
              schema: Optional[pa.Schema] = None) -> "DataFrame":
        return DataFrame(self._session, plan, schema)

    def __repr__(self):
        try:
            return f"DataFrame[{', '.join(self.columns)}]"
        except Exception:
            return "DataFrame[<unresolved>]"


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def agg(self, *aggs: AggExpr) -> DataFrame:
        specs: List[Tuple[str, str, str]] = []
        for a in aggs:
            column = a.column
            if column == "*":
                column = self._keys[0]
            specs.append((column, a.fn, a.name))
        return self._df._with(P.GroupAgg(self._df._plan, self._keys, specs))

    def count(self) -> DataFrame:
        key = self._keys[0]
        return self._df._with(P.GroupAgg(
            self._df._plan, self._keys, [(key, "count", "count")]))

    def _simple(self, fn: str, cols: Sequence[str]) -> DataFrame:
        cols = cols or [c for c in self._df.columns if c not in self._keys]
        specs = [(c, fn, f"{fn}({c})") for c in cols]
        return self._df._with(P.GroupAgg(self._df._plan, self._keys, specs))

    def mean(self, *cols: str) -> DataFrame:
        return self._simple("mean", cols)

    avg = mean

    def sum(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple("sum", cols)

    def max(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple("max", cols)

    def min(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple("min", cols)


class DataFrameWriter:
    def __init__(self, df: DataFrame):
        self._df = df

    def parquet(self, path: str, mode: str = "overwrite") -> None:
        """Write one parquet file per partition under ``path`` (the spill path
        used by ``fit_on_spark(fs_directory=...)``, torch/estimator.py:365-376)."""
        import os

        import pyarrow.parquet as pq
        os.makedirs(path, exist_ok=True)
        refs, _, _ = self._df._session.engine.materialize(self._df._plan)
        from raydp_tpu_torch.runtime.object_store import get_client
        client = get_client()
        for i, ref in enumerate(refs):
            table = client.get(ref)
            pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))
        client.free(refs)

    def csv(self, path: str, mode: str = "overwrite") -> None:
        import os

        import pyarrow.csv as pacsv
        os.makedirs(path, exist_ok=True)
        refs, _, _ = self._df._session.engine.materialize(self._df._plan)
        from raydp_tpu_torch.runtime.object_store import get_client
        client = get_client()
        for i, ref in enumerate(refs):
            pacsv.write_csv(client.get(ref),
                            os.path.join(path, f"part-{i:05d}.csv"))
        client.free(refs)
