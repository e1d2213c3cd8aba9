"""Task model: the physical unit of ETL work.

A :class:`Task` is a self-contained recipe for one partition — a source step plus a
chain of transform steps — finished by an output mode (return a store ref, cache as
a named block, hash-shuffle into buckets, collect, or count). Tasks being
self-contained *is* the lineage mechanism: any executor can recompute any lost
partition from the recipe, the property the reference gets from Spark RDD lineage +
its recache RPC (ObjectStoreWriter.scala:164-204 persists and pins the Arrow RDD;
RayDPExecutor.scala:289-310 re-caches lost blocks through the driver agent).

Everything here must stay picklable and runnable inside an executor actor process.
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from raydp_tpu_torch import faults
from raydp_tpu_torch.etl.expressions import Expr, evaluate_to_array
from raydp_tpu_torch.runtime.object_store import KIND_RAW, ObjectLostError, \
    ObjectRef, ShuffleStreamAborted, get_client

# -- output modes -------------------------------------------------------------------
RETURN_REF = "return_ref"
CACHE = "cache"
SHUFFLE = "shuffle"
COLLECT = "collect"
ROWCOUNT = "rowcount"


class Step:
    def run(self, table: pa.Table) -> pa.Table:
        raise NotImplementedError


# ==== sources ======================================================================
@dataclass
class RangeSource(Step):
    start: int
    stop: int
    step: int = 1
    column: str = "id"

    def load(self) -> pa.Table:
        return pa.table({self.column: np.arange(self.start, self.stop, self.step)})


@dataclass
class CsvSliceSource(Step):
    """Byte-range slice of a CSV file.

    ``start``/``end`` are *approximate* offsets: the reader skips to the first full
    line at/after ``start`` and reads through the line spanning ``end``. The header
    is re-attached so every slice parses independently — this is how one big CSV
    becomes N parallel partitions without a pre-pass.
    """

    path: str
    start: int
    end: int
    header: bytes
    parse_options: Optional[dict] = None

    def load(self) -> pa.Table:
        with open(self.path, "rb") as f:
            if self.start > 0:
                f.seek(self.start - 1)
                f.readline()  # consume partial line (or the newline ending it)
            pos = f.tell()
            if pos >= self.end and self.start > 0:
                data = b""
            else:
                data = f.read(self.end - pos)
                # extend through the end of the line spanning `end`
                if not data.endswith(b"\n"):
                    data += f.readline()
        payload = self.header + data if self.start > 0 else data
        opts = self.parse_options or {}
        names = opts.get("column_names")  # headerless files (e.g. Criteo TSV)
        parse = pacsv.ParseOptions(delimiter=opts.get("delimiter", ","))
        read = pacsv.ReadOptions(column_names=names) if names \
            else pacsv.ReadOptions()
        convert = pacsv.ConvertOptions(**opts.get("convert", {}))
        if not payload.strip():
            if names:
                # null-typed empties promote to any sibling slice's inferred
                # type under permissive concat (string would not)
                return pa.table({n: pa.array([], pa.null()) for n in names})
            return pacsv.read_csv(io.BytesIO(self.header),
                                  parse_options=parse)[:0]
        return pacsv.read_csv(io.BytesIO(payload), read_options=read,
                              parse_options=parse, convert_options=convert)


@dataclass
class ParquetSource(Step):
    path: str
    row_groups: Optional[List[int]] = None
    columns: Optional[List[str]] = None

    def load(self) -> pa.Table:
        f = pq.ParquetFile(self.path)
        if self.row_groups is None:
            return f.read(columns=self.columns)
        return f.read_row_groups(self.row_groups, columns=self.columns)


def _ranged_fetch_fault(client, parts: List[Tuple["ObjectRef", int, int]],
                        total: int) -> None:
    """The ``shuffle.fetch`` fault site, shared by every ranged reader
    (barrier :class:`RangeRefSource` and streamed
    :class:`StreamingRangeSource` — the chaos matrix compares the two
    directly, so the drop/delay semantics must never diverge): ``drop``
    frees part ``bucket=N``'s backing blob and surfaces the typed loss (the
    store-host-died model); generic actions honor ``ms_per_mb=`` against
    the bytes this read moves."""
    rule = faults.check("shuffle.fetch",
                        key=parts[0][0].id if parts else "")
    if rule is None:
        return
    if rule.action == "drop" and parts:
        victim = parts[rule.bucket % len(parts)][0]
        try:
            client.free([victim])
        except Exception:
            pass
        raise ObjectLostError(victim.id, "fault-injected fetch drop")
    faults.apply(rule, "shuffle.fetch", nbytes=total)


def concat_or_empty(tables: List[pa.Table],
                    schema: Optional[bytes]) -> pa.Table:
    """Concat bucket/block tables; an empty input list falls back to the
    serialized schema (shared by :class:`ArrowRefSource` and
    :class:`RangeRefSource` so both sources agree on the 0-ref case)."""
    if not tables:
        if schema is not None:
            return pa.ipc.read_schema(pa.py_buffer(schema)).empty_table()
        raise ValueError("ref source with no refs and no schema")
    return pa.concat_tables(tables, promote_options="permissive")


@dataclass
class ArrowRefSource(Step):  # carries-refs: refs
    """Concatenate Arrow tables from object-store refs (zero-copy reads)."""

    refs: List[ObjectRef]
    schema: Optional[bytes] = None  # serialized schema for the 0-ref case

    def load(self) -> pa.Table:
        client = get_client()
        return concat_or_empty([client.get(r) for r in self.refs],
                               self.schema)


@dataclass
class RangeRefSource(Step):  # carries-refs: parts
    """Byte-range reads of store blobs: ``(ref, offset, size)`` triples, each
    range an independent Arrow IPC stream — the reduce-side reader of the
    consolidated shuffle path (a map task's B buckets live back-to-back in
    ONE blob; each reduce task decodes only its bucket's slice). Sibling of
    :class:`SlicedRefSource`, but byte-range rather than row-range. A
    full-blob part ``(ref, 0, ref.size)`` reads a legacy single-bucket blob
    identically, so mixed stages decode fine.

    The fetch is batched: one ``lookup_batch`` for all refs (memo hits are
    free), local slices zero-copy out of the attached segment, and one
    ``store_fetch_ranges`` RPC per remote payload host (threaded across
    hosts) — O(hosts) round-trips per reduce task instead of O(maps)."""

    parts: List[Tuple[ObjectRef, int, int]]
    schema: Optional[bytes] = None  # serialized schema for the 0-part case

    def load(self) -> pa.Table:
        from raydp_tpu_torch import profiler

        client = get_client()
        total = sum(size for _, _, size in self.parts)
        # the ranged-read fault site (shared with the streamed reader):
        # ``drop`` removes one part's backing blob and surfaces the typed
        # loss — the store-host-died model for consolidated reduce reads,
        # skew-split portions, and broadcast replicas, all of which must
        # route into lineage recovery
        _ranged_fetch_fault(client, self.parts, total)
        with profiler.trace("shuffle:fetch", "etl", parts=len(self.parts),
                            bytes=total):
            bufs = client.get_range_buffers(self.parts)
        tables = [pa.ipc.open_stream(pa.py_buffer(b)).read_all()
                  for b in bufs]
        return concat_or_empty(tables, self.schema)


@dataclass
class StreamingRangeSource(Step):
    """The pipelined-shuffle reduce reader: consumes seal notifications from
    the store server's per-stage stream ledger and accumulates partial
    fetches — each map task's portion of this bucket is fetched + decoded as
    soon as that map SEALS, overlapping reduce-side work with the map tail
    instead of waiting for the stage barrier (doc/etl.md "Pipelined
    shuffle"). Decoded portions concatenate in ``map_id`` order, so the
    bucket's row order is identical to the barrier-mode
    :class:`RangeRefSource` read of the same stage.

    Generations: a lineage-regenerated producer re-seals under the same
    ``map_id`` with ``gen+1`` and a fresh ``(ref, off, size)``. A portion
    already decoded from the older generation is kept — reruns are
    byte-identical — but a fetch failing :class:`ObjectLostError` on a stale
    range first re-checks the ledger for a newer generation (another reducer
    may have triggered recovery already) and refetches in place; with no
    newer generation the loss rides the existing lineage-recovery path (the
    task fails typed, the engine regenerates + re-seals, and the resubmitted
    task reads the fresh generation).

    An aborted/closed stream raises :class:`ShuffleStreamAborted` (no-retry:
    replaying the consumer replays the abort), carrying the map stage's
    error when there was one.

    After ``load`` the instance carries ``stream_stats``:
    ``overlap_s`` (seconds spent fetching/decoding before the final seal
    notification arrived — the measured map/reduce overlap),
    ``first_fetch_ts`` (wall-clock of the first fetch), and ``rounds``."""

    stage_key: str
    bucket: int
    num_maps: int
    schema: Optional[bytes] = None
    poll_timeout_s: float = 10.0

    def load(self) -> pa.Table:
        from raydp_tpu_torch import profiler

        client = get_client()
        tables: Dict[int, pa.Table] = {}
        gens: Dict[int, int] = {}
        stats = {"overlap_s": 0.0, "first_fetch_ts": None, "rounds": 0}
        self.stream_stats = stats
        while len(tables) < self.num_maps:
            resp = client.stream_poll(self.stage_key, self.bucket, gens,
                                      self.poll_timeout_s)
            if resp.get("aborted"):
                raise ShuffleStreamAborted(
                    f"shuffle stream {self.stage_key} aborted: "
                    f"{resp['aborted']}")
            parts, metas = [], []
            for map_id, gen, ref_id, blob_size, off, size in \
                    resp.get("events") or []:
                if gens.get(map_id, 0) >= gen:
                    continue
                if map_id in tables:
                    # a re-sealed generation of a portion we already hold:
                    # reruns are byte-identical, so keep ours — just adopt
                    # the generation (or the superseded event would come
                    # back on every poll)
                    gens[map_id] = int(gen)
                    continue
                parts.append((ObjectRef(id=ref_id, size=blob_size,
                                        kind=KIND_RAW), int(off), int(size)))
                metas.append((int(map_id), int(gen)))
            if not parts:
                continue
            total = sum(size for _, _, size in parts)
            # does this batch complete the stage? If not, the map tail is
            # still running and the fetch+decode below is measured OVERLAP
            tail_live = len(set(tables) | {m for m, _ in metas}) \
                < self.num_maps
            t0 = time.perf_counter()
            if stats["first_fetch_ts"] is None:
                stats["first_fetch_ts"] = time.time()
            # the fault site sits INSIDE the timed window: an injected
            # per-MiB delay models fetch cost, so it must count as overlap
            _ranged_fetch_fault(client, parts, total)
            try:
                with profiler.trace("shuffle:fetch", "etl",
                                    parts=len(parts), bytes=total,
                                    streamed=True):
                    bufs = client.get_range_buffers(parts)
            except ObjectLostError as e:
                # stale range: a regenerated producer may ALREADY have
                # re-sealed a newer generation — discard this batch (gens
                # uncommitted, so every portion reappears in the next poll)
                # and refetch; no newer generation means the loss is fresh,
                # so surface it into lineage recovery
                probe = client.stream_poll(self.stage_key, self.bucket,
                                           gens, timeout_s=0)
                if probe.get("aborted"):
                    # the map stage died and its sealed blobs were freed —
                    # THAT is why the range is gone. Fail fast with the
                    # abort's real cause instead of sending the typed loss
                    # into a pointless lineage round against a dead stage
                    raise ShuffleStreamAborted(
                        f"shuffle stream {self.stage_key} aborted: "
                        f"{probe['aborted']}") from e
                newer = {m for m, g, *_ in probe.get("events") or []
                         if g > dict(metas).get(m, g)}
                if not newer:
                    raise e
                continue
            for (map_id, gen), buf in zip(metas, bufs):
                tables[map_id] = pa.ipc.open_stream(
                    pa.py_buffer(buf)).read_all()
                gens[map_id] = gen
            dur = time.perf_counter() - t0
            stats["rounds"] += 1
            if tail_live:
                stats["overlap_s"] += dur
        return concat_or_empty([tables[i] for i in range(self.num_maps)],
                               self.schema)


@dataclass
class SlicedRefSource(Step):  # carries-refs: parts
    """Row-range slices of store refs: ``(ref, offset, length)`` triples.

    Used by the balanced sharding path (``divide_blocks``) where a rank takes only
    part of a block (reference utils.py:149-222 returns per-block sample counts).
    """

    parts: List[Tuple[ObjectRef, int, int]]

    def load(self) -> pa.Table:
        client = get_client()
        tables = []
        for ref, offset, length in self.parts:
            t = client.get(ref)
            tables.append(t.slice(offset, length))
        return pa.concat_tables(tables, promote_options="permissive")


@dataclass
class CachedSource(Step):  # carries-refs: recover
    """Executor-local cached block, with a recovery recipe on miss.

    Parity: BlockManager read in ``getRDDPartition`` with recache-then-retry on
    miss (RayDPExecutor.scala:312-355). ``recover`` is the lineage task that
    recomputes the partition from first principles.
    """

    cache_key: str
    recover: Optional["Task"] = None

    def load(self) -> pa.Table:
        from raydp_tpu_torch.etl.executor import current_block_cache
        cache = current_block_cache()
        table = cache.get(self.cache_key)
        if table is None:
            if self.recover is None:
                raise KeyError(f"block {self.cache_key} lost and no lineage recipe")
            table = run_task_body(self.recover)
            cache.put(self.cache_key, table)
        return table


# ==== transforms ===================================================================
@dataclass
class ProjectStep(Step):
    """Output exactly these (name, expr) columns — select / withColumn / drop."""

    columns: List[Tuple[str, Expr]]

    def run(self, table: pa.Table) -> pa.Table:
        arrays, names = [], []
        for name, expr in self.columns:
            arrays.append(evaluate_to_array(expr, table))
            names.append(name)
        return pa.table(dict(zip(names, arrays)))


@dataclass
class FilterStep(Step):
    predicate: Expr

    def run(self, table: pa.Table) -> pa.Table:
        mask = evaluate_to_array(self.predicate, table)
        return table.filter(pc.fill_null(mask, False))


@dataclass
class DropNaStep(Step):
    subset: Optional[List[str]] = None

    def run(self, table: pa.Table) -> pa.Table:
        cols = self.subset or table.column_names
        mask = None
        for c in cols:
            valid = pc.is_valid(table.column(c))
            mask = valid if mask is None else pc.and_(mask, valid)
        return table.filter(mask) if mask is not None else table


@dataclass
class SampleStep(Step):
    fraction: float
    seed: Optional[int] = None
    partition_index: int = 0

    def run(self, table: pa.Table) -> pa.Table:
        seed = (self.seed if self.seed is not None else 0) + self.partition_index
        rng = np.random.RandomState(seed)
        mask = rng.random_sample(table.num_rows) < self.fraction
        return table.filter(pa.array(mask))


@dataclass
class SplitSelectStep(Step):
    """Deterministic random split: keep rows whose draw lands in [lo, hi).

    Powers ``random_split`` (reference utils.py:67-90): every sibling frame uses
    the same seed with a different band, so splits are disjoint and exhaustive.
    """

    lo: float
    hi: float
    seed: int
    partition_index: int = 0

    def run(self, table: pa.Table) -> pa.Table:
        rng = np.random.RandomState(self.seed + self.partition_index)
        draws = rng.random_sample(table.num_rows)
        return table.filter(pa.array((draws >= self.lo) & (draws < self.hi)))


@dataclass
class LocalShuffleStep(Step):
    """Uniform random permutation of the rows of one partition — the reduce
    side of the distributed ``random_shuffle`` (map side: :func:`random_buckets`).
    Runs on the executors; the driver never sees row data."""

    seed: int

    def run(self, table: pa.Table) -> pa.Table:
        if table.num_rows <= 1:
            return table
        rng = np.random.RandomState(self.seed)
        return table.take(pa.array(rng.permutation(table.num_rows)))


@dataclass
class LimitStep(Step):
    n: int

    def run(self, table: pa.Table) -> pa.Table:
        return table.slice(0, self.n)


@dataclass
class DistinctStep(Step):
    """First row per key (``subset``; None → all columns). Globally correct
    when rows were hash-shuffled by the same keys: equal keys share a bucket.
    Keeps original row order of the surviving first occurrences
    (parity surface: Spark ``distinct``/``dropDuplicates``,
    reference examples/data_process.py)."""

    subset: Optional[List[str]] = None

    def run(self, table: pa.Table) -> pa.Table:
        keys = self.subset or table.column_names
        if table.num_rows == 0:
            return table
        row_col = "__rdt_row__"
        # dedupe on normalized keys (±0.0 group together) but keep the
        # surviving rows' ORIGINAL values via the row-index take below
        aug = normalize_group_keys(table, keys).append_column(
            row_col, pa.array(np.arange(table.num_rows, dtype=np.int64)))
        firsts = aug.group_by(keys).aggregate([(row_col, "min")])
        take = firsts.column(f"{row_col}_min").combine_chunks()
        take = take.take(pc.sort_indices(take))  # preserve original order
        return table.take(take)


def window_output_type(fn: str, arg_type=None) -> pa.DataType:
    """Static output type of a window function — used by the empty-bucket
    path AND the frame's derived schema, so both agree with what the
    non-empty pandas/numpy compute actually produces (e.g. lag/lead over
    integers yields float64: pandas shift introduces NaN holes)."""
    if fn in ("row_number", "rank", "dense_rank", "count"):
        return pa.int64()
    if fn == "mean":
        return pa.float64()
    if fn in ("lag", "lead"):
        if arg_type is not None and pa.types.is_integer(arg_type):
            return pa.float64()
        return arg_type if arg_type is not None else pa.float64()
    # sum/min/max keep the argument's type
    return arg_type if arg_type is not None else pa.float64()


@dataclass
class WindowStep(Step):
    """Evaluate one window function over a bucket that holds every row of its
    partitions (guaranteed by the hash shuffle on the partition keys).

    Rows are sorted by (partition, order) keys; group/tie boundaries are
    computed positionally (factorized codes — null-safe, any dtype), ranks by
    numpy index arithmetic, lag/lead/aggregates by a pandas groupby on the
    integer partition id (dtype-preserving: the computed column is appended
    to the ORIGINAL arrow table, none of its columns round-trip)."""

    part_keys: List[str]
    order_keys: List[Tuple[str, str]]
    out_name: str
    fn: str
    arg_col: Optional[str] = None
    offset: int = 1
    default: object = None

    def run(self, table: pa.Table) -> pa.Table:
        import pandas as pd

        n = table.num_rows
        if n == 0:
            arg_t = (table.schema.field(self.arg_col).type
                     if self.arg_col and self.arg_col != "*" else None)
            typ = window_output_type(self.fn, arg_t)
            return table.append_column(self.out_name, pa.array([], typ))
        sort_spec = ([(k, "ascending") for k in self.part_keys]
                     + list(self.order_keys))
        tbl = table.sort_by(sort_spec) if sort_spec else table

        def change_mask(keys) -> np.ndarray:
            mask = np.zeros(n, dtype=bool)
            mask[0] = True
            for k in keys:
                codes, _ = pd.factorize(tbl.column(k).to_pandas(),
                                        use_na_sentinel=True)
                mask[1:] |= codes[1:] != codes[:-1]
            return mask

        idx = np.arange(n, dtype=np.int64)
        group_start = change_mask(self.part_keys) if self.part_keys \
            else (idx == 0)
        grp_first = np.maximum.accumulate(np.where(group_start, idx, 0))

        fn = self.fn
        if fn == "row_number":
            out = pa.array(idx - grp_first + 1)
        elif fn in ("rank", "dense_rank"):
            tie_start = group_start | change_mask(
                [k for k, _ in self.order_keys])
            if fn == "rank":
                tie_first = np.maximum.accumulate(np.where(tie_start, idx, 0))
                out = pa.array(tie_first - grp_first + 1)
            else:
                ties = np.cumsum(tie_start)
                out = pa.array(ties - ties[grp_first] + 1)
        elif fn == "count" and self.arg_col in (None, "*"):
            part_id = np.cumsum(group_start)
            if self.order_keys:
                # running row count (RANGE frame: order-key peers share it)
                rows = idx - grp_first + 1
                out = pa.array(self._range_frame(rows, group_start,
                                                 change_mask, n))
            else:
                # count("*") = partition row count broadcast to every row
                out = pa.array(np.bincount(part_id)[part_id].astype(np.int64))
        else:
            if self.arg_col is None or self.arg_col == "*":
                raise ValueError(f"window function {fn!r} needs a column")
            part_id = np.cumsum(group_start)
            series = tbl.column(self.arg_col).to_pandas()
            g = series.groupby(part_id)
            if fn in ("sum", "mean", "min", "max", "count"):
                if self.order_keys:
                    # Spark's default frame WITH orderBy is unboundedPreceding
                    # ..currentRow — a RUNNING aggregate whose RANGE frame
                    # includes order-key peers (ties share the value). Nulls
                    # are ignored within the frame (pandas cumulatives emit
                    # NaN AT a null row while continuing past it — the
                    # forward fill gives those rows the prior running value;
                    # an all-null prefix correctly stays null)
                    def _ffill(s):
                        return s.groupby(part_id).ffill()

                    if fn == "sum":
                        out_s = _ffill(g.cumsum())
                    elif fn == "min":
                        out_s = _ffill(g.cummin())
                    elif fn == "max":
                        out_s = _ffill(g.cummax())
                    elif fn == "count":
                        out_s = series.notna().astype("int64") \
                            .groupby(part_id).cumsum()
                    else:  # mean
                        nn_cum = series.notna().astype("int64") \
                            .groupby(part_id).cumsum()
                        out_s = _ffill(g.cumsum()) / nn_cum.where(nn_cum > 0)
                    out_s = pd.Series(self._range_frame(
                        out_s.to_numpy(), group_start, change_mask, n))
                else:
                    out_s = g.transform(fn)
            elif fn in ("lag", "lead"):
                shift = self.offset if fn == "lag" else -self.offset
                out_s = g.shift(shift)
                if self.default is not None:
                    out_s = out_s.where(out_s.notna(), self.default)
            else:
                raise ValueError(f"unknown window function {fn!r}")
            out = pa.Array.from_pandas(out_s)
        return tbl.append_column(self.out_name, out)

    def _range_frame(self, rows_cumulative: np.ndarray,
                     group_start: np.ndarray, change_mask, n: int
                     ) -> np.ndarray:
        """ROWS-frame running values → RANGE frame: every row takes the value
        of the LAST row of its order-key tie group (Spark's default frame
        includes current-row peers)."""
        import pandas as pd

        tie_start = group_start | change_mask([k for k, _ in self.order_keys])
        tie_id = np.cumsum(tie_start)
        return pd.Series(rows_cumulative).groupby(tie_id) \
            .transform("last").to_numpy()


@dataclass
class DescribeStep(Step):
    """Per-partition moment partials for ``describe``: one row of
    count/sum/sumsq/min/max per column. The driver merges these K tiny rows —
    never the data."""

    cols: List[str]

    def run(self, table: pa.Table) -> pa.Table:
        out = {}
        for c in self.cols:
            v = pc.cast(table.column(c).drop_null(), pa.float64(), safe=False)
            s = pc.sum(v).as_py()
            sq = pc.sum(pc.multiply(v, v)).as_py()
            out[f"{c}:count"] = [len(v)]
            out[f"{c}:sum"] = [0.0 if s is None else float(s)]
            out[f"{c}:sumsq"] = [0.0 if sq is None else float(sq)]
            out[f"{c}:min"] = [pc.min(v).as_py()]
            out[f"{c}:max"] = [pc.max(v).as_py()]
        return pa.table(out)


@dataclass
class LocalSortStep(Step):
    keys: List[Tuple[str, str]]  # (column, "ascending"|"descending")

    def run(self, table: pa.Table) -> pa.Table:
        return table.sort_by(self.keys)


def normalize_group_keys(table: pa.Table, keys: Sequence[str]) -> pa.Table:
    """-0.0 → +0.0 in float key columns. Arrow's hash grouper (like our
    ``hash_buckets``) distinguishes the two bit patterns even though the keys
    compare equal, so a groupby/distinct would emit duplicate key rows.
    Adding a typed zero flips only -0.0 (NaN/inf/null unchanged)."""
    for k in keys:
        i = table.schema.get_field_index(k)
        column = table.column(i)
        if pa.types.is_floating(column.type):
            zero = pa.scalar(0.0, type=column.type)
            table = table.set_column(i, k, pc.add(column, zero))
    return table


@dataclass
class GroupAggStep(Step):
    """Local hash aggregation; correct as a whole when rows were shuffled by key."""

    keys: List[str]
    aggs: List[Tuple[str, str, str]]  # (input_col, agg_fn, output_name)

    def run(self, table: pa.Table) -> pa.Table:
        table = normalize_group_keys(table, self.keys)
        agg_spec = [(c, f) for c, f, _ in self.aggs]
        out = table.group_by(self.keys).aggregate(agg_spec)
        # rename pyarrow's <col>_<fn> outputs to requested names
        rename = {}
        for c, f, name in self.aggs:
            rename[f"{c}_{f}"] = name
        new_names = [rename.get(n, n) for n in out.column_names]
        return out.rename_columns(new_names)


def decompose_aggs(aggs: List[Tuple[str, str, str]]
                   ) -> Tuple[List[Tuple[str, str, str]],
                              List[Tuple[str, str, List[str]]]]:
    """Split decomposable aggregates into map-side partials + a reduce-side
    merge plan (two-phase aggregation).

    Returns ``(partials, merges)``: ``partials`` are ``(col, fn, partial_name)``
    specs computed per map task BEFORE the shuffle (deduped, so ``mean`` +
    ``sum`` over one column share a partial); ``merges`` are
    ``(out_name, kind, partial_names)`` where ``kind`` is how the reduce side
    combines partials — ``sum`` (also merges counts), ``min``/``max``, or
    ``mean`` (sum-of-sums / sum-of-counts with a float64 divide)."""
    partial_names: Dict[Tuple[str, str], str] = {}
    partials: List[Tuple[str, str, str]] = []

    def need(c: str, f: str) -> str:
        key = (c, f)
        if key not in partial_names:
            name = f"__rdt_p_{f}_{c}"
            partial_names[key] = name
            partials.append((c, f, name))
        return partial_names[key]

    merges: List[Tuple[str, str, List[str]]] = []
    for c, f, out in aggs:
        if f == "mean":
            merges.append((out, "mean", [need(c, "sum"), need(c, "count")]))
        elif f == "count":
            merges.append((out, "sum", [need(c, "count")]))
        elif f == "sum":
            merges.append((out, "sum", [need(c, "sum")]))
        elif f in ("min", "max"):
            merges.append((out, f, [need(c, f)]))
        else:
            raise ValueError(f"aggregate {f!r} is not decomposable")
    return partials, merges


@dataclass
class GroupAggPartialStep(Step):
    """Map-side partial aggregation: one row per (map task, key) crosses the
    shuffle instead of every input row — the shuffle-byte reduction of
    two-phase aggregation. Output columns: [keys..., partial names...].

    High-cardinality guard: when a sampled prefix shows the keys are mostly
    distinct, a hash aggregation would shrink nothing while paying a full
    grouping pass per map task (the committed bench recorded +47% wall on
    the 100k-cardinality config before this guard). In that case each row is
    emitted AS its own partial — computed vectorized, no hash table: the
    reduce-side merge is oblivious, a raw row is just a group of size 1."""

    keys: List[str]
    partials: List[Tuple[str, str, str]]  # (input_col, fn, partial_name)

    #: sampled-prefix size and the distinct-fraction above which grouping is
    #: judged not worth a per-map hash pass
    SAMPLE_ROWS = 2048
    DISTINCT_FRACTION = 0.5

    def run(self, table: pa.Table) -> pa.Table:
        table = normalize_group_keys(table, self.keys)
        if self.keys and table.num_rows >= 256:
            sample = table.select(self.keys).slice(0, self.SAMPLE_ROWS)
            distinct = sample.group_by(self.keys).aggregate([]).num_rows
            if distinct > self.DISTINCT_FRACTION * sample.num_rows:
                return self._rowwise(table)
        spec = [(c, f) for c, f, _ in self.partials]
        out = table.group_by(self.keys).aggregate(spec)
        rename = {f"{c}_{f}": name for c, f, name in self.partials}
        return out.rename_columns(
            [rename.get(n, n) for n in out.column_names])

    def _rowwise(self, table: pa.Table) -> pa.Table:
        """Per-row partials in the exact schema the grouped path emits (an
        empty-slice group_by probes the aggregate output types, so e.g. an
        int32 sum partial correctly widens to int64)."""
        spec = [(c, f) for c, f, _ in self.partials]
        probe = table.slice(0, 0).group_by(self.keys).aggregate(spec)
        arrays = [table.column(k) for k in self.keys]
        names = list(self.keys)
        for c, f, name in self.partials:
            typ = probe.schema.field(f"{c}_{f}").type
            if f == "count":
                # count of one value: 1 when valid, 0 when null (never null)
                arr = pc.cast(pc.is_valid(table.column(c)), typ)
            else:
                # sum/min/max of one value is the value (null stays null, so
                # the merge-side aggregate skips it, exactly like grouping)
                arr = pc.cast(table.column(c), typ, safe=False)
            arrays.append(arr)
            names.append(name)
        return pa.table(arrays, names=names)


@dataclass
class GroupAggMergeStep(Step):
    """Reduce-side merge of map-side partials. Emits exactly the schema the
    single-phase :class:`GroupAggStep` would: keys first, then one column per
    requested aggregate, in order."""

    keys: List[str]
    merges: List[Tuple[str, str, List[str]]]  # (out_name, kind, partial_names)

    def run(self, table: pa.Table) -> pa.Table:
        spec, seen = [], set()
        for _, kind, ops in self.merges:
            pairs = ([(ops[0], "sum"), (ops[1], "sum")] if kind == "mean"
                     else [(ops[0], kind)])
            for p in pairs:
                if p not in seen:
                    seen.add(p)
                    spec.append(p)
        merged = table.group_by(self.keys).aggregate(spec)
        arrays = [merged.column(k) for k in self.keys]
        names = list(self.keys)
        for out, kind, ops in self.merges:
            if kind == "mean":
                s = merged.column(f"{ops[0]}_sum")
                c = merged.column(f"{ops[1]}_sum")
                arr = pc.divide(pc.cast(s, pa.float64(), safe=False),
                                pc.cast(c, pa.float64(), safe=False))
            else:
                arr = merged.column(f"{ops[0]}_{kind}")
            arrays.append(arr)
            names.append(out)
        return pa.table(arrays, names=names)


@dataclass
class GroupAggPartialMergeStep(Step):
    """Merge map-side partials INTO partials (same schema in, same schema
    out): the intermediate level of a skew-split aggregation. A hot bucket's
    byte-ranges split across k reduce tasks, each running this step over its
    portion; the outputs stay in partial form (count partials re-sum, sums
    sum, min/min max/max) so the combining task's ordinary
    :class:`GroupAggMergeStep` finishes them exactly as if the bucket had
    never been split — mean still divides only once, at the end."""

    keys: List[str]
    partials: List[Tuple[str, str, str]]  # (input_col, fn, partial_name)

    def run(self, table: pa.Table) -> pa.Table:
        spec = [(name, "sum" if f in ("count", "sum") else f)
                for _, f, name in self.partials]
        out = table.group_by(self.keys).aggregate(spec)
        rename = {f"{name}_{fn}": name for (_, _, name), (_, fn)
                  in zip(self.partials, spec)}
        return out.rename_columns(
            [rename.get(n, n) for n in out.column_names])


@dataclass
class HashJoinStep(Step):  # carries-refs: right_refs, right_parts, right_stream
    """Join the incoming (left bucket) table against the right bucket refs.

    ``right_parts`` (byte-range triples) carries the right side when it was
    shuffled through consolidated map outputs; ``right_stream`` when the
    right map stage is PIPELINED (the build side accumulates from seal
    notifications while both map stages still run); otherwise ``right_refs``
    holds whole-blob refs, exactly as before."""

    right_refs: List[ObjectRef]
    keys: List[str]
    right_keys: List[str]
    how: str = "inner"
    right_schema: Optional[bytes] = None
    right_parts: Optional[List[Tuple[ObjectRef, int, int]]] = None
    right_stream: Optional[StreamingRangeSource] = None

    def run(self, table: pa.Table) -> pa.Table:
        if self.right_stream is not None:
            right = self.right_stream.load()
        elif self.right_parts is not None:
            right = RangeRefSource(self.right_parts,
                                   schema=self.right_schema).load()
        else:
            right = ArrowRefSource(self.right_refs,
                                   schema=self.right_schema).load()
        return table.join(right, keys=self.keys, right_keys=self.right_keys,
                          join_type=self.how)


#: join types for which each broadcast side is semantically safe: the
#: STREAMED side's rows are partitioned (each row seen exactly once), so its
#: unmatched rows surface correctly; the BROADCAST side's unmatched rows
#: would be emitted once per probe partition, so any join type that keeps
#: them ("full outer", the broadcast side's own outer) is excluded.
BROADCAST_RIGHT_JOIN_TYPES = frozenset(
    ("inner", "left outer", "left semi", "left anti"))
BROADCAST_LEFT_JOIN_TYPES = frozenset(
    ("inner", "right outer", "right semi", "right anti"))


@dataclass
class BroadcastJoinStep(Step):  # carries-refs: parts
    """Broadcast-hash join: stream this task's partition against an
    executor-local hash table of the (small) broadcast side.

    ``parts`` are ``(ref, offset, size)`` byte ranges of the broadcast
    side's store blobs — replication IS the ranged-fetch plane: the first
    task on each executor pulls every range in one batched fetch
    (:class:`RangeRefSource`) and the built table is kept in the executor's
    bounded broadcast cache, so sibling partitions probe it for free.
    ``broadcast_side`` says which logical side the cached table plays:
    ``"right"`` probes the incoming (left) partition against it, ``"left"``
    streams right-side partitions. Either way the output schema matches the
    bucketed :class:`HashJoinStep` exactly (left columns, then the right's
    non-key columns)."""

    parts: List[Tuple[ObjectRef, int, int]]
    keys: List[str]
    right_keys: List[str]
    how: str = "inner"
    broadcast_side: str = "right"
    schema: Optional[bytes] = None  # broadcast side's serialized schema

    def _load_small(self) -> pa.Table:
        from raydp_tpu_torch.etl.executor import broadcast_cache
        key = (tuple((r.id, int(o), int(s)) for r, o, s in self.parts),
               self.schema)
        return broadcast_cache().get_or_load(
            key, lambda: RangeRefSource(list(self.parts),
                                        schema=self.schema).load())

    def run(self, table: pa.Table) -> pa.Table:
        small = self._load_small()
        if self.broadcast_side == "right":
            return table.join(small, keys=self.keys,
                              right_keys=self.right_keys, join_type=self.how)
        return small.join(table, keys=self.keys,
                          right_keys=self.right_keys, join_type=self.how)


@dataclass
class RenameStep(Step):
    mapping: Dict[str, str]

    def run(self, table: pa.Table) -> pa.Table:
        return table.rename_columns(
            [self.mapping.get(c, c) for c in table.column_names])


# ==== task =========================================================================
@dataclass
class Task:
    task_id: str
    source: Step
    steps: List[Step] = field(default_factory=list)
    output: str = RETURN_REF
    # SHUFFLE parameters
    num_buckets: int = 0
    shuffle_keys: Optional[List[str]] = None      # None → round-robin repartition
    shuffle_seed: Optional[int] = None            # set → seeded random bucketing
    # CACHE parameter
    cache_key: Optional[str] = None
    # range-partition spec for sort (overrides hash bucketing):
    # (key, boundaries, nulls_high); legacy 2-tuples are tolerated
    range_key: Optional[Tuple[str, List, bool]] = None
    owner: Optional[str] = None                   # object-store owner for outputs
    # how many TRAILING steps are shuffle-side (e.g. map-side partial
    # aggregation): the executor measures rows/bytes entering the shuffle
    # stage BEFORE these run, so the in/out counters show the reduction
    shuffle_pre_steps: int = 0
    # SHUFFLE output writes all buckets as ONE consolidated blob (back-to-back
    # IPC streams + per-bucket index) sealed with a single RPC; decided by the
    # driver per action (RDT_SHUFFLE_CONSOLIDATE) so a mid-session toggle
    # never splits one stage across the two formats
    shuffle_consolidate: bool = False
    # the shuffle-stage label this task READS (set on reduce tasks): its
    # store-RPC counters are attributed to that stage's ledger entry
    consumes_stage: Optional[str] = None
    # the UNIQUE stream stage_key this task reads when that stage is
    # PIPELINED — labels repeat within one action (a.join(b).join(c) runs
    # "join-left" twice), so the driver's attribution/wait logic must key
    # on this, never the label
    consumes_stream: Optional[str] = None

    def with_output(self, **kw) -> "Task":
        d = self.__dict__.copy()
        d.update(kw)
        return Task(**d)


def run_task_body(task: Task) -> pa.Table:
    src = task.source
    table = src.load()
    for step in task.steps:
        table = step.run(table)
    return table


# ==== pipelined-shuffle helpers ====================================================
def stream_sources_of(task: Task) -> List[StreamingRangeSource]:
    """Every :class:`StreamingRangeSource` a task reads through — its source,
    a join step's streamed build side, or a cached recipe's nested task. The
    executor routes tasks with any of these onto dedicated stream threads
    (they WAIT on seal notifications, and parking a bounded dispatcher
    thread on that wait could deadlock the very map tasks being waited on)."""
    out: List[StreamingRangeSource] = []

    def _step(step: Step) -> None:
        if isinstance(step, StreamingRangeSource):
            out.append(step)
        rs = getattr(step, "right_stream", None)
        if isinstance(rs, StreamingRangeSource):
            out.append(rs)
        if isinstance(step, CachedSource) and step.recover is not None:
            out.extend(stream_sources_of(step.recover))

    _step(task.source)
    for s in task.steps:
        _step(s)
    return out


def collect_stream_stats(task: Task) -> Dict[str, float]:
    """Fold the per-source ``stream_stats`` left behind by a streamed read
    into the result keys the driver's stage ledger aggregates."""
    srcs = [s for s in stream_sources_of(task)
            if getattr(s, "stream_stats", None) is not None]
    if not srcs:
        return {}
    out: Dict[str, float] = {
        "stream_overlap_s": sum(s.stream_stats["overlap_s"] for s in srcs),
        "stream_rounds": sum(s.stream_stats["rounds"] for s in srcs),
    }
    firsts = [s.stream_stats["first_fetch_ts"] for s in srcs
              if s.stream_stats["first_fetch_ts"] is not None]
    if firsts:
        out["stream_first_fetch_ts"] = min(firsts)
    return out


def resolve_stream_sources(task: Task, resolver) -> Task:
    """Rewrite a task's streaming reads into concrete
    :class:`RangeRefSource` reads — ``resolver(stage_key, bucket)`` returns
    the final ``(ref, off, size)`` parts once the stage's maps have ALL
    sealed. Used before a task is serialized to OUTLIVE its action (cache()
    recover recipes): the stream ledger closes with the action, so a recipe
    kept in streaming form would be permanently unreadable."""
    import dataclasses

    def _res(step: Step) -> Step:
        if isinstance(step, StreamingRangeSource):
            return RangeRefSource(resolver(step.stage_key, step.bucket),
                                  schema=step.schema)
        if isinstance(step, HashJoinStep) \
                and isinstance(step.right_stream, StreamingRangeSource):
            rs = step.right_stream
            return dataclasses.replace(
                step, right_stream=None,
                right_parts=resolver(rs.stage_key, rs.bucket),
                right_schema=step.right_schema or rs.schema)
        if isinstance(step, CachedSource) and step.recover is not None:
            recover = resolve_stream_sources(step.recover, resolver)
            if recover is not step.recover:
                return dataclasses.replace(step, recover=recover)
        return step

    source = _res(task.source)
    steps = [_res(s) for s in task.steps]
    if source is task.source \
            and all(a is b for a, b in zip(steps, task.steps)):
        return task
    return task.with_output(source=source, steps=steps)


# ==== lineage-recovery ref surgery =================================================
def task_input_ids(task: Task) -> List[str]:
    """Object ids a task reads — the refs lineage recovery must keep alive
    (or regenerate) for the task to run."""
    ids: List[str] = []

    def _step(step: Step) -> None:
        if isinstance(step, ArrowRefSource):
            ids.extend(r.id for r in step.refs)
        elif isinstance(step, (SlicedRefSource, RangeRefSource)):
            ids.extend(r.id for r, _, _ in step.parts)
        elif isinstance(step, HashJoinStep):
            ids.extend(r.id for r in step.right_refs)
            if step.right_parts is not None:
                ids.extend(r.id for r, _, _ in step.right_parts)
        elif isinstance(step, BroadcastJoinStep):
            ids.extend(r.id for r, _, _ in step.parts)
        elif isinstance(step, CachedSource) and step.recover is not None:
            ids.extend(task_input_ids(step.recover))

    _step(task.source)
    for s in task.steps:
        _step(s)
    return ids


def _patch_step_refs(step: Step, mapping: Dict[str, ObjectRef]) -> Step:
    import dataclasses
    if isinstance(step, ArrowRefSource):
        refs = [mapping.get(r.id, r) for r in step.refs]
        if refs != step.refs:
            return dataclasses.replace(step, refs=refs)
    elif isinstance(step, (SlicedRefSource, RangeRefSource)):
        # offsets/sizes survive the swap: producer reruns are deterministic,
        # so a regenerated consolidated blob is byte-identical and the
        # bucket index still addresses it
        parts = [(mapping.get(r.id, r), o, n) for r, o, n in step.parts]
        if parts != step.parts:
            return dataclasses.replace(step, parts=parts)
    elif isinstance(step, HashJoinStep):
        refs = [mapping.get(r.id, r) for r in step.right_refs]
        parts = step.right_parts
        if parts is not None:
            new_parts = [(mapping.get(r.id, r), o, n) for r, o, n in parts]
            if new_parts != parts:
                parts = new_parts
        if refs != step.right_refs or parts is not step.right_parts:
            return dataclasses.replace(step, right_refs=refs,
                                       right_parts=parts)
    elif isinstance(step, BroadcastJoinStep):
        # regenerated broadcast blobs are byte-identical (deterministic
        # producer reruns), so offsets/sizes survive — and the fresh ids
        # change the executor-side broadcast-cache key, forcing a refetch
        parts = [(mapping.get(r.id, r), o, n) for r, o, n in step.parts]
        if parts != step.parts:
            return dataclasses.replace(step, parts=parts)
    elif isinstance(step, CachedSource) and step.recover is not None:
        recover = patch_task_refs(step.recover, mapping)
        if recover is not step.recover:
            return dataclasses.replace(step, recover=recover)
    return step


def patch_task_refs(task: Task, mapping: Dict[str, ObjectRef]) -> Task:
    """Rewrite a task to read regenerated blobs: every ObjectRef whose id is
    in ``mapping`` (old id → fresh ref) is swapped, everywhere a task can hold
    refs. Returns the original task object when nothing matched."""
    if not mapping:
        return task
    source = _patch_step_refs(task.source, mapping)
    steps = [_patch_step_refs(s, mapping) for s in task.steps]
    if source is task.source and all(a is b for a, b in zip(steps, task.steps)):
        return task
    return task.with_output(source=source, steps=steps)


def split_by_bucket(table: pa.Table, bucket: np.ndarray,
                    num_buckets: int) -> List[pa.Table]:
    """One-pass bucket split: a single stable argsort + ``take`` + zero-copy
    slices, replacing the per-bucket ``table.filter`` loop that scanned the
    whole table once PER bucket (O(rows × buckets) passes). The stable sort
    preserves original row order within each bucket, exactly like the
    sequential filters did."""
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket, minlength=num_buckets)
    arranged = table.take(pa.array(order))
    out, off = [], 0
    for c in counts:
        out.append(arranged.slice(off, int(c)))
        off += int(c)
    return out


def _hash_string_like(arr: pa.Array) -> np.ndarray:
    """Vectorized hash for string/other non-numeric key columns: dictionary-
    encode (a single C++ pass), hash each DISTINCT value once, then gather by
    index — the old path called ``str(v)`` + crc32 on every ROW via
    ``to_pylist``. Dictionary-typed columns use their existing dictionary
    directly instead of falling into the per-row slow path."""
    if pa.types.is_dictionary(arr.type):
        dict_arr = arr
    else:
        try:
            dict_arr = pc.dictionary_encode(arr)
        except pa.ArrowException:
            # not dictionary-encodable (e.g. nested struct/list keys): keep
            # the per-row path the pre-vectorized code used
            return np.array([hash_bytes(str(v)) for v in arr.to_pylist()],
                            dtype=np.uint64)
    if isinstance(dict_arr, pa.ChunkedArray):
        dict_arr = dict_arr.combine_chunks()
    distinct = dict_arr.dictionary.to_pylist()
    # one extra slot for nulls: fill_null routes null indices there, and the
    # sentinel hashes like str(None) did on the old per-row path
    h = np.empty(len(distinct) + 1, dtype=np.uint64)
    for i, v in enumerate(distinct):
        h[i] = hash_bytes(str(v))
    h[len(distinct)] = hash_bytes(str(None))
    idx = np.asarray(pc.fill_null(pc.cast(dict_arr.indices, pa.int64()),
                                  len(distinct)))
    return h[idx]


def hash_buckets(table: pa.Table, keys: Sequence[str], num_buckets: int) -> List[pa.Table]:
    """Deterministic hash partitioning on key columns.

    Uses a stable numpy-side hash over the key columns so map tasks on different
    executors agree — Python's ``hash`` is salted per process and unusable here.
    The sentinel key list ``["*"]`` means "all columns" (used by ``distinct``,
    whose key set is the full row and unknown until the table is loaded).
    """
    if list(keys) == ["*"]:
        keys = table.column_names
    if table.num_rows == 0:
        return [table] * num_buckets
    acc = np.zeros(table.num_rows, dtype=np.uint64)
    for k in keys:
        arr = table.column(k).combine_chunks()
        if pa.types.is_integer(arr.type) or pa.types.is_floating(arr.type):
            vals = np.asarray(pc.cast(arr, pa.float64(), safe=False).fill_null(np.nan))
            # -0.0 == 0.0 but their bit patterns differ: equal keys must hash
            # equal or a groupby emits duplicate key rows
            vals = np.where(vals == 0.0, 0.0, vals)
            h = vals.view(np.uint64).copy()
        else:
            h = _hash_string_like(arr)
        acc = acc * np.uint64(1000003) + h
    # avalanche finalizer (murmur3 fmix64): the raw accumulator's LOW bits
    # are degenerate for numeric keys — a small integer's float64 bit
    # pattern ends in zero mantissa bits, so ``acc % 2^k`` put EVERY
    # integer-keyed row in bucket 0 whenever the bucket count was a power
    # of two (the default ``min(8, 2×executors)`` always is). Mixing the
    # high bits down gives the uniform spread the skew detector and the
    # per-bucket size index assume. Deterministic across executors, like
    # the accumulator itself.
    acc = acc ^ (acc >> np.uint64(33))
    acc = acc * np.uint64(0xFF51AFD7ED558CCD)
    acc = acc ^ (acc >> np.uint64(33))
    bucket = (acc % np.uint64(num_buckets)).astype(np.int64)
    return split_by_bucket(table, bucket, num_buckets)


def hash_bytes(s: str) -> int:
    import zlib
    return zlib.crc32(s.encode()) & 0xFFFFFFFF


def random_buckets(table: pa.Table, num_buckets: int,
                   seed: int) -> List[pa.Table]:
    """Seeded uniform random bucket assignment — the map side of the
    distributed ``random_shuffle``. Deterministic per (seed, partition), so a
    recomputed map task lands every row in the same bucket."""
    if table.num_rows == 0:
        return [table] * num_buckets
    rng = np.random.RandomState(seed)
    bucket = rng.randint(0, num_buckets, size=table.num_rows)
    return split_by_bucket(table, bucket, num_buckets)


def round_robin_buckets(table: pa.Table, num_buckets: int,
                        start: int = 0) -> List[pa.Table]:
    if table.num_rows == 0:
        return [table] * num_buckets
    idx = (np.arange(table.num_rows) + start) % num_buckets
    return split_by_bucket(table, idx, num_buckets)


def range_buckets_multi(table: pa.Table, keys: List[Tuple[str, str]],
                        boundaries: List[Tuple]) -> List[pa.Table]:
    """Range partitioning on a COMPOSITE sort key.

    ``keys`` are ``(column, "ascending"|"descending")`` pairs; ``boundaries``
    are key tuples drawn from a sorted sample. A row's bucket is the number of
    boundaries it sorts AFTER — lexicographic comparison honoring each key's
    direction, with null keys sorting last (matching ``sort_by``'s ``at_end``
    placement) — so buckets come out already in global sort order for any
    direction mix, no reversal step. Single-key skew is why this exists: with
    a low-cardinality first key, per-key boundaries collapse and only the
    composite key can spread rows."""
    bucket = np.zeros(table.num_rows, dtype=np.int64)
    cols = {name: table.column(name).combine_chunks() for name, _ in keys}
    nan_masks = {}
    for name, _ in keys:
        arr = cols[name]
        if pa.types.is_floating(arr.type):
            nan_masks[name] = pc.fill_null(pc.is_nan(arr), False)
    for bvals in boundaries:
        after = None
        # build lexicographic "sorts after boundary" from the LAST key back:
        # after_k = gt_k OR (eq_k AND after_{k+1})
        for (name, order), b in reversed(list(zip(keys, bvals))):
            arr = cols[name]
            cmp = pc.less if order == "descending" else pc.greater
            gt = pc.fill_null(cmp(arr, pa.scalar(b)), True)  # nulls sort last
            nan = nan_masks.get(name)
            if nan is not None and order != "descending":
                # Arrow orders NaN above every number: ascending sorts place
                # it after any boundary (pc.greater says False there);
                # descending already gets bucket 0 from pc.less = False
                gt = pc.or_(gt, nan)
            if after is None:
                after = gt
            else:
                eq = pc.fill_null(pc.equal(arr, pa.scalar(b)), False)
                after = pc.or_(gt, pc.and_(eq, after))
        if after is not None:
            bucket += np.asarray(after, dtype=np.int64)
    return split_by_bucket(table, bucket, len(boundaries) + 1)


def range_buckets(table: pa.Table, key: str, boundaries: List,
                  nulls_high: bool = False) -> List[pa.Table]:
    """Partition rows by boundary values using Arrow comparisons — works for any
    orderable type (ints, floats, strings, timestamps), no numeric cast.

    ``nulls_high`` routes null keys to the LAST bucket instead of the first:
    ``sort_by`` places nulls at_end within each bucket, so a globally correct
    ascending sort needs them in the final bucket (descending sorts reverse
    the bucket list, so there nulls stay in bucket 0 which becomes last)."""
    col_arr = table.column(key).combine_chunks()
    bucket = np.zeros(table.num_rows, dtype=np.int64)
    for b in boundaries:
        gt = pc.fill_null(pc.greater(col_arr, pa.scalar(b)), nulls_high)
        bucket += np.asarray(gt, dtype=np.int64)
    return split_by_bucket(table, bucket, len(boundaries) + 1)
