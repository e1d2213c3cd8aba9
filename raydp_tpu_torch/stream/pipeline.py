"""Continuous pipelines: micro-batched epochs over the batch ETL engine —
the port's copy of :mod:`raydp_tpu.stream.pipeline` (imports renamed).

:func:`read_stream` turns a
:class:`~raydp_tpu_torch.stream.sources.StreamSource` into a
:class:`ContinuousPipeline`. Each source micro-batch runs as one
**incremental shuffle epoch**: the batch becomes an in-store frame, the
pipeline's ``transform`` (the full DataFrame surface — filter/project/
groupagg/join against static or broadcast sides) runs as an ordinary engine
action (AQE, pipelined shuffle, speculation, lineage recovery and the
abort/no-orphan contract all apply inside the epoch), and the epoch's
result seals into the object store as one Arrow blob **published through
the store's shuffle stream ledger** (stage key = the pipeline id, map id =
the epoch id) — downstream consumers (:meth:`ContinuousPipeline.epoch_stream`,
``EstimatorInterface.partial_fit``) long-poll the ledger and ranged-fetch
each epoch as its seal lands, exactly like a pipelined shuffle's reducers.

**Windowed aggregations** (tumbling/sliding over epoch ids) carry stateful
partials across epochs *via the store*: every epoch materializes a partial
aggregate (decomposable ops — sum/count/min/max/mean) whose refs persist
until every window containing the epoch has closed; a closing window merges
its partials with one more engine action.

**Exactly-once.** A lost epoch blob (``ObjectLostError`` — host died, spill
file lost, chaos ``stream.epoch:drop``) is replayed through the source's
deterministic journal: the pipeline re-derives the epoch's rows, re-runs
the same transform/partial action, and re-seals — window merges retry over
the replayed partials, and a re-sealed epoch RESULT publishes under
``gen+1`` so in-flight consumers discard and refetch (the ledger's
generation semantics). Replays are byte-identical to the original epoch, so
a chaos run's window results match an unfaulted run exactly, with every
epoch contributing exactly once.

Driver threads only — nothing here runs on an RPC dispatcher.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import pyarrow as pa

from raydp_tpu_torch import faults, knobs, metrics, profiler
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime.object_store import (
    KIND_ARROW,
    ObjectLostError,
    ObjectRef,
    get_client,
)
from raydp_tpu_torch.stream.sources import StreamError, StreamSource

logger = get_logger("stream.pipeline")

#: decomposable window ops: per-epoch partial column -> merge op
_WINDOW_OPS = ("sum", "count", "min", "max", "mean")


@dataclass(frozen=True)
class WindowResult:
    """One closed window: epochs ``[start, end]`` inclusive, rows sorted by
    the window keys (groupagg row order is otherwise unspecified)."""

    start: int
    end: int
    table: pa.Table


@dataclass
class EpochResult:
    """One completed epoch: the sealed result blob + any windows that
    closed at this epoch."""

    epoch: int
    input_rows: int
    ref: ObjectRef          # the sealed epoch-result blob (ledger-published)
    num_rows: int           # rows in the result blob
    wall_s: float
    schema: Optional[pa.Schema] = None   # captured at seal time
    windows: List[WindowResult] = field(default_factory=list)

    def table(self) -> pa.Table:
        return get_client().get(self.ref)

    def dataset(self):
        """The epoch result as a 1-block dataset for the feed plane."""
        from raydp_tpu_torch.data.dataset import (
            BlockMeta, DistributedDataset,
        )
        schema = self.schema if self.schema is not None else \
            self.table().schema  # replay-constructed results fall back
        return DistributedDataset(
            [BlockMeta(num_rows=self.num_rows, ref=self.ref)], schema)


@dataclass(frozen=True)
class _WindowSpec:
    size: int
    slide: int
    keys: Tuple[str, ...]
    aggs: Tuple[Tuple[str, str], ...]   # (column, op) pairs, output order

    def primitives(self) -> List[Tuple[str, str]]:
        """The decomposable (op, column) partials the spec needs (mean
        expands to sum+count), deduplicated, stable order."""
        need: List[Tuple[str, str]] = []
        for c, op in self.aggs:
            ops = ("sum", "count") if op == "mean" else (op,)
            for p in ops:
                if (p, c) not in need:
                    need.append((p, c))
        return need


def read_stream(source: StreamSource, session=None,
                name: Optional[str] = None) -> "ContinuousPipeline":
    """Open a continuous pipeline over ``source`` on an ETL session
    (default: the active one)."""
    if session is None:
        from raydp_tpu_torch.context import active_session
        session = active_session()
    if session is None:
        raise ValueError("read_stream needs a live session: pass session= "
                         "or call raydp_tpu_torch.init() first")
    return ContinuousPipeline(source, session, name=name)


class ContinuousPipeline:
    """See module docstring. Build with :func:`read_stream`, shape with
    :meth:`transform` / :meth:`window`, then either drive it inline
    (:meth:`step` / :meth:`epochs`) or in the background (:meth:`start`)
    while consumers follow :meth:`epoch_stream`."""

    def __init__(self, source: StreamSource, session, name: Optional[str] = None):
        self.source = source
        self.session = session
        self.name = name or f"stream-{uuid.uuid4().hex[:6]}"
        self._transform: Optional[Callable] = None
        self._window: Optional[_WindowSpec] = None
        self._lock = threading.Lock()
        #: epoch -> (partial refs, partial schema bytes)
        self._partials: Dict[int, Tuple[List[ObjectRef], bytes]] = {}  # guarded-by: _lock
        #: epoch -> (generation, result ref) of the published epoch blob
        self._results: Dict[int, Tuple[int, ObjectRef]] = {}  # guarded-by: _lock
        self._stage_key = f"stream:{self.name}"
        self._begun = False
        self._closed = False
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._sink_error: Optional[BaseException] = None
        # counters for report()
        self._epoch_walls: List[float] = []
        self._rows_in = 0
        self._windows_closed = 0
        self._replays = 0

    # ---- builder surface ----------------------------------------------------
    def transform(self, fn: Callable) -> "ContinuousPipeline":
        """Per-epoch plan builder: ``fn(df) -> df`` over the micro-batch
        frame, with the whole DataFrame API available (filter/project/
        groupagg/joins against static frames of the same session). Must be
        deterministic — it is re-run verbatim on replay."""
        self._transform = fn
        return self

    def window(self, size: int, keys: List[str], aggs: Dict[str, Any],
               slide: Optional[int] = None) -> "ContinuousPipeline":
        """Windowed aggregation over epoch ids: every ``slide`` epochs
        (default ``size`` — tumbling), the window of the last ``size``
        epochs merges its per-epoch partials. ``aggs`` maps column ->
        op (or list of ops) from sum/count/min/max/mean; output columns
        are named ``<column>_<op>``."""
        if size < 1 or (slide is not None and slide < 1):
            raise ValueError("window size/slide must be >= 1")
        pairs: List[Tuple[str, str]] = []
        for c, ops in aggs.items():
            for op in ([ops] if isinstance(ops, str) else list(ops)):
                if op not in _WINDOW_OPS:
                    raise ValueError(f"unsupported window op {op!r}; "
                                     f"have {_WINDOW_OPS}")
                pairs.append((c, op))
        self._window = _WindowSpec(size=int(size), slide=int(slide or size),
                                   keys=tuple(keys), aggs=tuple(pairs))
        return self

    # ---- the epoch step ------------------------------------------------------
    def step(self, timeout_s: Optional[float] = None) -> Optional[EpochResult]:
        """Run ONE epoch inline: poll the source, run the transform as an
        engine action, seal + publish the result, materialize window
        partials, close any due windows. None when the source had nothing
        within the poll timeout."""
        if self._closed:
            raise StreamError(f"pipeline {self.name} is closed")
        mb = self.source.next_batch(timeout_s)
        if mb is None:
            return None
        t0 = time.perf_counter()
        with profiler.trace("stream:epoch", "stream", pipeline=self.name,
                            epoch=mb.epoch, rows=mb.table.num_rows):
            key = f"{self.name}|{mb.epoch}"
            rule = faults.check("stream.epoch", key=key)
            drop_after = rule is not None and rule.action == "drop"
            if rule is not None and not drop_after:
                faults.apply(rule, "stream.epoch")
            result_ref, nrows, schema = self._run_epoch(mb.epoch, mb.table)
            self._publish(mb.epoch, 1, result_ref)
            if drop_after:
                # the chaos plane's epoch-blob loss: the freshly sealed
                # partials (or, windowless, the result blob) vanish
                # post-commit — the merge/consumer path must replay
                self._drop_epoch_blobs(mb.epoch)
            windows = [self._close_window(s, mb.epoch)
                       for s in self._due_windows(mb.epoch)]
        wall = time.perf_counter() - t0
        self._rows_in += mb.table.num_rows
        self._epoch_walls.append(wall)
        if len(self._epoch_walls) > 4096:
            del self._epoch_walls[:-4096]
        metrics.inc("stream_epochs_total")
        metrics.inc("stream_rows_total", mb.table.num_rows)
        metrics.observe("stream_epoch_seconds", wall)
        self._retire_old(mb.epoch)
        return EpochResult(epoch=mb.epoch, input_rows=mb.table.num_rows,
                           ref=result_ref, num_rows=nrows, wall_s=wall,
                           schema=schema, windows=windows)

    def _run_epoch(self, epoch: int, table: pa.Table,
                   replay: bool = False
                   ) -> Tuple[ObjectRef, int, pa.Schema]:
        """The epoch's engine work: frame the batch, run the transform
        action, seal ONE result blob, materialize the window partial.
        Deterministic — the replay path runs exactly this."""
        parts = int(knobs.get("RDT_STREAM_MAX_PARTITIONS")) \
            or max(1, min(len(self.session.executors),
                          table.num_rows or 1))
        in_df = self.session.createDataFrame(table, num_partitions=parts)
        in_refs = list(in_df._plan.refs)
        try:
            df = self._transform(in_df) if self._transform else in_df
            out = self.session.engine.collect(df._plan)
            # one sealed blob per epoch: the unit the ledger publishes and
            # consumers ranged-fetch (combine_chunks so a replayed seal is
            # byte-identical regardless of upstream chunking)
            result_ref = get_client().put_arrow(
                out.combine_chunks(), owner=self.session.master_name)
            if self._window is not None:
                prefs, pschema, _ = self.session.engine.materialize(
                    self._partial_frame(df)._plan,
                    owner=self.session.master_name)
                with self._lock:
                    old = self._partials.get(epoch)
                    self._partials[epoch] = (prefs, pschema)
                if replay and old is not None:
                    self._free_refs(old[0])  # superseded (lost) partials
        finally:
            self._free_refs(in_refs)
        return result_ref, out.num_rows, out.schema

    def _partial_frame(self, df):
        from raydp_tpu_torch.etl import functions as F
        assert self._window is not None
        aggs = [getattr(F, op)(c).alias(f"__{op}_{c}")
                for op, c in self._window.primitives()]
        return df.groupBy(*self._window.keys).agg(*aggs)

    def _ensure_begun(self) -> None:
        """Open the ledger stage exactly once — from the first publish OR
        from a consumer attaching before any epoch ran (else its first
        poll would race the stage into an unknown-stage abort)."""
        with self._lock:
            if self._begun:
                return
            get_client().stream_begin(self._stage_key, 0)  # unbounded
            self._begun = True

    def _publish(self, epoch: int, gen: int, ref: ObjectRef) -> None:
        client = get_client()
        self._ensure_begun()
        old = None
        with self._lock:
            prev = self._results.get(epoch)
            if prev is not None:
                gen = max(gen, prev[0] + 1)
                old = prev[1]
            self._results[epoch] = (gen, ref)
        client.stream_publish(self._stage_key, epoch, gen, ref.id,
                              ref.size, [(0, ref.size)])
        if gen > 1:
            metrics.record_event("stream_reseal", stage=self._stage_key,
                                 map_id=epoch, gen=gen)
            if old is not None:
                self._free_refs([old])

    # ---- windows -------------------------------------------------------------
    def _due_windows(self, epoch: int) -> List[int]:
        """Start epochs of windows that close exactly at ``epoch``."""
        w = self._window
        if w is None:
            return []
        s = epoch - w.size + 1
        return [s] if s >= 0 and s % w.slide == 0 else []

    def _close_window(self, start: int, end: int) -> WindowResult:
        """Merge the window's per-epoch partials — with exactly-once
        replay: a lost partial blob re-derives its epoch from the source
        journal and the merge retries, up to RDT_STREAM_REPLAY_ROUNDS."""
        from raydp_tpu_torch.etl.engine import (
            StageError as EngineStageError,
        )
        rounds = max(0, int(knobs.get("RDT_STREAM_REPLAY_ROUNDS")))
        with profiler.trace("stream:window", "stream", pipeline=self.name,
                            start=start, end=end):
            for attempt in range(rounds + 1):
                try:
                    table = self._merge_window(start, end)
                    break
                except (EngineStageError, ObjectLostError) as err:
                    lost = self._lost_epochs(start, end)
                    if not lost or attempt >= rounds:
                        raise StreamError(
                            f"window [{start}, {end}] merge failed after "
                            f"{attempt} replay rounds (lost epochs: "
                            f"{lost})") from err
                    for ep in lost:
                        self._replay_epoch(ep, reason="window merge")
        self._windows_closed += 1
        metrics.inc("stream_windows_total")
        return WindowResult(start=start, end=end, table=table)

    def _merge_window(self, start: int, end: int) -> pa.Table:
        from raydp_tpu_torch.etl import functions as F
        from raydp_tpu_torch.etl import plan as P
        from raydp_tpu_torch.etl.expressions import col
        from raydp_tpu_torch.etl.frame import DataFrame
        w = self._window
        assert w is not None
        with self._lock:
            missing = [e for e in range(start, end + 1)
                       if e not in self._partials]
            refs = [r for e in range(start, end + 1)
                    for r in self._partials.get(e, ([], b""))[0]]
            schema = self._partials.get(end, (None, None))[1]
        if missing:
            raise StreamError(f"window [{start}, {end}] is missing epochs "
                              f"{missing} (retention too short?)")
        union = DataFrame(self.session, P.InMemory(list(refs), schema))
        merge = {"sum": F.sum, "count": F.sum, "min": F.min, "max": F.max}
        aggs = [merge[op](f"__{op}_{c}").alias(f"__{op}_{c}")
                for op, c in w.primitives()]
        out = union.groupBy(*w.keys).agg(*aggs)
        names = []
        for c, op in w.aggs:
            name = f"{c}_{op}"
            if op == "mean":
                # float division explicitly: int sum / int count would
                # truncate under arrow's integer divide
                out = out.withColumn(
                    name, col(f"__sum_{c}").cast("float64")
                    / col(f"__count_{c}").cast("float64"))
            else:
                out = out.withColumn(name, col(f"__{op}_{c}"))
            names.append(name)
        out = out.select(*(list(w.keys) + names))
        table = self.session.engine.collect(out._plan)
        return table.sort_by([(k, "ascending") for k in w.keys])

    # ---- exactly-once replay -------------------------------------------------
    def _lost_epochs(self, start: int, end: int) -> List[int]:
        """Window epochs with any partial blob missing from the store
        (fresh lookups — the memo may hold stale entries for lost blobs)."""
        with self._lock:
            span = {e: list(self._partials.get(e, ([], b""))[0])
                    for e in range(start, end + 1)}
        ids = [r.id for refs in span.values() for r in refs]
        found = get_client().lookup_many(ids, fresh=True)
        return [e for e, refs in span.items()
                if any(r.id not in found for r in refs)]

    def _replay_epoch(self, epoch: int, reason: str) -> None:
        """Re-derive one epoch from the source journal: same rows, same
        transform, same partial action — byte-identical by the source's
        replay contract. The result blob re-publishes under gen+1 so any
        in-flight consumer discards and refetches."""
        logger.warning("pipeline %s replaying lost epoch %d (%s)",
                       self.name, epoch, reason)
        table = self.source.replay(epoch)
        ref, _, _ = self._run_epoch(epoch, table, replay=True)
        self._publish(epoch, 2, ref)   # _publish bumps to max(prev+1, 2)
        self._replays += 1
        metrics.inc("stream_replays_total")
        metrics.record_event("stream_replay", pipeline=self.name,
                             epoch=epoch, reason=reason)

    def _drop_epoch_blobs(self, epoch: int) -> None:
        """The ``stream.epoch:drop`` chaos action: silently lose the
        epoch's just-sealed blobs (partials when windowed, else the
        published result) — the store-host-died model for streams."""
        with self._lock:
            victims = list(self._partials.get(epoch, ([], b""))[0]) \
                if self._window is not None \
                else [self._results[epoch][1]]
        logger.warning("stream.epoch:drop injected: freeing %d blob(s) of "
                       "epoch %d", len(victims), epoch)
        self._free_refs(victims)

    # ---- ledger consumers ----------------------------------------------------
    def epoch_stream(self, from_epoch: int = 0) -> "EpochStream":
        """A decoupled consumer over the pipeline's ledger stage: yields
        ``(epoch, table)`` in epoch order as seals land, replaying lost
        result blobs through the pipeline (gen+1 re-seals)."""
        self._ensure_begun()
        return EpochStream(self, from_epoch)

    # ---- driving -------------------------------------------------------------
    def epochs(self, max_epochs: Optional[int] = None,
               timeout_s: Optional[float] = None) -> Iterator[EpochResult]:
        """Drive the pipeline inline; stops after ``max_epochs``, when the
        source is exhausted, or when :meth:`stop` is called."""
        done = 0
        while not self._stopping and not self._closed:
            if max_epochs is not None and done >= max_epochs:
                return
            er = self.step(timeout_s)
            if er is None:
                if self.source.exhausted:
                    return
                continue
            done += 1
            yield er

    def start(self, sink: Optional[Callable[[EpochResult], None]] = None,
              max_epochs: Optional[int] = None) -> "ContinuousPipeline":
        """Run the epoch loop on a background thread; ``sink`` (if any) is
        called with every EpochResult. Consumers follow
        :meth:`epoch_stream`."""
        if self._thread is not None:
            raise StreamError("pipeline already started")

        def _loop():
            try:
                for er in self.epochs(max_epochs=max_epochs):
                    if sink is not None:
                        sink(er)
            except BaseException as e:  # noqa: BLE001 - surfaced via join/close
                self._sink_error = e
                logger.exception("pipeline %s loop failed", self.name)
                try:
                    get_client().stream_abort(self._stage_key, repr(e))
                except Exception:  # noqa: BLE001 - store may be gone too
                    pass

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name=f"rdt-stream-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 60.0) -> None:
        """Stop the background loop after its current epoch."""
        self._stopping = True
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if self._sink_error is not None:
            err, self._sink_error = self._sink_error, None
            raise StreamError(
                f"pipeline {self.name} loop failed") from err

    # ---- retention / teardown ------------------------------------------------
    def _retire_old(self, epoch: int) -> None:
        """Free what the stream no longer needs: published result blobs
        older than the retention window, and window partials once no
        future window's span can reach them."""
        retain = max(1, int(knobs.get("RDT_STREAM_RETAIN")))
        victims: List[ObjectRef] = []
        with self._lock:
            for e in [e for e in self._results if e <= epoch - retain]:
                victims.append(self._results.pop(e)[1])
            if self._window is not None:
                w = self._window
                # the earliest epoch a not-yet-closed window can contain is
                # the smallest window start strictly after the start of the
                # window that closes at THIS epoch (before any window has
                # closed, that is start 0 — nothing retires)
                t = epoch - w.size + 1
                next_start = 0 if t < 0 else (t // w.slide + 1) * w.slide
                for e in [e for e in self._partials if e < next_start]:
                    victims.extend(self._partials.pop(e)[0])
        self._free_refs(victims)

    @staticmethod
    def _free_refs(refs: List[ObjectRef]) -> None:
        if not refs:
            return
        try:
            get_client().free(list(refs))
        except Exception:  # noqa: BLE001 - teardown/loss races are benign
            logger.debug("stream free failed", exc_info=True)

    def close(self) -> None:
        """Stop, close the ledger stage, and free every retained blob —
        the pipeline leaves zero orphaned store objects. A background
        loop's failure re-raises AFTER cleanup (the zero-orphan contract
        holds even for a failed pipeline)."""
        if self._closed:
            return
        loop_error: Optional[BaseException] = None
        try:
            self.stop()
        except StreamError as e:
            loop_error = e
        self._closed = True
        victims: List[ObjectRef] = []
        with self._lock:
            victims.extend(ref for _, ref in self._results.values())
            self._results.clear()
            for refs, _ in self._partials.values():
                victims.extend(refs)
            self._partials.clear()
        self._free_refs(victims)
        if self._begun:
            try:
                get_client().stream_close([self._stage_key])
            except Exception:  # noqa: BLE001 - store may already be down
                pass
        self.source.close()
        if loop_error is not None:
            raise loop_error

    def __enter__(self) -> "ContinuousPipeline":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            # the body already failed: clean up without masking its error
            try:
                self.close()
            except StreamError:
                logger.warning("pipeline %s loop had also failed; body "
                               "error wins", self.name)
        else:
            self.close()

    # ---- reporting -----------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        walls = sorted(self._epoch_walls)

        def q(f):
            return round(walls[min(len(walls) - 1, int(f * len(walls)))], 4) \
                if walls else 0.0

        return {
            "pipeline": self.name,
            "epochs": self.source.epochs_emitted,
            "rows_in": self._rows_in,
            "windows_closed": self._windows_closed,
            "replays": self._replays,
            "epoch_p50_s": q(0.50),
            "epoch_p99_s": q(0.99),
            "epoch_max_s": round(walls[-1], 4) if walls else 0.0,
        }


class EpochStream:
    """Ledger-following consumer: long-polls the pipeline's stage for new
    seals (exactly like a pipelined shuffle's reducers) and yields
    ``(epoch, table)`` in epoch order. A fetch that hits a lost blob asks
    the pipeline to replay the epoch (gen+1 re-seal) and refetches."""

    def __init__(self, pipeline: ContinuousPipeline, from_epoch: int = 0):
        self._pipe = pipeline
        self._next = from_epoch
        self._have: Dict[int, int] = {}      # map_id -> newest gen seen
        self._sealed: Dict[int, Tuple[int, str, int]] = {}  # epoch -> seal

    def next(self, timeout_s: float = 30.0) -> Optional[Tuple[int, pa.Table]]:
        """The next epoch's result table, or None when nothing sealed
        within the timeout. Raises StreamError once the stage closes."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        client = get_client()
        while True:
            if self._next in self._sealed:
                epoch = self._next
                gen, ref_id, size = self._sealed[epoch]
                ref = ObjectRef(id=ref_id, size=size, kind=KIND_ARROW)
                try:
                    table = client.get(ref)
                except ObjectLostError:
                    # lost between seal and fetch: replay → gen+1 re-seal,
                    # then poll again for the fresh ref
                    self._pipe._replay_epoch(epoch, reason="consumer fetch")
                    del self._sealed[epoch]
                    continue
                del self._sealed[epoch]
                self._next += 1
                return epoch, table
            wait = deadline - time.monotonic()
            if wait <= 0:
                return None
            resp = client.stream_poll(self._pipe._stage_key, 0,
                                      have=dict(self._have),
                                      timeout_s=min(wait, 10.0))
            for map_id, gen, ref_id, size, _off, _bsize in resp["events"]:
                self._have[map_id] = gen
                if map_id >= self._next:
                    self._sealed[map_id] = (gen, ref_id, size)
            if resp.get("aborted"):
                if self._next in self._sealed:
                    continue  # drain what is already sealed
                raise StreamError(
                    f"epoch stream over {self._pipe._stage_key} ended: "
                    f"{resp['aborted']}")

    @property
    def exhausted(self) -> bool:
        """True once the pipeline's source is done and every emitted epoch
        has been yielded — this consumer will never produce again."""
        return (self._pipe.source.exhausted
                and self._next >= self._pipe.source.epochs_emitted
                and not self._sealed)

    def __iter__(self) -> Iterator[Tuple[int, pa.Table]]:
        while True:
            try:
                item = self.next()
            except StreamError:
                return
            if item is None:
                if self.exhausted:
                    return
                continue
            yield item
