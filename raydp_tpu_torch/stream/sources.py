"""Streaming sources: Arrow micro-batches with monotonic epoch ids — the
port's copy of :mod:`raydp_tpu.stream.sources` (imports renamed).

A :class:`StreamSource` turns an external feed into a sequence of **epochs**
— each ``next_batch()`` call yields one :class:`MicroBatch` carrying a
``pyarrow.Table`` and a monotonically increasing epoch id assigned by the
source. Three concrete sources cover the blueprint's ingestion shapes:

- :class:`FileTailSource` — directory watch / file tail: new parquet or csv
  files appearing under a path become micro-batches (optionally chunked to
  a row cap), the Kafka-less analogue of a landing-zone feed;
- :class:`ReplayLogSource` — a pre-recorded log of tables replayed in
  order, for backfills and deterministic tests;
- :class:`SyntheticSource` — rows derived from ``make_batch(epoch)``, for
  load generation and benches (optionally rate-limited).

**Replay contract (exactly-once).** Every source can re-derive an emitted
epoch: ``replay(epoch)`` returns a table byte-identical to the one
``next_batch`` originally produced for that epoch. This is the streaming
twin of the batch engine's lineage recipes — when a downstream epoch blob
is lost (``ObjectLostError``), the pipeline replays the epoch through the
same deterministic path instead of double-reading the feed. FileTail keeps
``(path, offset, rows)`` specs and re-reads the file; ReplayLog indexes its
log; Synthetic re-invokes its generator. The journal is bounded by
``RDT_STREAM_RETAIN`` epochs — a replay older than the retention window
fails loudly rather than silently re-ingesting different rows.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from raydp_tpu_torch import knobs
from raydp_tpu_torch.log import get_logger

logger = get_logger("stream.sources")


class StreamError(RuntimeError):
    """A continuous pipeline failed in a way replay cannot absorb (source
    exhausted its journal, replay rounds exhausted, pipeline closed)."""


@dataclass(frozen=True)
class MicroBatch:
    """One epoch's rows. Epoch ids are assigned by the source,
    monotonically from 0, with no gaps."""

    epoch: int
    table: pa.Table


class StreamSource:
    """Base: assigns epoch ids and keeps the bounded replay journal.

    Subclasses implement ``_next(timeout_s)`` (the rows of the next epoch,
    or None when nothing is ready yet) and ``_rederive(spec)`` (rebuild an
    epoch's table from the journal entry ``_journal_spec`` stored for it).
    The default journal entry is the table itself (ReplayLog/small feeds);
    sources with a cheaper recipe (FileTail's file ranges, Synthetic's
    generator args) override ``_journal_spec`` to avoid pinning every
    emitted table in driver memory."""

    def __init__(self):
        self._epoch = 0
        self._lock = threading.Lock()
        self._journal: Dict[int, object] = {}  # guarded-by: _lock

    # -- subclass surface -----------------------------------------------------
    def _next(self, timeout_s: float) -> Optional[pa.Table]:
        raise NotImplementedError

    def _journal_spec(self, epoch: int, table: pa.Table) -> object:
        return table

    def _rederive(self, spec: object) -> pa.Table:
        assert isinstance(spec, pa.Table)
        return spec

    # -- pipeline surface -----------------------------------------------------
    def next_batch(self, timeout_s: Optional[float] = None
                   ) -> Optional[MicroBatch]:
        """The next epoch's rows, or None if the feed has nothing yet
        (poll again) — an exhausted finite source also returns None forever
        (``exhausted`` distinguishes the two)."""
        if timeout_s is None:
            timeout_s = float(knobs.get("RDT_STREAM_POLL_TIMEOUT_S"))
        table = self._next(timeout_s)
        if table is None:
            return None
        retain = max(1, int(knobs.get("RDT_STREAM_RETAIN")))
        with self._lock:
            epoch = self._epoch
            self._epoch += 1
            self._journal[epoch] = self._journal_spec(epoch, table)
            for e in [e for e in self._journal if e <= epoch - retain]:
                del self._journal[e]
        return MicroBatch(epoch, table)

    def replay(self, epoch: int) -> pa.Table:
        """Byte-identical re-derivation of an already-emitted epoch."""
        with self._lock:
            spec = self._journal.get(epoch)
        if spec is None:
            raise StreamError(
                f"epoch {epoch} is outside the replay journal "
                f"(RDT_STREAM_RETAIN={knobs.get('RDT_STREAM_RETAIN')}, "
                f"newest={self._epoch - 1})")
        return self._rederive(spec)

    @property
    def exhausted(self) -> bool:
        """True once a finite source will never emit again (infinite
        sources always return False)."""
        return False

    @property
    def epochs_emitted(self) -> int:
        return self._epoch

    def close(self) -> None:
        with self._lock:
            self._journal.clear()


# ---- file tail / directory watch --------------------------------------------

def _read_rows(path: str, offset: int, rows: int) -> pa.Table:
    """``rows`` rows of ``path`` starting at row ``offset`` (the FileTail
    journal recipe; also its forward read)."""
    if path.endswith((".parquet", ".pq")):
        import pyarrow.parquet as pq
        table = pq.read_table(path)
    else:
        import pyarrow.csv as pacsv
        table = pacsv.read_csv(path)
    return table.slice(offset, rows)


class FileTailSource(StreamSource):
    """Watch a directory (or glob) for new parquet/csv files; each new file
    becomes one micro-batch, chunked to ``rows_per_batch`` when set. Files
    are consumed in sorted-name order (the landing-zone convention:
    writers name files monotonically); a file must be fully written before
    it appears under the watched name (write-then-rename)."""

    def __init__(self, path: str, pattern: str = "*.parquet",
                 rows_per_batch: Optional[int] = None):
        super().__init__()
        self._path = path
        self._pattern = pattern
        self._rows_per_batch = rows_per_batch
        self._seen: set = set()
        #: (path, row offset) of the partially consumed head file
        self._cursor: Optional[Tuple[str, int]] = None

    def _candidates(self) -> List[str]:
        if os.path.isdir(self._path):
            return sorted(glob.glob(os.path.join(self._path, self._pattern)))
        return sorted(glob.glob(self._path))

    def _next(self, timeout_s: float) -> Optional[pa.Table]:
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            if self._cursor is not None:
                path, off = self._cursor
                cap = self._rows_per_batch
                table = _read_rows(path, off, cap if cap else (1 << 62))
                if table.num_rows == 0:
                    self._cursor = None  # fully consumed: fall through
                else:
                    # a full chunk may have more rows behind it; a short
                    # one exhausted the file
                    self._cursor = ((path, off + cap)
                                    if cap and table.num_rows == cap
                                    else None)
                    self._last_spec = (path, off, table.num_rows)
                    return table
            fresh = [p for p in self._candidates() if p not in self._seen]
            if fresh:
                self._seen.add(fresh[0])
                self._cursor = (fresh[0], 0)
                continue
            if time.monotonic() >= deadline:
                return None
            time.sleep(min(0.05, max(0.001, timeout_s)))

    def _journal_spec(self, epoch: int, table: pa.Table) -> object:
        return self._last_spec  # (path, offset, rows) set by _next

    def _rederive(self, spec: object) -> pa.Table:
        path, off, rows = spec
        return _read_rows(path, off, rows)


# ---- replayed log ------------------------------------------------------------

class ReplayLogSource(StreamSource):
    """Replay a pre-recorded log of tables in order — one table per epoch
    (backfill / deterministic-test shape). The log IS the journal, so
    replay is an index and retention never drops it."""

    def __init__(self, log: Sequence[pa.Table], rate_hz: Optional[float] = None):
        super().__init__()
        self._log = list(log)
        self._rate_hz = rate_hz
        self._t_last = 0.0

    def _next(self, timeout_s: float) -> Optional[pa.Table]:
        i = self._epoch
        if i >= len(self._log):
            return None
        if self._rate_hz:
            wait = self._t_last + 1.0 / self._rate_hz - time.monotonic()
            if wait > 0:
                if wait > timeout_s:
                    time.sleep(timeout_s)
                    return None
                time.sleep(wait)
            self._t_last = time.monotonic()
        return self._log[i]

    def _journal_spec(self, epoch: int, table: pa.Table) -> object:
        return epoch  # the log itself re-derives any epoch

    def _rederive(self, spec: object) -> pa.Table:
        return self._log[int(spec)]

    def replay(self, epoch: int) -> pa.Table:
        if not 0 <= epoch < len(self._log):
            raise StreamError(f"epoch {epoch} outside the replayed log "
                              f"({len(self._log)} entries)")
        return self._log[epoch]

    @property
    def exhausted(self) -> bool:
        return self._epoch >= len(self._log)


# ---- synthetic rate source ---------------------------------------------------

class SyntheticSource(StreamSource):
    """Micro-batches derived from ``make_batch(epoch) -> pa.Table`` — the
    generator must be deterministic per epoch (that determinism IS the
    replay contract). ``rate_hz`` throttles emission; ``max_epochs`` makes
    the source finite."""

    def __init__(self, make_batch: Callable[[int], pa.Table],
                 rate_hz: Optional[float] = None,
                 max_epochs: Optional[int] = None):
        super().__init__()
        self._make = make_batch
        self._rate_hz = rate_hz
        self._max = max_epochs
        self._t_last = 0.0

    def _next(self, timeout_s: float) -> Optional[pa.Table]:
        if self._max is not None and self._epoch >= self._max:
            return None
        if self._rate_hz:
            wait = self._t_last + 1.0 / self._rate_hz - time.monotonic()
            if wait > 0:
                if wait > timeout_s:
                    time.sleep(timeout_s)
                    return None
                time.sleep(wait)
            self._t_last = time.monotonic()
        return self._make(self._epoch)

    def _journal_spec(self, epoch: int, table: pa.Table) -> object:
        return epoch

    def _rederive(self, spec: object) -> pa.Table:
        return self._make(int(spec))

    @property
    def exhausted(self) -> bool:
        return self._max is not None and self._epoch >= self._max
