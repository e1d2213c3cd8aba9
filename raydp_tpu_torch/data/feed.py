"""Arrow blocks → batches of device tensors — the port of
:mod:`raydp_tpu.data.feed`.

**Host half** (copied from the reference; same names and behaviour):
:class:`ShardSpec`, :func:`pad_batch`, :func:`epoch_seed`, :func:`_as_numpy`
(through the native staging kernel, :mod:`raydp_tpu_torch.native.stage`),
:class:`HostBatchIterator`, :class:`GangShardIterator` (a gang rank's slice
of every global batch), :class:`PipelineTimings` and
:class:`DevicePrefetcher`. With the same seed, shuffle and remainder flags
the host batches are byte-identical to the reference's. One addition:
:class:`GangShardIterator` pads and masks the ragged final global batch
when asked (``pad_remainder``), where the reference's drops it.

**Device half** (the counterpart of ``jax.device_put``):

- :class:`DeviceFeed` streams batches: a background thread decodes host
  batches ``prefetch`` ahead, a second one copies each into pinned host
  memory (the ``stage`` phase) and enqueues a ``non_blocking`` host→device
  copy on a side CUDA stream (the ``h2d`` phase), ``prefetch_to_device``
  batches ahead; the consumer's stream waits on the copy's event, so batch
  ``k+1`` crosses the bus while batch ``k`` computes.
  :meth:`DeviceFeed.chained` stacks ``k`` host batches and places the
  stack with one copy: the inputs of one replay of a ``k``-step graph.
- :class:`DeviceEpochCache` keeps the whole dataset resident in device
  memory; an epoch (:class:`ResidentEpoch`) gathers its batches on the
  device through static index state (the epoch's row order and a step
  cursor), so one captured step can be replayed for every batch.

The reference draws the resident permutation with
``jax.random.permutation``, which torch cannot reproduce; the port draws it
with ``torch.randperm`` from a ``torch.Generator`` seeded with
:func:`epoch_seed`, so resident shuffled epochs visit the rows in another
(equally uniform) order than the reference's.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import pyarrow as pa
import torch

from raydp_tpu_torch import knobs, metrics, profiler
from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.native.stage import stage_table


@dataclass
class ShardSpec:
    """What one data-parallel rank reads: ``(block_index, offset, length)``."""

    parts: List[Tuple[int, int, int]] = field(default_factory=list)

    def num_rows(self) -> int:
        return sum(n for _, _, n in self.parts)


ColumnSpec = Union[str, Sequence[str]]

#: batch-dict key carrying the per-row validity mask under pad-and-mask mode
#: (1.0 = real row, 0.0 = padding). Present on EVERY batch a padding feed
#: yields, and threaded by the estimator into loss/metric accumulators so
#: padded rows contribute nothing.
MASK_KEY = "__mask__"


def pad_batch(batch: Dict[str, np.ndarray], batch_size: int
              ) -> Dict[str, np.ndarray]:
    """Zero-pad a ragged host batch up to ``batch_size`` rows and attach the
    validity mask, so every batch has the same shape."""
    rows = int(next(iter(batch.values())).shape[0])
    pad = batch_size - rows
    if pad < 0:
        raise ValueError(f"batch of {rows} rows exceeds batch_size "
                         f"{batch_size}")
    mask = np.zeros(batch_size, np.float32)
    mask[:rows] = 1.0
    if pad:
        batch = {n: np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
            for n, a in batch.items()}
        metrics.inc("train_padded_rows_total", pad)
    else:
        batch = dict(batch)
    batch[MASK_KEY] = mask
    return batch


def epoch_seed(base: int, epoch: int) -> int:
    """Deterministic per-epoch shuffle seed — THE derivation every feed path
    shares."""
    return (base + epoch * 1000003) % (2**31 - 1)


def _normalize_columns(columns: Dict[str, Tuple[ColumnSpec, np.dtype]]
                       ) -> Dict[str, Tuple[Tuple[str, ...], np.dtype]]:
    return {
        name: ((cols,) if isinstance(cols, str) else tuple(cols), np.dtype(dt))
        for name, (cols, dt) in columns.items()
    }


def _as_numpy(table: pa.Table, columns: Sequence[str], dtype) -> np.ndarray:
    """Stack columns into [rows, len(columns)] (or [rows] for one column).

    Multi-column decode goes through the native staging kernel when eligible
    (cast+interleave fused into one pass per column, straight from the Arrow
    data buffers); null-bearing/non-primitive columns and missing toolchains
    fall back to the numpy path below, output-identical."""
    if len(columns) > 1:
        staged = stage_table(table, columns, dtype)
        if staged is not None:
            return staged
    arrays = []
    for c in columns:
        col = table.column(c)
        arrays.append(col.to_numpy(zero_copy_only=False).astype(dtype, copy=False))
    if len(arrays) == 1:
        return arrays[0]
    return np.stack(arrays, axis=1)


class HostBatchIterator:
    """Yields host-side numpy batch dicts from a dataset (or one shard of it).

    Decoded blocks are cached across epochs (``cache_decoded``, on by
    default, bounded by ``RDT_FEED_CACHE_MB``): Arrow→numpy decode + dtype
    cast is the dominant host cost of an epoch once the train step is fast,
    and multi-epoch training re-reads the same immutable blocks. Per-epoch
    shuffling permutes indices over the cached arrays instead of re-decoding.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        columns: Dict[str, Tuple[ColumnSpec, np.dtype]],
        shard: Optional[ShardSpec] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        cache_decoded: bool = True,
        cache_cap_bytes: Optional[int] = None,
        pad_remainder: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.columns = _normalize_columns(columns)
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder and not pad_remainder
        #: pad-and-mask mode: the ragged tail pads to a full batch and EVERY
        #: batch carries :data:`MASK_KEY`; wins over drop_remainder
        self.pad_remainder = pad_remainder
        self.cache_decoded = cache_decoded
        # per-iterator budget (train and eval feeds each get their own); env
        # read at construction so callers can tune it after import
        self.cache_cap_bytes = cache_cap_bytes if cache_cap_bytes is not None \
            else int(float(knobs.get("RDT_FEED_CACHE_MB")) * (1 << 20))
        self._decoded: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_bytes = 0
        self._sizes: Optional[List[int]] = None

    def _block_sizes(self) -> List[int]:
        if self._sizes is None:
            self._sizes = list(self.dataset.block_sizes())
        return self._sizes

    def _parts(self) -> List[Tuple[int, int, int]]:
        if self.shard is not None:
            return list(self.shard.parts)
        return [(i, 0, n) for i, n in enumerate(self._block_sizes())]

    def _block_rows(self, block_idx: int) -> int:
        return self._block_sizes()[block_idx]

    def _decode_block(self, block_idx: int) -> Dict[str, np.ndarray]:
        """Decode (and maybe cache) ALL rows of a block."""
        cached = self._decoded.get(block_idx)
        if cached is not None:
            return cached
        table = self.dataset.get_block(block_idx, zero_copy=True)
        arrays = {name: _as_numpy(table, cols, dt)
                  for name, (cols, dt) in self.columns.items()}
        if self.cache_decoded:
            size = sum(a.nbytes for a in arrays.values())
            if self._cache_bytes + size <= self.cache_cap_bytes:
                # own the bytes: a zero-copy view into the store must not be
                # cached past this iteration (the block could be freed)
                arrays = {n: (a if a.flags["OWNDATA"] else a.copy())
                          for n, a in arrays.items()}
                for a in arrays.values():
                    # batches served from the cache are views; freezing the
                    # cache turns an in-place consumer mutation (which would
                    # silently poison later epochs) into a loud error
                    a.setflags(write=False)
                self._decoded[block_idx] = arrays
                self._cache_bytes += size
        return arrays

    def _decode_slice(self, block_idx: int, off: int,
                      length: int) -> Dict[str, np.ndarray]:
        """Decode just ``[off, off+length)`` — used for partial shard parts
        so a rank neither decodes nor budgets rows it never reads."""
        table = self.dataset.get_block(block_idx,
                                       zero_copy=True).slice(off, length)
        return {name: _as_numpy(table, cols, dt)
                for name, (cols, dt) in self.columns.items()}

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        parts = self._parts()
        if self.shuffle:
            rng.shuffle(parts)
        buffers: Dict[str, List[np.ndarray]] = {n: [] for n in self.columns}
        buffered = 0
        for block_idx, off, length in parts:
            full_block = off == 0 and length == self._block_rows(block_idx)
            if full_block or block_idx in self._decoded:
                arrays = self._decode_block(block_idx)
                if self.shuffle and length > 1:
                    idx = off + rng.permutation(length)
                    sel = {n: a[idx] for n, a in arrays.items()}
                else:
                    sel = {n: a[off:off + length] for n, a in arrays.items()}
            else:
                sel = self._decode_slice(block_idx, off, length)
                if self.shuffle and length > 1:
                    idx = rng.permutation(length)
                    sel = {n: a[idx] for n, a in sel.items()}
            for name in self.columns:
                buffers[name].append(sel[name])
            buffered += length
            while buffered >= self.batch_size:
                batch, buffers, buffered = self._cut_batch(buffers, buffered)
                yield pad_batch(batch, self.batch_size) \
                    if self.pad_remainder else batch
        if buffered > 0 and not self.drop_remainder:
            batch = {n: np.concatenate(v, axis=0) for n, v in buffers.items()}
            yield pad_batch(batch, self.batch_size) \
                if self.pad_remainder else batch

    def _cut_batch(self, buffers, buffered):
        joined = {n: (np.concatenate(v, axis=0) if len(v) > 1 else v[0])
                  for n, v in buffers.items()}
        batch = {n: a[: self.batch_size] for n, a in joined.items()}
        rest = {n: [a[self.batch_size:]] for n, a in joined.items()}
        return batch, rest, buffered - self.batch_size


class GangShardIterator:
    """Per-rank host batches that compose into globally-consistent batches.

    Global batch ``k`` covers dataset rows ``[k*B, (k+1)*B)`` in block order —
    exactly the batches a single-process :class:`HostBatchIterator` with
    ``shuffle=False`` cuts — and rank ``r`` of ``w`` yields its slice of
    each, the equal split ``[r*B/w, (r+1)*B/w)`` (the reference derives the
    range from the batch sharding of its mesh, ``process_local_batch_rows``;
    under the port's replicated gang it is the equal split). All ranks
    permute the *batch order* with the same seed (numpy's
    ``RandomState``, as the reference; no within-block shuffling), so every
    rank walks the same global batch sequence, and a shuffled gang visits
    the reference's batches in the reference's order.

    ``pad_remainder``: the ragged final global batch (``total % B`` rows) is
    padded with zero rows to ``B`` and every batch carries :data:`MASK_KEY`,
    so the ranks' slices of the final batch cover every row once and the
    pad rows count zero — the rule the reference states for a >1 data
    extent (``RDT_TRAIN_PAD_TAIL``), which its own gang iterator breaks by
    dropping the tail. Without it the tail drops (``total // B`` batches),
    as the reference's iterator does.
    """

    def __init__(
        self,
        dataset,
        global_batch: int,
        world_size: int,
        rank: int,
        columns: Dict[str, Tuple[ColumnSpec, np.dtype]],
        shuffle: bool = False,
        seed: int = 0,
        pad_remainder: bool = False,
    ):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world {world_size}")
        if global_batch % world_size != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by world size "
                f"{world_size}")
        self.dataset = dataset
        self.global_batch = global_batch
        self.world_size = world_size
        self.rank = rank
        self.columns = _normalize_columns(columns)
        self.shuffle = shuffle
        self.seed = seed
        self.per_rank = global_batch // world_size
        self.pad_remainder = pad_remainder
        self._starts = np.cumsum([0] + list(dataset.block_sizes()))
        self.total = int(self._starts[-1])
        # decoded-block cache across epochs (HostBatchIterator's trick):
        # without it every rank re-runs Arrow→numpy decode for every batch
        # of every epoch — the dominant per-epoch host cost of a gang rank
        self._decoded: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_bytes = 0
        self._cache_cap = int(float(knobs.get("RDT_FEED_CACHE_MB"))
                              * (1 << 20))

    def __len__(self) -> int:
        if self.pad_remainder:
            return -(-self.total // self.global_batch)
        return self.total // self.global_batch

    def _runs(self, start: int, stop: int) -> List[Tuple[int, int, int]]:
        """Global row range → list of (block_index, offset, length) runs."""
        runs: List[Tuple[int, int, int]] = []
        b = int(np.searchsorted(self._starts, start, side="right")) - 1
        row = start
        while row < stop:
            blk_end = int(self._starts[b + 1])
            take = min(stop, blk_end) - row
            runs.append((b, row - int(self._starts[b]), take))
            row += take
            b += 1
        return runs

    def _decoded_nbytes(self, rows: int) -> int:
        """Exact decoded size of ``rows`` rows under this iterator's fixed-
        width column specs — lets cache eligibility be decided WITHOUT
        decoding the block first."""
        return rows * sum(len(cols) * dt.itemsize
                          for cols, dt in self.columns.values())

    def _decode_run(self, b: int, off: int,
                    length: int) -> Dict[str, np.ndarray]:
        """Rows ``[off, off+length)`` of block ``b``: served from the decoded
        cache when the block fits the ``RDT_FEED_CACHE_MB`` budget; otherwise
        only the requested slice is decoded (``table.slice`` is zero-copy),
        so an over-cap gang feed pays O(batch) — not O(block) — Arrow→numpy
        work per batch (mirrors ``HostBatchIterator._decode_slice``)."""
        cached = self._decoded.get(b)
        if cached is None and (self._cache_bytes
                               + self._decoded_nbytes(self._block_rows(b))
                               <= self._cache_cap):
            table = self.dataset.get_block(b, zero_copy=True)
            arrays = {name: _as_numpy(table, cols, dt)
                      for name, (cols, dt) in self.columns.items()}
            # own the bytes (a zero-copy view into the store must not be
            # cached past this iteration) and freeze them so an in-place
            # consumer mutation fails loudly instead of poisoning epochs
            arrays = {n: (a if a.flags["OWNDATA"] else a.copy())
                      for n, a in arrays.items()}
            for a in arrays.values():
                a.setflags(write=False)
            cached = self._decoded[b] = arrays
            self._cache_bytes += sum(a.nbytes for a in arrays.values())
        if cached is not None:
            return {n: a[off:off + length] for n, a in cached.items()}
        table = self.dataset.get_block(b, zero_copy=True).slice(off, length)
        return {name: _as_numpy(table, cols, dt)
                for name, (cols, dt) in self.columns.items()}

    def _block_rows(self, b: int) -> int:
        return int(self._starts[b + 1] - self._starts[b])

    def _slice(self, k: int) -> Dict[str, np.ndarray]:
        """This rank's rows of global batch ``k``: the real ones only (the
        final batch's slice may be short, or empty)."""
        start = k * self.global_batch + self.rank * self.per_rank
        stop = min(start + self.per_rank, self.total)
        parts = [self._decode_run(b, off, length)
                 for b, off, length in self._runs(start, stop)]
        if len(parts) == 1:
            return parts[0]
        if not parts:  # a slice wholly past the last row
            return {n: np.zeros((0,) + (() if len(cols) == 1
                                        else (len(cols),)), dt)
                    for n, (cols, dt) in self.columns.items()}
        return {n: np.concatenate([p[n] for p in parts], axis=0)
                for n in self.columns}

    def __iter__(self):
        order = np.arange(len(self))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        for k in order:
            batch = self._slice(int(k))
            yield pad_batch(batch, self.per_rank) \
                if self.pad_remainder else batch


class ResidentEpoch:
    """The batches of one resident epoch, read through static index state.

    ``order`` holds the epoch's row order (a permutation of all rows, or
    ``arange`` unshuffled) and ``cursor`` the next step; :meth:`next_batch`
    gathers rows ``order[cursor·b : (cursor+1)·b]`` of every resident array
    and advances the cursor, all on the device, so a step that calls it
    reads the same tensors at every call and can be captured into a CUDA
    graph once and replayed for every batch. :meth:`begin` draws the
    epoch's permutation eagerly, before the steps, from a
    ``torch.Generator`` seeded with the epoch's seed, and rewinds the
    cursor. ``steps`` whole batches an epoch; a ragged tail is dropped."""

    def __init__(self, arrays: Dict[str, torch.Tensor], num_rows: int,
                 batch_size: int, shuffle: bool, device: torch.device):
        self.arrays = arrays
        self.num_rows = num_rows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.steps = num_rows // batch_size
        self.order = torch.arange(num_rows, device=device)
        self.cursor = torch.zeros((), dtype=torch.int64, device=device)
        self._offsets = torch.arange(batch_size, device=device)

    def begin(self, seed: int) -> None:
        """Start an epoch: the permutation for ``seed`` (when shuffled) and
        the cursor at step 0."""
        if self.shuffle:
            device = self.order.device
            gen = torch.Generator(device=device).manual_seed(seed)
            self.order.copy_(torch.randperm(self.num_rows, generator=gen,
                                            device=device))
        self.cursor.zero_()

    def next_batch(self) -> Dict[str, torch.Tensor]:
        idx = self.order.index_select(
            0, self.cursor * self.batch_size + self._offsets)
        self.cursor.add_(1)
        return {n: a.index_select(0, idx) for n, a in self.arrays.items()}


class DeviceEpochCache:
    """The whole dataset resident in device memory.

    Decode every block once, concatenate to contiguous host arrays and copy
    them to the device. The train loop then runs an epoch
    (:meth:`make_epoch`) whose batches are *gathered on the device* — with
    per-epoch shuffling as an on-device ``torch.randperm`` — so no host
    batch is built and no host→device copy is made after the first epoch.
    The streaming :class:`DeviceFeed` remains the path for datasets above
    the budget.
    """

    def __init__(self, dataset, columns: Dict[str, Tuple[ColumnSpec, np.dtype]],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        _require_torch_dtypes(columns)
        cols = _normalize_columns(columns)
        host: Dict[str, List[np.ndarray]] = {n: [] for n in cols}
        for i in range(dataset.num_blocks()):
            table = dataset.get_block(i, zero_copy=True)
            for name, (cnames, dt) in cols.items():
                host[name].append(_as_numpy(table, cnames, dt))
        joined = {n: (np.concatenate(v, axis=0) if len(v) > 1 else v[0])
                  for n, v in host.items()}
        self.num_rows = int(next(iter(joined.values())).shape[0])
        self.nbytes = sum(a.nbytes for a in joined.values())
        # torch.tensor copies (the host arrays may be read-only views)
        self.arrays = {n: torch.tensor(a, device=self.device)
                       for n, a in joined.items()}

    def make_epoch(self, batch_size: int, shuffle: bool) -> ResidentEpoch:
        """THE resident epoch over these arrays: batches of ``batch_size``
        consecutive rows, or, when ``shuffle``, gathered by one permutation
        of all rows per epoch (:class:`ResidentEpoch`)."""
        return ResidentEpoch(self.arrays, self.num_rows, batch_size, shuffle,
                             self.device)

    @staticmethod
    def cap_bytes() -> int:
        return int(float(knobs.get("RDT_DEVICE_CACHE_MB")) * (1 << 20))

    @staticmethod
    def estimate_bytes(dataset,
                       columns: Dict[str, Tuple[ColumnSpec, np.dtype]]) -> int:
        rows = sum(dataset.block_sizes())
        per_row = sum(len(cnames) * np.dtype(dt).itemsize
                      for cnames, dt in _normalize_columns(columns).values())
        return rows * per_row

    @classmethod
    def eligible(cls, dataset,
                 columns: Dict[str, Tuple[ColumnSpec, np.dtype]],
                 batch_size: int, drop_last: bool) -> bool:
        """THE residency gate. Requires: opted in (``RDT_DEVICE_CACHE``),
        static full batches (``drop_last`` with at least one batch of rows),
        and decoded arrays within the ``RDT_DEVICE_CACHE_MB`` budget."""
        if not knobs.get("RDT_DEVICE_CACHE"):
            return False
        if not drop_last:
            return False
        cap = cls.cap_bytes()  # outside the try: a malformed
        # RDT_DEVICE_CACHE_MB should raise loudly, not silently stream
        try:
            if sum(dataset.block_sizes()) < batch_size:
                return False
            return cls.estimate_bytes(dataset, columns) <= cap
        except Exception:  # noqa: BLE001 - unknown size: stream
            return False


class PipelineTimings:
    """Thread-safe per-phase wall accumulator for the feed pipeline.

    Phases (surfaced per epoch as ``decode_time_s``/``stage_time_s``/
    ``h2d_time_s`` by the estimator):

    - ``decode`` — host batch production: Arrow→numpy decode (native staging
      kernel included) plus the host iterator's own batch assembly.
    - ``stage``  — the copy of each batch into pinned host memory.
    - ``h2d``    — device placement: enqueueing the ``non_blocking`` copy to
      the device (on the CPU device: the copy into a tensor).

    The timers run on the pipeline's background threads, so phase walls
    OVERLAP the consumer's dispatch wall by design.
    """

    KEYS = ("decode", "stage", "h2d")

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = {k: 0.0 for k in self.KEYS}

    def add(self, key: str, dt: float) -> None:
        with self._lock:
            self._acc[key] += dt
        # the registry twin: metrics_report() sees the feed's phases
        # without the estimator re-publishing its epoch dicts
        metrics.observe("feed_phase_seconds", dt, label=key)

    def take(self) -> Dict[str, float]:
        """Snapshot AND reset — each epoch reports its own split."""
        with self._lock:
            out = dict(self._acc)
            for k in self._acc:
                self._acc[k] = 0.0
        return out


class DevicePrefetcher:
    """Bounded async stage of the device-feed pipeline (double buffering).

    Pulls items from ``src`` on a background thread, applies ``fn`` (the
    device stage passes the feed's placement), and keeps up to ``depth``
    results queued ahead of the consumer, so staging + H2D for batch ``k+1``
    overlap the compute of batch ``k``. The bounded queue IS the
    backpressure: the producer can run at most ``depth + 1`` items ahead.
    Producer exceptions re-raise in the consumer; closing (or abandoning)
    the iterator stops the thread. Single-use: one ``iter()`` per instance.
    The producer runs under the trace context of the constructing thread,
    so a span that ``fn`` opens has that thread's span as its parent.

    ``pull_key``/``work_key`` name the :class:`PipelineTimings` phases the
    ``next(src)`` pull and the ``fn`` call accumulate into.
    """

    _DONE = object()

    def __init__(self, src, fn=None, depth: int = 2, timings=None,
                 pull_key: Optional[str] = None,
                 work_key: Optional[str] = None,
                 name: str = "devicefeed-prefetch"):
        self._src = src
        self._fn = fn
        self._timings = timings
        self._pull_key = pull_key
        self._work_key = work_key
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        # the prefetch thread traces under the constructing context (a
        # serving replica's staging pipeline, an estimator's feed): a plain
        # Thread would drop the contextvar at the handoff
        self._ctx = profiler.capture()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._started = False

    def _run(self):
        with profiler.activate(self._ctx):
            self._run_inner()

    def _run_inner(self):
        try:
            src = iter(self._src)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(src)
                except StopIteration:
                    break
                if self._timings is not None and self._pull_key:
                    self._timings.add(self._pull_key,
                                      time.perf_counter() - t0)
                if self._fn is not None:
                    t1 = time.perf_counter()
                    item = self._fn(item)
                    if self._timings is not None and self._work_key:
                        self._timings.add(self._work_key,
                                          time.perf_counter() - t1)
                if not self._put(item):
                    break
            self._put(self._DONE)  # no-op if stopped
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            self._put(e)
        finally:
            if self._stop.is_set():
                # stopped early: close() may already have run (and given up
                # after its join timeout if THIS thread was mid-fn), so the
                # upstream close falls to us
                self._close_src()

    def _put(self, item) -> bool:
        """Blocking put that stays responsive to :meth:`close` (the timeout
        only ticks while the queue is FULL, i.e. the pipeline is ahead)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _close_src(self) -> None:
        """Best-effort upstream cleanup: a generator src closes its own
        stage in its finally. Both the consumer's close() and the producer's
        finally may race here — generator.close() raises on the loser,
        swallowed below."""
        src_close = getattr(self._src, "close", None)
        if src_close is not None:
            try:
                src_close()
            except Exception:  # noqa: BLE001 - already shutting down
                pass

    def __iter__(self):
        if self._started:
            raise RuntimeError("DevicePrefetcher is single-use")
        self._started = True
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self) -> None:
        """Stop the producer and release queued buffers (idempotent)."""
        self._stop.set()
        self._drain()  # unblocks a producer waiting on a full queue
        if self._started and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self._drain()  # a mid-put producer may have landed one more item
        if not self._thread.is_alive():
            # thread gone (or never started): upstream close is on us; a
            # still-running thread closes upstream itself in _run's finally
            self._close_src()


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype that holds numpy ``dtype`` — the one
    ``torch.from_numpy`` gives, so every dtype torch can hold maps (the
    unsigned 16/32/64-bit integers included). Raises ``ValueError`` for a
    dtype torch cannot hold (datetimes, strings, objects, long double)."""
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError as e:
        raise ValueError(
            f"numpy dtype {np.dtype(dtype)} has no torch dtype: {e}") from None


def _require_torch_dtypes(columns) -> None:
    """Refuse, naming the spec, a column spec whose dtype torch cannot hold."""
    for name, (_, dt) in _normalize_columns(columns).items():
        try:
            torch_dtype(dt)
        except ValueError as e:
            raise ValueError(f"column spec {name!r}: {e}") from None


class DeviceFeed:
    """Async double-buffered iterator of batches of device tensors.

    Two background stages feed the consumer: host decode (``prefetch``
    decoded batches ahead) and device placement (``prefetch_to_device``
    already-placed batches ahead; ``0`` places on the consumer's thread —
    the same values either way). On CUDA a batch is copied into pinned host
    memory and sent with a ``non_blocking`` copy on a side stream; the
    consumer's current stream waits on that copy's event before the batch is
    yielded. ``timings`` carries the per-phase decode/stage/h2d split the
    estimator reports per epoch. ``device`` defaults to CUDA and raises
    without it; pass ``device="cpu"`` to feed the CPU."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        columns: Dict[str, Tuple[ColumnSpec, np.dtype]],
        device: DeviceLike = None,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        drop_remainder: bool = True,
        prefetch_to_device: Optional[int] = None,
        pad_remainder: bool = False,
        host_iter=None,
    ):
        self.device = resolve_device(device)
        _require_torch_dtypes(columns)
        #: the host batches: ``host_iter`` when given (a gang rank's
        #: :class:`GangShardIterator`), else a :class:`HostBatchIterator`
        self.host_iter = host_iter if host_iter is not None \
            else HostBatchIterator(
                dataset, batch_size, columns, shuffle=shuffle, seed=seed,
                drop_remainder=drop_remainder, pad_remainder=pad_remainder)
        self.prefetch = max(1, prefetch)
        if prefetch_to_device is None:
            prefetch_to_device = int(knobs.get("RDT_PREFETCH_TO_DEVICE"))
        #: already-placed batches kept ahead of the consumer (0 = place
        #: synchronously on the consumer thread)
        self.prefetch_to_device = max(0, int(prefetch_to_device))
        self.timings = PipelineTimings()
        self._copy_stream: Optional[torch.cuda.Stream] = None
        #: held while a batch is placed on CUDA (pinned staging, the copy);
        #: whoever holds it keeps the feed's threads from CUDA calls — the
        #: capture of a CUDA graph does, since a call from another thread
        #: can invalidate a capture in progress
        self.placement_lock = threading.Lock()

    def set_epoch(self, epoch: int) -> None:
        """Reseed per-epoch so shuffling differs across epochs deterministically."""
        if not hasattr(self, "_base_seed"):
            self._base_seed = self.host_iter.seed
        self.host_iter.seed = epoch_seed(self._base_seed, epoch + 1)

    def _place(self, batch: Dict[str, np.ndarray]):
        """``(tensors, ready)``: the batch on the device and the CUDA event
        its copy records (None on the CPU)."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = {n: torch.tensor(a) for n, a in batch.items()}
            self.timings.add("h2d", time.perf_counter() - t0)
            return out, None
        with self.placement_lock:
            t0 = time.perf_counter()
            pinned = {}
            for n, a in batch.items():
                host = torch.empty(a.shape, dtype=torch_dtype(a.dtype),
                                   pin_memory=True)
                np.copyto(host.numpy(), a)
                pinned[n] = host
            t1 = time.perf_counter()
            with torch.cuda.device(self.device):
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream()
                with torch.cuda.stream(self._copy_stream):
                    # the caching host allocator keeps each pinned block
                    # until the copy reading it has completed
                    out = {n: h.to(self.device, non_blocking=True)
                           for n, h in pinned.items()}
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
            del pinned  # the host allocator's release, under the lock too
            t2 = time.perf_counter()
        self.timings.add("stage", t1 - t0)
        self.timings.add("h2d", t2 - t1)
        return out, ready

    def _consume(self, item) -> Dict[str, torch.Tensor]:
        """Make the consumer's stream wait for the batch's copy, and tell the
        allocator the consumer's stream uses the copy-stream tensors."""
        tensors, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in tensors.values():
                t.record_stream(current)
        return tensors

    def _host_batches(self):
        """Host batches decoded ``prefetch`` ahead on a background thread;
        the pull wall (Arrow→numpy decode, native staging kernel included)
        accumulates as the ``decode`` phase."""
        return iter(DevicePrefetcher(
            self.host_iter, depth=self.prefetch, timings=self.timings,
            pull_key="decode", name="devicefeed-host"))

    def _placed(self, items, place_fn):
        """Run ``place_fn`` over ``items`` — through the async
        :class:`DevicePrefetcher` stage when ``prefetch_to_device`` > 0,
        inline otherwise. Same values in the same order either way."""
        if self.prefetch_to_device <= 0:
            for item in items:
                yield place_fn(item)
            return
        yield from DevicePrefetcher(
            items, fn=place_fn, depth=self.prefetch_to_device,
            name="devicefeed-device")

    def __iter__(self):
        for item in self._placed(self._host_batches(), self._place):
            yield self._consume(item)

    def chained(self, k: int):
        """Yield ``(stack, n)``: up to ``k`` host batches stacked on a new
        leading dim and placed with ONE pinned host→device copy — the
        inputs of one replay of a ``k``-step graph (the reference's
        ``lax.scan``-chained dispatch). The epoch remainder (steps % k)
        comes as a smaller stack; a ragged batch (the ``drop_remainder=
        False`` epoch tail) cannot stack with full batches, so the stack
        before it is flushed and it travels alone. ``k <= 1`` yields each
        batch unstacked, as ``(batch, 1)``.

        With ``prefetch_to_device`` > 0 the stacking (the ``stage`` phase)
        AND the placement run on the device-prefetch thread, so both
        overlap the consumer's steps."""
        if k <= 1:
            for batch in self:
                yield batch, 1
            return

        def _rows(b: Dict[str, np.ndarray]) -> int:
            return next(iter(b.values())).shape[0]

        def _stack(buf):
            t0 = time.perf_counter()
            stacked = {n: np.stack([b[n] for b in buf]) for n in buf[0]}
            self.timings.add("stage", time.perf_counter() - t0)
            return stacked, len(buf)

        def _stacks():
            buf: List[Dict[str, np.ndarray]] = []
            for batch in self._host_batches():
                if buf and _rows(batch) != _rows(buf[0]):
                    yield _stack(buf)
                    buf = []
                buf.append(batch)
                if len(buf) == k:
                    yield _stack(buf)
                    buf = []
            if buf:
                yield _stack(buf)

        def _place_stack(item):
            stacked, n = item
            return self._place(stacked), n

        for placed, n in self._placed(_stacks(), _place_stack):
            yield self._consume(placed), n

