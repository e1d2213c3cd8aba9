"""Arrow blocks → batches of device tensors — the port of
:mod:`raydp_tpu.data.feed`.

**Host half** (copied from the reference; same names and behaviour):
:class:`ShardSpec`, :func:`pad_batch`, :func:`epoch_seed`, :func:`_as_numpy`
(through the native staging kernel, :mod:`raydp_tpu_torch.native.stage`),
:class:`HostBatchIterator`, :class:`PipelineTimings` and
:class:`DevicePrefetcher`. With the same seed, shuffle and remainder flags
the host batches are byte-identical to the reference's.

**Device half** (the counterpart of ``jax.device_put``):

- :class:`DeviceFeed` streams batches: a background thread decodes host
  batches ``prefetch`` ahead, a second one copies each into pinned host
  memory (the ``stage`` phase) and enqueues a ``non_blocking`` host→device
  copy on a side CUDA stream (the ``h2d`` phase), ``prefetch_to_device``
  batches ahead; the consumer's stream waits on the copy's event, so batch
  ``k+1`` crosses the bus while batch ``k`` computes.
- :class:`DeviceEpochCache` keeps the whole dataset resident in device
  memory; an epoch is a loop over on-device slices (no shuffle) or gathers
  of one per-epoch permutation.

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

from raydp_tpu_torch import knobs
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


class DeviceEpochCache:
    """The whole dataset resident in device memory.

    Decode every block once, concatenate to contiguous host arrays and copy
    them to the device. The train loop then runs an epoch as a loop whose
    batches are *sliced (or gathered) on the device* — with per-epoch
    shuffling as an on-device ``torch.randperm`` — so no host batch is built
    and no host→device copy is made after the first epoch. The streaming
    :class:`DeviceFeed` remains the path for datasets above the budget.
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

    def make_epoch_fn(self, step, batch_size: int, shuffle: bool):
        """Build THE resident epoch loop.

        ``step(carry, batch) -> carry`` is the caller's train step. Returns
        ``(epoch_fn, steps_per_epoch)`` with ``epoch_fn(carry, data, seed) ->
        carry``: one whole epoch over ``data`` (the resident arrays) —
        batches of ``batch_size`` consecutive rows, or, when ``shuffle``,
        gathered by one permutation of all rows drawn on the device from a
        ``torch.Generator`` seeded with ``seed``. A ragged tail is dropped.
        """
        n_rows, b = self.num_rows, batch_size
        steps_per_epoch = n_rows // b
        device = self.device

        def epoch_fn(carry, data, seed: int):
            perm = None
            if shuffle:
                gen = torch.Generator(device=device).manual_seed(seed)
                perm = torch.randperm(n_rows, generator=gen, device=device)
            for s in range(steps_per_epoch):
                if perm is not None:
                    idx = perm[s * b:(s + 1) * b]
                    batch = {n: a.index_select(0, idx)
                             for n, a in data.items()}
                else:
                    batch = {n: a[s * b:(s + 1) * b] for n, a in data.items()}
                carry = step(carry, batch)
            return carry

        return epoch_fn, steps_per_epoch

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
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._started = False

    def _run(self):
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
    ):
        self.device = resolve_device(device)
        _require_torch_dtypes(columns)
        self.host_iter = HostBatchIterator(
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
        t0 = time.perf_counter()
        pinned = {}
        for n, a in batch.items():
            host = torch.empty(a.shape, dtype=torch_dtype(a.dtype),
                               pin_memory=True)
            np.copyto(host.numpy(), a)
            pinned[n] = host
        t1 = time.perf_counter()
        self.timings.add("stage", t1 - t0)
        with torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream()
            with torch.cuda.stream(self._copy_stream):
                # the caching host allocator keeps each pinned block until
                # the copy reading it has completed
                out = {n: h.to(self.device, non_blocking=True)
                       for n, h in pinned.items()}
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        self.timings.add("h2d", time.perf_counter() - t1)
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

    def _placed(self, items):
        """Run :meth:`_place` over ``items`` — through the async
        :class:`DevicePrefetcher` stage when ``prefetch_to_device`` > 0,
        inline otherwise. Same values in the same order either way."""
        if self.prefetch_to_device <= 0:
            for item in items:
                yield self._place(item)
            return
        yield from DevicePrefetcher(
            items, fn=self._place, depth=self.prefetch_to_device,
            name="devicefeed-device")

    def __iter__(self):
        for item in self._placed(self._host_batches()):
            yield self._consume(item)

