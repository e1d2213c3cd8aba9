"""Port parity: raydp_tpu_torch's feed (host batches, residency gate,
resident epochs, the streaming DeviceFeed on the CPU) vs the JAX reference.

Host batches must be byte-identical to the reference's ``HostBatchIterator``
for the same dataset, seed and flags. The reference reads a store-backed
``DistributedDataset`` (blocks put with ``get_client().put_arrow`` under the
bare ``runtime`` fixture); the port reads a ``TableDataset`` of the same
Arrow tables, and also the reference's dataset itself.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data import feed as ref_feed
from raydp_tpu_torch.data import (
    MASK_KEY, DeviceEpochCache, DeviceFeed, DevicePrefetcher,
    HostBatchIterator, TableDataset,
)
from raydp_tpu_torch.data import feed as port_feed
from raydp_tpu_torch.native import stage as port_stage

# ragged blocks: no block is a multiple of any batch size below
BLOCKS = (37, 64, 5, 90)
COLUMNS = {"features": (["a", "b", "c"], np.float32),
           "ids": (["i", "j"], np.int64),
           "label": ("y", np.float32)}


def _tables(sizes=BLOCKS, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        out.append(pa.table({
            "a": rng.randn(n).astype(np.float32),
            "b": rng.randn(n),                            # float64 → f32
            "c": rng.randint(0, 9, n).astype(np.int32),   # int32 → f32
            "i": rng.randint(0, 1000, n),                 # int64 → int64
            "j": rng.randint(0, 50, n).astype(np.int16),  # int16 → int64
            "y": rng.randn(n).astype(np.float32)}))
    return out


def _ref_dataset(tables):
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.runtime.object_store import get_client

    return DistributedDataset(
        [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
         for t in tables], tables[0].schema)


def _assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for name in r:
            assert g[name].dtype == r[name].dtype, name
            assert g[name].shape == r[name].shape, name
            assert g[name].tobytes() == r[name].tobytes(), name


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("tail", ["drop", "keep", "pad"])
@pytest.mark.parametrize("batch_size", [16, 50])
def test_host_batches_are_byte_identical(runtime, shuffle, tail, batch_size):
    tables = _tables()
    ref_ds = _ref_dataset(tables)
    flags = dict(shuffle=shuffle, seed=7, drop_remainder=tail == "drop",
                 pad_remainder=tail == "pad")
    ref_it = ref_feed.HostBatchIterator(ref_ds, batch_size, COLUMNS, **flags)
    port_it = HostBatchIterator(TableDataset(tables), batch_size, COLUMNS,
                                **flags)
    # the port also reads the reference's own dataset
    port_on_ref = HostBatchIterator(ref_ds, batch_size, COLUMNS, **flags)
    for epoch in range(2):      # the second epoch comes from the decode cache
        for it in (ref_it, port_it, port_on_ref):
            it.seed = 7 + epoch
        ref = list(ref_it)
        _assert_same_batches(list(port_it), ref)
        _assert_same_batches(list(port_on_ref), ref)
    if tail == "pad":
        assert all(MASK_KEY in b for b in ref)
        assert ref[-1][MASK_KEY].sum() == sum(BLOCKS) % batch_size


def test_native_staging_matches_reference_and_builds_in_the_port():
    table = pa.concat_tables(_tables())     # several chunks per column
    for cols, dt in (("abc", np.float32), ("abc", np.float64),
                     ("ij", np.int64), ("ij", np.int32)):
        got = port_feed._as_numpy(table, list(cols), dt)
        ref = ref_feed._as_numpy(table, list(cols), dt)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert port_stage.native_stage_available()
    assert port_stage._LIB.startswith(port_stage._PKG)
    assert "/_build/" in port_stage._LIB


@pytest.mark.parametrize("case", ["fits", "knob_off", "no_drop_last",
                                  "too_few_rows", "over_cap"])
def test_residency_gate_decides_as_the_reference(runtime, monkeypatch, case):
    tables = _tables()
    batch_size, drop_last = 32, True
    if case == "knob_off":
        monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    elif case == "no_drop_last":
        drop_last = False
    elif case == "too_few_rows":
        batch_size = sum(BLOCKS) + 1
    elif case == "over_cap":
        # 196 rows x (3·4 + 2·8 + 4) bytes = 6272 bytes > 0.005 MiB
        monkeypatch.setenv("RDT_DEVICE_CACHE_MB", "0.005")
    ref = ref_feed.DeviceEpochCache.eligible(_ref_dataset(tables), COLUMNS,
                                             batch_size, drop_last)
    got = DeviceEpochCache.eligible(TableDataset(tables), COLUMNS,
                                    batch_size, drop_last)
    assert got == ref == (case == "fits")
    assert DeviceEpochCache.estimate_bytes(TableDataset(tables), COLUMNS) \
        == ref_feed.DeviceEpochCache.estimate_bytes(_ref_dataset(tables),
                                                    COLUMNS) == 6272


def _resident_epoch(cache, shuffle, seed, batch_size=32):
    epoch = cache.make_epoch(batch_size, shuffle)
    epoch.begin(seed)
    batches = [epoch.next_batch() for _ in range(epoch.steps)]
    assert len(batches) == epoch.steps == cache.num_rows // batch_size
    return {n: torch.cat([b[n] for b in batches]) for n in cache.arrays}


def test_resident_epoch_is_a_permutation_of_the_rows():
    """The reference's jax.random permutation cannot be reproduced in torch
    (ROADMAP queue 3), so the port's shuffled resident epoch is held to
    what it must be: every row once, rows kept whole, a new order per
    seed; unshuffled, the rows in dataset order."""
    tables = _tables((64, 64))          # 128 rows: four whole batches
    cache = DeviceEpochCache(TableDataset(tables), COLUMNS, device="cpu")
    whole = {n: a.clone() for n, a in cache.arrays.items()}
    ordered = _resident_epoch(cache, False, 0)
    for n in whole:
        assert torch.equal(ordered[n], whole[n])
    orders = []
    for seed in (11, 12):
        got = _resident_epoch(cache, True, seed)
        # the label column identifies each row (continuous random values)
        perm = [int(np.flatnonzero(whole["label"].numpy() == v)[0])
                for v in got["label"].numpy()]
        assert sorted(perm) == list(range(128))
        for n in whole:
            assert torch.equal(got[n], whole[n][perm])
        orders.append(perm)
    assert orders[0] != orders[1] and orders[0] != list(range(128))


@pytest.mark.parametrize("prefetch_to_device", [0, 2])
@pytest.mark.parametrize("pad", [False, True])
def test_device_feed_on_cpu_yields_the_host_batches(prefetch_to_device, pad):
    tables = _tables()
    ds = TableDataset(tables)
    feed = DeviceFeed(ds, 16, COLUMNS, device="cpu", seed=3,
                      drop_remainder=not pad, pad_remainder=pad,
                      prefetch_to_device=prefetch_to_device)
    feed.set_epoch(1)
    host = list(HostBatchIterator(ds, 16, COLUMNS, seed=feed.host_iter.seed,
                                  drop_remainder=not pad, pad_remainder=pad))
    placed = list(feed)
    assert len(placed) == len(host)
    for t, h in zip(placed, host):
        assert sorted(t) == sorted(h)
        for n in h:
            assert isinstance(t[n], torch.Tensor) and t[n].device.type == "cpu"
            np.testing.assert_array_equal(t[n].numpy(), h[n])
    timings = feed.timings.take()
    assert set(timings) == {"decode", "stage", "h2d"}
    assert timings["decode"] > 0 and timings["h2d"] > 0
    assert feed.timings.take() == dict.fromkeys(timings, 0.0)


def test_device_prefetcher_order_errors_and_single_use():
    assert list(DevicePrefetcher(range(10), fn=lambda x: x * x, depth=2)) \
        == [x * x for x in range(10)]

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(DevicePrefetcher(boom()))
    once = DevicePrefetcher(range(3))
    list(once)
    with pytest.raises(RuntimeError, match="single-use"):
        list(once)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_device_prefetcher_spans_join_the_constructing_trace(side):
    """A span that the prefetcher's ``fn`` opens on the producer thread has
    the constructing thread's span as its parent, in both packages."""
    if side == "reference":
        from raydp_tpu import profiler
        prefetcher = ref_feed.DevicePrefetcher
    else:
        from raydp_tpu_torch import profiler
        prefetcher = DevicePrefetcher
    tag = f"prefetch-trace-{side}"

    def stage(x):
        with profiler.trace("serve:apply", "serve", replica=tag, rows=x):
            return x

    with profiler.trace("serve:batch", "serve", replica=tag):
        parent = profiler.capture()
        staged = prefetcher(range(3), fn=stage, depth=1)
    assert list(staged) == [0, 1, 2]
    children = [s for s in profiler.spans() if s["name"] == "serve:apply"
                and s.get("args", {}).get("replica") == tag]
    assert len(children) == 3
    assert all((s["tr"], s.get("par")) == parent for s in children)


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_shard_parts_are_byte_identical(runtime, shuffle):
    """A ShardSpec of partial and whole blocks (partial parts decode only
    their slice) reads as the reference's."""
    tables = _tables()
    shard = ref_feed.ShardSpec(parts=[(3, 10, 50), (0, 0, 37), (1, 5, 20)])
    port_shard = port_feed.ShardSpec(parts=list(shard.parts))
    assert port_shard.num_rows() == shard.num_rows() == 107
    ref = list(ref_feed.HostBatchIterator(
        _ref_dataset(tables), 16, COLUMNS, shard=shard, shuffle=shuffle,
        seed=4, drop_remainder=False))
    got = list(HostBatchIterator(TableDataset(tables), 16, COLUMNS,
                                 shard=port_shard, shuffle=shuffle, seed=4,
                                 drop_remainder=False))
    _assert_same_batches(got, ref)


@pytest.mark.parametrize("np_dtype,expected", [
    (np.float16, torch.float16), (np.float32, torch.float32),
    (np.float64, torch.float64), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.uint8, torch.uint8),
    (np.uint16, torch.uint16), (np.uint32, torch.uint32),
    (np.uint64, torch.uint64), (np.bool_, torch.bool),
    (np.complex64, torch.complex64), (np.complex128, torch.complex128),
])
def test_torch_dtype_maps_every_dtype_torch_holds(np_dtype, expected):
    """The CUDA feed stages each batch in pinned buffers of
    ``torch_dtype(a.dtype)``: every numpy dtype ``torch.from_numpy`` takes
    maps, the unsigned 16/32/64-bit integers included (a fixed table of
    nine dtypes once raised ``KeyError`` for them on the card)."""
    assert port_feed.torch_dtype(np.dtype(np_dtype)) == expected
    feed = DeviceFeed(TableDataset(_tables()), 16,
                      {"x": ("i", np_dtype)}, device="cpu", shuffle=False)
    batch = next(iter(feed))
    assert batch["x"].dtype == expected
    want = _tables()[0]["i"].to_numpy()[:16].astype(np_dtype)
    assert np.array_equal(batch["x"].numpy(), want)


@pytest.mark.parametrize("np_dtype", ["datetime64[ns]", "timedelta64[s]",
                                      "U8", object, np.longdouble])
def test_feed_refuses_a_dtype_torch_cannot_hold(np_dtype):
    """A column spec whose dtype torch cannot hold is refused when either
    device feed is built, on every device, naming the spec."""
    for make in (lambda ds, cols: DeviceFeed(ds, 16, cols, device="cpu"),
                 lambda ds, cols: DeviceEpochCache(ds, cols, device="cpu")):
        with pytest.raises(ValueError,
                           match="column spec 'x'.*no torch dtype"):
            make(TableDataset(_tables()), {"x": ("i", np_dtype)})
    with pytest.raises(ValueError, match="no torch dtype"):
        port_feed.torch_dtype(np.dtype(np_dtype))
