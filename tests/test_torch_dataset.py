"""The port's store-backed DistributedDataset against the reference's, on
the CPU.

The same seeded Arrow blocks go through each package's object store: the
reference's runtime is started, read and shut down first, then the port's
(the two never run at once; they share environment names and the segment
prefix). Host batches, the session-less ``random_shuffle`` and the
``split_shards`` plans must be identical, and a two-epoch streaming
``TorchEstimator`` fit from the port's dataset must match ``FlaxEstimator``
on the reference's within test_torch_estimator.py's ``EPOCH_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data import feed as ref_feed
from raydp_tpu.data.dataset import BlockMeta as RefBlockMeta
from raydp_tpu.data.dataset import DistributedDataset as RefDataset
from raydp_tpu.models import NYCTaxiModel as JaxNYC
from raydp_tpu.runtime import init_runtime as ref_init
from raydp_tpu.runtime import shutdown_runtime as ref_shutdown
from raydp_tpu.runtime.object_store import get_client as ref_get_client
from raydp_tpu.train import FlaxEstimator
from raydp_tpu_torch.data import (
    BlockMeta, DeviceFeed, DistributedDataset, HostBatchIterator, ShardSpec,
    TableDataset, release,
)
from raydp_tpu_torch.models import NYCTaxiModel, mlp_variables_from_flax
from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime
from raydp_tpu_torch.runtime.object_store import get_client
from raydp_tpu_torch.train import TorchEstimator

# as in test_torch_estimator.py: f32 sums in another order, carried by Adam
EPOCH_RTOL = 5e-4
SIZES = (300, 257, 1, 190)
COLUMNS = {"features": (["a", "b", "c"], np.float32),
           "ids": ("i", np.int64), "label": ("y", np.float32)}
FEATURES = [f"f{i}" for i in range(5)]


def _blocks(sizes=SIZES, seed=0):
    """Seeded blocks of several Arrow types (f32, f64, i64, u16)."""
    rng = np.random.RandomState(seed)
    return [pa.table({"a": rng.randn(n).astype(np.float32),
                      "b": rng.randn(n),
                      "c": rng.randint(-5, 5, n).astype(np.int32),
                      "i": rng.randint(0, 1 << 40, n),
                      "u": rng.randint(0, 1 << 16, n).astype(np.uint16),
                      "y": rng.rand(n).astype(np.float32)})
            for n in sizes]


class BlockWriter:
    """A port actor that writes blocks into the session's store."""

    def write(self, tables):
        from raydp_tpu_torch.runtime.object_store import get_client
        refs = get_client().put_arrow_many(tables)
        get_client().transfer_ownership(refs, "__driver__")
        return refs


def _ref_side(tables, work):
    """``work(dataset)`` on the reference's store-backed dataset of
    ``tables``, under a reference runtime that is shut down after."""
    ref_init()
    try:
        refs = ref_get_client().put_arrow_many(tables)
        ds = RefDataset([RefBlockMeta(num_rows=t.num_rows, ref=r)
                         for t, r in zip(tables, refs)], tables[0].schema)
        return work(ds)
    finally:
        ref_shutdown()


def _port_dataset(rt, tables, writer=None):
    """The port's dataset of ``tables``, written by ``writer`` (an actor
    handle) or by the driver."""
    refs = (writer.write(tables) if writer is not None
            else get_client().put_arrow_many(tables))
    return DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                               for t, r in zip(tables, refs)],
                              tables[0].schema)


def _port_side(tables, work, by_actor=False):
    """``work(dataset)`` on the port's dataset of ``tables`` under a port
    runtime, written by an actor when ``by_actor`` (an actor of this module
    imports it, JAX included: seconds on the CPU)."""
    rt = init_runtime()
    try:
        writer = rt.create_actor(BlockWriter) if by_actor else None
        return work(_port_dataset(rt, tables, writer))
    finally:
        shutdown_runtime()


def _batches(iterator_cls, shard_cls, shuffle, seed, world):
    """Every host batch of every rank of one epoch, copied out of the
    store before the runtime goes."""
    def work(ds):
        out = []
        plans = ds.split_shards(world, shuffle=shuffle, seed=seed) \
            if world else [None]
        for plan in plans:
            it = iterator_cls(ds, 64, COLUMNS, shuffle=shuffle, seed=seed,
                              drop_remainder=False,
                              shard=None if plan is None else shard_cls(plan))
            out.append([{k: np.array(v) for k, v in b.items()} for b in it])
        return out
    return work


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("world", [0, 2, 6], ids=["whole", "2ranks",
                                                  "6ranks"])
def test_host_batches_byte_identical_to_the_reference(shuffle, world):
    tables = _blocks()
    ref = _ref_side(tables, _batches(ref_feed.HostBatchIterator,
                                     ref_feed.ShardSpec, shuffle, 3, world))
    got = _port_side(tables, _batches(HostBatchIterator, ShardSpec, shuffle,
                                      3, world))
    assert len(got) == len(ref) == max(world, 1)
    for rank_ref, rank_got in zip(ref, got):
        assert len(rank_got) == len(rank_ref) > 0
        for r, g in zip(rank_ref, rank_got):
            assert g.keys() == r.keys()
            for k in r:
                assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
                assert g[k].tobytes() == r[k].tobytes(), k


def _shuffled_blocks(ds):
    out = ds.random_shuffle(seed=11)
    return [out.get_block(i) for i in range(out.num_blocks())]


def test_random_shuffle_byte_identical_to_the_reference():
    """Without a session both shuffle locally (numpy ``RandomState``): the
    same block order and row order."""
    tables = _blocks()
    ref = _ref_side(tables, _shuffled_blocks)
    got = _port_side(tables, _shuffled_blocks)
    assert [t.num_rows for t in got] == [t.num_rows for t in ref]
    for r, g in zip(ref, got):
        assert g.equals(r)
    rows = pa.concat_tables(got)
    assert sorted(rows["i"].to_pylist()) == sorted(
        pa.concat_tables(tables)["i"].to_pylist())


@pytest.mark.parametrize("sizes", [(300, 257, 1, 190, 64), (5, 3)],
                         ids=["5blocks", "2blocks"])
@pytest.mark.parametrize("world", [1, 2, 3, 7])
@pytest.mark.parametrize("shuffle", [False, True])
def test_split_shards_plans_identical(sizes, world, shuffle):
    """The plans (``divide_blocks``, and the contiguous row ranges when
    there are more ranks than blocks) equal the reference's; every rank
    gets the same number of rows."""
    ref = RefDataset([RefBlockMeta(num_rows=n) for n in sizes], None)
    got = DistributedDataset([BlockMeta(num_rows=n) for n in sizes], None)
    for seed in (None, 0, 5):
        plan = got.split_shards(world, shuffle=shuffle, seed=seed)
        assert plan == ref.split_shards(world, shuffle=shuffle, seed=seed)
        assert len({sum(n for _, _, n in p) for p in plan}) == 1


def test_split_shards_two_ranks_cover_every_row_once():
    """Two ranks over an even number of equal blocks (as the feed's
    datasets are cut) read every row exactly once. Uneven blocks may not:
    ``divide_blocks`` tops a short rank up by resampling, as the
    reference does."""
    def rows_of_ranks(ds):
        out = []
        for plan in ds.split_shards(2):
            out.append(np.concatenate(
                [ds.get_block(b)["i"].to_numpy()[off:off + n]
                 for b, off, n in plan]))
        return out

    tables = _blocks((150, 150, 150, 150))
    ranks = _port_side(tables, rows_of_ranks, by_actor=True)
    every = pa.concat_tables(tables)["i"].to_numpy()
    assert sorted(np.concatenate(ranks)) == sorted(every)
    assert len(ranks[0]) == len(ranks[1]) == len(every) // 2


def test_accessors_and_portable_roundtrip():
    tables = _blocks()

    def work(ds):
        assert ds.num_blocks() == len(SIZES) and ds.count() == sum(SIZES)
        assert ds.block_sizes() == list(SIZES)
        assert ds.to_arrow().equals(pa.concat_tables(tables))
        assert ds.to_pandas().shape == (sum(SIZES), 6)
        assert ds.take(3) == pa.concat_tables(tables).slice(0, 3).to_pylist()
        back = DistributedDataset.from_portable(ds.portable())
        assert back.schema.equals(ds.schema)
        assert back.to_arrow().equals(ds.to_arrow())
        refs = [ds.get_block_ref(i) for i in range(ds.num_blocks())]
        release(ds)
        assert ds.num_blocks() == 0
        assert not any(get_client().contains(r) for r in refs)

    _port_side(tables, work)


def test_release_right_after_a_streaming_epoch_reads_no_freed_memory(
        monkeypatch):
    """The feed decodes blocks in place over the store's shared memory
    (``get_block(zero_copy=True)``), and with the decode cache off its
    single-column batches are views of it. Every placed batch must own its
    bytes by the time the epoch ends: release the dataset at once, reclaim
    the arena with no grace, write other blocks into the freed space, and
    the epoch's tensors still hold the first blocks' values."""
    monkeypatch.setenv("RDT_FEED_CACHE_MB", "0")
    tables = _blocks()
    rt = init_runtime()
    try:
        host = rt.store_server.host
        host.ARENA_FREE_GRACE_S = 0.0
        writer = rt.create_actor(BlockWriter)
        ds = _port_dataset(rt, tables, writer)
        offsets = {rt.store_server.lookup(ds.get_block_ref(i).id)[3]
                   for i in range(ds.num_blocks())}
        feed = DeviceFeed(ds, 64, COLUMNS, device="cpu", shuffle=False,
                          prefetch_to_device=2, drop_remainder=False)
        placed = list(feed)
        release(ds)
        host._reap_deferred(everything=True)
        flipped = [pa.table({c: pa.array(-t[c].to_numpy())
                             if c in "aby" else t[c] for c in t.column_names})
                   for t in tables]
        again = _port_dataset(rt, flipped, writer)
        reused = {rt.store_server.lookup(again.get_block_ref(i).id)[3]
                  for i in range(again.num_blocks())}
        assert offsets & reused, "the new blocks did not reuse freed space"
        assert again.to_arrow().equals(pa.concat_tables(flipped))
    finally:
        shutdown_runtime()
    whole = pa.concat_tables(tables)
    y = torch.cat([b["label"] for b in placed])
    x = torch.cat([b["features"] for b in placed])
    assert torch.equal(y, torch.from_numpy(whole["y"].to_numpy()))
    assert torch.equal(x[:, 0], torch.from_numpy(whole["a"].to_numpy()))


def _nyc_tables(sizes, seed):
    """test_torch_estimator.py's regression blocks: labels centred near the
    initial predictions, so smooth L1 sees both of its regimes."""
    rng = np.random.RandomState(seed)
    w = np.array([1.5, -2.0, 0.5, 3.0, -1.0], np.float32)
    out = []
    for n in sizes:
        x = (rng.randn(n, 5) * [1, 2, 0.5, 1, 3]
             + [0, 1, -1, 2, 0]).astype(np.float32)
        y = (x @ w + 0.3 * np.sin(3 * x[:, 0]) + 0.1 * rng.randn(n)
             - 2.5).astype(np.float32)
        out.append(pa.table({**{f: x[:, i] for i, f in enumerate(FEATURES)},
                             "y": y}))
    return out


@pytest.mark.parametrize("path", ["stream", "resident"])
def test_fit_from_the_store_matches_flax_estimator(monkeypatch, path):
    """Two epochs (shuffled streaming, unshuffled resident) from the port's
    store-backed dataset match FlaxEstimator on the reference's, and the
    same fit from a TableDataset of the same tables gives the same
    losses bit for bit."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "1" if path == "resident" else "0")
    tables = _nyc_tables((400, 333, 291), 0)
    jm = JaxNYC()
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5)), train=False))
    kw = dict(loss="smooth_l1", feature_columns=FEATURES, label_column="y",
              batch_size=64, num_epochs=2, metrics=["mae"],
              shuffle=path == "stream", seed=0)
    ref = _ref_side(tables, lambda ds: FlaxEstimator(
        model=jm, optimizer=optax.adam(1e-3), **kw).fit(ds).history)

    def port_fit(ds):
        tm = NYCTaxiModel(5, device="cpu")
        tm.load_state_dict(mlp_variables_from_flax(variables))
        return TorchEstimator(model=tm, device="cpu", **kw).fit(ds).history

    got = _port_side(tables, port_fit)
    table_fit = port_fit(TableDataset(tables))
    assert len(got) == len(ref) == 2
    for r, g, t in zip(ref, got, table_fit):
        assert g["steps"] == r["steps"]
        for k in ("train_loss", "train_mae"):
            np.testing.assert_allclose(g[k], r[k], rtol=EPOCH_RTOL, err_msg=k)
            assert g[k] == t[k], k
