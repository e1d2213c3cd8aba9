"""The port's data bridges (``raydp_tpu_torch.data.bridges``) against the
reference's (``raydp_tpu.data.bridges``) on the CPU.

Each package's ETL session (2 executors × 1 core × 512MB) builds the same
frame as ``tests/test_data.py``'s bridge tests, converts it with
``from_frame`` and walks the bridges while it runs: the reference's session
first, stopped, then the port's. Every batch must be equal byte for byte:
the same dtypes, shapes and values in the same order, whole, sharded over 2
ranks, and shuffled over two epochs. ``to_tf_dataset`` imports TensorFlow at
its call, and without it both raise the same error.
"""

import sys

import numpy as np
import pytest

SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")
ROWS, PARTS = 500, 2


def _batches(dataset):
    """Every batch of one pass as numpy arrays, features and label."""
    return [tuple(t.numpy() for t in batch) for batch in dataset]


def _run_side(side: str) -> dict:
    if side == "ref":
        import raydp_tpu as root
        from raydp_tpu.data import from_frame, to_tf_dataset, to_torch_dataset
        from raydp_tpu.etl.expressions import col
    else:
        import raydp_tpu_torch as root
        from raydp_tpu_torch.data import (
            from_frame, to_tf_dataset, to_torch_dataset,
        )
        from raydp_tpu_torch.etl.expressions import col
    out = {}
    session = root.init(f"pytest-bridges-{side}", **SESSION)
    try:
        df = session.range(ROWS, num_partitions=PARTS).withColumn(
            "x", col("id") * 2).withColumn("y", col("id") % 7)
        ds = from_frame(df)
        whole = to_torch_dataset(ds, feature_columns=["x", "y"],
                                 label_column="id", batch_size=100,
                                 label_dtype=np.int64)
        out["len"] = len(whole)
        out["whole"] = _batches(whole)
        out["shards"] = [_batches(to_torch_dataset(
            ds, ["x"], "id", batch_size=50, label_dtype=np.int64,
            world_size=2, rank=r)) for r in range(2)]
        shuffled = to_torch_dataset(ds, ["x"], "id", batch_size=100,
                                    label_dtype=np.int64, shuffle=True,
                                    seed=7)
        out["shuffled"] = [_batches(shuffled), _batches(shuffled)]
        out["features_only"] = _batches(to_torch_dataset(
            ds, ["x", "y"], batch_size=128, drop_last=True))
        out["tf"] = [tuple(t.numpy() for t in b) for b in to_tf_dataset(
            ds, feature_columns=["x", "y"], label_column="id",
            batch_size=100, label_dtype=np.int64)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "tensorflow", None)
            try:
                to_tf_dataset(ds, ["x"], "id")
            except ImportError as e:
                out["no_tf"] = (type(e), str(e))
    finally:
        root.stop()
    return out


@pytest.fixture(scope="module")
def sides():
    ref = _run_side("ref")
    return ref, _run_side("port")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["whole", "shards", "shuffled",
                                  "features_only", "tf"])
def test_bridge_batches_equal_the_reference(sides, case):
    ref, port = sides
    if case in ("shards", "shuffled"):
        for got, want in zip(port[case], ref[case]):
            _same(got, want)
    else:
        _same(port[case], ref[case])


def test_bridge_contract(sides):
    """What the reference's bridge test asserts, on the port's batches:
    len() in batches, every row once, disjoint equal shards, and a shuffle
    that walks another order each epoch."""
    _, port = sides
    assert port["len"] == 5 and len(port["whole"]) == 5
    feats, labels = port["whole"][0]
    assert feats.shape == (100, 2) and labels.dtype == np.int64
    ids = np.concatenate([b[1] for b in port["whole"]])
    assert sorted(ids.tolist()) == list(range(ROWS))
    r0, r1 = (np.concatenate([b[1] for b in s]) for s in port["shards"])
    assert len(r0) == len(r1) == ROWS // 2
    assert not set(r0.tolist()) & set(r1.tolist())
    e0, e1 = (np.concatenate([b[1] for b in e]) for e in port["shuffled"])
    assert sorted(e0.tolist()) == sorted(e1.tolist()) == list(range(ROWS))
    assert e0.tolist() != e1.tolist()
    assert [len(b[0]) for b in port["tf"]] == [100] * 5


def test_to_tf_dataset_without_tensorflow_raises_as_the_reference(sides):
    ref, port = sides
    assert port["no_tf"] == ref["no_tf"]
    assert issubclass(port["no_tf"][0], ImportError)


def test_torch_dataset_in_a_dataloader_with_workers():
    """A stock ``DataLoader`` with 2 workers takes each batch once (the
    bridge stripes batches across workers), on a table-backed dataset."""
    import pyarrow as pa
    import torch

    from raydp_tpu_torch.data import TableDataset, to_torch_dataset

    ids = np.arange(ROWS, dtype=np.int64)
    ds = TableDataset([pa.table({"x": ids[:250] * 2, "id": ids[:250]}),
                       pa.table({"x": ids[250:] * 2, "id": ids[250:]})])
    tds = to_torch_dataset(ds, ["x"], "id", batch_size=100,
                           label_dtype=np.int64)
    loader = torch.utils.data.DataLoader(tds, batch_size=None,
                                         num_workers=2)
    got = torch.cat([b[1] for b in loader]).tolist()
    assert sorted(got) == list(range(ROWS))
