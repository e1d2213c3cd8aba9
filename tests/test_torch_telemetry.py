"""The train loop's chaos site and telemetry in the port, on the CPU.

- ``estimator.epoch``: a fault the port's fault plane raises at the top of
  epoch 2, with ``max_retries=1``, restores epoch 1's checkpoint and ends
  as an uninterrupted fit: per-epoch losses within 1e-6 (the same steps on
  the same batches from the same restored state), on the resident path
  (whose step runners are built again over the restored state) and the
  streaming one.
- The registry names the reference's loop and feed emit, with the same
  values where they are counts: ``train_param_bytes_per_process``,
  ``train_accum_steps``, ``train_epoch_seconds``, ``feed_phase_seconds``,
  ``train_padded_rows_total``, and the ``train:place`` span.
  ``train_activation_bytes_per_process`` and ``train:accum`` time a CUDA
  graph's capture, so they appear only on the card (``chip_smoke.py``
  phase 9).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch import faults, metrics, profiler
from raydp_tpu_torch.data import DeviceFeed, TableDataset
from raydp_tpu_torch.models import MLP
from raydp_tpu_torch.parallel.roles import addressable_nbytes
from raydp_tpu_torch.train import TorchEstimator

RETRY_RTOL = 1e-6
FEATURES = ["x1", "x2"]


def _tables(n=640, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.random_sample((n, 2)).astype(np.float32)
    y = (x @ np.array([2.0, -3.0], np.float32) + 1.0).astype(np.float32)
    return [pa.table({"x1": x[:, 0], "x2": x[:, 1], "y": y})]


def _estimator(**kw):
    model = MLP(2, (8,), device="cpu",
                generator=torch.Generator().manual_seed(0))
    args = dict(loss="mse", feature_columns=FEATURES, label_column="y",
                batch_size=64, num_epochs=4, metrics=["mae"], device="cpu")
    return TorchEstimator(model=model, **{**args, **kw})


@pytest.fixture
def clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.mark.parametrize("cache", ["1", "0"], ids=["resident", "streaming"])
def test_epoch_fault_retry_ends_as_an_uninterrupted_fit(
        tmp_path, monkeypatch, clean_faults, cache):
    monkeypatch.setenv("RDT_DEVICE_CACHE", cache)
    ds = TableDataset(_tables())
    clean = _estimator(checkpoint_dir=str(tmp_path / "clean")).fit(ds)
    rule = faults.inject("estimator.epoch", "raise", match="2", times=1)
    retried = _estimator(checkpoint_dir=str(tmp_path / "retried")).fit(
        ds, max_retries=1)
    assert rule.fires == 1
    for key in ("train_loss", "train_mae"):
        np.testing.assert_allclose([h[key] for h in retried.history],
                                   [h[key] for h in clean.history],
                                   rtol=RETRY_RTOL, err_msg=key)
    a = clean.state.model.state_dict()
    b = retried.state.model.state_dict()
    for name in a:
        np.testing.assert_allclose(b[name].numpy(), a[name].numpy(),
                                   rtol=RETRY_RTOL, atol=1e-7)
    if cache == "1":
        # the failed epoch ran no step; the replayed one warms up again
        assert [(d["epoch"], d["eager_steps"]) for d in retried.dispatch] \
            == [(0, 1), (1, 0), (2, 1), (3, 0)]
    # without a retry budget the fault surfaces
    faults.inject("estimator.epoch", "raise", match="1", times=1)
    with pytest.raises(faults.InjectedFault, match="estimator.epoch"):
        _estimator().fit(ds)


def _emitted(snap):
    return {kind: {name: sorted(labels) for name, labels in snap[kind].items()}
            for kind in ("counters", "gauges", "hists")}


def test_fit_emits_the_references_names_and_counts(runtime, monkeypatch):
    """A streaming fit of each package (accum_steps=2): the same metric
    names with the same labels, the same epoch count in
    ``train_epoch_seconds``, the same accumulation gauge; the parameter
    bytes are the port's state (parameters, buffers and Adam's state)."""
    import optax

    from raydp_tpu import metrics as ref_metrics
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    tables = _tables()
    ref_ds = DistributedDataset(
        [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
         for t in tables], tables[0].schema)
    ref_metrics.reset()
    FlaxEstimator(model=JaxMLP(features=(8,)), optimizer=optax.adam(1e-3),
                  loss="mse", feature_columns=FEATURES, label_column="y",
                  batch_size=64, num_epochs=2, accum_steps=2).fit(ref_ds)
    want = ref_metrics.snapshot()

    metrics.reset()
    profiler.clear()
    result = _estimator(num_epochs=2, accum_steps=2).fit(
        TableDataset(tables))
    got = metrics.snapshot()
    names = {"train_param_bytes_per_process", "train_accum_steps",
             "train_epoch_seconds", "feed_phase_seconds"}
    mine = _emitted(got)
    theirs = _emitted(want)
    for kind in mine:
        mine[kind] = {n: v for n, v in mine[kind].items() if n in names}
        theirs[kind] = {n: v for n, v in theirs[kind].items() if n in names}
    assert mine == theirs
    assert set(mine["gauges"]) | set(mine["hists"]) == names
    assert got["gauges"]["train_accum_steps"][""] \
        == want["gauges"]["train_accum_steps"][""] == 2
    assert got["hists"]["train_epoch_seconds"][""]["count"] \
        == want["hists"]["train_epoch_seconds"][""]["count"] == 2
    state = result.state
    assert got["gauges"]["train_param_bytes_per_process"][""] \
        == addressable_nbytes((state.model, state.optimizer))
    assert {"train:place"} <= {s["name"] for s in profiler.spans()}
    assert "train_activation_bytes_per_process" not in got["gauges"]


def test_pad_and_mask_feed_counts_its_padded_rows():
    metrics.reset()
    feed = DeviceFeed(TableDataset(_tables(150)), 64,
                      {"features": (FEATURES, np.float32),
                       "label": ("y", np.float32)},
                      device="cpu", shuffle=False, pad_remainder=True)
    batches = list(feed)
    assert len(batches) == 3
    assert metrics.snapshot()["counters"]["train_padded_rows_total"][""] \
        == 3 * 64 - 150
