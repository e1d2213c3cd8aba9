"""Port parity for the training slice as a whole: raydp_tpu_torch's
TorchEstimator vs the reference's FlaxEstimator on the CPU.

Both estimators start from the same weights (the Flax init, carried across
with the converters, as FlaxEstimator draws it from ``PRNGKey(seed)``),
read the same Arrow blocks (a ``TableDataset`` and the reference's
store-backed dataset of the same tables, or one ETL dataset for both) and
train with matched optimizers. Per-epoch losses and metrics agree within
``EPOCH_RTOL``: every step sums f32 products in another order, and Adam
carries those last-bit differences from step to step (they also decide the
odd ReLU input that lies within rounding of zero); measured worst case
6.5e-5 over these 3-epoch runs, so 5e-4 leaves a margin of eight.

The regression labels are centred near the initial predictions so that the
smooth-L1 loss has rows in both of its regimes: when every row is in the
linear regime, the gradient below the last BatchNorm is zero in exact
arithmetic (the loss then sees only the batch mean of the last BatchNorm's
output, which is its bias), the computed values are rounding noise, and
Adam scales that noise up to learning-rate-sized steps that differ between
any two implementations.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.models import DLRM as JaxDLRM
from raydp_tpu.models import NYCTaxiModel as JaxNYC
from raydp_tpu.models import criteo_batch_preprocessor as jax_prep
from raydp_tpu.train import FlaxEstimator
from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.models import (
    DLRM, NYCTaxiModel, criteo_batch_preprocessor, dlrm_params_from_flax,
    mlp_variables_from_flax,
)
from raydp_tpu_torch.train import TorchEstimator

EPOCH_RTOL = 5e-4
FEATURES = [f"f{i}" for i in range(5)]
REPORT_KEYS = {"epoch", "train_loss", "steps", "samples_per_s",
               "epoch_time_s", "feed_time_s", "decode_time_s",
               "stage_time_s", "h2d_time_s", "dispatch_time_s",
               "sync_time_s"}


def _tables(sizes, seed):
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


def _ref_dataset(tables):
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.runtime.object_store import get_client

    return DistributedDataset(
        [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
         for t in tables], tables[0].schema)


def _nyc_pair(width=5, use_batch_norm=True):
    """(Flax model, its init as FlaxEstimator draws it, port model with
    those weights)."""
    jm = JaxNYC(use_batch_norm=use_batch_norm)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, width)), train=False))
    tm = NYCTaxiModel(width, use_batch_norm=use_batch_norm, device="cpu")
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return jm, tm


def _assert_histories_match(ref, got, keys, rtol=EPOCH_RTOL):
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g["steps"] == r["steps"]
        for k in keys:
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("path,shuffle", [("stream", False),
                                          ("stream", True),
                                          ("resident", False)])
def test_fit_matches_flax_estimator(runtime, monkeypatch, path, shuffle):
    monkeypatch.setenv("RDT_DEVICE_CACHE", "1" if path == "resident" else "0")
    train, evals = _tables((400, 333, 291), 0), _tables((150, 53), 1)
    jm, tm = _nyc_pair()
    kw = dict(loss="smooth_l1", feature_columns=FEATURES, label_column="y",
              batch_size=64, num_epochs=3, metrics=["mse", "mae", "rmse"],
              shuffle=shuffle, seed=0)
    ref = FlaxEstimator(model=jm, optimizer=optax.adam(1e-3), **kw).fit(
        _ref_dataset(train), _ref_dataset(evals))
    got = TorchEstimator(model=tm, device="cpu", **kw).fit(
        TableDataset(train), TableDataset(evals))
    metric_keys = {f"{s}_{m}" for s in ("train", "eval")
                   for m in ("mse", "mae", "rmse")}
    assert set(got.history[0]) == set(ref.history[0]) \
        == REPORT_KEYS | metric_keys | {"eval_loss"}
    _assert_histories_match(ref.history, got.history,
                            ["train_loss", "eval_loss", *metric_keys])
    # the reference's time split is measured on the feed that ran
    feed_keys = ("decode_time_s", "h2d_time_s", "feed_time_s")
    assert all((h[k] > 0) == (path == "stream")
               for h in got.history for k in feed_keys)


def test_predict_matches_flax_and_a_plain_forward(runtime):
    """The same trained weights (the Flax fit's, carried across) predict
    the same values on a ragged row count (203 rows, batches of 64); and
    ``predict`` is a plain eval-mode forward of ``get_model()``."""
    train, rows = _tables((400,), 0), _tables((150, 53), 2)
    jm, tm = _nyc_pair()
    kw = dict(loss="smooth_l1", feature_columns=FEATURES, label_column="y",
              batch_size=64, num_epochs=1)
    fest = FlaxEstimator(model=jm, optimizer=optax.adam(1e-3), **kw)
    fest.fit(_ref_dataset(train))
    test = TorchEstimator(model=tm, device="cpu", **kw)
    test.fit(TableDataset(train))
    test.get_model().load_state_dict(mlp_variables_from_flax(
        jax.tree.map(np.asarray, fest.get_model())))
    ref = fest.predict(_ref_dataset(rows))
    got = test.predict(TableDataset(rows))
    assert got.shape == ref.shape == (203,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    x = np.concatenate([np.stack([t[f].to_numpy() for f in FEATURES], 1)
                        for t in rows])
    model = test.get_model()
    assert not model.training
    with torch.no_grad():
        plain = model(torch.from_numpy(x))[:, 0].numpy()
    np.testing.assert_allclose(got, plain, atol=1e-6)


def test_accum_steps_matches_one_step():
    """k row-weighted microbatches reproduce one step over the whole batch
    (no BatchNorm: its batch statistics are per microbatch by design), to
    f32 summation order: 1e-5."""
    tables = _tables((256, 128), 3)

    def fit(k):
        _, tm = _nyc_pair(use_batch_norm=False)
        return TorchEstimator(
            model=tm, loss="mse", feature_columns=FEATURES, label_column="y",
            batch_size=64, num_epochs=2, metrics=["mae"], accum_steps=k,
            device="cpu").fit(TableDataset(tables))

    one, four = fit(1), fit(4)
    _assert_histories_match(one.history, four.history,
                            ["train_loss", "train_mae"], rtol=1e-5)
    a, b = one.state.model.state_dict(), four.state.model.state_dict()
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        TorchEstimator(model=_nyc_pair()[1], batch_size=64, accum_steps=5,
                       feature_columns=FEATURES, label_column="y",
                       device="cpu").fit(TableDataset(tables))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_masks_pad_rows(accum):
    """A ragged batch zero-padded with ``pad_batch`` (the feed's
    pad-and-mask mode) takes the same step as the ragged batch itself: the
    mask keeps pad rows out of the loss, the gradients and the metrics,
    with and without accumulation (f32 summation order: 1e-6)."""
    from raydp_tpu_torch.data import pad_batch
    from raydp_tpu_torch.train.metrics import build_metrics
    from raydp_tpu_torch.train.torch_estimator import (
        _make_apply, _make_train_step, _resolve_loss, TrainState,
    )

    t = _tables((37,), 6)[0]
    host = {"features": np.stack([t[f].to_numpy() for f in FEATURES], 1),
            "label": t["y"].to_numpy()}
    metrics = build_metrics(["mse", "accuracy"])
    results = []
    for batch, k in ((host, 1), (pad_batch(host, 40), accum)):
        _, tm = _nyc_pair(use_batch_norm=False)
        state = TrainState(tm, torch.optim.SGD(tm.parameters(), lr=0.1))
        step = _make_train_step(
            _make_apply(lambda b: (b["features"], b["label"]), None),
            _resolve_loss("smooth_l1"), metrics, k)
        loss, stats = step(state, {n: torch.tensor(a)
                                   for n, a in batch.items()},
                           tuple(m.init() for m in metrics),
                           torch.zeros(()))
        results.append((float(loss), [m.compute({n: np.asarray(v) for n, v
                                                 in s.items()})
                                      for m, s in zip(metrics, stats)],
                        tm.state_dict()))
    (l0, m0, p0), (l1, m1, p1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    np.testing.assert_allclose(m1, m0, rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(p1[k].numpy(), p0[k].numpy(), atol=1e-6)


@pytest.mark.parametrize("path", ["stream", "resident"])
@pytest.mark.parametrize("fail_at", [0, 2])
def test_retry_history_equals_uninterrupted(monkeypatch, tmp_path, path,
                                            fail_at):
    """A callback raises once at the end of epoch ``fail_at``, before that
    epoch's checkpoint. ``max_retries=1`` then restores the last checkpoint
    this fit wrote (epoch 1's, for a failure at epoch 2) and replays from
    there, or, with no checkpoint yet (epoch 0), starts over from the
    initial weights: either way the history equals an uninterrupted
    fit's, bit for bit on the CPU."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "1" if path == "resident" else "0")
    tables = _tables((300, 212), 4)
    _, tm = _nyc_pair()

    def fit(callbacks=(), max_retries=0, ckpt_dir=None):
        return TorchEstimator(
            model=tm, loss="smooth_l1", feature_columns=FEATURES,
            label_column="y", batch_size=64, num_epochs=4, metrics=["mse"],
            callbacks=list(callbacks), checkpoint_dir=ckpt_dir,
            device="cpu").fit(TableDataset(tables), max_retries=max_retries)

    clean = fit()
    raised = []

    def fail_once(report):
        if report["epoch"] == fail_at and not raised:
            raised.append(report["train_loss"])
            raise RuntimeError("injected failure")

    ckpt_dir = str(tmp_path / "ckpt")
    retried = fit([fail_once], max_retries=1, ckpt_dir=ckpt_dir)
    assert raised == [clean.history[fail_at]["train_loss"]]
    drop = ("epoch_time_s", "samples_per_s", "feed_time_s", "decode_time_s",
            "stage_time_s", "h2d_time_s", "dispatch_time_s", "sync_time_s")
    strip = [[{k: v for k, v in r.items() if k not in drop} for r in h]
             for h in (clean.history, retried.history)]
    assert len(strip[1]) == 4 and strip[0] == strip[1]
    assert sorted(os.listdir(ckpt_dir)) == ["step_2", "step_3"]
    for k, v in clean.state.model.state_dict().items():
        assert torch.equal(retried.state.model.state_dict()[k], v), k
    raised.clear()
    with pytest.raises(RuntimeError, match="injected failure"):
        fit([fail_once], max_retries=0, ckpt_dir=str(tmp_path / "again"))


def test_adagrad_mapping_matches_optax():
    """``optax.adagrad(lr)`` ≡ ``torch.optim.Adagrad(lr,
    initial_accumulator_value=0.1, eps=0)``: optax divides by sqrt(acc +
    1e-7), torch by sqrt(acc); with acc ≥ 0.1 the updates differ by at most
    5e-7 of themselves, so 20 steps move the parameters by less than 1e-7
    of the learning rate times the step count."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(40).astype(np.float32)
    grads = [(rng.randn(40) * s).astype(np.float32)
             for s in np.geomspace(1e-3, 10, 20)]
    tx = optax.adagrad(1e-2)
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adagrad([p], lr=1e-2, initial_accumulator_value=0.1,
                              eps=0.0)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    moved = np.abs(np.asarray(params) - p0).max()
    assert moved > 0.03
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               atol=20 * 1e-2 * 1e-6)


def _criteo_tables(sizes, seed, with_label=True):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        cols = {}
        if with_label:
            cols["_c0"] = (rng.random_sample(n) < 0.25).astype(np.float32)
        dense = np.log1p(rng.poisson(8, size=(n, 13))).astype(np.float64)
        dense[rng.random_sample(dense.shape) < 0.1] = 0.0
        for i in range(13):
            cols[f"_c{i + 1}"] = dense[:, i]
        for j in range(3):
            cols[f"_c{14 + j}"] = rng.zipf(1.3, size=n) % 20
        out.append(pa.table(cols))
    return out


def test_dlrm_fit_and_predict_match_flax_with_adagrad(runtime, monkeypatch):
    """DLRM (3 tables, small widths) through both estimators with the
    reference's Adagrad, its flat float64 feature decode and
    ``criteo_batch_preprocessor``, shuffled on the streaming feed (the
    resident permutations differ by design); then ``predict`` on rows
    without the label column (the preprocessor's label is synthesized as
    zeros). No BatchNorm, no smooth L1: the same f32 reasoning at 1e-5."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    sizes = [20, 20, 20]
    widths = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1))
    train = _criteo_tables((200, 184), 5)
    rows = _criteo_tables((70,), 6, with_label=False)
    jm = JaxDLRM(categorical_sizes=sizes, **widths)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"dense": jnp.zeros((1, 13)),
                                "sparse": jnp.zeros((1, 3), jnp.int32)}
    )["params"])
    tm = DLRM(sizes, device="cpu", **widths)
    tm.load_state_dict(dlrm_params_from_flax(params))
    kw = dict(loss="bce_with_logits",
              feature_columns=[f"_c{i}" for i in range(1, 17)],
              label_column="_c0", feature_dtype=np.float64, batch_size=64,
              num_epochs=2, metrics=["accuracy"], shuffle=True)
    fest = FlaxEstimator(model=jm, optimizer=optax.adagrad(1e-2),
                         batch_preprocessor=jax_prep(13), **kw)
    ref = fest.fit(_ref_dataset(train))
    test = TorchEstimator(
        model=tm, optimizer=lambda p: torch.optim.Adagrad(
            p, lr=1e-2, initial_accumulator_value=0.1, eps=0.0),
        batch_preprocessor=criteo_batch_preprocessor(13), device="cpu", **kw)
    got = test.fit(TableDataset(train))
    _assert_histories_match(ref.history, got.history,
                            ["train_loss", "train_accuracy"], rtol=1e-5)
    assert ref.history[-1]["train_loss"] < ref.history[0]["train_loss"]
    ref_p = fest.predict(_ref_dataset(rows), batch_size=32)
    got_p = test.predict(TableDataset(rows), batch_size=32)
    assert got_p.shape == ref_p.shape == (70,)
    np.testing.assert_allclose(got_p, ref_p, atol=1e-5)


def test_dlrm_fit_matches_flax_with_sgd_on_the_row_sparse_path(
        runtime, monkeypatch):
    """DLRM through both estimators with the source's plain SGD
    (``optax.sgd(0.1)`` against ``torch.optim.SGD(lr=0.1)``), from the same
    weights over the same shuffled batches: every port table takes the
    row-sparse path (a sparse gradient applied in the optimizer's step),
    the reference updates its tables densely, and both end at the same
    losses and parameters (summation order only: 1e-5)."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    sizes = [20, 20, 20]
    widths = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1))
    train = _criteo_tables((200, 184), 5)
    jm = JaxDLRM(categorical_sizes=sizes, **widths)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"dense": jnp.zeros((1, 13)),
                                "sparse": jnp.zeros((1, 3), jnp.int32)}
    )["params"])
    tm = DLRM(sizes, device="cpu", **widths)
    tm.load_state_dict(dlrm_params_from_flax(params))
    kw = dict(loss="bce_with_logits",
              feature_columns=[f"_c{i}" for i in range(1, 17)],
              label_column="_c0", feature_dtype=np.float64, batch_size=64,
              num_epochs=2, metrics=["accuracy"], shuffle=True)
    fest = FlaxEstimator(model=jm, optimizer=optax.sgd(0.1),
                         batch_preprocessor=jax_prep(13), **kw)
    ref = fest.fit(_ref_dataset(train))
    test = TorchEstimator(
        model=tm, optimizer=lambda p: torch.optim.SGD(p, lr=0.1),
        batch_preprocessor=criteo_batch_preprocessor(13), device="cpu", **kw)
    got = test.fit(TableDataset(train))
    assert len(got.state.row_sparse) == len(sizes)
    assert [(d["row_sparse_tables"], d["dense_tables"])
            for d in got.dispatch] == [(len(sizes), 0)] * 2
    _assert_histories_match(ref.history, got.history,
                            ["train_loss", "train_accuracy"], rtol=1e-5)
    assert ref.history[-1]["train_loss"] < ref.history[0]["train_loss"]
    start = dlrm_params_from_flax(params)
    want = dlrm_params_from_flax(jax.tree.map(
        np.asarray, fest.get_model()["params"]))
    have = test.get_model().state_dict()
    assert set(want) == set(have) == set(start)
    for name, value in want.items():
        np.testing.assert_allclose(have[name].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        assert not torch.equal(value, start[name]), name


def test_nyctaxi_etl_dataset_trains_both_estimators(session, tmp_path):
    """The reference's NYCTaxi ETL (examples/nyctaxi_features.py) on 3,000
    synthetic rows, converted once with ``from_frame`` and passed to both
    estimators. Also pins the feature count ``chip_smoke.py`` generates.

    These are the raw ETL features (a year near 2019, coordinates near −74
    and 41): the first layer's pre-activations lie far from zero against
    their spread, so the first BatchNorm's E[x²] − E[x]² loses digits to
    cancellation; and fares far above the initial predictions put most rows
    in smooth L1's linear regime, where the gradient below the last
    BatchNorm nearly vanishes (module docstring). Both let f32 differences
    grow faster than on the centred data above (measured 6e-5 at epoch 0),
    still within ``EPOCH_RTOL``; eval metrics are not compared."""
    import sys

    examples = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples")
    sys.path.insert(0, examples)
    try:
        from generate_nyctaxi import generate
        from nyctaxi_features import LABEL, feature_columns, \
            nyc_taxi_preprocess
    finally:
        sys.path.remove(examples)
    import chip_smoke
    from raydp_tpu.data import from_frame

    csv = str(tmp_path / "nyctaxi.csv")
    generate(3000).to_csv(csv, index=False)
    df = nyc_taxi_preprocess(session.read.csv(csv, num_partitions=2))
    features = feature_columns(df)
    assert len(features) == chip_smoke.NYCTAXI_FEATURES
    ds = from_frame(df)
    jm, tm = _nyc_pair(width=len(features))
    kw = dict(loss="smooth_l1", feature_columns=features, label_column=LABEL,
              batch_size=256, num_epochs=2, shuffle=False)
    ref = FlaxEstimator(model=jm, optimizer=optax.adam(1e-3), **kw).fit(ds)
    got = TorchEstimator(model=tm, device="cpu", **kw).fit(ds)
    assert got.history[0]["steps"] == ds.count() // 256
    _assert_histories_match(ref.history, got.history, ["train_loss"])
