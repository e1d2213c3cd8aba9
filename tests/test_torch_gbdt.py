"""The port's GBDT (``raydp_tpu_torch.models.gbdt``, ``GBDTEstimator``)
against the reference's (``raydp_tpu.models.gbdt``) on the CPU.

The same numpy inputs from a seed go through both packages. Histograms are
held bitwise (torch's CPU ``index_add_`` and the sorted path the card takes
both add each segment in row order, as ``segment_sum`` does). Whole fits are
held to the reference's own rule for a different reduction order
(``tests/test_gbdt.py``'s sharded-fit test): at most 5 % of split nodes
differ, margins within rtol 1e-3 and atol 1e-4. The gain scan sums in
``jnp.cumsum``'s order (``scan_bins``, held bitwise here), since a gain
near a tie would flip an argmax otherwise; what still differs is the
last bits of the objectives' transcendental functions and of the eval
metric's means. The fused eval history is held within rtol 1e-4.

Sizes stay small (n <= 4,000, depth <= 5, bins <= 64, rounds <= 40).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from raydp_tpu_torch.models import GBDTModel, gbdt_from_reference
from raydp_tpu_torch.models import gbdt as P

SPLIT_FRACTION = 0.05
MARGIN_RTOL, MARGIN_ATOL = 1e-3, 1e-4
HISTORY_RTOL = 1e-4


def _ref():
    from raydp_tpu.models import gbdt as R
    return R


def _data(n=2000, seed=1):
    """Features with a constant column and a 3-valued one (many equal
    gains across empty bins), a regression target and its class labels."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6).astype(np.float32)
    X[:, 4] = 2019.0
    X[:, 5] = rng.randint(0, 3, n)
    y = (2 * X[:, 0] - X[:, 1] ** 2 + np.sin(4 * X[:, 2]) + 0.3 * X[:, 5]
         + 0.05 * rng.randn(n)).astype(np.float32)
    return X, y


def _labels(objective, y):
    if objective == "binary:logistic":
        return (y > np.median(y)).astype(np.float32)
    if objective.startswith("multi:"):
        return np.digitize(y, np.quantile(y, [0.25, 0.5, 0.75])
                           ).astype(np.float32)
    return y


def _split_fraction(a, b) -> float:
    return float(np.mean(a.split_feature != b.split_feature))


def _hold_forests(port, ref, port_margin, ref_margin, label):
    frac = _split_fraction(port, ref)
    print(f"{label}: {frac:.2%} of split nodes differ")
    assert port.split_feature.shape == ref.split_feature.shape
    assert frac <= SPLIT_FRACTION, f"{label}: {frac:.1%} of nodes differ"
    np.testing.assert_allclose(port_margin, ref_margin, rtol=MARGIN_RTOL,
                               atol=MARGIN_ATOL, err_msg=label)


@pytest.mark.parametrize("path", ["index_add", "sorted"])
@pytest.mark.parametrize("classes", [1, 3])
def test_level_histograms_are_bitwise_segment_sum(path, classes):
    """One level's histograms (depth 2: 4 nodes, 6 features, 64 bins, and
    the class in the segment index) equal ``jax.ops.segment_sum``'s bit for
    bit, through ``index_add_`` (the CPU's path) and through the sorted
    segment reduction (the card's)."""
    import jax
    import jax.numpy as jnp

    X, _ = _data(3000, seed=4)
    B, f, L = 64, X.shape[1], 4
    Xb = P.apply_bins(X, P.make_bins(X, B))
    rng = np.random.RandomState(5)
    g = rng.randn(len(X), classes).astype(np.float32)
    node = rng.randint(0, L, (len(X), classes))
    seg = (((np.arange(classes) * L + node)[:, :, None] * f
            + np.arange(f)) * B + Xb[:, None, :])
    vals = np.broadcast_to(g[:, :, None], seg.shape)
    S = classes * L * f * B
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals).ravel(),
                                          jnp.asarray(seg).ravel(),
                                          num_segments=S))
    sums = P.segment_sums if path == "index_add" else P._sorted_segment_sums
    got = sums(torch.tensor(seg), S, torch.tensor(np.ascontiguousarray(
        vals)))[0].numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("length", [8, 16, 17, 64, 100, 256, 300])
def test_scan_bins_is_bitwise_jnp_cumsum(length):
    import jax.numpy as jnp

    rng = np.random.RandomState(length)
    x = (rng.randn(50, length) * rng.choice([1e-3, 1.0, 1e3], (50, 1))
         ).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    assert np.array_equal(P.scan_bins(torch.tensor(x)).numpy(), want)


def test_make_bins_and_apply_bins_equal_the_reference():
    R = _ref()
    X, _ = _data()
    for bins in (16, 64):
        edges = P.make_bins(X, bins)
        assert np.array_equal(edges, R.make_bins(X, bins))
        assert np.array_equal(P.apply_bins(X, edges),
                              R.apply_bins(X, edges))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("objective", P.OBJECTIVES)
def test_fit_matches_the_reference(objective, weighted):
    """20 rounds of depth 5 on 64 bins with a per-round eval set (the fused
    path), with and without instance weights: split tables, train margins
    and the eval history against the reference's fit of the same data."""
    R = _ref()
    X, y = _data()
    y = _labels(objective, y)
    w = (np.random.RandomState(2).rand(len(y)).astype(np.float32) + 0.5
         if weighted else None)
    kw = dict(num_trees=20, max_depth=5, num_bins=64, learning_rate=0.3,
              objective=objective, sample_weight=w,
              evals=(X[:400], y[:400]))
    ref, ref_margin, ref_hist = R.fit_gbdt(X, y, **kw)
    port, port_margin, port_hist = P.fit_gbdt(X, y, device="cpu", **kw)
    _hold_forests(port, ref, port_margin, ref_margin, objective)
    assert list(port_hist) == list(ref_hist)
    for key in ref_hist:
        np.testing.assert_allclose(port_hist[key], ref_hist[key],
                                   rtol=HISTORY_RTOL, err_msg=key)
    assert port.base_score.shape == ref.base_score.shape
    np.testing.assert_array_equal(port.base_score, ref.base_score)
    np.testing.assert_allclose(port.predict(X[:50], device="cpu"),
                               ref.predict(X[:50]), rtol=MARGIN_RTOL,
                               atol=MARGIN_ATOL)


@pytest.mark.parametrize("objective", ["reg:squarederror", "multi:softprob"])
def test_early_stopping_matches_the_reference(objective):
    """The reference test's overfitting setup (tests/test_gbdt.py: deep
    trees at lr 0.5 on a noisy target): the same best iteration, history
    and truncated forest. Here the reference's rounds 3 and 4 score 3e-6
    apart, so the gain scan must sum in ``jnp.cumsum``'s order
    (``scan_bins``): with torch's ``cumsum`` a near-tied split flipped and
    so did the best iteration (ROADMAP queue 3)."""
    R = _ref()
    rng = np.random.RandomState(5)
    X = rng.rand(2000, 5).astype(np.float32)
    y = _labels(objective, (X[:, 0] + 0.3 * rng.randn(2000)
                            ).astype(np.float32))
    kw = dict(num_trees=40, max_depth=5, num_bins=64, learning_rate=0.5,
              objective=objective, evals=(X[1000:], y[1000:]),
              early_stopping_rounds=5)
    ref, ref_margin, ref_hist = R.fit_gbdt(X[:1000], y[:1000], **kw)
    port, port_margin, port_hist = P.fit_gbdt(X[:1000], y[:1000],
                                              device="cpu", **kw)
    assert ref.best_iteration < 39
    assert port.best_iteration == ref.best_iteration
    assert port.num_trees == ref.num_trees == ref.best_iteration + 1
    key, = ref_hist
    assert len(port_hist[key]) == len(ref_hist[key])
    np.testing.assert_allclose(port_hist[key], ref_hist[key],
                               rtol=HISTORY_RTOL)
    _hold_forests(port, ref, port_margin, ref_margin, objective)


def test_ties_take_the_first_maximum():
    """Two identical features give every split two equal gains; both
    packages take the first (feature 0), as ``jnp.argmax`` does."""
    R = _ref()
    rng = np.random.RandomState(3)
    a = rng.rand(1500).astype(np.float32)
    X = np.stack([a, a, rng.rand(1500).astype(np.float32) * 0.01], axis=1)
    y = (np.sin(6 * a) + 0.01 * rng.randn(1500)).astype(np.float32)
    kw = dict(num_trees=5, max_depth=4, num_bins=32)
    ref, ref_margin, _ = R.fit_gbdt(X, y, **kw)
    port, port_margin, _ = P.fit_gbdt(X, y, device="cpu", **kw)
    assert np.array_equal(port.split_feature, ref.split_feature)
    assert 1 not in port.split_feature and 0 in port.split_feature
    np.testing.assert_allclose(port_margin, ref_margin, rtol=MARGIN_RTOL,
                               atol=MARGIN_ATOL)


@pytest.mark.parametrize("objective", ["reg:squarederror", "multi:softmax"])
def test_gbdt_from_reference_predicts_as_the_reference(objective):
    """The reference's fitted forest carried across by its fields: the
    port's predictions equal the JAX model's within 1e-6."""
    R = _ref()
    X, y = _data(1500)
    y = _labels(objective, y)
    ref, _, _ = R.fit_gbdt(X, y, num_trees=12, max_depth=4, num_bins=32,
                           objective=objective)
    port = gbdt_from_reference(dataclasses.asdict(ref))
    assert isinstance(port, GBDTModel)
    for margin in (False, True):
        np.testing.assert_allclose(
            port.predict(X, output_margin=margin, device="cpu"),
            ref.predict(X, output_margin=margin), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown"):
        gbdt_from_reference({**dataclasses.asdict(ref), "extra": 1})


def test_unsupported_objective_and_mesh_are_refused():
    R = _ref()
    X, y = np.zeros((10, 2), np.float32), np.zeros(10, np.float32)
    with pytest.raises(ValueError) as want:
        R.fit_gbdt(X, y, objective="rank:pairwise")
    with pytest.raises(ValueError) as got:
        P.fit_gbdt(X, y, objective="rank:pairwise", device="cpu")
    assert str(got.value) == str(want.value)
    # a mesh of ranks this process has no process group for (a layout
    # given only as axis sizes) cannot shard rows: make_mesh in the ranks
    from raydp_tpu_torch.parallel import Mesh

    with pytest.raises(RuntimeError, match="make_mesh inside the ranks"):
        P.fit_gbdt(X, y, mesh=Mesh(dict(data=2)), device="cpu")


def test_fit_timings_name_every_part_of_the_wall():
    """``timings`` receives the fit's wall split and how its rounds were
    dispatched (on the CPU the step runner calls each round directly)."""
    X, y = _data(1000)
    timings = {}
    P.fit_gbdt(X, y, num_trees=6, max_depth=3, num_bins=32, device="cpu",
               evals=(X[:200], y[:200]), timings=timings)
    assert {"binning_s", "h2d_s", "capture_s", "rounds_s",
            "fetch_s"} <= set(timings)
    assert timings["rounds"] == timings["eager_rounds"] == 6
    assert timings["graph_replays"] == 0 and timings["capture_s"] == 0.0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_gbdt_runs_on_the_card_by_default_and_raises_without_it(no_cuda):
    from raydp_tpu_torch.train import GBDTEstimator

    X, y = _data(200)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.fit_gbdt(X, y, num_trees=2, max_depth=2, num_bins=8)
    model, _, _ = P.fit_gbdt(X, y, num_trees=2, max_depth=2, num_bins=8,
                             device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.predict(X)
    assert model.predict(X, device="cpu").shape == (200,)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GBDTEstimator()
    assert GBDTEstimator(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# GBDTEstimator.fit_on_frame on each package's ETL session
# ---------------------------------------------------------------------------

SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")
#: case -> (estimator keywords, label column, feature columns)
FRAME_CASES = {
    "regression": dict(
        params={"objective": "reg:squarederror", "max_depth": 4,
                "eta": 0.3, "max_bin": 64},
        num_boost_round=30),
    "multiclass_early_stop": dict(
        params={"objective": "multi:softprob", "num_class": 3,
                "max_depth": 3, "eta": 0.3},
        num_boost_round=40, early_stopping_rounds=8),
}


def _frames():
    """The two reference tests' frames (tests/test_gbdt.py)."""
    rng = np.random.RandomState(3)
    x = rng.rand(600, 3).astype(np.float32)
    reg = pd.DataFrame({"f0": x[:, 0], "f1": x[:, 1], "f2": x[:, 2],
                        "y": (x[:, 0] * 4 + x[:, 1]
                              + 0.01 * rng.randn(600)).astype(np.float32)})
    rng = np.random.RandomState(11)
    X = rng.rand(1500, 4)
    multi = pd.DataFrame({f"f{i}": X[:, i] for i in range(4)})
    multi["y"] = (X[:, 0] * 3).astype(np.int64).clip(0, 2).astype(np.float64)
    return {"regression": (reg, 2), "multiclass_early_stop": (multi, 3)}


def _run_side(side: str, tmp) -> dict:
    if side == "ref":
        import raydp_tpu as root
        from raydp_tpu.data import from_frame
        from raydp_tpu.train import GBDTEstimator
        device = {}
    else:
        import raydp_tpu_torch as root
        from raydp_tpu_torch.data import from_frame
        from raydp_tpu_torch.train import GBDTEstimator
        device = {"device": "cpu"}
    out = {}
    session = root.init(f"pytest-gbdt-{side}", **SESSION)
    try:
        for case, (pdf, parts) in _frames().items():
            df = session.createDataFrame(pdf, num_partitions=parts)
            train_df, eval_df = df.randomSplit([0.8, 0.2], seed=0)
            features = [c for c in pdf.columns if c != "y"]
            est = GBDTEstimator(feature_columns=features, label_column="y",
                                checkpoint_dir=str(tmp / f"{side}-{case}"),
                                **FRAME_CASES[case], **device)
            result = est.fit_on_frame(train_df, eval_df)
            eval_ds = from_frame(eval_df)
            X_eval = np.stack([eval_ds.to_arrow().column(c).to_numpy()
                               .astype(np.float32) for c in features], 1)
            out[case] = {"report": result.history[-1],
                         "evals": est.evals_result,
                         "model": est.get_model(),
                         "ckpt": result.checkpoint_dir,
                         "predict": est.predict(eval_ds),
                         "X_eval": X_eval}
    finally:
        root.stop()
    return out


@pytest.fixture(scope="module")
def frame_sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gbdt")
    ref = _run_side("ref", tmp)
    return ref, _run_side("port", tmp)


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_fit_on_frame_matches_the_reference_estimator(frame_sides, case):
    ref, port = (s[case] for s in frame_sides)
    assert port["report"].keys() == ref["report"].keys()
    for key, value in ref["report"].items():
        if key in ("num_trees", "best_iteration"):
            assert port["report"][key] == value, key
        else:
            np.testing.assert_allclose(port["report"][key], value,
                                       rtol=MARGIN_RTOL, atol=MARGIN_ATOL,
                                       err_msg=key)
    key, = ref["evals"]
    np.testing.assert_allclose(port["evals"][key], ref["evals"][key],
                               rtol=HISTORY_RTOL)
    frac = _split_fraction(port["model"], ref["model"])
    print(f"{case}: {frac:.2%} of split nodes differ")
    assert frac <= SPLIT_FRACTION
    assert np.array_equal(port["X_eval"], ref["X_eval"])
    np.testing.assert_allclose(port["predict"], ref["predict"],
                               rtol=MARGIN_RTOL, atol=MARGIN_ATOL)


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_checkpoint_round_trip(frame_sides, case):
    """``model.pkl`` holds the port's GBDTModel; loaded back it predicts
    the same bits as the fitted model and as ``GBDTEstimator.predict``."""
    from raydp_tpu_torch.train import GBDTEstimator

    port = frame_sides[1][case]
    loaded = GBDTEstimator.load_model(port["ckpt"])
    assert isinstance(loaded, GBDTModel)
    got = loaded.predict(port["X_eval"], device="cpu")
    assert np.array_equal(got, port["model"].predict(port["X_eval"],
                                                     device="cpu"))
    assert np.array_equal(got, port["predict"])
