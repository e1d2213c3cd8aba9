"""``TorchEstimator.fit_on_frame`` against ``FlaxEstimator.fit_on_frame``,
on the CPU.

Each package's ETL session (2 executors × 1 core × 512MB) runs the NYCTaxi
feature pipeline on the same seeded 3,000-row CSV and fits from the frame:
the reference's session first, stopped, then the port's (the two runtimes
never run at once). Both estimators start from the same weights (the Flax
init, carried across with ``mlp_variables_from_flax`` or
``dlrm_params_from_flax``) and their per-epoch losses agree within
``EPOCH_RTOL`` (from ``test_torch_estimator.py``: f32 sums in another
order, carried by Adam). These are real fares, mostly in smooth L1's linear
regime, where Adam amplifies rounding noise below the last BatchNorm
(ROADMAP queue 3), so only the train loss is compared for NYCTaxi.

Cases: a streaming fit with ``shuffle`` (the engine's ``random_shuffle``,
then the feed's), a resident fit without, the ``fs_directory`` parquet path
with an eval frame, a DLRM streaming fit with ``shuffle``, and
``stop_etl_after_conversion`` (last: it stops the session).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from raydp_tpu_torch.models import (
    DLRM, NYCTaxiModel, criteo_batch_preprocessor, dlrm_params_from_flax,
    mlp_variables_from_flax,
)
from raydp_tpu_torch.train import TorchEstimator

EPOCH_RTOL = 5e-4
SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")
NYC_ROWS, SEED = 3000, 11
DLRM_SIZES = [20, 20, 20]
DLRM_WIDTHS = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 1))
DLRM_FEATURES = [f"_c{i}" for i in range(1, 17)]
#: case -> (RDT_DEVICE_CACHE, shuffle, fit_on_frame keywords)
CASES = {
    "stream_shuffle": ("0", True, {}),
    "resident": ("1", False, {}),
    "resident_shuffle": ("1", True, {}),
    "fs_directory": ("0", False, {"fs_directory": True, "eval": True}),
    "dlrm_stream_shuffle": ("0", True, {}),
    "stop_etl": ("1", False, {"stop_etl_after_conversion": True}),
}


def _criteo_frame(n=400, seed=5) -> pd.DataFrame:
    """Criteo-shaped rows after ``pre_process`` (3 tables of 20 ids)."""
    rng = np.random.RandomState(seed)
    cols = {"_c0": (rng.random_sample(n) < 0.25).astype(np.float32)}
    dense = np.log1p(rng.poisson(8, size=(n, 13))).astype(np.float64)
    dense[rng.random_sample(dense.shape) < 0.1] = 0.0
    for i in range(13):
        cols[f"_c{i + 1}"] = dense[:, i]
    for j in range(3):
        cols[f"_c{14 + j}"] = rng.zipf(1.3, size=n) % 20
    return pd.DataFrame(cols)


def _estimators(side, case, features):
    """One side's estimator for ``case``; both start from the Flax init
    that ``FlaxEstimator`` draws from ``PRNGKey(seed)``."""
    dlrm = case.startswith("dlrm")
    _, shuffle, _ = CASES[case]
    if dlrm:
        from raydp_tpu.models import DLRM as JaxDLRM
        from raydp_tpu.models import criteo_batch_preprocessor as jax_prep
        jm = JaxDLRM(categorical_sizes=DLRM_SIZES, **DLRM_WIDTHS)
        kw = dict(loss="bce_with_logits", feature_columns=DLRM_FEATURES,
                  label_column="_c0", feature_dtype=np.float64,
                  batch_size=64, num_epochs=2, metrics=["accuracy"],
                  shuffle=shuffle, seed=SEED)
        if side == "ref":
            from raydp_tpu.train import FlaxEstimator
            return FlaxEstimator(model=jm, optimizer=optax.adagrad(1e-2),
                                 batch_preprocessor=jax_prep(13), **kw)
        params = jax.tree.map(np.asarray, jm.init(
            jax.random.PRNGKey(SEED), {"dense": jnp.zeros((1, 13)),
                                    "sparse": jnp.zeros((1, 3), jnp.int32)}
        )["params"])
        tm = DLRM(DLRM_SIZES, device="cpu", **DLRM_WIDTHS)
        tm.load_state_dict(dlrm_params_from_flax(params))
        return TorchEstimator(
            model=tm, optimizer=lambda p: torch.optim.Adagrad(
                p, lr=1e-2, initial_accumulator_value=0.1, eps=0.0),
            batch_preprocessor=criteo_batch_preprocessor(13), device="cpu",
            **kw)
    from raydp_tpu.models import NYCTaxiModel as JaxNYC
    jm = JaxNYC()
    kw = dict(loss="smooth_l1", feature_columns=features,
              label_column="fare_amount", batch_size=256, num_epochs=2,
              shuffle=shuffle, seed=SEED)
    if side == "ref":
        from raydp_tpu.train import FlaxEstimator
        return FlaxEstimator(model=jm, optimizer=optax.adam(1e-3), **kw)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(SEED), jnp.zeros((1, len(features))), train=False))
    tm = NYCTaxiModel(len(features), device="cpu")
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return TorchEstimator(model=tm, device="cpu", **kw)


def _run_side(side: str, csv: str, tmp) -> dict:
    """Every case's fit through one package's session; returns histories,
    the number of engine shuffles each case made and what the stopped
    session left."""
    if side == "ref":
        import raydp_tpu as root
        from raydp_tpu.data.dataset import DistributedDataset
        spec = importlib.util.spec_from_file_location(
            "ref_nyctaxi_features", os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "examples", "nyctaxi_features.py"))
        nyc = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(nyc)
    else:
        import raydp_tpu_torch as root
        from raydp_tpu_torch.data.dataset import DistributedDataset
        from raydp_tpu_torch.examples import nyctaxi_features as nyc
    shuffles = []
    real = DistributedDataset.random_shuffle

    def counted(self, seed=None):
        shuffles.append(seed)
        return real(self, seed=seed)

    out = {"history": {}, "shuffles": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DistributedDataset, "random_shuffle", counted)
        session = root.init(f"pytest-frame-{side}", **SESSION)
        try:
            frame = nyc.nyc_taxi_preprocess(
                session.read.csv(csv, num_partitions=4))
            train, evals = frame.randomSplit([0.8, 0.2], seed=1)
            features = nyc.feature_columns(frame)
            criteo = session.createDataFrame(_criteo_frame(),
                                             num_partitions=3)
            for case, (cache, _, kw) in CASES.items():
                mp.setenv("RDT_DEVICE_CACHE", cache)
                args = dict(kw)
                eval_df = evals if args.pop("eval", False) else None
                if args.get("fs_directory"):
                    args["fs_directory"] = str(tmp / f"fs-{side}")
                df = criteo if case.startswith("dlrm") else (
                    train if eval_df is not None else frame)
                del shuffles[:]
                est = _estimators(side, case, features)
                out["history"][case] = est.fit_on_frame(
                    df, eval_df, **args).history
                out["shuffles"][case] = list(shuffles)
            out["stopped_session_executors"] = len(session.executors)
        finally:
            root.stop()
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from raydp_tpu_torch.examples.generate_nyctaxi import generate

    tmp = tmp_path_factory.mktemp("frame")
    csv = str(tmp / "nyctaxi.csv")
    generate(NYC_ROWS, seed=SEED).to_csv(csv, index=False)
    ref = _run_side("ref", csv, tmp)
    return ref, _run_side("port", csv, tmp)


@pytest.mark.parametrize("case", [c for c in CASES if c != "resident_shuffle"])
def test_fit_on_frame_matches_flax_estimator(sides, case):
    ref, port = sides
    got, want = port["history"][case], ref["history"][case]
    keys = ["train_loss"]
    if case.startswith("dlrm"):
        keys.append("train_accuracy")
    if case == "fs_directory":
        assert "eval_loss" in got[0] and "eval_loss" in want[0]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["steps"] == w["steps"] > 0
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=EPOCH_RTOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_shuffle_only_before_a_streaming_shuffled_fit(sides, case):
    """``random_shuffle(seed)`` runs once before a streaming fit with
    ``shuffle`` and never before a resident one (whose on-device
    permutation already shuffles every row), as in the reference."""
    ref, port = sides
    cache, shuffle, _ = CASES[case]
    want = [SEED] if shuffle and cache == "0" else []
    assert port["shuffles"][case] == ref["shuffles"][case] == want


def test_stop_etl_after_conversion_trains_from_kept_blocks(sides):
    """The last case stopped the ETL (executors gone, data kept) before
    its fit, which still completed every epoch with a falling loss."""
    _, port = sides
    assert port["stopped_session_executors"] == 0
    losses = [h["train_loss"] for h in port["history"]["stop_etl"]]
    assert len(losses) == 2 and losses[-1] < losses[0]


def test_fit_on_frame_refuses_gang_training():
    """Gang training is not ported: ``num_workers > 1`` raises before any
    conversion instead of training on one device."""
    est = TorchEstimator(model=NYCTaxiModel(3, device="cpu"),
                         feature_columns=["a", "b", "c"], label_column="y",
                         device="cpu")
    with pytest.raises(NotImplementedError, match="gang training"):
        est.fit_on_frame(None, num_workers=2)
