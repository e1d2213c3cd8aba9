"""The port's headline examples (``raydp_tpu_torch/examples/nyctaxi_mlp.py``
and ``stroke_pipeline.py``) against the reference's, on the CPU.

Each package's ETL session (2 executors × 1 core × 512MB, as in
``test_torch_frame_estimator.py``) runs both examples' pipelines on the same
generated CSVs (3,000 NYCTaxi rows, 2,000 stroke rows): the reference's
session first, stopped, then the port's (the two runtimes never run at
once). Each side builds its estimator as its example does — the
reference's ``FlaxEstimator``, the port's ``build_estimator`` — and both
start from the same weights (the Flax init, carried across with
``mlp_variables_from_flax``). The fits stream (``RDT_DEVICE_CACHE=0``), the
path on which a shuffled fit is the reference's (ROADMAP queue 3, the
resident shuffle order). Per-epoch losses agree within ``EPOCH_RTOL``
(``test_torch_frame_estimator.py``'s): the stroke MLP's train and eval
losses; NYCTaxi's train loss only (real fares, mostly in smooth L1's linear
regime, where Adam amplifies rounding noise: ROADMAP queue 3).

Then the port's ``main`` of each example runs end to end with
``--device cpu``, NYCTaxi's also as a gang of two ranks.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raydp_tpu.models import MLP as JaxMLP
from raydp_tpu.models import NYCTaxiModel as JaxNYC
from raydp_tpu_torch.examples import nyctaxi_mlp, stroke_pipeline
from raydp_tpu_torch.models import MLP, NYCTaxiModel, mlp_variables_from_flax

EPOCH_RTOL = 5e-4
SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")
NYC_ROWS, STROKE_ROWS, EPOCHS = 3000, 2000, 2
NYC_BATCH, STROKE_BATCH = 256, 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_example(name: str):
    """One of the reference's ``examples/`` modules, loaded by path (the
    directory is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flax_variables(model, width: int):
    """The init ``FlaxEstimator`` draws from ``PRNGKey(0)`` (its default
    seed, and the stroke example's), as numpy."""
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, width)), train=False))


def _run_side(side: str, nyc_csv: str, stroke_csv: str) -> dict:
    """Both examples' pipelines through one package's session; returns the
    histories."""
    if side == "ref":
        import raydp_tpu as root
        from raydp_tpu.data import from_frame
        from raydp_tpu.train import FlaxEstimator
        from raydp_tpu.utils import random_split
        nyc = _reference_example("nyctaxi_features")
        stroke = _reference_example("stroke_pipeline")
    else:
        import raydp_tpu_torch as root
        from raydp_tpu_torch.data import from_frame
        from raydp_tpu_torch.examples import nyctaxi_features as nyc
        from raydp_tpu_torch.utils import random_split
        stroke = stroke_pipeline
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RDT_DEVICE_CACHE", "0")
        session = root.init(f"pytest-examples-{side}", **SESSION)
        try:
            # nyctaxi_mlp.py: read with 2 partitions an executor, split 0.9
            data = nyc.nyc_taxi_preprocess(
                session.read.csv(nyc_csv, num_partitions=4))
            train_df, test_df = data.randomSplit([0.9, 0.1], seed=0)
            features = nyc.feature_columns(data)
            if side == "ref":
                est = FlaxEstimator(
                    model=JaxNYC(), optimizer=optax.adam(1e-3),
                    loss="smooth_l1", feature_columns=features,
                    label_column=nyc.LABEL, batch_size=NYC_BATCH,
                    num_epochs=EPOCHS, metrics=["mae", "mse"])
            else:
                tm = NYCTaxiModel(len(features), device="cpu")
                tm.load_state_dict(mlp_variables_from_flax(
                    _flax_variables(JaxNYC(), len(features))))
                est = nyctaxi_mlp.build_estimator(
                    features, NYC_BATCH, EPOCHS, "cpu", model=tm)
            out["nyctaxi"] = est.fit_on_frame(train_df, test_df).history
            out["features"] = features

            # stroke_pipeline.py: preprocess, random_split 0.8, from_frame
            data = stroke.preprocess(
                session.read.csv(stroke_csv, num_partitions=4))
            train_df, test_df = random_split(data, [0.8, 0.2], seed=0)
            train_ds, test_ds = from_frame(train_df), from_frame(test_df)
            if side == "ref":
                est = FlaxEstimator(
                    model=JaxMLP(features=(64, 32, 1), use_batch_norm=False),
                    optimizer=optax.adam(1e-3), loss="bce_with_logits",
                    feature_columns=stroke.FEATURES,
                    label_column=stroke.LABEL, batch_size=STROKE_BATCH,
                    num_epochs=EPOCHS, seed=0)
            else:
                tm = MLP(len(stroke.FEATURES), (64, 32, 1), out_features=1,
                         use_batch_norm=False, device="cpu")
                tm.load_state_dict(mlp_variables_from_flax(_flax_variables(
                    JaxMLP(features=(64, 32, 1), use_batch_norm=False),
                    len(stroke.FEATURES))))
                est = stroke_pipeline.build_estimator(
                    STROKE_BATCH, EPOCHS, "cpu", model=tm)
            out["stroke"] = est.fit(train_ds, test_ds).history
        finally:
            root.stop()
    return out


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    from raydp_tpu_torch.examples.generate_nyctaxi import generate

    tmp = tmp_path_factory.mktemp("examples")
    nyc_csv, stroke_csv = str(tmp / "nyctaxi.csv"), str(tmp / "stroke.csv")
    generate(NYC_ROWS).to_csv(nyc_csv, index=False)
    stroke_pipeline.generate_stroke(STROKE_ROWS).to_csv(stroke_csv,
                                                        index=False)
    return nyc_csv, stroke_csv


@pytest.fixture(scope="module")
def sides(csvs):
    ref = _run_side("ref", *csvs)
    return ref, _run_side("port", *csvs)


def test_generated_stroke_data_is_the_reference_s():
    """``generate_stroke`` is copied with its seed: the same table."""
    ref = _reference_example("stroke_pipeline")
    a, b = ref.generate_stroke(500), stroke_pipeline.generate_stroke(500)
    assert list(a.columns) == list(b.columns)
    assert a.equals(b)
    assert ref.FEATURES == stroke_pipeline.FEATURES
    assert ref.LABEL == stroke_pipeline.LABEL


@pytest.mark.parametrize("example,keys", [
    ("stroke", ("train_loss", "eval_loss")),
    ("nyctaxi", ("train_loss",)),
])
def test_example_losses_match_the_reference(sides, example, keys):
    ref, port = sides
    got, want = port[example], ref[example]
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert g["steps"] == w["steps"] > 0
        assert "eval_loss" in g and "eval_loss" in w
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=EPOCH_RTOL,
                                       err_msg=f"{example} {k}")
    if example == "nyctaxi":
        assert port["features"] == ref["features"]
        assert len(port["features"]) == 25


def test_stroke_main_runs_end_to_end_and_its_loss_falls(capsys):
    out = stroke_pipeline.main(["--rows", str(STROKE_ROWS), "--epochs",
                                str(EPOCHS), "--device", "cpu"])
    losses = [h["train_loss"] for h in out["history"]]
    assert out["ok"] and len(losses) == EPOCHS and losses[-1] < losses[0]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("final: train_loss=")


def test_nyctaxi_main_with_trace_writes_a_trace_and_a_dump(capsys):
    out = nyctaxi_mlp.main(["--rows", str(NYC_ROWS), "--epochs",
                            str(EPOCHS), "--batch-size", str(NYC_BATCH),
                            "--device", "cpu", "--trace"])
    assert len(out["history"]) == EPOCHS and len(out["features"]) == 25
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["eval_loss"])
               for h in out["history"])
    with open(out["trace"]) as fh:
        trace = json.load(fh)
    # the driver's lane and one per live actor: the master and 2 executors
    assert out["trace"].actors == 3 and out["trace"].skipped_actors == 0
    assert out["trace"].flow_events > 0
    assert trace["otherData"]["flow_events"] == out["trace"].flow_events
    for path in out["metrics_dump"].values():
        assert os.path.getsize(path) > 0
    assert "chrome trace:" in capsys.readouterr().out


def test_nyctaxi_main_trains_a_gang_of_two(capsys):
    """``--num-workers 2`` trains as a gang of two CPU ranks (gloo): every
    epoch reports, the loss falls, every eval row counts."""
    out = nyctaxi_mlp.main(["--num-workers", "2", "--device", "cpu",
                            "--rows", str(NYC_ROWS), "--epochs", "2",
                            "--batch-size", str(NYC_BATCH)])
    losses = [h["train_loss"] for h in out["history"]]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert all(np.isfinite(h["eval_loss"]) and h["allreduce_time_s"] > 0
               for h in out["history"])
    assert "'epoch': 1" in capsys.readouterr().out
