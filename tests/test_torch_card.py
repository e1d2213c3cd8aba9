"""The dispatch plane's CUDA graphs on the card: tests that skip without
one. They import neither JAX nor the reference, so they also run where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

- a resident fit (one graph a step) and a ``steps_per_dispatch=4`` fit
  (one graph a stack of four) against the eager streaming fit of the same
  batches: the same kernels on the same values, so the reference's limits
  for chaining (rtol 1e-5, atol 1e-6) hold;
- Adagrad keeps its step counter on the host, where a replay does not run:
  after a graphed fit the live optimizer and its restored checkpoint record
  every step the fit ran;
- GBDT replays one captured boosting round: a graphed fit equals one run
  round by round without a capture and a second graphed fit, bit for bit,
  and the CPU's fit under the reference's rule (at most 5 % of split nodes
  differ; margins within rtol 1e-3, atol 1e-4).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.models import MLP
from raydp_tpu_torch.train import TorchEstimator
from raydp_tpu_torch.train import checkpoint as ckpt

CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6
KW = dict(loss="mse", feature_columns=["x1", "x2"], label_column="y",
          batch_size=64, num_epochs=2, shuffle=False, seed=0)


@pytest.fixture
def cuda():
    # decided here, not at import: every test worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _dataset(n=1344):
    rng = np.random.RandomState(0)
    x = rng.random_sample((n, 2)).astype(np.float32)
    y = (x @ np.array([2.0, -3.0], np.float32) + 1.0).astype(np.float32)
    return TableDataset([pa.table({"x1": x[:, 0], "x2": x[:, 1], "y": y})])


def _model():
    return MLP(2, (8,), device="cpu",
               generator=torch.Generator().manual_seed(0))


@pytest.mark.cuda
def test_graphed_fits_equal_eager_ones(monkeypatch, cuda):
    ds = _dataset()

    def fit(cache, k=1):
        monkeypatch.setenv("RDT_DEVICE_CACHE", cache)
        return TorchEstimator(model=_model(), steps_per_dispatch=k,
                              device=cuda, **KW).fit(ds)

    eager = fit("0")
    assert all(d["graph_replays"] == 0 for d in eager.dispatch)
    for graphed in (fit("1"), fit("0", k=4)):
        np.testing.assert_allclose(
            [h["train_loss"] for h in graphed.history],
            [h["train_loss"] for h in eager.history],
            rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
        assert graphed.dispatch[0]["capture_s"] > 0
        assert sum(d["graph_steps"] + d["eager_steps"]
                   for d in graphed.dispatch) == 42


@pytest.mark.cuda
def test_adagrad_checkpoint_after_a_graphed_fit(tmp_path, cuda):
    est = TorchEstimator(
        model=_model(), optimizer=lambda p: torch.optim.Adagrad(
            p, lr=1e-2, initial_accumulator_value=0.1, eps=0.0),
        checkpoint_dir=str(tmp_path), device=cuda, **KW)
    result = est.fit(_dataset())
    saved, _ = ckpt.restore(str(tmp_path), result.state.state_dict())
    recorded = {float(s["step"]) for s in saved["optimizer"]["state"].values()}
    live = {float(s["step"])
            for s in result.state.optimizer.state.values()}
    assert sum(d["graph_steps"] for d in result.dispatch) == 41
    assert recorded == live == {42.0}


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["reg:squarederror", "multi:softprob"])
def test_gbdt_graphed_rounds_equal_eager_ones(monkeypatch, cuda, objective):
    from raydp_tpu_torch.models import fit_gbdt
    from raydp_tpu_torch.train import step_graph

    rng = np.random.RandomState(1)
    X = rng.rand(4000, 6).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1] ** 2 + 0.05 * rng.randn(4000)
         ).astype(np.float32)
    if objective.startswith("multi:"):
        y = np.digitize(y, np.quantile(y, [0.25, 0.5, 0.75])
                        ).astype(np.float32)
    kw = dict(num_trees=8, max_depth=5, num_bins=64, objective=objective,
              evals=(X[:500], y[:500]))

    def fit(device=cuda):
        timings = {}
        return fit_gbdt(X, y, device=device, timings=timings, **kw), timings

    (a, ma, ha), ta = fit()
    (b, mb, hb), _ = fit()
    real = step_graph.StepRunner.__init__

    def eager(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.graphed = False

    monkeypatch.setattr(step_graph.StepRunner, "__init__", eager)
    (c, mc, hc), tc = fit()
    monkeypatch.undo()
    assert ta["graph_replays"] == 7 and tc["graph_replays"] == 0
    for other, margins, hist in ((b, mb, hb), (c, mc, hc)):
        for name in ("split_feature", "split_bin", "leaf_value"):
            assert np.array_equal(getattr(a, name), getattr(other, name))
        assert np.array_equal(ma, margins) and ha == hist
    (cpu, mcpu, _), _ = fit("cpu")
    assert np.mean(cpu.split_feature != a.split_feature) <= 0.05
    np.testing.assert_allclose(ma, mcpu, rtol=1e-3, atol=1e-4)
