"""The port's dispatch plane on the CPU: ``steps_per_dispatch`` chains, the
resident epoch through the step runner, and the runner itself.

On the card a chain of ``k`` steps and a resident step are CUDA graphs
replayed once a call (:mod:`raydp_tpu_torch.train.step_graph`); on the CPU
the same runner stages each call's inputs into its static buffers and calls
the step on them, so everything but the capture runs here. Limits:

- the port's ``k = 4`` against ``FlaxEstimator(steps_per_dispatch=4)``:
  ``EPOCH_RTOL`` (5e-4, from ``test_torch_estimator.py``: f32 sums in
  another order, carried by Adam);
- the port's ``k = 4`` against its ``k = 1``, and the resident runner
  against the eager streaming path: the reference's own limits for the
  same contract (``tests/test_train.py``, rtol 1e-5, atol 1e-6) — the same
  steps on the same batches, so in fact bit for bit here.

``tests/test_torch_card.py`` holds the same checks with the capture itself,
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.models import MLP as JaxMLP
from raydp_tpu.train import FlaxEstimator
from raydp_tpu_torch.data import DeviceFeed, HostBatchIterator, TableDataset
from raydp_tpu_torch.models import MLP, mlp_variables_from_flax
from raydp_tpu_torch.train import TorchEstimator
from raydp_tpu_torch.train import checkpoint as ckpt
from raydp_tpu_torch.train.step_graph import (
    Accumulators, StepRunner, prepare_optimizer,
)

EPOCH_RTOL = 5e-4
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6
FEATURES = ["x1", "x2"]


def _tables(n, seed=0, blocks=2):
    """``n`` rows of a noisy linear target, in ``blocks`` ragged blocks."""
    rng = np.random.RandomState(seed)
    x = rng.random_sample((n, 2)).astype(np.float32)
    y = (x @ np.array([2.0, -3.0], np.float32) + 1.0
         + 0.05 * rng.randn(n)).astype(np.float32)
    cuts = [0] + [n * (i + 1) // blocks + (7 if i + 1 < blocks else 0)
                  for i in range(blocks)]
    return [pa.table({"x1": x[a:b, 0], "x2": x[a:b, 1], "y": y[a:b]})
            for a, b in zip(cuts[:-1], cuts[1:])]


def _ref_dataset(tables):
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.runtime.object_store import get_client

    return DistributedDataset(
        [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
         for t in tables], tables[0].schema)


def _pair(use_batch_norm=True):
    """(Flax MLP(8), the port's MLP with the Flax init's weights)."""
    jm = JaxMLP(features=(8,), use_batch_norm=use_batch_norm)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))
    tm = MLP(2, (8,), use_batch_norm=use_batch_norm, device="cpu")
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return jm, tm


KW = dict(loss="mse", feature_columns=FEATURES, label_column="y",
          batch_size=64, num_epochs=2, shuffle=False, seed=0,
          metrics=["mae"])


def _port(tables, k=1, **kw):
    _, tm = _pair()
    args = {**KW, **kw}
    return TorchEstimator(
        model=tm, optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
        steps_per_dispatch=k, device="cpu", **args).fit(TableDataset(tables))


def _losses(result, key="train_loss"):
    return [h[key] for h in result.history]


def test_chain_matches_flax_estimator(runtime, monkeypatch):
    """k=4 against the reference's k=4 on the streaming feed, 21 batches
    of 64 (21 % 4 != 0: the remainder stack) with BatchNorm."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    tables = _tables(1344)
    jm, _ = _pair()
    ref = FlaxEstimator(model=jm, optimizer=optax.adam(1e-2),
                        steps_per_dispatch=4, **KW).fit(_ref_dataset(tables))
    got = _port(tables, k=4)
    assert [h["steps"] for h in got.history] == \
        [h["steps"] for h in ref.history] == [21, 21]
    for key in ("train_loss", "train_mae"):
        np.testing.assert_allclose(_losses(got, key), _losses(ref, key),
                                   rtol=EPOCH_RTOL, err_msg=key)


def test_chain_equals_one_step_dispatch(monkeypatch):
    """k=4 is the update sequence of k=1: the same losses and weights; the
    first stack is the eager warm-up, the second is staged (captured on
    the card), the remainder stack of one batch runs eagerly."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    tables = _tables(1344)
    one, four = _port(tables, k=1), _port(tables, k=4)
    assert [h["steps"] for h in four.history] == [21, 21]
    for key in ("train_loss", "train_mae"):
        np.testing.assert_allclose(_losses(four, key), _losses(one, key),
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    a, b = one.state.model.state_dict(), four.state.model.state_dict()
    for name in a:
        np.testing.assert_allclose(b[name].numpy(), a[name].numpy(),
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    assert [(d["graph_replays"], d["graph_steps"], d["eager_steps"])
            for d in four.dispatch] == [(4, 16, 5), (5, 20, 1)]
    assert all(d["graph_replays"] == 0 and d["eager_steps"] == 21
               for d in one.dispatch)


def test_chain_ragged_tail_trains_every_row(monkeypatch):
    """drop_last=False with k=4: the 6-row tail cannot stack with full
    batches; the feed flushes and sends it alone, and it trains."""
    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    result = _port(_tables(1350), k=4, drop_last=False)
    assert [h["steps"] for h in result.history] == [22, 22]
    assert np.isfinite(result.history[-1]["train_loss"])
    # 21 full batches: 5 stacks of 4 and a stack of 1, then the tail
    assert [d["eager_steps"] for d in result.dispatch] == [4 + 1 + 1, 1 + 1]


def test_feed_chained_stacks_the_host_batches():
    """``chained(k)`` yields the host batches stacked k at a time, in
    order: the remainder as a smaller stack, a ragged tail alone; k=1
    yields each batch unstacked."""
    tables = _tables(1350, blocks=3)
    ds = TableDataset(tables)
    cols = {"features": (FEATURES, np.float32), "label": ("y", np.float32)}
    host = list(HostBatchIterator(ds, 64, cols, shuffle=False,
                                  drop_remainder=False))
    feed = DeviceFeed(ds, 64, cols, device="cpu", shuffle=False,
                      drop_remainder=False)
    stacks = list(feed.chained(4))
    assert [n for _, n in stacks] == [4, 4, 4, 4, 4, 1, 1]
    flat = []
    for stack, n in stacks:
        assert all(t.shape[0] == n for t in stack.values())
        flat += [{k: t[i].numpy() for k, t in stack.items()}
                 for i in range(n)]
    assert len(flat) == len(host) == 22
    for got, want in zip(flat, host):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert feed.timings.take()["stage"] > 0
    single = list(feed.chained(1))
    assert [n for _, n in single] == [1] * 22
    np.testing.assert_array_equal(single[3][0]["label"].numpy(),
                                  host[3]["label"])


def test_resident_runner_equals_the_eager_streaming_path(monkeypatch):
    """The resident epoch through the runner (batches gathered by the
    static row order and step cursor; eval through its own runner plus
    the ragged eval tail eagerly) against the eager streaming feed,
    unshuffled: the same train and eval numbers, and every step run once
    (epoch 0: the warm-up, then staged calls)."""
    tables, evals = _tables(1344), _tables(200, seed=1)

    def fit(cache):
        monkeypatch.setenv("RDT_DEVICE_CACHE", cache)
        _, tm = _pair()
        return TorchEstimator(
            model=tm, optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
            device="cpu", **KW).fit(TableDataset(tables),
                                    TableDataset(evals))

    resident, streaming = fit("1"), fit("0")
    for key in ("train_loss", "train_mae", "eval_loss", "eval_mae"):
        np.testing.assert_allclose(_losses(resident, key),
                                   _losses(streaming, key),
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL,
                                   err_msg=key)
    assert [(d["graph_replays"], d["eager_steps"], d["eval_replays"])
            for d in resident.dispatch] == [(20, 1, 2), (21, 0, 3)]


def test_step_runner_staging_matches_direct_calls():
    """The runner's first call runs the body on its own inputs, later
    calls copy their inputs into its static buffers and run the body on
    those; the results equal direct calls, a call of another shape runs
    eagerly, and the inputs are never aliased."""
    torch.manual_seed(0)
    batches = [torch.randn(5, 3) for _ in range(4)] + [torch.randn(2, 3)]

    def make():
        w = torch.zeros(3)
        acc = Accumulators([], torch.device("cpu"))

        def body(inputs):
            w.add_(inputs["x"].mean(0))
            acc.update(acc.loss + inputs["x"].sum(), ())

        return w, acc, body

    w1, acc1, body1 = make()
    for b in batches:
        body1({"x": b})
    w2, acc2, body2 = make()
    runner = StepRunner(body2, torch.device("cpu"), "test step")
    for b in batches:
        runner({"x": b})
    assert torch.equal(w1, w2) and torch.equal(acc1.loss, acc2.loss)
    assert (runner.eager_steps, runner.replays, runner.replayed_steps) \
        == (2, 3, 3)
    assert runner._static["x"].shape == (5, 3)
    assert runner._static["x"].data_ptr() not in {
        b.data_ptr() for b in batches}
    torch.testing.assert_close(runner._static["x"], batches[3])
    acc2.reset()
    assert float(acc2.loss) == 0.0


def test_prepare_optimizer_makes_capturable_or_refuses():
    params = [torch.nn.Parameter(torch.zeros(2))]
    adam = torch.optim.Adam(params, lr=1e-3)
    prepare_optimizer(adam, graphed=True)
    assert all(g["capturable"] for g in adam.param_groups)
    prepare_optimizer(torch.optim.Adagrad(params, lr=1e-2), graphed=True)
    prepare_optimizer(torch.optim.SGD(params, lr=1e-2), graphed=True)
    with pytest.raises(ValueError, match=r"Adagrad\(lr_decay=0.1\)"):
        prepare_optimizer(torch.optim.Adagrad(params, lr_decay=0.1),
                          graphed=True)
    with pytest.raises(ValueError, match="LBFGS cannot be captured"):
        prepare_optimizer(torch.optim.LBFGS(params), graphed=True)
    # an eager fit takes any optimizer
    prepare_optimizer(torch.optim.LBFGS(params), graphed=False)


def _adagrad_fit(tmp_path, device):
    _, tm = _pair()
    est = TorchEstimator(
        model=tm, optimizer=lambda p: torch.optim.Adagrad(
            p, lr=1e-2, initial_accumulator_value=0.1, eps=0.0),
        checkpoint_dir=str(tmp_path / "ckpt"), device=device, **KW)
    result = est.fit(TableDataset(_tables(1344)))
    saved, step = ckpt.restore(str(tmp_path / "ckpt"),
                               result.state.state_dict())
    steps = sum(h["steps"] for h in result.history)
    recorded = {float(s["step"]) for s in saved["optimizer"]["state"].values()}
    live = {float(s["step"]) for s in result.state.optimizer.state.values()}
    return step, steps, recorded, live, result


def test_adagrad_checkpoint_records_the_steps_run(tmp_path):
    """Adagrad keeps its step counter on the host. A resident fit's
    checkpoint, restored, records every step the fit ran (42), and so does
    the live optimizer."""
    step, steps, recorded, live, result = _adagrad_fit(tmp_path, "cpu")
    assert step == 1 and steps == 42
    assert recorded == live == {42.0}
    assert sum(d["graph_steps"] for d in result.dispatch) == 41
