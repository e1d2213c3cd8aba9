"""``remat`` in the port: the policy grammar and the role rules copied from
``raydp_tpu.parallel.roles``, and ``torch.utils.checkpoint`` in place of
``jax.checkpoint`` (``dots`` saves the matrix products, ``full`` nothing).

Limits: recomputation recomputes and never approximates, so the three
modes give the same losses within 1e-6 (the reference holds its own modes
to that, ``tests/test_gang_sharded.py``); against
``FlaxEstimator(remat=mode)`` the training-slice limit ``EPOCH_RTOL``
(5e-4, ``test_torch_estimator.py``). A BatchNorm's running statistics move
once a step under every mode (the recompute restores the buffers it
found), which the eval losses and the final buffers show, for the port's
BatchNorm and for ``torch.nn.BatchNorm1d``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.models import DLRM as JaxDLRM
from raydp_tpu.models import MLP as JaxMLP
from raydp_tpu.parallel import roles as ref_roles
from raydp_tpu.train import FlaxEstimator
from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.models import DLRM, MLP, mlp_variables_from_flax
from raydp_tpu_torch.parallel import roles
from raydp_tpu_torch.train import TorchEstimator

EPOCH_RTOL = 5e-4
MODE_RTOL = 1e-6
FEATURES = ["x1", "x2", "x3"]

SPECS = ["none", "dots", "full", " dots ", "", "kernel=dots",
         "embedding=none,kernel=dots,default=full",
         "kernel=full, embedding=dots", "kernel=dots,,default=full",
         "replicated=full,default=dots",
         # refused, with the reference's texts
         "huge", "kernel=huge", "attention=dots", "kernel",
         "kernel=dots,kernel=full", "default=sometimes"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_remat_policy_equals_the_reference(spec):
    def parse(fn):
        try:
            return ("ok", fn(spec))
        except ValueError as e:
            return ("error", str(e))

    assert parse(roles.parse_remat_policy) == \
        parse(ref_roles.parse_remat_policy)


def test_vocabulary_and_roles_equal_the_reference():
    assert roles.REMAT_MODES == ref_roles.REMAT_MODES
    assert roles.REMAT_ROLES == ref_roles.REMAT_ROLES
    for path, shape in [("Dense_0/kernel", (5, 8)), ("Dense_0/bias", (8,)),
                        ("embedding_3/embedding", (20, 8)),
                        ("opt/mu/embedding_0/embedding", (20, 8)),
                        ("block/kernel", (4, 4, 4)), ("step", ())]:
        assert roles.classify_param(path, shape) == \
            ref_roles.classify_param(path, shape)
    policy = roles.parse_remat_policy("embedding=full,default=dots")
    for role in ("embedding", "kernel", "replicated"):
        assert roles.remat_mode_for_role(policy, role) == \
            ref_roles.remat_mode_for_role(policy, role)


def _flax_mlp(width, features=(16, 8)):
    jm = JaxMLP(features=features, use_batch_norm=True)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, width)), train=False))
    tm = MLP(width, features, use_batch_norm=True, device="cpu")
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return jm, variables, tm


def test_segment_role_equals_the_reference():
    """The mode-picking role of a whole model: the dense kernels of an
    MLP, the tables of a DLRM with large tables — from the port's named
    parameters as from the reference's params."""
    _, variables, tm = _flax_mlp(3)
    assert roles.segment_role(tm) == \
        ref_roles.segment_role(variables["params"]) == "kernel"
    sizes = [500, 400]
    jm = JaxDLRM(categorical_sizes=sizes, embedding_dim=8,
                 bottom_mlp=(16, 8), top_mlp=(16, 1))
    params = jm.init(jax.random.PRNGKey(0),
                     {"dense": jnp.zeros((1, 13)),
                      "sparse": jnp.zeros((1, 2), jnp.int32)})["params"]
    dm = DLRM(sizes, embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(16, 1),
              device="cpu")
    assert roles.segment_role(dm) == ref_roles.segment_role(params) \
        == "embedding"
    assert roles.segment_role({}) == ref_roles.segment_role({}) \
        == "replicated"


def test_addressable_nbytes_counts_params_buffers_and_optimizer_state():
    _, _, tm = _flax_mlp(3)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    tm(torch.ones(4, 3)).sum().backward()
    opt.step()
    params = sum(p.numel() * 4 for p in tm.parameters())
    buffers = sum(b.numel() * 4 for b in tm.buffers())
    # Adam: two moments a parameter, and a scalar f32 step
    state = 2 * params + 4 * len(list(tm.parameters()))
    assert roles.addressable_nbytes(tm) == params + buffers
    assert roles.addressable_nbytes((tm, opt)) == params + buffers + state


def test_apply_remat_recomputes_under_the_flag():
    """The forward runs once in the forward pass and again when the
    backward recomputes it; ``none`` returns the function itself."""
    calls = []

    def fn(w, x):
        calls.append(torch.is_grad_enabled())
        return torch.tanh(x @ w).sum()

    assert roles.apply_remat(fn, "none") is fn
    with pytest.raises(ValueError, match="unknown remat mode"):
        roles.apply_remat(fn, "most")
    for mode in ("dots", "full"):
        calls.clear()
        w = torch.randn(3, 3, requires_grad=True)
        roles.apply_remat(fn, mode)(w, torch.randn(2, 3)).backward()
        assert len(calls) == 2 and w.grad is not None


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_apply_remat_keeps_buffers_of_a_torch_batchnorm(mode):
    """``torch.nn.BatchNorm1d`` updates its running statistics and its
    batch count in place in its forward; under remat they move once a step,
    as without it (the recompute leaves them as it found them), and the
    gradients and the weights agree."""
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 3)
                         .astype(np.float32))

    def run(m):
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(3, 8),
                                  torch.nn.BatchNorm1d(8), torch.nn.ReLU(),
                                  torch.nn.Linear(8, 1))
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        forward = roles.apply_remat(lambda model, xs: model(xs), m)
        grads = []
        for _ in range(3):
            opt.zero_grad()
            forward(net, x).square().mean().backward()
            grads += [p.grad.clone() for p in net.parameters()]
            opt.step()
        return net.state_dict(), grads

    (want, want_grads), (got, got_grads) = run("none"), run(mode)
    assert int(got["1.num_batches_tracked"]) == 3
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=MODE_RTOL, atol=1e-7, err_msg=name)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=MODE_RTOL,
                                   atol=1e-7)


def _tables(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3).astype(np.float32)
    y = (x @ np.array([1.5, -2.0, 0.5], np.float32) + 0.3 * np.sin(x[:, 0])
         ).astype(np.float32)
    return [pa.table({**{f: x[:, i] for i, f in enumerate(FEATURES)},
                      "y": y})]


KW = dict(loss="mse", feature_columns=FEATURES, label_column="y",
          batch_size=32, num_epochs=2, shuffle=False, seed=0,
          metrics=["mae"])


def _port_fit(mode, train, evals):
    _, _, tm = _flax_mlp(3)
    result = TorchEstimator(model=tm, remat=mode, device="cpu", **KW).fit(
        TableDataset(train), TableDataset(evals))
    return result


@pytest.mark.parametrize("cache", ["1", "0"], ids=["resident", "streaming"])
def test_remat_modes_give_the_same_losses(monkeypatch, cache):
    monkeypatch.setenv("RDT_DEVICE_CACHE", cache)
    train, evals = _tables(320, 0), _tables(70, 1)
    fits = {m: _port_fit(m, train, evals) for m in ("none", "dots", "full")}
    keys = ("train_loss", "train_mae", "eval_loss", "eval_mae")
    base = fits["none"]
    for mode in ("dots", "full"):
        for key in keys:
            np.testing.assert_allclose(
                [h[key] for h in fits[mode].history],
                [h[key] for h in base.history], rtol=MODE_RTOL,
                err_msg=f"remat={mode} {key}")
        a = base.state.model.state_dict()
        b = fits[mode].state.model.state_dict()
        for name in a:
            np.testing.assert_allclose(b[name].numpy(), a[name].numpy(),
                                       rtol=MODE_RTOL, atol=1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("mode", ["none", "dots", "full"])
def test_remat_matches_flax_estimator(runtime, monkeypatch, mode):
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.runtime.object_store import get_client

    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    train, evals = _tables(320, 0), _tables(70, 1)

    def ref_ds(tables):
        return DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)

    jm, _, _ = _flax_mlp(3)
    ref = FlaxEstimator(model=jm, optimizer=optax.adam(1e-3), remat=mode,
                        **KW).fit(ref_ds(train), ref_ds(evals))
    got = _port_fit(mode, train, evals)
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose([h[key] for h in got.history],
                                   [h[key] for h in ref.history],
                                   rtol=EPOCH_RTOL, err_msg=key)


def test_remat_knob_is_read_when_the_argument_is_none(monkeypatch):
    _, _, tm = _flax_mlp(3)
    est = TorchEstimator(model=tm, device="cpu", **KW)
    monkeypatch.setenv("RDT_TRAIN_REMAT", "full")
    assert est._resolve_remat() == {"default": "full"}
    monkeypatch.setenv("RDT_TRAIN_REMAT", "Embedding=None,kernel=dots")
    assert est._resolve_remat() == {"embedding": "none", "kernel": "dots",
                                    "default": "none"}
    assert est._make_forward(tm)[2] == "dots"
    # the argument wins over the knob
    est.remat = "none"
    assert est._resolve_remat() == {"default": "none"}
    # a bad policy fails before any step
    est.remat = None
    monkeypatch.setenv("RDT_TRAIN_REMAT", "kernel=huge")
    with pytest.raises(ValueError, match="unknown remat mode 'huge'"):
        est.fit(TableDataset(_tables(64, 0)))
    assert est._result is None
