"""Port parity: raydp_tpu_torch MLP / NYCTaxiModel (with Flax BatchNorm) vs
the JAX reference.

Flax variables are initialised by the reference and carried across with
``mlp_variables_from_flax``; inputs are made with numpy from a seed.
Tolerances: f32 outputs and BatchNorm statistics atol 1e-5 (f32 products and
batch means summed in another order); bf16 outputs within twice bf16's own
error (the largest |Flax bf16 − Flax f32| of the same call): both sides
round at the same points, so a difference is an f32 sum that lands on the
other side of a bf16 rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models import MLP as JaxMLP
from raydp_tpu.models import NYCTaxiModel as JaxNYC
from raydp_tpu_torch.models import MLP, NYCTaxiModel, mlp_variables_from_flax
from raydp_tpu_torch.models.layers import BatchNorm

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
F32_ATOL = 1e-5


def _inputs(rows=96, width=7, seed=0):
    # mixed scales, like raw tabular features
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, width) * np.linspace(0.5, 4.0, width)
            + np.linspace(-2.0, 3.0, width)).astype(np.float32)


def _pair(x, dtype=torch.float32, use_batch_norm=True, nyc=True):
    jdt = None if dtype == torch.float32 else JAX_DTYPE[dtype]
    tdt = None if dtype == torch.float32 else dtype
    if nyc:
        jm = JaxNYC(dtype=jdt, use_batch_norm=use_batch_norm)
        tm = NYCTaxiModel(x.shape[1], dtype=tdt,
                          use_batch_norm=use_batch_norm, device="cpu")
    else:
        jm = JaxMLP(features=(32, 8), out_features=3,
                    use_batch_norm=use_batch_norm, dtype=jdt)
        tm = MLP(x.shape[1], (32, 8), out_features=3,
                 use_batch_norm=use_batch_norm, dtype=tdt, device="cpu")
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return jm, variables, tm


def _flax_train_eval(jm, variables, x):
    """(train-mode output, updated batch_stats, eval-mode output with them)."""
    jx = jnp.asarray(x)
    if "batch_stats" not in variables:
        out = jm.apply(variables, jx, train=True)
        return np.asarray(out), None, np.asarray(jm.apply(variables, jx))
    out, upd = jm.apply(variables, jx, train=True, mutable=["batch_stats"])
    stats = jax.tree.map(np.asarray, upd["batch_stats"])
    ev = jm.apply({"params": variables["params"], "batch_stats": stats}, jx,
                  train=False)
    return np.asarray(out), stats, np.asarray(ev)


def _port_train_eval(tm, x):
    tx = torch.from_numpy(x)
    with torch.no_grad():
        out = tm.train()(tx).numpy()
        ev = tm.eval()(tx).numpy()
    return out, tm.state_dict(), ev


@pytest.mark.parametrize("nyc", [True, False], ids=["NYCTaxiModel", "MLP"])
@pytest.mark.parametrize("use_batch_norm", [True, False],
                         ids=["bn", "no_bn"])
def test_f32_train_eval_and_stats_match_flax(nyc, use_batch_norm):
    x = _inputs()
    jm, variables, tm = _pair(x, use_batch_norm=use_batch_norm, nyc=nyc)
    ref_out, ref_stats, ref_eval = _flax_train_eval(jm, variables, x)
    out, state, ev = _port_train_eval(tm, x)
    assert out.dtype == np.float32 and out.shape == ref_out.shape
    np.testing.assert_allclose(out, ref_out, atol=F32_ATOL)
    np.testing.assert_allclose(ev, ref_eval, atol=F32_ATOL)
    if use_batch_norm:
        for name, leaves in ref_stats.items():
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(state[f"{name}.{leaf}"].numpy(),
                                           leaves[leaf], atol=F32_ATOL)
    else:
        assert not any("BatchNorm" in k for k in state)


def test_bf16_matches_flax_within_twice_its_own_error():
    x = _inputs(seed=1)
    jm16, v16, tm16 = _pair(x, torch.bfloat16)
    jm32, v32, _ = _pair(x)
    ref16 = _flax_train_eval(jm16, v16, x)
    ref32 = _flax_train_eval(jm32, v32, x)
    got = _port_train_eval(tm16, x)
    for i in (0, 2):            # train-mode and eval-mode outputs
        own = np.abs(ref16[i] - ref32[i]).max()
        assert own > 0          # bf16 rounding is visible at these widths
        assert np.abs(got[i] - ref16[i]).max() <= 2 * own
    for name, leaves in ref16[1].items():  # statistics are f32 reductions
        for leaf in ("mean", "var"):
            own = np.abs(leaves[leaf] - ref32[1][name][leaf]).max()
            np.testing.assert_allclose(got[1][f"{name}.{leaf}"].numpy(),
                                       leaves[leaf], atol=max(2 * own, 1e-5))


def test_batchnorm_keeps_biased_variance_and_momentum_099():
    """One train-mode call from the initial statistics (mean 0, var 1):
    Flax stores 0.99·old + 0.01·batch, with the BIASED batch variance;
    torch.nn.BatchNorm1d would store 0.9·old + 0.1·batch with the unbiased
    one (both differ well past f32 noise at 8 rows)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(8, 5) * 2 + 1).astype(np.float32)
    bn = BatchNorm(5, None, torch.device("cpu")).train()
    with torch.no_grad():
        bn(torch.from_numpy(x))
    mean, var = x.mean(0), x.var(0)          # numpy's var is the biased one
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * mean, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * var, atol=1e-6)
    torch_bn = torch.nn.BatchNorm1d(5).train()
    with torch.no_grad():
        torch_bn(torch.from_numpy(x))
    assert np.abs(torch_bn.running_var.numpy() - bn.var.numpy()).min() > 1e-2
    # and the same as Flax's own BatchNorm
    import flax.linen as nn
    fbn = nn.BatchNorm(use_running_average=False)
    fv = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = fbn.apply(fv, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6)


def test_state_dict_names_and_default_init_follow_flax():
    """The port's own init: Flax's names and shapes (strict load of a Flax
    init), truncated lecun-normal kernels (std 1/sqrt(fan_in), cut at two
    of their std), zero biases, unit BatchNorm scales and variances."""
    x = _inputs(rows=4, width=25)
    _, variables, _ = _pair(x)
    tm = NYCTaxiModel(25, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    ref = mlp_variables_from_flax(variables)
    state = tm.state_dict()
    assert sorted(state) == sorted(ref)
    assert all(state[k].shape == ref[k].shape for k in ref)
    k = state["Dense_0.kernel"]   # [25, 256]
    std = 1.0 / np.sqrt(25)
    assert abs(k.std().item() - std) < 0.1 * std
    assert k.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    for name, t in state.items():
        if name.endswith("bias") or name.endswith(".mean"):
            assert not t.any(), name
        if name.endswith(("scale", ".var")):
            assert bool((t == 1).all()), name
