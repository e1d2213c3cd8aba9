"""Port parity: raydp_tpu_torch DLRM vs the JAX reference.

Flax params are initialised by the reference and carried across with
``dlrm_params_from_flax``; dense features and categorical ids are made with
numpy from a seed. Tolerances: f32 logits and interaction outputs atol 1e-5
and every parameter gradient of the mean BCE-with-logits loss atol 1e-6
(f32 products summed in another order; gradients are O(1e-2)); bf16 logits
within twice bf16's own error (|Flax bf16 − Flax f32|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models import DLRM as JaxDLRM
from raydp_tpu.models import criteo_batch_preprocessor as jax_prep
from raydp_tpu.models.dlrm import DotInteraction as JaxDot
from raydp_tpu_torch.models import (
    DLRM, criteo_batch_preprocessor, dlrm_params_from_flax,
)
from raydp_tpu_torch.models.dlrm import DotInteraction

SIZES = (11, 7, 5, 13)
WIDTHS = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 16, 1))


def _batch(rows=24, seed=0):
    rng = np.random.RandomState(seed)
    dense = np.log1p(rng.poisson(8, size=(rows, 13))).astype(np.float32)
    sparse = np.stack([rng.randint(0, s, rows) for s in SIZES], 1)
    label = (rng.random_sample(rows) < 0.25).astype(np.float32)
    return dense, sparse.astype(np.int32), label


def _pair(dense, sparse, dtype=None):
    jm = JaxDLRM(categorical_sizes=SIZES, dtype=dtype and jnp.bfloat16,
                 **WIDTHS)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0),
        {"dense": jnp.asarray(dense), "sparse": jnp.asarray(sparse)}
    )["params"])
    tm = DLRM(SIZES, dtype=dtype, device="cpu", **WIDTHS)
    tm.load_state_dict(dlrm_params_from_flax(params))
    return jm, params, tm


def _port_inputs(dense, sparse):
    return {"dense": torch.from_numpy(dense),
            "sparse": torch.from_numpy(sparse).long()}


def test_dot_interaction_matches_flax():
    rng = np.random.RandomState(1)
    vectors = rng.randn(6, 5, 4).astype(np.float32)
    bottom = vectors[:, 0]
    ref = JaxDot().apply({}, jnp.asarray(vectors), jnp.asarray(bottom))
    got = DotInteraction(5, device="cpu")(torch.from_numpy(vectors),
                                          torch.from_numpy(bottom))
    # bottom (4) + 5·4/2 pairs + one zero pad column
    assert got.shape == (6, 4 + 10 + 1)
    assert not got[:, -1].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_logits_match_jax(dtype):
    dense, sparse, _ = _batch()
    jm, params, tm = _pair(dense, sparse, dtype)
    inputs = {"dense": jnp.asarray(dense), "sparse": jnp.asarray(sparse)}
    ref = np.asarray(jm.apply({"params": params}, inputs))
    with torch.no_grad():
        got = tm(_port_inputs(dense, sparse)).numpy()
    assert got.shape == (24, 1) and got.dtype == np.float32
    if dtype is None:
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        jm32, _, _ = _pair(dense, sparse)
        own = np.abs(ref - np.asarray(jm32.apply({"params": params},
                                                 inputs))).max()
        assert 0 < own and np.abs(got - ref).max() <= 2 * own


def test_every_parameter_gradient_matches_jax():
    dense, sparse, label = _batch(seed=2)
    jm, params, tm = _pair(dense, sparse)
    inputs = {"dense": jnp.asarray(dense), "sparse": jnp.asarray(sparse)}

    def jloss(p):
        z = jm.apply({"params": p}, inputs)[:, 0]
        return jnp.mean(jnp.clip(z, 0) - z * label
                        + jnp.log1p(jnp.exp(-jnp.abs(z))))

    ref = dlrm_params_from_flax(jax.tree.map(np.asarray,
                                             jax.grad(jloss)(params)))
    z = tm(_port_inputs(dense, sparse))[:, 0]
    torch.nn.functional.binary_cross_entropy_with_logits(
        z, torch.from_numpy(label)).backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(grads) == sorted(ref)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=1e-6,
                                   err_msg=k)
    # every table received a gradient on exactly the rows it looked up
    for i in range(len(SIZES)):
        rows = grads[f"embedding_{i}.embedding"].abs().sum(1) > 0
        assert set(np.flatnonzero(rows.numpy())) == set(sparse[:, i])


def test_criteo_batch_preprocessor_matches_jax():
    """The estimator's flat float64 feature batch (13 dense columns, then
    the categorical ids) splits into f32 dense and integer ids, as the
    reference's does."""
    dense, sparse, label = _batch(rows=10, seed=3)
    feats = np.concatenate([dense, sparse], axis=1).astype(np.float64)
    ref_in, ref_label = jax_prep(13)({"features": jnp.asarray(feats),
                                      "label": jnp.asarray(label)})
    got_in, got_label = criteo_batch_preprocessor(13)(
        {"features": torch.from_numpy(feats),
         "label": torch.from_numpy(label)})
    assert got_in["dense"].dtype == torch.float32
    assert got_in["sparse"].dtype == torch.int64
    np.testing.assert_array_equal(got_in["dense"].numpy(),
                                  np.asarray(ref_in["dense"]))
    np.testing.assert_array_equal(got_in["sparse"].numpy(),
                                  np.asarray(ref_in["sparse"]))
    np.testing.assert_array_equal(got_label.numpy(), np.asarray(ref_label))


def test_bottom_width_must_equal_embedding_dim():
    with pytest.raises(ValueError, match="embedding_dim"):
        DLRM(SIZES, embedding_dim=8, bottom_mlp=(16, 4), device="cpu")
