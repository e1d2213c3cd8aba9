"""Port parity: raydp_tpu_torch flash attention (CPU path) vs the JAX reference.

The port's CPU path is the plain PyTorch forward (``_fwd_plain``); the JAX
side runs its jnp path and its Pallas forward kernel in interpret mode, as
tests/test_transformer.py does. Inputs are made with numpy from a seed and
handed to both. Tolerances: f32 outputs atol 2e-5 (f32 sums in another
order); lse atol 1e-5 (a log of an f32 sum of O(T) terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.ops import flash_attention as jfa
from raydp_tpu.ops.ring_attention import dense_attention as jdense
from raydp_tpu_torch.ops import flash_attention as tfa
from raydp_tpu_torch.ops.ring_attention import dense_attention

CASES = [(causal, t, d) for causal in (True, False) for t in (64, 256, 37)
         for d in (32, 64)]


def _qkv(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, t, h, d) * 0.3).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal,t,d", CASES)
def test_flash_attention_matches_jax(causal, t, d):
    q, k, v = _qkv(2, t, 2, d)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert got.shape == (2, t, 2, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("causal,t,d", CASES)
def test_flash_fwd_out_and_lse_match_pallas_interpret(causal, t, d):
    """out and lse against the Pallas forward kernel itself (interpret mode),
    on a multi-block grid where T allows (blocks of 64 → up to 4 x 4)."""
    rng = np.random.RandomState(1)
    q3, k3, v3 = [(rng.randn(4, t, d) * 0.3).astype(np.float32)
                  for _ in range(3)]
    scale = 1.0 / d ** 0.5
    blk = jfa._fit_block(t, 64)
    ref_out, ref_lse = jfa._fwd_pallas(
        *map(jnp.asarray, (q3, k3, v3)), scale=scale, causal=causal,
        blk_q=blk, blk_k=blk, interpret=True)
    out, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q3, k3, v3)),
                                       causal=causal)
    assert lse.shape == (4, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_jax(causal):
    """bf16 in, bf16 out, f32 inside on both sides: the outputs round the
    same f32 values, so they agree to one bf16 rounding step (atol 1e-2 at
    |out| < 1)."""
    q, k, v = _qkv(2, 96, 2, 32, seed=2)
    ref = jfa.flash_attention(*(jnp.asarray(x).astype(jnp.bfloat16)
                                for x in (q, k, v)), causal=causal)
    got = tfa.flash_attention(*(torch.from_numpy(x).bfloat16()
                                for x in (q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(2, 37, 2, 16, seed=3)
    ref = jdense(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = dense_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_flash_cpu_grads_match_jax():
    """On the CPU the autograd Function's backward differentiates the plain
    forward; gradients agree with the reference's custom_vjp (atol 1e-4, as
    the reference's own grad test)."""
    q, k, v = _qkv(2, 64, 2, 32, seed=4)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=True) ** 2)

    g_ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tfa.flash_attention(tq, tk, tv, causal=True) ** 2).sum().backward()
    for ref, got in zip(g_ref, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("t,blk", [(8192, 1024), (37, 1024), (100, 64),
                                   (96, 64), (1, 8)])
def test_fit_block_matches_jax(t, blk):
    assert tfa._fit_block(t, blk) == jfa._fit_block(t, blk)
