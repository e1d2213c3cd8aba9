"""Port parity: raydp_tpu_torch flash attention (CPU path) vs the JAX reference.

The port's CPU path is the plain PyTorch forward (``_fwd_plain``) and
backward (``_bwd_plain``); the JAX side runs its jnp path and its Pallas
kernels in interpret mode, as tests/test_transformer.py does. Inputs are made
with numpy from a seed and handed to both. Tolerances: f32 outputs atol 2e-5
(f32 sums in another order); lse atol 1e-5 (a log of an f32 sum of O(T)
terms); f32 gradients atol 1e-4, as the reference's own gradient tests; bf16
gradients one bf16 step (see ``_assert_within_bf16_step``).
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
    """On the CPU the autograd Function's backward is ``_bwd_plain``, the
    recompute from the saved (q, k, v, out, lse); gradients agree with the
    reference's custom_vjp (atol 1e-4, as the reference's own grad test)."""
    q, k, v = _qkv(2, 64, 2, 32, seed=4)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=True) ** 2)

    g_ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tfa.flash_attention(tq, tk, tv, causal=True) ** 2).sum().backward()
    for ref, got in zip(g_ref, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def _bwd_case(bh, t, d, seed, causal, dtype=torch.float32):
    """Numpy (q, k, v, out, lse, do) [BH, T, D] with out/lse from the plain
    forward, so both packages' backwards get identical residuals."""
    rng = np.random.RandomState(seed)
    q3, k3, v3, do = [torch.from_numpy((rng.randn(bh, t, d) * 0.5)
                                       .astype(np.float32)).to(dtype)
                      for _ in range(4)]
    out, lse = tfa._fwd_plain(q3, k3, v3, 1.0 / d ** 0.5, causal)
    return q3, k3, v3, out, lse, do


def _to_jax(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("blocks", [(256, 256), (64, 64), (64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_pallas_interpret_and_blockwise(causal, blocks):
    """dq, dk, dv of ``_bwd_plain`` against the reference's Pallas dk/dv and
    dq kernels (interpret mode) and its ``_bwd_blockwise``, on the blocks of
    tests/test_transformer.py: multi-block grids up to 4 x 4, the causal
    block skip, and rectangular blk_q != blk_k. f32, atol 1e-4."""
    bq, bk = blocks
    case = _bwd_case(4, 256, 64, seed=5, causal=causal)
    q3, k3, v3, out, lse, do = case
    scale = 1.0 / 8.0
    res = tuple(map(_to_jax, (q3, k3, v3, out, lse)))
    ref_pallas = jfa._bwd_pallas(res, _to_jax(do), scale=scale, causal=causal,
                                 blk_q=bq, blk_k=bk, interpret=True)
    ref_blockwise = jfa._bwd_blockwise(res, _to_jax(do), scale=scale,
                                       causal=causal, blk_k=bk)
    got = tfa._bwd_plain(*case, scale, causal, bk)
    for g, rp, rb in zip(got, ref_pallas, ref_blockwise):
        assert g.dtype == torch.float32 and g.shape == (4, 256, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(rp), atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(rb), atol=1e-4)


@pytest.mark.parametrize("blk_k", [1024, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_ragged_matches_blockwise(causal, blk_k):
    """T = 37 (prime): one block of 37, or ``_fit_block`` halving 8 down to
    blocks of 1, as the reference's blockwise backward does. f32, atol
    1e-4."""
    case = _bwd_case(3, 37, 32, seed=6, causal=causal)
    scale = 1.0 / 32 ** 0.5
    ref = jfa._bwd_blockwise(tuple(map(_to_jax, case[:5])), _to_jax(case[5]),
                             scale=scale, causal=causal, blk_k=blk_k)
    got = tfa._bwd_plain(*case, scale, causal, blk_k)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def _assert_within_bf16_step(got, ref, bound=0.0):
    """|got - ref| <= 2^-7 (|ref| + rms(ref)) + bound elementwise: both
    sides round f32 values that differ in the last f32 bits to bf16, so at
    most one bf16 step (2^-7 of the smaller neighbour) apart; the rms term
    covers values near zero; ``bound`` adds what one side's own roundings
    inside the computation may move (``_bwd_rounding_bound``)."""
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    rms = np.sqrt(np.mean(ref ** 2))
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * (np.abs(ref) + rms)
                  + np.asarray(bound))


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_bf16_matches_blockwise(causal):
    """bf16 q/k/v/do/out: f32 math on both sides, one rounding to bf16."""
    case = _bwd_case(2, 96, 32, seed=7, causal=causal, dtype=torch.bfloat16)
    scale = 1.0 / 32 ** 0.5
    ref = jfa._bwd_blockwise(tuple(map(_to_jax, case[:5])), _to_jax(case[5]),
                             scale=scale, causal=causal, blk_k=32)
    got = tfa._bwd_plain(*case, scale, causal, 32)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        _assert_within_bf16_step(g, r)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_bf16_matches_pallas_interpret(causal):
    """bf16 through the reference's Pallas dk/dv and dq kernels (interpret
    mode, a 4 x 4 grid of 64-row blocks), which round p and ds to bf16
    before the dv, dk and dq products, as the Hopper bf16 kernels do. The
    f32-inside ``_bwd_plain`` stays within one bf16 step plus
    ``_bwd_rounding_bound`` of them, the limit chip_smoke.py holds the CUDA
    kernels to against ``_bwd_plain``. (One bf16 step alone does not hold:
    causal rows with few keys reach about twice it.)"""
    case = _bwd_case(4, 256, 64, seed=10, causal=causal, dtype=torch.bfloat16)
    q3, k3, v3, out, lse, do = case
    scale = 1.0 / 8.0
    ref = jfa._bwd_pallas(tuple(map(_to_jax, (q3, k3, v3, out, lse))),
                          _to_jax(do), scale=scale, causal=causal, blk_q=64,
                          blk_k=64, interpret=True)
    got = tfa._bwd_plain(*case, scale, causal, 64)
    bounds = tfa._bwd_rounding_bound(*case, scale, causal, 64)
    for g, r, b in zip(got, ref, bounds):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        assert b.dtype == torch.float32 and b.shape == g.shape
        _assert_within_bf16_step(g, r, b.numpy())


@pytest.mark.parametrize("t,blk_k", [(96, 1024), (96, 32), (37, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_rounding_bound_covers_rounded_p_ds(causal, t, blk_k):
    """``_bwd_rounding_bound`` against the move it bounds, computed here
    directly: the three products with p and ds rounded to bf16 minus the
    same products in f32, both summed in f64 so only the rounding of p and
    ds differs. It holds elementwise (1e-6 slack for the f32 sums of p and
    ds themselves) for any key blocking, and it is not vacuous: the largest
    move uses a visible share of it."""
    case = _bwd_case(3, t, 32, seed=11, causal=causal, dtype=torch.bfloat16)
    q3, k3, v3, out, lse, do = case
    scale = 1.0 / 32 ** 0.5
    qf, kf, vf, dof = (x.double() for x in (q3, k3, v3, do))
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v3.float())
    ds = p * (dp - (do.float() * out.float()).sum(-1)[..., None]) * scale
    moves = []
    for pp, dd in ((p, ds), (p.bfloat16().float(), ds.bfloat16().float())):
        pp, dd = pp.double(), dd.double()
        moves.append((torch.einsum("bqk,bkd->bqd", dd, kf),
                      torch.einsum("bqk,bqd->bkd", dd, qf),
                      torch.einsum("bqk,bqd->bkd", pp, dof)))
    bounds = tfa._bwd_rounding_bound(*case, scale, causal, blk_k)
    used = 0.0
    for exact, rounded, bound in zip(*moves, bounds):
        move = (rounded - exact).abs()
        assert torch.all(move <= bound.double() * (1 + 1e-6) + 1e-9)
        used = max(used, (move / (bound.double() + 1e-30)).max().item())
    assert used > 0.05


# chip_smoke.py's bf16 out limit: atol + rtol |plain| (one bf16 step)
OUT_ATOL, OUT_RTOL = 1e-5, 2.0 ** -7


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_plain_bf16_matches_pallas_interpret(causal, d):
    """bf16 through the reference's Pallas forward kernel (interpret mode,
    a 4 x 4 grid of 64-row blocks, seeded randn inputs as chip_smoke.py
    makes them), which rounds p to bf16 before p·v as the Hopper bf16
    kernel does. The f32-p ``_fwd_plain`` stays within chip_smoke.py's bf16
    out limit plus ``_fwd_rounding_bound`` of it, the limit chip_smoke.py
    holds the CUDA kernel to; lse agrees to 1e-5. (The one-step limit alone
    does not hold: at these inputs the Pallas kernel uses 45 to 89 times
    it, at outputs near zero, which have almost no relative room; with the
    bound added, at most 0.66 of the limit.)"""
    rng = np.random.RandomState(12)
    q3, k3, v3 = [torch.from_numpy(rng.randn(4, 256, d).astype(np.float32))
                  .bfloat16() for _ in range(3)]
    scale = 1.0 / d ** 0.5
    ref_out, ref_lse = jfa._fwd_pallas(
        *map(_to_jax, (q3, k3, v3)), scale=scale, causal=causal, blk_q=64,
        blk_k=64, interpret=True)
    assert ref_out.dtype == jnp.bfloat16
    out, lse = tfa._fwd_plain(q3, k3, v3, scale, causal)
    bound = tfa._fwd_rounding_bound(q3, k3, v3, scale, causal)
    assert bound.dtype == torch.float32 and bound.shape == out.shape
    ref = np.asarray(ref_out.astype(jnp.float32))
    got = out.float().numpy()
    one_step = OUT_ATOL + OUT_RTOL * np.abs(got)
    assert np.all(np.abs(ref - got) <= one_step + bound.numpy())
    assert np.max(np.abs(ref - got) / one_step) > 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5)


@pytest.mark.parametrize("t", [96, 37])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_rounding_bound_covers_rounded_p(causal, t):
    """``_fwd_rounding_bound`` against the move it bounds, computed here
    directly: a plain forward that rounds p (formed against the row max)
    to bf16 before p·v, minus the same forward in f32, both normalised by
    the l of the unrounded p and summed in f64, so only the rounding of p
    differs. It holds elementwise (1e-6 slack for the f32 sums of the
    bound itself), and it is not vacuous: the largest move uses a visible
    share of it."""
    rng = np.random.RandomState(13)
    q3, k3, v3 = [torch.from_numpy(rng.randn(3, t, 32).astype(np.float32))
                  .bfloat16() for _ in range(3)]
    scale = 1.0 / 32 ** 0.5
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.double().sum(-1, keepdim=True)
    vd = v3.double()
    exact = torch.einsum("bqk,bkd->bqd", p.double(), vd) / l
    rounded = torch.einsum("bqk,bkd->bqd", p.bfloat16().double(), vd) / l
    bound = tfa._fwd_rounding_bound(q3, k3, v3, scale, causal).double()
    move = (rounded - exact).abs()
    assert torch.all(move <= bound * (1 + 1e-6) + 1e-9)
    assert (move / (bound + 1e-30)).max().item() > 0.05


@pytest.mark.parametrize("t,block_k", [(64, 16), (37, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_through_autograd_match_jax(causal, t, block_k):
    """``flash_attention`` gradients through ``_Flash`` (the [B, T, H, D]
    layout, a strided incoming gradient, ``block_k`` passed on to the plain
    backward) against ``jax.grad`` of the reference. f32, atol 1e-4."""
    q, k, v = _qkv(2, t, 3, 16, seed=8)
    w = np.random.RandomState(9).randn(2, t, 3, 16).astype(np.float32)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_k=block_k)
        return jnp.sum(out * jnp.asarray(w))

    g_ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_k=block_k)
    (out * torch.from_numpy(w)).sum().backward()
    for ref, got in zip(g_ref, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("t,blk", [(8192, 1024), (37, 1024), (100, 64),
                                   (96, 64), (1, 8)])
def test_fit_block_matches_jax(t, blk):
    assert tfa._fit_block(t, blk) == jfa._fit_block(t, blk)


def test_kernel_inputs_are_contiguous_at_batch_one(monkeypatch):
    """The kernels read contiguous rows and refuse strided tensors: at B = 1
    the [B, T, H, D] → [BH, T, D] reshape is a strided view, so the wrapper
    must copy it. The forward and backward receive contiguous q, k, v (and
    out, do) whatever B is."""
    seen = []

    def checked(fn):
        def run(*args, **kwargs):
            seen.append(all(a.is_contiguous() for a in args
                            if isinstance(a, torch.Tensor)))
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(tfa, "_fwd", checked(tfa._fwd))
    monkeypatch.setattr(tfa, "_bwd", checked(tfa._bwd))
    for b in (1, 2):
        q, k, v = [torch.from_numpy(x).requires_grad_()
                   for x in _qkv(b, 32, 2, 16, seed=b)]
        tfa.flash_attention(q, k, v).sum().backward()
    assert seen == [True] * 4
