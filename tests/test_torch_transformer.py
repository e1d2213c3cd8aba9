"""Port parity: raydp_tpu_torch TransformerLM forward, gradients and
training vs the JAX reference.

Flax params are initialised by the reference and carried across with
``transformer_params_from_flax``; tokens are made with numpy from a seed.
Tolerances: f32 logits atol 1e-4 (two layers of f32 products summed in
another order); losses rtol 1e-5. Under bf16 the port mirrors the
reference's rounding points op for op in the forward, so bf16 results agree
to f32 noise; in the backward XLA and torch autograd round at other points
(tolerances stated per test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raydp_tpu.models import TransformerLM as JaxLM
from raydp_tpu.models import lm_loss as jax_lm_loss
from raydp_tpu.models.transformer import lm_loss_fused as jax_lm_loss_fused
from raydp_tpu.models.transformer import RMSNorm as JaxRMSNorm
from raydp_tpu_torch.models import (
    TransformerLM, lm_loss, lm_loss_fused, transformer_params_from_flax,
)
from raydp_tpu_torch.models.transformer import RMSNorm

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, t)).astype(
        np.int32)


def _pair(tokens, vocab, dim, heads, layers, attention="dense",
          dtype=torch.float32, perturb_scales=False):
    """(jax model, flax params, port model with the same weights)."""
    jm = JaxLM(vocab_size=vocab, dim=dim, num_heads=heads, num_layers=layers,
               attention=attention, dtype=JAX_DTYPE[dtype])
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    if perturb_scales:  # non-unit RMSNorm scales make the f32 promotion show
        rng = np.random.RandomState(7)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: (1 + 0.5 * rng.randn(*x.shape)).astype(np.float32)
            if "scale" in jax.tree_util.keystr(p) else x, params)
    tm = TransformerLM(vocab, dim=dim, num_heads=heads, num_layers=layers,
                       attention=attention, dtype=dtype, device="cpu")
    tm.load_state_dict(transformer_params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("attention", ["dense", "flash", "auto"])
def test_logits_match_jax_f32(attention):
    tokens = _tokens(2, 48, 64)
    jm, params, tm = _pair(tokens, 64, dim=64, heads=2, layers=2,
                           attention=attention)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.shape == (2, 48, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_losses_match_jax(attention):
    """Odd sizes (vocab 97, T 37, chunk 16) exercise the fused loss's ragged
    last chunk, as tests/test_transformer.py does for the reference."""
    vocab, t, b = 97, 37, 3
    tokens = _tokens(b, t, vocab)
    jm, params, tm = _pair(tokens, vocab, dim=32, heads=2, layers=2,
                           attention=attention)
    jt = jnp.asarray(tokens)
    ref_loss = jax_lm_loss(jm.apply({"params": params}, jt), jt)
    ref_fused = jax_lm_loss_fused(
        jm.apply({"params": params}, jt, return_hidden=True),
        jnp.asarray(params["lm_head"]["kernel"]), jt, chunk=16)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        loss = lm_loss(tm(tt), tt)
        fused = lm_loss_fused(tm(tt, return_hidden=True), tm.lm_head.kernel,
                              tt, chunk=16)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(fused), float(ref_fused), rtol=1e-5)
    np.testing.assert_allclose(float(fused), float(loss), rtol=1e-5)


def test_bf16_matches_jax_and_pins_rmsnorm_promotion():
    """bf16 activations with non-unit RMSNorm scales. The reference's RMSNorm
    rounds to bf16 and then multiplies by an f32 scale, so its output (and
    the returned hidden states) are float32; rounding that product to bf16
    instead would move hidden states by up to a bf16 step (~1e-2). Since the
    port rounds at the same points, hidden states match to 1e-5 and logits
    (bf16 head) to 1e-3."""
    vocab, t = 97, 37
    tokens = _tokens(2, t, vocab, seed=1)
    jm, params, tm = _pair(tokens, vocab, dim=64, heads=2, layers=2,
                           attention="flash", dtype=torch.bfloat16,
                           perturb_scales=True)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    ref_hidden = jm.apply({"params": params}, jt, return_hidden=True)
    ref_logits = jm.apply({"params": params}, jt)
    with torch.no_grad():
        hidden = tm(tt, return_hidden=True)
        logits = tm(tt)
    assert ref_hidden.dtype == jnp.float32 and hidden.dtype == torch.float32
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden),
                               atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-3)
    # the two losses take different heads (bf16 materialized, f32 fused);
    # each matches its reference twin
    ref_fused = jax_lm_loss_fused(ref_hidden,
                                  jnp.asarray(params["lm_head"]["kernel"]),
                                  jt, chunk=16)
    with torch.no_grad():
        fused = lm_loss_fused(hidden, tm.lm_head.kernel, tt, chunk=16)
    np.testing.assert_allclose(float(lm_loss(logits, tt)),
                               float(jax_lm_loss(ref_logits, jt)), rtol=1e-5)
    np.testing.assert_allclose(float(fused), float(ref_fused), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_output_dtype_matches_jax(dtype):
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    jx = jnp.asarray(x).astype(JAX_DTYPE[dtype])
    norm = JaxRMSNorm()
    ref = norm.apply(norm.init(jax.random.PRNGKey(0), jx), jx)
    got = RMSNorm(8, device="cpu")(torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)


def test_return_hidden_matches_jax_and_head():
    tokens = _tokens(2, 24, 64, seed=3)
    jm, params, tm = _pair(tokens, 64, dim=32, heads=2, layers=2)
    ref = jm.apply({"params": params}, jnp.asarray(tokens),
                   return_hidden=True)
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        hidden = tm(tt, return_hidden=True)
        logits = tm(tt)
        # the head applied to the hidden states is exactly the logits
        torch.testing.assert_close(tm.lm_head(hidden).float(), logits,
                                   atol=0, rtol=0)
    assert hidden.shape == (2, 24, 32)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_converter_output_is_checked_on_load(change):
    tokens = _tokens(1, 8, 64)
    _, params, tm = _pair(tokens, 64, dim=16, heads=2, layers=1)
    state = transformer_params_from_flax(params)
    assert set(state) == set(tm.state_dict())
    assert state["block_0.attn.q.kernel"].shape == (16, 2, 8)
    assert state["block_0.attn.o.kernel"].shape == (2, 8, 16)
    if change == "missing":
        del state["block_0.ln2.scale"]
    elif change == "extra":
        state["block_0.attn.q.bias"] = torch.zeros(2, 8)
    else:
        state["lm_head.kernel"] = state["lm_head.kernel"].T
    with pytest.raises(RuntimeError):
        tm.load_state_dict(state)


def test_ring_and_mesh_are_not_ported_yet():
    """The ring and the mesh are ported now (tests/test_torch_seq_sharded.py
    runs them over ranks): ``attention="ring"`` needs a mesh, a mesh that
    splits the sequence refuses the attentions that would see only the
    rank's block, and over a world-1 mesh the ring is the flash path —
    the dense logits within 1e-4 (f32 sums in another order)."""
    from raydp_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="needs the mesh"):
        TransformerLM(64, dim=16, num_heads=2, num_layers=1,
                      attention="ring", device="cpu")
    for kind in ("dense", "flash"):
        with pytest.raises(ValueError, match="'ring' or 'auto'"):
            TransformerLM(64, dim=16, num_heads=2, num_layers=1,
                          attention=kind, mesh=Mesh(dict(seq=2)),
                          device="cpu")
    tokens = torch.from_numpy(_tokens(2, 16, 64)).long()
    dense = TransformerLM(64, dim=16, num_heads=2, num_layers=1,
                          attention="dense", device="cpu")
    ring = TransformerLM(64, dim=16, num_heads=2, num_layers=1,
                         attention="ring", mesh=Mesh(dict()), device="cpu")
    ring.load_state_dict(dense.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(ring(tokens).numpy(),
                                   dense(tokens).numpy(), atol=1e-4)


def _jax_loss(jm, kind, tokens):
    """The reference's loss of ``kind`` as a function of the Flax params."""
    jt = jnp.asarray(tokens)

    def loss(p):
        if kind == "lm_loss":
            return jax_lm_loss(jm.apply({"params": p}, jt), jt)
        return jax_lm_loss_fused(
            jm.apply({"params": p}, jt, return_hidden=True),
            p["lm_head"]["kernel"], jt, chunk=16, remat=kind == "fused_remat")
    return loss


def _port_loss(tm, kind, tokens):
    tt = torch.from_numpy(tokens)
    if kind == "lm_loss":
        return lm_loss(tm(tt), tt)
    return lm_loss_fused(tm(tt, return_hidden=True), tm.lm_head.kernel, tt,
                         chunk=16, remat=kind == "fused_remat")


# Largest |port - reference| of each parameter gradient, as a share of that
# gradient's largest |element|. f32: only the order of f32 sums differs
# (measured 1.5e-6). bf16: XLA and torch autograd round the backward at other
# points (silu's derivative, the casts), one bf16 step (2^-8 .. 2^-7) on the
# largest elements (measured 1.1e-2).
GRAD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["lm_loss", "fused_remat", "fused"])
def test_param_grads_match_jax(kind, dtype):
    """Every parameter gradient of ``lm_loss`` and of ``lm_loss_fused`` with
    and without remat (vocab 97, T 37, chunk 16: a ragged last chunk) through
    flash attention, against ``jax.grad`` of the reference."""
    tokens = _tokens(3, 37, 97)
    jm, params, tm = _pair(tokens, 97, dim=32, heads=2, layers=2,
                           attention="flash", dtype=dtype)
    ref = transformer_params_from_flax(jax.grad(_jax_loss(jm, kind, tokens))(
        jax.tree.map(jnp.asarray, params)))
    _port_loss(tm, kind, tokens).backward()
    for name, p in tm.named_parameters():
        scale = ref[name].abs().max().item()
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= GRAD_REL_TOL[dtype] * scale, (name, err, scale)


# optax.adam / adamw and the torch optimizers that match them: optax's eps is
# 1e-8 as torch's, and adamw's weight decay 1e-4 (torch's default is 1e-2)
OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3),
             lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999),
                                         eps=1e-8)),
    "adamw": (lambda: optax.adamw(3e-4),
              lambda ps: torch.optim.AdamW(ps, lr=3e-4, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=1e-4)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_mapping_matches_optax(name):
    """Three updates from identical numpy gradients leave identical params,
    atol 1e-6: a few f32 ulps at |p| ~ 1, where RMSNorm scales start."""
    rng = np.random.RandomState(3)
    params = {"scale": np.ones(8, np.float32),
              "kernel": rng.randn(8, 5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -i
              for k, v in params.items()} for i in range(3)]
    make_tx, make_opt = OPTIMIZERS[name]
    tx = make_tx()
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_opt(list(tp.values()))
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["lm_loss", "fused_remat"])
def test_adam_training_trajectory_matches_jax(kind):
    """Five f32 Adam(1e-3) steps on one batch from converted weights: each
    step's loss agrees with the reference's, rtol 1e-4 (f32 gradients agree
    to ~1e-6 of their max, and Adam's normalised steps carry that along)."""
    tokens = _tokens(2, 37, 97, seed=4)
    jm, params, tm = _pair(tokens, 97, dim=32, heads=2, layers=2,
                           attention="flash")
    tx = optax.adam(1e-3)
    step_loss = jax.jit(jax.value_and_grad(_jax_loss(jm, kind, tokens)))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    opt = OPTIMIZERS["adam"][1](tm.parameters())
    for step in range(5):
        ref, grads = step_loss(jp)
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        loss = _port_loss(tm, kind, tokens)
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4,
                                   err_msg=f"step {step}")
