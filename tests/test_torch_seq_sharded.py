"""The sequence axis in the port — ring attention inside the TransformerLM,
the LM step over a sequence split, and ``seq``-sharded estimator fits —
against the reference, on the CPU.

- ``tests/test_transformer.py::test_lm_ring_matches_dense_on_mesh``: the
  full model with ring attention, the sequence over ``seq=4`` (the
  reference test's; the causal skip differs from rank to rank), against
  the reference's dense single-device logits, atol and rtol 2e-4;
- the LM step at ``seq=2`` (with ``data=2``, and with ``tensor=2`` under
  ``transformer_param_rules``) against the reference's unsharded step from
  the same Flax init: the global loss rtol 1e-5, every gradient within
  1e-5 of its array's largest magnitude (f32 round-off scales with the
  array), and the parameters after one SGD 1e-1
  step atol 2e-5 (``test_lm_tensor_parallel_matches_replicated``'s);
- ``tests/test_gang_sharded.py::test_seq_sharded_parity`` and
  ``::test_seq_sharded_with_accum_and_remat``: an MLP on ``data=2 ×
  seq=2`` — the feed splits each batch's features over ``seq``, the step
  gathers them — against the reference's single device: losses rtol 5e-4,
  predictions rtol 1e-4, atol 1e-6;
- ``tests/test_spmd.py::test_gang_ring_attention_across_processes``: ring
  attention across rank processes (``seq=2`` within each ``data`` pair)
  against dense attention, the output within 2e-5 and, beyond the
  reference test, the q/k/v gradients within 5e-4 (the ring tests').

One spawned world of four ranks (gloo) runs every port case; the
reference runs in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

VOCAB, B, T, LM_DIM, LM_HEADS, LM_LAYERS = 64, 4, 32, 32, 2, 2
LOGITS_TOL = 2e-4           # test_lm_ring_matches_dense_on_mesh's
LM_LOSS_RTOL, LM_PARAM_ATOL = 1e-5, 2e-5
LM_GRAD_TOL = 1e-5          # of each gradient's largest magnitude
LM_LR = 1e-1
LOSS_RTOL = 5e-4            # test_seq_sharded_parity's
PRED_RTOL, PRED_ATOL = 1e-4, 1e-6
RING_OUT_TOL, RING_GRAD_TOL = 2e-5, 5e-4


def _tokens():
    return np.random.RandomState(0).randint(0, VOCAB, size=(B, T)).astype(
        np.int32)


def _linear_tables(n=1536, parts=4):
    """The reference test's ``_linear_df`` rows, as ``parts`` blocks."""
    rng = np.random.RandomState(0)
    x = rng.random_sample((n, 2))
    y = x @ np.array([2.0, -3.0]) + 1.0 + rng.normal(0, 0.01, n)
    table = pa.table({"x1": x[:, 0], "x2": x[:, 1], "y": y})
    cuts = np.linspace(0, n, parts + 1).astype(int)
    return [table.slice(a, b - a) for a, b in zip(cuts[:-1], cuts[1:])]


def _mlp_kw(**extra):
    return {**dict(loss="mse", feature_columns=["x1", "x2"],
                   label_column="y", batch_size=64, num_epochs=3,
                   shuffle=False), **extra}


def _flax_mlp_variables():
    from raydp_tpu.models import MLP as JaxMLP

    return jax.tree.map(np.asarray, JaxMLP(
        features=(32, 16), use_batch_norm=False).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))


def _ring_qkv():
    """test_gang_ring_attention_across_processes's inputs at T = 16 · 4."""
    rng = np.random.RandomState(0)
    return [rng.randn(1, 64, 2, 8).astype(np.float32) for _ in range(3)]


# ---- the reference ----------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's LM (init, dense logits, the unsharded step's loss,
    gradients and updated parameters), its single-device MLP fit and
    predictions, and dense attention's output and gradients."""
    import optax

    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.models import TransformerLM as JaxLM
    from raydp_tpu.models import lm_loss as jax_lm_loss
    from raydp_tpu.ops.ring_attention import dense_attention
    from raydp_tpu.parallel import MeshSpec, make_mesh
    from raydp_tpu.runtime import init_runtime, shutdown_runtime
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    from raydp_tpu_torch.models import transformer_params_from_flax

    out = {}
    model = JaxLM(vocab_size=VOCAB, dim=LM_DIM, num_heads=LM_HEADS,
                  num_layers=LM_LAYERS, attention="dense")
    tokens = jnp.asarray(_tokens())
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    out["logits"] = np.asarray(model.apply({"params": params}, tokens))
    loss, grads = jax.value_and_grad(lambda p: jax_lm_loss(
        model.apply({"params": p}, tokens), tokens))(params)
    tx = optax.sgd(LM_LR)
    upd, _ = tx.update(grads, tx.init(params))

    def flat(tree):
        return {k: v.numpy() for k, v in transformer_params_from_flax(
            jax.tree.map(np.asarray, tree)).items()}

    out["lm"] = {"init": flat(params), "loss": float(loss),
                 "grads": flat(grads),
                 "updated": flat(optax.apply_updates(params, upd))}

    q, k, v = (jnp.asarray(a) for a in _ring_qkv())

    def attn_loss(q, k, v):
        o = dense_attention(q, k, v, causal=True)
        return jnp.sum(o ** 2), o

    (_, o), g = jax.value_and_grad(attn_loss, argnums=(0, 1, 2),
                                   has_aux=True)(q, k, v)
    out["ring"] = [np.asarray(x) for x in (o, *g)]

    init_runtime()
    try:
        tables = _linear_tables()
        ds = DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)
        est = FlaxEstimator(
            model=JaxMLP(features=(32, 16), use_batch_norm=False),
            optimizer=optax.sgd(5e-2),
            mesh=make_mesh(MeshSpec(), devices=jax.devices()[:1]),
            **_mlp_kw())
        out["mlp"] = [h["train_loss"] for h in est.fit(ds).history]
        feats = DistributedDataset(
            [BlockMeta(num_rows=t.num_rows,
                       ref=get_client().put_arrow(t.select(["x1", "x2"])))
             for t in tables], tables[0].select(["x1", "x2"]).schema)
        out["predict"] = np.asarray(est.predict(feats))
    finally:
        shutdown_runtime()
    return out


# ---- the port's world -------------------------------------------------------

def _lm_step(mesh, init, rules=None):
    """One SGD step of the port's TransformerLM on the rank's block of the
    tokens: the global loss, the gradients and the updated parameters,
    gathered whole."""
    from raydp_tpu_torch.models import TransformerLM, lm_loss
    from raydp_tpu_torch.parallel import ShardedModule

    lm = TransformerLM(VOCAB, dim=LM_DIM, num_heads=LM_HEADS,
                       num_layers=LM_LAYERS, mesh=mesh, device="cpu")
    lm.load_state_dict({k: torch.tensor(v) for k, v in init.items()})
    sm = ShardedModule(lm, mesh, rules)
    rows = B // mesh.shape["data"]
    cols = T // mesh.shape["seq"]
    r, c = mesh.coords["data"], mesh.coords["seq"]
    tok = torch.tensor(_tokens()[r * rows:(r + 1) * rows,
                                 c * cols:(c + 1) * cols]).long()
    opt = torch.optim.SGD(sm.parameters(), lr=LM_LR)
    loss = lm_loss(sm(tok), tok, mesh)
    loss.backward()
    sm.reduce_grads()
    grads = sm.gather_state({"model": {
        n: p.grad for n, p in sm.module.named_parameters()}})["model"]
    opt.step()
    whole = sm.gather_state({"model": sm.state_dict()})["model"]
    return {"loss": loss.item(),
            "grads": {n: g.numpy() for n, g in grads.items()},
            "updated": {n: t.numpy() for n, t in whole.items()}}


def _seq_rank(ctx, init):
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.models import (
        MLP, TransformerLM, mlp_variables_from_flax, transformer_param_rules,
    )
    from raydp_tpu_torch.ops import ring_attention
    from raydp_tpu_torch.parallel import make_mesh
    from raydp_tpu_torch.train import TorchEstimator

    torch.set_num_threads(2)
    out = {}
    seq4 = make_mesh(dict(seq=4), device_type="cpu")
    lm = TransformerLM(VOCAB, dim=LM_DIM, num_heads=LM_HEADS,
                       num_layers=LM_LAYERS, mesh=seq4, device="cpu")
    lm.load_state_dict({k: torch.tensor(v) for k, v in init.items()})
    per = T // 4
    with torch.no_grad():
        out["logits"] = lm(torch.tensor(
            _tokens()[:, ctx.rank * per:(ctx.rank + 1) * per]).long()
        ).numpy()

    dp_seq = make_mesh(dict(data=2, seq=2), device_type="cpu")
    out["lm data×seq"] = _lm_step(dp_seq, init)
    out["lm seq×tensor"] = _lm_step(
        make_mesh(dict(seq=2, tensor=2), device_type="cpu"), init,
        transformer_param_rules("tensor"))

    # ring attention across the processes: seq=2 within each data pair
    c = dp_seq.coords["seq"]
    q, k, v = (torch.tensor(a[:, c * 32:(c + 1) * 32]).requires_grad_(True)
               for a in _ring_qkv())
    o = ring_attention(q, k, v, dp_seq, causal=True)
    (o ** 2).sum().backward()
    out["ring"] = {"seq": c, "blocks": [
        t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]}

    variables = _flax_mlp_variables()
    ds = TableDataset(_linear_tables())
    feats = TableDataset([t.select(["x1", "x2"]) for t in _linear_tables()])

    def fit(**extra):
        model = MLP(2, (32, 16), use_batch_norm=False, device="cpu")
        model.load_state_dict(mlp_variables_from_flax(variables))
        est = TorchEstimator(
            model=model, optimizer=lambda p: torch.optim.SGD(p, lr=5e-2),
            device="cpu", feature_dtype=np.float32,
            mesh=make_mesh(dict(data=2, seq=2), device_type="cpu"),
            **_mlp_kw(**extra))
        return est, [h["train_loss"] for h in est.fit(ds).history]

    est, out["mlp"] = fit()
    out["predict"] = est.predict(feats)
    _, out["mlp accum remat"] = fit(accum_steps=4, remat="full")
    return out


@pytest.fixture(scope="module")
def port_world(reference):
    from raydp_tpu_torch.spmd import create_spmd_job

    init = reference["lm"]["init"]
    job = create_spmd_job("t-seq", 4, torch_distributed=True, timeout=120)
    job.start()
    try:
        return job.run(lambda ctx: _seq_rank(ctx, init), timeout=600)
    finally:
        job.stop()


def _scaled(got, want, tol, what):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# ---- the tests --------------------------------------------------------------

def test_lm_ring_matches_dense_on_mesh(reference, port_world):
    """The full model over seq=4: RoPE's global positions, the ring, every
    rank's block of the logits equal to the dense single-device model's."""
    got = np.concatenate([r["logits"] for r in port_world], axis=1)
    np.testing.assert_allclose(got, reference["logits"], atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


@pytest.mark.parametrize("case", ["lm data×seq", "lm seq×tensor"])
def test_lm_step_gradients_match_the_unsharded_step(reference, port_world,
                                                    case):
    """One step at seq=2: the loss is global (the next rank's first token
    as the last position's target, the mean over B·(T−1)), and every
    gradient — replicated parameters summed over seq (and data), tensor
    splits their own heads' — is the unsharded step's."""
    want = reference["lm"]
    for r in port_world:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LM_LOSS_RTOL)
        assert set(got["grads"]) == set(want["grads"])
        for name, w in want["grads"].items():
            _scaled(got["grads"][name], w, LM_GRAD_TOL, f"{case}: {name}")
        for name, w in want["updated"].items():
            np.testing.assert_allclose(got["updated"][name], w,
                                       atol=LM_PARAM_ATOL,
                                       err_msg=f"{case}: {name}")


def test_seq_sharded_parity(reference, port_world):
    """data=2 × seq=2: the feature dim split over seq on top of the batch
    dim is a pure layout change — the reference's single-device losses and
    per-row predictions."""
    for r in port_world:
        np.testing.assert_allclose(r["mlp"], reference["mlp"],
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(port_world[0]["predict"],
                               reference["predict"], rtol=PRED_RTOL,
                               atol=PRED_ATOL)


def test_seq_sharded_with_accum_and_remat(reference, port_world):
    """accum=4 × remat=full × data=2/seq=2 still lands the single-device
    trajectory."""
    for r in port_world:
        np.testing.assert_allclose(r["mlp accum remat"], reference["mlp"],
                                   rtol=LOSS_RTOL)


def test_gang_ring_attention_across_processes(reference, port_world):
    """Ring attention rotating K/V between rank processes (seq=2 within
    each data pair) equals dense attention on every rank, and so do its
    q/k/v gradients."""
    want = reference["ring"]
    for r in port_world:
        c = r["ring"]["seq"]
        block = slice(c * 32, (c + 1) * 32)
        got = r["ring"]["blocks"]
        assert float(np.abs(got[0] - want[0][:, block]).max()) \
            < RING_OUT_TOL
        for label, g, w in zip("qkv", got[1:], want[1:]):
            np.testing.assert_allclose(g, w[:, block], atol=RING_GRAD_TOL,
                                       rtol=RING_GRAD_TOL, err_msg=label)
