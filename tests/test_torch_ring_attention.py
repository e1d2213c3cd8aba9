"""The port's ring attention (``raydp_tpu_torch.ops.ring_attention``) against
the reference's, on the CPU: the counterparts of
``tests/test_ring_attention.py``'s five tests (nine cases).

The reference runs ``ring_attention_sharded`` in this process on its
8-device CPU mesh (``data=2 × seq=4``, or ``seq=8`` where its test does);
the port's four ranks (gloo, one spawned world shared by every case) each
pass their block of the sequence on ``seq=4`` — a world has at most four
processes here, so ``test_ring_full_seq8`` runs at ``seq=4``. Every case
holds the output AND the q/k/v gradients of ``sum(out ** 2)``, the ranks'
blocks concatenated along the sequence, against the reference's. The
causal cases run the causal skip: at ``seq=4`` rank ``i`` folds ``i + 1``
of the four blocks and skips the rest, in both rings.

Tolerances are the reference tests' own: outputs within 2e-5 (atol and
rtol), gradients within 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

OUT_TOL = 2e-5              # test_ring_attention.py's output tolerance
GRAD_TOL = 5e-4             # ... and its gradient tolerance
SEQ = 4                     # the port's seq ranks

#: case id -> (qkv shape (b, t, h, d), seed, causal, chunk_size, the
#: reference's mesh)
CASES = {
    "seq4-causal": ((2, 64, 4, 8), 0, True, 2048, dict(data=2, seq=4)),
    "seq4-full": ((2, 64, 4, 8), 0, False, 2048, dict(data=2, seq=4)),
    "full-seq8": ((1, 128, 2, 16), 3, True, 2048, dict(data=1, seq=8)),
    "chunk4-causal": ((2, 64, 2, 16), 7, True, 4, dict(data=2, seq=4)),
    "chunk5-causal": ((2, 64, 2, 16), 7, True, 5, dict(data=2, seq=4)),
    "chunk4-full": ((2, 64, 2, 16), 7, False, 4, dict(data=2, seq=4)),
    "chunk5-full": ((2, 64, 2, 16), 7, False, 5, dict(data=2, seq=4)),
    "chunked-grad": ((2, 32, 2, 8), 9, True, 4, dict(data=2, seq=4)),
    "grad-flows": ((1, 64, 2, 8), 0, True, 2048, dict(data=1, seq=8)),
}


def _qkv(b, t, h, d, seed):
    """The reference test's inputs: q, k, v drawn in that order."""
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _ring_rank(ctx, cases=CASES):
    """Every case on one rank of the seq=4 world: its block of the output
    and of the q/k/v gradients."""
    import torch

    from raydp_tpu_torch.ops import ring_attention
    from raydp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dict(seq=SEQ), device_type="cpu")
    out = {}
    for name, (shape, seed, causal, chunk, _) in cases.items():
        per = shape[1] // SEQ
        block = slice(ctx.rank * per, (ctx.rank + 1) * per)
        q, k, v = (torch.tensor(a[:, block]).requires_grad_(True)
                   for a in _qkv(*shape, seed))
        o = ring_attention(q, k, v, mesh, causal=causal, chunk_size=chunk)
        (o ** 2).sum().backward()
        out[name] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    return out


@pytest.fixture(scope="module")
def port_blocks():
    """The port's output and gradients of every case, the four ranks'
    blocks concatenated along the sequence (one spawned world)."""
    from raydp_tpu_torch.spmd import create_spmd_job

    job = create_spmd_job("t-ring", SEQ, torch_distributed=True, timeout=120)
    job.start()
    try:
        ranks = job.run(_ring_rank, timeout=600)
    finally:
        job.stop()
    return {name: [np.concatenate([r[name][i] for r in ranks], axis=1)
                   for i in range(4)] for name in CASES}


def _reference(name):
    """The reference's ring output and q/k/v gradients of ``sum(out**2)``."""
    from raydp_tpu.ops.ring_attention import ring_attention_sharded
    from raydp_tpu.parallel import MeshSpec, make_mesh

    shape, seed, causal, chunk, spec = CASES[name]
    mesh = make_mesh(MeshSpec(**spec))
    q, k, v = (jnp.asarray(a) for a in _qkv(*shape, seed))

    def loss(q, k, v):
        out = ring_attention_sharded(q, k, v, mesh, causal=causal,
                                     chunk_size=chunk)
        return jnp.sum(out ** 2), out

    # one compiled program for the output and the gradients
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _check(port_blocks, name):
    got = port_blocks[name]
    want = _reference(name)
    np.testing.assert_allclose(got[0], want[0], atol=OUT_TOL, rtol=OUT_TOL,
                               err_msg=f"{name}: out")
    for label, g, w in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"{name}: d{label}")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_dense_seq4(port_blocks, causal):
    _check(port_blocks, "seq4-causal" if causal else "seq4-full")


def test_ring_full_seq8(port_blocks):
    """The reference's seq=8 case, at seq=4 in the port."""
    _check(port_blocks, "full-seq8")


@pytest.mark.parametrize("chunk", [4, 5])      # 5 does not divide 16: ragged
@pytest.mark.parametrize("causal", [True, False])
def test_ring_chunked_matches_dense(port_blocks, causal, chunk):
    """chunk_size below the 16-row block: the CPU fold walks the keys a few
    at a time, a ragged (padded and masked) final chunk included, with the
    causal skip."""
    _check(port_blocks, f"chunk{chunk}-{'causal' if causal else 'full'}")


def test_ring_chunked_grad_matches_dense(port_blocks):
    _check(port_blocks, "chunked-grad")


def test_ring_grad_flows(port_blocks):
    _check(port_blocks, "grad-flows")
