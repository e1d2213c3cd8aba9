"""The port's GPipe schedule (``raydp_tpu_torch.parallel.pipeline``) against
the reference's, on the CPU: the counterparts of ``tests/test_pipeline.py``'s
seven tests, and the gradients of a whole ``PipelineModel`` (embed, stage
stack, head) through the schedule.

The reference runs ``pipeline_apply`` in this process on its 8-device CPU
mesh; the port's four ranks (gloo, one spawned world shared by every case)
run the same inputs, made from the reference test's seeds. A world has at
most four processes here, so the pp × dp case runs at ``stage=2 × data=2``
(the reference's too, on four of its devices) and the transformer-block
case at ``stage=2 × data=2`` against the reference's ``stage=2`` on eight
devices. Every case holds the outputs AND the gradients of
``sum(out ** 2)`` — each stage's layers on their stage, and the input —
against the reference's ``jax.grad``.

Each case is held twice. The pipelined run against the port's own
sequential application of the same layers, at the reference tests'
tolerances: outputs within 1e-6 (the transformer blocks within 2e-5), the
stages' gradients within 1e-5 — the schedule must not change the math. And
the port against the reference, each array's largest difference within
``PARITY_TOL`` = 1e-5 of its largest magnitude: the two libraries sum their
f32 products in different orders, and that round-off scales with the array
(measured at 2.2e-6 of it at most, in the 8-layer gradients; elementwise,
gradients near zero differ by more than their own size). The transformer
blocks' gradients, which the reference test does not hold, are held to the
port's sequential application within 2e-5 (the blocks' output tolerance)
of each array's largest magnitude — splitting the rows over ``data`` sums
them in another order, and these gradients reach 5e2 — and the
``PipelineModel``'s gradients to the reference's within 1e-5 (the gradient
test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

N_STAGES = 4
N_MICRO = 6
MB, DIM = 4, 16
OUT_TOL = 1e-6              # test_pipeline.py's output tolerance
GRAD_TOL = 1e-5             # ... and its gradient tolerance
BLOCK_TOL = 2e-5            # test_pipeline_transformer_blocks' tolerance
PARITY_TOL = 1e-5           # the port against the reference (docstring)


def _stage_params(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 0.5, (DIM, DIM)).astype(np.float32),
            "b": rng.normal(0, 0.1, (DIM,)).astype(np.float32)}


def _stacked(n_layers):
    return {k: np.stack([_stage_params(i)[k] for i in range(n_layers)])
            for k in ("w", "b")}


def _x_micro():
    rng = np.random.RandomState(42)
    return rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32)


def _ref_stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _port_stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


# ---- the blocks of the transformer case -------------------------------------

BLK_DIM, BLK_HEADS, BLK_T, BLK_MB, BLK_MICRO, BLK_STAGES = 32, 2, 16, 2, 3, 2


def _block_case():
    """The reference test's blocks and inputs: Flax params of each stage's
    Block and x_micro [3, 2, 16, 32]."""
    from raydp_tpu.models.transformer import Block

    block = Block(num_heads=BLK_HEADS, attention="dense")
    rng = np.random.RandomState(0)
    x = (rng.normal(size=(BLK_MICRO, BLK_MB, BLK_T, BLK_DIM)) * 0.3
         ).astype(np.float32)
    trees = [jax.tree.map(np.asarray, block.init(
        jax.random.PRNGKey(i), jnp.asarray(x[0]))["params"])
        for i in range(BLK_STAGES)]
    return block, trees, x


# ---- the PipelineModel case -------------------------------------------------

PM_DIM, PM_LAYERS, PM_ROWS, PM_MICRO = 8, 4, 16, 4


def _pm_reference():
    """The reference PipelineModel (embed Dense, four residual tanh blocks,
    head Dense) and its Flax params, inputs and labels."""
    import flax.linen as nn

    from raydp_tpu.train import PipelineModel as RefPipelineModel

    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            return x + nn.tanh(nn.Dense(PM_DIM)(x))

    model = RefPipelineModel(layers=[Block() for _ in range(PM_LAYERS)],
                             embed=nn.Dense(PM_DIM), head=nn.Dense(1))
    rng = np.random.RandomState(5)
    x = rng.normal(size=(PM_ROWS, 3)).astype(np.float32)
    y = rng.normal(size=(PM_ROWS, 1)).astype(np.float32)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    return model, params, x, y


def _pm_port(params):
    """The port's PipelineModel with the reference's params."""
    from raydp_tpu_torch.models import pipeline_params_from_flax
    from raydp_tpu_torch.models.layers import _Dense
    from raydp_tpu_torch.train import PipelineModel

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = _Dense((PM_DIM,), (PM_DIM,), None,
                                  torch.device("cpu"), use_bias=True)

        def forward(self, x):
            return x + torch.tanh(self.Dense_0(x))

    cpu = torch.device("cpu")
    model = PipelineModel([Block() for _ in range(PM_LAYERS)],
                          embed=_Dense((3,), (PM_DIM,), None, cpu,
                                       use_bias=True),
                          head=_Dense((PM_DIM,), (1,), None, cpu,
                                      use_bias=True))
    model.load_state_dict(pipeline_params_from_flax(params))
    return model


# ---- the port's world -------------------------------------------------------

def _run_case(fn, stacked, x, mesh):
    """Outputs, input gradient and this rank's stage gradients of
    ``sum(pipeline_apply(...) ** 2)``."""
    from raydp_tpu_torch.parallel import pipeline_apply

    params = {k: torch.tensor(v).requires_grad_(True)
              for k, v in stacked.items()}
    xt = torch.tensor(x).requires_grad_(True)
    out = pipeline_apply(fn, params, xt, mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "grads": {k: p.grad.numpy() for k, p in params.items()}}


def _sequential(fn, stacked, x):
    """The port's layers applied in order to each microbatch, in this
    process: outputs, input gradient and every layer's gradients."""
    params = {k: torch.tensor(v).requires_grad_(True)
              for k, v in stacked.items()}
    xt = torch.tensor(x).requires_grad_(True)

    def one(h):
        for i in range(next(iter(params.values())).shape[0]):
            h = fn({k: p[i] for k, p in params.items()}, h)
        return h

    out = torch.stack([one(h) for h in xt])
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "grads": {k: p.grad.numpy() for k, p in params.items()}}


def _pipeline_rank(ctx, blocks, pm):
    from torch.func import functional_call

    from raydp_tpu_torch.models import transformer_params_from_flax
    from raydp_tpu_torch.models.transformer import Block
    from raydp_tpu_torch.parallel import ShardedModule, make_mesh

    torch.set_num_threads(2)
    stage4 = make_mesh(dict(stage=4), device_type="cpu")
    pp_dp = make_mesh(dict(stage=2, data=2), device_type="cpu")
    out = {"coords": [stage4.coords["stage"], pp_dp.coords["stage"]]}
    out["stage4"] = _run_case(_port_stage_fn, _stacked(N_STAGES), _x_micro(),
                              stage4)
    out["data"] = _run_case(_port_stage_fn, _stacked(N_STAGES), _x_micro(),
                            pp_dp)
    out["layers8"] = _run_case(_port_stage_fn, _stacked(8), _x_micro(),
                               stage4)

    trees, x = blocks
    block = Block(BLK_DIM, BLK_HEADS, attention="dense", device="cpu")
    flat = [transformer_params_from_flax(t) for t in trees]
    stacked = {k: np.stack([f[k].numpy() for f in flat]) for k in flat[0]}
    out["blocks"] = _run_case(
        lambda p, h: functional_call(block, p, (h,)), stacked, x, pp_dp)

    params, x, y = pm
    model = ShardedModule(_pm_port(params), pp_dp)
    model.module.schedule = (pp_dp, PM_MICRO, {})
    rows = PM_ROWS // 2
    mine = slice(pp_dp.coords["data"] * rows, (pp_dp.coords["data"] + 1)
                 * rows)
    preds = model(torch.tensor(x[mine]))
    # the rank's rows' share of the global mean, as the estimator's gang
    ((preds - torch.tensor(y[mine])) ** 2).sum().div(PM_ROWS).backward()
    model.reduce_grads()
    whole = model.gather_state({"model": {
        n: p.grad for n, p in model.module.named_parameters()}})["model"]
    out["pm"] = {n: g.numpy() for n, g in whole.items()}
    return out


@pytest.fixture(scope="module")
def port_world():
    """Rank 0's and rank 3's view of every case (one spawned world), and
    the coordinates of every rank."""
    from raydp_tpu_torch.spmd import create_spmd_job

    _, trees, x = _block_case()
    _, params, px, py = _pm_reference()
    job = create_spmd_job("t-pipeline", 4, torch_distributed=True,
                          timeout=120)
    job.start()
    try:
        return job.run(lambda ctx: _pipeline_rank(
            ctx, (trees, x), (params, px, py)), timeout=600)
    finally:
        job.stop()


def _reference(fn, stacked, x, spec, n_devices=8):
    """The reference's outputs, input gradient and stage gradients."""
    from raydp_tpu.parallel import MeshSpec, make_mesh, pipeline_apply

    mesh = make_mesh(MeshSpec(**spec), devices=jax.devices()[:n_devices])
    stacked = jax.tree.map(jnp.asarray, stacked)

    def loss(p, x):
        out = pipeline_apply(fn, p, x, mesh)
        return jnp.sum(out ** 2), out

    (_, out), (dp, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(x))
    return {"out": np.asarray(out), "dx": np.asarray(dx),
            "grads": jax.tree.map(np.asarray, dp)}


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _parity(got, want, what, tol=PARITY_TOL):
    """The largest difference within ``tol`` of the array's largest
    magnitude (the port against the reference: module docstring)."""
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _hold(ranks, case, seq, ref, n_stages, coord, out_tol, grad_tol,
          scaled_grads=False):
    """Every rank's outputs and input gradient, and each rank's stage
    gradients on its own run of layers (zero elsewhere), against the
    port's sequential application (``out_tol``, ``grad_tol``; relative to
    the array's scale with ``scaled_grads``) and the reference's
    (:func:`_parity`)."""
    def grads_close(got, want, what):
        if scaled_grads:
            _parity(got, want, what, grad_tol)
        else:
            _close(got, want, grad_tol, what)

    for r in ranks:
        got = r[case]
        _close(got["out"], seq["out"], out_tol, f"{case} sequential: out")
        grads_close(got["dx"], seq["dx"], f"{case} sequential: dx")
        _parity(got["out"], ref["out"], f"{case} reference: out")
        _parity(got["dx"], ref["dx"], f"{case} reference: dx")
        s = r["coords"][coord]
        for k, g in got["grads"].items():
            per = g.shape[0] // n_stages
            run = slice(s * per, (s + 1) * per)
            grads_close(g[run], seq["grads"][k][run],
                        f"{case} sequential: {k}")
            _parity(g[run], ref["grads"][k][run], f"{case} reference: {k}")
            rest = np.delete(g, np.arange(s * per, (s + 1) * per), axis=0)
            assert not rest.any(), f"{case}: {k} off the rank's stage"


def test_pipeline_matches_sequential(port_world):
    seq = _sequential(_port_stage_fn, _stacked(N_STAGES), _x_micro())
    ref = _reference(_ref_stage_fn, _stacked(N_STAGES), _x_micro(),
                     dict(stage=N_STAGES))
    for r in port_world:
        assert r["stage4"]["out"].shape == (N_MICRO, MB, DIM)
        _close(r["stage4"]["out"], seq["out"], OUT_TOL, "sequential")
        _parity(r["stage4"]["out"], ref["out"], "reference")


def test_pipeline_grads_match_sequential(port_world):
    """Autograd through the tick loop and its exchanges IS the reverse
    pipeline: every stage's gradients land on their stage and match."""
    _hold(port_world, "stage4",
          _sequential(_port_stage_fn, _stacked(N_STAGES), _x_micro()),
          _reference(_ref_stage_fn, _stacked(N_STAGES), _x_micro(),
                     dict(stage=N_STAGES)), N_STAGES, 0, OUT_TOL, GRAD_TOL)


def test_pipeline_composes_with_data_axis(port_world):
    """pp × dp: stage=2 × data=2; each microbatch's rows split over data
    inside the pipeline, the parameters' gradients summed over it."""
    _hold(port_world, "data",
          _sequential(_port_stage_fn, _stacked(N_STAGES), _x_micro()),
          _reference(_ref_stage_fn, _stacked(N_STAGES), _x_micro(),
                     dict(stage=2, data=2), n_devices=4),
          2, 1, OUT_TOL, GRAD_TOL)


def test_pipeline_multiple_layers_per_stage(port_world):
    """8 stacked layers over 4 stages: each stage applies its contiguous
    pair in order."""
    _hold(port_world, "layers8",
          _sequential(_port_stage_fn, _stacked(8), _x_micro()),
          _reference(_ref_stage_fn, _stacked(8), _x_micro(),
                     dict(stage=N_STAGES)), N_STAGES, 0, OUT_TOL, GRAD_TOL)


def test_pipeline_rejects_indivisible_layer_count():
    """The reference's ValueError, word for word (raised before any
    collective: no process group is needed)."""
    from raydp_tpu.parallel import MeshSpec, make_mesh
    from raydp_tpu.parallel import pipeline_apply as ref_apply
    from raydp_tpu_torch.parallel import Mesh, pipeline_apply

    bad = _stacked(N_STAGES + 1)
    with pytest.raises(ValueError, match="must divide") as want:
        ref_apply(_ref_stage_fn, jax.tree.map(jnp.asarray, bad),
                  jnp.asarray(_x_micro()), make_mesh(MeshSpec(stage=4)))
    with pytest.raises(ValueError, match="must divide") as got:
        pipeline_apply(_port_stage_fn,
                       {k: torch.tensor(v) for k, v in bad.items()},
                       torch.tensor(_x_micro()), Mesh(dict(stage=4)))
    assert str(got.value) == str(want.value)


def test_pipeline_no_stage_axis_is_sequential():
    """stage=1: the layers applied in order, in this process."""
    from raydp_tpu_torch.parallel import Mesh

    got = _run_case(_port_stage_fn, _stacked(N_STAGES), _x_micro(),
                    Mesh(dict()))
    _hold([dict(none=got, coords=[0])], "none",
          _sequential(_port_stage_fn, _stacked(N_STAGES), _x_micro()),
          _reference(_ref_stage_fn, _stacked(N_STAGES), _x_micro(),
                     dict(data=8)), 1, 0, OUT_TOL, GRAD_TOL)


def test_pipeline_transformer_blocks(port_world):
    """The TransformerLM's own Blocks as stages (dense attention): the
    port's stage=2 × data=2 against the reference's stage=2."""
    from raydp_tpu.parallel.pipeline import stack_stage_params

    from raydp_tpu_torch.models import transformer_params_from_flax

    from torch.func import functional_call

    from raydp_tpu_torch.models.transformer import Block

    block, trees, x = _block_case()
    ref = _reference(lambda p, h: block.apply({"params": p}, h),
                     stack_stage_params(trees), x, dict(stage=BLK_STAGES))
    ref["grads"] = {k: v.numpy() for k, v in transformer_params_from_flax(
        ref["grads"]).items()}
    port_block = Block(BLK_DIM, BLK_HEADS, attention="dense", device="cpu")
    flat = [transformer_params_from_flax(t) for t in trees]
    seq = _sequential(lambda p, h: functional_call(port_block, p, (h,)),
                      {k: np.stack([f[k].numpy() for f in flat])
                       for k in flat[0]}, x)
    _hold(port_world, "blocks", seq, ref, BLK_STAGES, 1, BLOCK_TOL,
          BLOCK_TOL, scaled_grads=True)


def test_pipeline_model_gradients_match_sequential(port_world):
    """A PipelineModel (embed, four blocks, head) trained through the
    schedule on stage=2 × data=2: the embed's, every stage's and the
    head's gradients, gathered, equal the reference's sequential model's
    (``PipelineModel.apply``) — the head's are each rank's own, the
    embed's reach every stage, nothing counts twice."""
    from raydp_tpu_torch.models import pipeline_params_from_flax

    model, params, x, y = _pm_reference()

    def loss(p):
        preds = model.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((preds - jnp.asarray(y)) ** 2)

    want = pipeline_params_from_flax(jax.tree.map(
        np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray, params))))
    for r in port_world:
        assert set(r["pm"]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(r["pm"][name], w.numpy(),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=name)
