"""Pipeline-parallel training in the port (``TorchEstimator`` with a
``PipelineModel`` on a ``stage`` mesh) against the reference's
``FlaxEstimator``, on the CPU: the counterparts of
``tests/test_pipeline_estimator.py``'s seven tests, and six layers over
two stages.

The reference fits its ``PipelineModel`` (four residual tanh blocks and a
Dense head) once, unstaged (``stage=1 × data=8``, ``accum_steps=4``), in
this process; the port starts from the same Flax init
(``pipeline_params_from_flax``) and reads the same rows. Its staged fits
run as ranks under gloo: ``fit_gang(mesh_spec=dict(stage=2, data=2))``
(four ranks) for the equivalence, and one spawned world of two ranks
(``stage=2``) that runs ``fit(mesh=...)`` for the microbatching, remat and
chaos legs. A staged run must reproduce the unstaged losses — sharding is a
layout, not a math change.

Tolerances: the port against the reference's losses through Adam within
``REF_RTOL`` = 5e-5 (``torch.optim.Adam`` is not bitwise ``optax.adam``,
ROADMAP Queue 3, as the gang's tests hold it) and its parameters within
atol 1e-5 (the reference test's); the port's staged runs against each
other within rtol 5e-4 (the reference test's); the chaos leg's weights
bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

DIM = 8
FEATURES = [f"f{i}" for i in range(DIM)]
REF_RTOL = 5e-5             # the port against the reference through Adam
LOSS_RTOL = 5e-4            # test_pipeline_estimator.py's across runs
PARAM_ATOL = 1e-5           # ... and its parameter tolerance


def _tables(n=256, parts=4):
    """The reference test's ``_linear_ds`` rows, as ``parts`` blocks."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(n, DIM))
    w = rng.normal(size=(DIM,))
    data = {f"f{i}": x[:, i] for i in range(DIM)}
    data["label"] = x @ w + 0.1 * rng.normal(size=n)
    table = pa.table(data)
    per = n // parts
    return [table.slice(i * per, per) for i in range(parts)]


def _ref_model(n_layers=4):
    import flax.linen as nn

    from raydp_tpu.train import PipelineModel

    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            return x + nn.tanh(nn.Dense(DIM)(x))

    return PipelineModel(layers=[Block() for _ in range(n_layers)],
                         head=nn.Dense(1))


def _init_params(n_layers=4):
    """The Flax init every FlaxEstimator fit of the model draws (seed 0)."""
    return jax.tree.map(np.asarray, _ref_model(n_layers).init(
        jax.random.PRNGKey(0), jnp.zeros((1, DIM)))["params"])


class _Block(torch.nn.Module):
    """The reference test's residual tanh block."""

    def __init__(self):
        super().__init__()
        from raydp_tpu_torch.models.layers import _Dense

        self.Dense_0 = _Dense((DIM,), (DIM,), None, torch.device("cpu"),
                              use_bias=True)

    def forward(self, x):
        return x + torch.tanh(self.Dense_0(x))


def _port_model(n_layers=4):
    """The port's PipelineModel from the reference's init."""
    from raydp_tpu_torch.models import pipeline_params_from_flax
    from raydp_tpu_torch.models.layers import _Dense
    from raydp_tpu_torch.train import PipelineModel

    model = PipelineModel([_Block() for _ in range(n_layers)],
                          head=_Dense((DIM,), (1,), None,
                                      torch.device("cpu"), use_bias=True))
    model.load_state_dict(pipeline_params_from_flax(_init_params(n_layers)))
    return model


def _est(**kw):
    from raydp_tpu_torch.train import TorchEstimator

    kw.setdefault("model", _port_model())
    kw.setdefault("num_epochs", 3)
    return TorchEstimator(loss="mse", feature_columns=FEATURES,
                          label_column="label", batch_size=64, seed=0,
                          shuffle=False, device="cpu", **kw)


def _losses(history):
    return [h["train_loss"] for h in history]


@pytest.fixture(scope="module")
def reference():
    """The reference's unstaged fit: its losses and final params."""
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.parallel import make_mesh
    from raydp_tpu.runtime import init_runtime, shutdown_runtime
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    from raydp_tpu_torch.models import pipeline_params_from_flax

    init_runtime()
    try:
        tables = _tables()
        ds = DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)
        est = FlaxEstimator(
            model=_ref_model(), loss="mse", feature_columns=FEATURES,
            label_column="label", batch_size=64, seed=0, shuffle=False,
            num_epochs=3, mesh=make_mesh(dict(stage=1, data=8)),
            accum_steps=4)
        result = est.fit(ds)
        params = jax.tree.map(np.asarray, result.state.params)
    finally:
        shutdown_runtime()
    return {"losses": _losses(result.history),
            "params": {k: v.numpy() for k, v in
                       pipeline_params_from_flax(params).items()}}


@pytest.fixture(scope="module")
def staged_gang(reference):
    """``fit_gang(mesh_spec=dict(stage=2, data=2))`` over four ranks, from
    the store (the port's runtime, after the reference's stopped)."""
    from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime
    from raydp_tpu_torch.runtime.object_store import get_client

    init_runtime()
    try:
        tables = _tables()
        refs = get_client().put_arrow_many(tables)
        ds = DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                                 for t, r in zip(tables, refs)],
                                tables[0].schema)
        est = _est(mesh_spec=dict(stage=2, data=2), accum_steps=4)
        result = est.fit_gang(ds, num_workers=4, run_timeout=600.0)
    finally:
        shutdown_runtime()
    return est, result


def _staged_rank(ctx, ckpt_root):
    """Every ``fit(mesh=stage=2)`` leg in one rank of a two-rank world:
    ``{label: (losses, gauges, final state)}``."""
    from raydp_tpu_torch import faults, metrics
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.parallel import make_mesh

    torch.set_num_threads(2)
    ds = TableDataset(_tables())

    def fit(**kw):
        mesh = make_mesh(dict(stage=2), device_type="cpu")
        result = _est(mesh=mesh, **kw).fit(ds)
        gauges = metrics.snapshot()["gauges"]
        return (_losses(result.history),
                {g: gauges.get(g, {}).get("") for g in
                 ("train_pipeline_stages", "train_accum_steps")},
                {n: p.detach().numpy().copy()
                 for n, p in result.state.model.state_dict().items()})

    out = {f"accum {a}": fit(accum_steps=a) for a in (2, 4)}
    out["six layers"] = fit(model=_port_model(6), accum_steps=4)
    out["remat"] = fit(accum_steps=4,
                       remat="embedding=none,kernel=dots,default=full")
    out["clean"] = fit(accum_steps=4,
                       checkpoint_dir=os.path.join(ckpt_root, "clean"))
    faults.clear()
    try:
        # every rank fails the same epoch, and every rank restores
        rule = faults.inject("estimator.epoch", "raise", match="1", times=1)
        mesh = make_mesh(dict(stage=2), device_type="cpu")
        result = _est(mesh=mesh, accum_steps=4, checkpoint_dir=os.path.join(
            ckpt_root, "faulted")).fit(ds, max_retries=1)
    finally:
        faults.clear()
    out["faulted"] = (_losses(result.history), {"fires": rule.fires},
                      {n: p.detach().numpy().copy()
                       for n, p in result.state.model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def staged_fits(tmp_path_factory):
    """Rank 0's and rank 1's legs (one spawned world of two ranks)."""
    from raydp_tpu_torch.spmd import create_spmd_job

    root = str(tmp_path_factory.mktemp("staged"))
    job = create_spmd_job("t-pipe-est", 2, torch_distributed=True,
                          timeout=120)
    job.start()
    try:
        return job.run(lambda ctx: _staged_rank(ctx, root), timeout=600)
    finally:
        job.stop()


def test_stage2_matches_stage1_losses_and_params(reference, staged_gang):
    """The equivalence: fit_gang over stage=2 × data=2 (four microbatches
    marching through the GPipe schedule on each data half) reproduces the
    reference's unstaged losses AND final parameters, gathered from the
    stages into the driver's model."""
    est, result = staged_gang
    np.testing.assert_allclose(_losses(result.history),
                               reference["losses"], rtol=REF_RTOL)
    got = {n: t.numpy() for n, t in result.state.model.state_dict().items()}
    assert set(got) == set(reference["params"]) and got
    for name, want in reference["params"].items():
        np.testing.assert_allclose(got[name], want, atol=PARAM_ATOL,
                                   err_msg=name)
    # each stage held its half of the stack
    assert result.state.specs["stage_stack.Dense_0.kernel"][0] == "stage"
    assert [r["local_shapes"]["stage_stack.Dense_0.kernel"]
            for r in result.ranks] == [(2, DIM, DIM)] * 4
    # the driver's model is the sequential host form: predict runs it
    from raydp_tpu_torch.data import TableDataset

    assert est.predict(TableDataset(_tables())).shape == (256,)


def test_unified_microbatching_accum_is_pipeline_microbatch(reference,
                                                            staged_fits):
    """accum_steps IS the pipeline microbatch count: accum 2 and 4 at
    stage=2 land the reference's losses, and the gauges report the staged
    geometry on every rank."""
    for accum in (2, 4):
        for r in staged_fits:
            losses, gauges, _ = r[f"accum {accum}"]
            np.testing.assert_allclose(losses, reference["losses"],
                                       rtol=REF_RTOL, err_msg=str(accum))
            assert gauges == {"train_pipeline_stages": 2,
                              "train_accum_steps": accum}


def test_stage2_runs_three_layers_a_stage(staged_fits):
    """Six layers over stage=2: each rank holds and applies its run of
    three (the placement check counts the whole stack, not the rank's run)
    and the losses are those of the same model fit in one process."""
    from raydp_tpu_torch.data import TableDataset

    want = _losses(_est(model=_port_model(6), accum_steps=4).fit(
        TableDataset(_tables())).history)
    for r in staged_fits:
        losses, gauges, state = r["six layers"]
        np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
        assert state["stage_stack.Dense_0.kernel"].shape == (3, DIM, DIM)


def test_per_role_remat_policy_trains_to_same_loss(staged_fits):
    """A role→mode remat policy recomputes, never approximates: the same
    losses as no remat at all."""
    for r in staged_fits:
        np.testing.assert_allclose(r["remat"][0], r["accum 4"][0],
                                   rtol=LOSS_RTOL)


def test_remat_policy_validates_before_compile():
    """Unknown remat modes and roles fail in the driver, before any rank
    starts, with the offending token named."""
    from raydp_tpu_torch.data import TableDataset

    ds = TableDataset(_tables(64, 2))
    with pytest.raises(ValueError, match="unknown remat mode 'huge'"):
        _est(mesh_spec=dict(stage=2), remat="kernel=huge").fit_gang(
            ds, num_workers=2)
    with pytest.raises(ValueError, match="unknown remat role 'attention'"):
        _est(mesh_spec=dict(stage=2), remat="attention=dots").fit_gang(
            ds, num_workers=2)


def test_misplacement_fails_loud():
    """Layers must divide over the stages, a staged mesh needs a
    PipelineModel, and the microbatch count must divide the batch — each
    the reference's ValueError, raised before any rank starts."""
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.models import MLP

    ds = TableDataset(_tables(64, 2))
    with pytest.raises(ValueError, match="stage=2 must divide"):
        _est(model=_port_model(3), mesh_spec=dict(stage=2)).fit_gang(
            ds, num_workers=2)
    with pytest.raises(ValueError, match="not a PipelineModel"):
        _est(model=MLP(DIM, (8,), use_batch_norm=False, device="cpu"),
             mesh_spec=dict(stage=2)).fit_gang(ds, num_workers=2)
    with pytest.raises(ValueError, match="accum_steps=5"):
        _est(mesh_spec=dict(stage=2), accum_steps=5).fit_gang(
            ds, num_workers=2)


def test_pipeline_model_description_contract():
    """Empty layer lists and modules with running statistics (BatchNorm)
    are refused with the reference's messages."""
    from raydp_tpu_torch.models.layers import BatchNorm
    from raydp_tpu_torch.train import PipelineModel

    with pytest.raises(ValueError, match="at least one layer"):
        PipelineModel(layers=[])
    with pytest.raises(ValueError, match="mutable"):
        PipelineModel(layers=[BatchNorm(DIM, None, torch.device("cpu"))
                              for _ in range(2)])


def test_pipeline_chaos_epoch_crash_resumes_identically(staged_fits):
    """An injected crash at ``estimator.epoch`` 1 on every rank of the
    staged mesh restores the epoch-0 checkpoint (each stage's shard of the
    stack, written by its own rank) and replays to weights bitwise those
    of an uninterrupted staged fit."""
    for r in staged_fits:
        clean, faulted = r["clean"], r["faulted"]
        assert faulted[1]["fires"] == 1, "epoch fault never fired"
        assert len(faulted[0]) == 3
        np.testing.assert_allclose(faulted[0], clean[0], rtol=LOSS_RTOL)
        assert set(faulted[2]) == set(clean[2]) and clean[2]
        for name, w in clean[2].items():
            np.testing.assert_array_equal(faulted[2][name], w, err_msg=name)
