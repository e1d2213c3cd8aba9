"""Sharded gang training in the port (``fit_gang(mesh_spec=...)`` and
``fit(mesh=...)`` inside a user's ranks) against the reference's SINGLE
process on as many virtual CPU devices, on the CPU.

The reference shards one process's train state over 8 virtual devices and
GSPMD inserts the collectives (``tests/test_gang_sharded.py``); the port's
ranks are real subprocesses under ``gloo``, one mesh position each, and its
step calls the collectives (:mod:`raydp_tpu_torch.parallel.shard`). Both
start from the Flax init ``FlaxEstimator`` draws (carried across with
``mlp_variables_from_flax``) and read the same Arrow blocks; the optimizer
is SGD, the same update in both. Tolerances are the reference tests' own:

- the equivalence matrix ``data=2`` / ``fsdp=2`` / ``tensor=2`` /
  ``fsdp=2×tensor=2`` (the one 4-rank gang): per-epoch train losses within
  rtol 5e-4 of the reference on 2 (4) devices, and ``Dense_1``'s spec
  ``("fsdp", "tensor")`` with its (16, 8) shard;
- the gathered model within rtol 1e-3, atol 1e-4; a sharded
  ``export_serving`` bitwise ``predict``;
- the sharded multi-writer checkpoint: 2 manifests and ``COMPLETE``, a
  resumed gang's history ``[0, 1, 2, 3]``, a driver-side restore that
  reassembles the gang's state bit for bit, and a gang of another mesh
  shape resuming from it;
- ``accum_steps=4`` across meshes (rtol 5e-4), the three ``remat`` modes
  equal under ``fsdp=2`` (rtol 1e-6), the ragged train and eval tails
  padded and masked (rtol 5e-4, 24 steps) and ``RDT_TRAIN_PAD_TAIL=0``
  restoring the drop (23 steps).

The reference's runtime runs first and is stopped; the port's runtime then
holds the same blocks (the two never run at once).
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.models import MLP, mlp_variables_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.train import TorchEstimator
from raydp_tpu_torch.train import checkpoint as ckpt

LOSS_RTOL = 5e-4            # the reference tests' across meshes
REMAT_RTOL = 1e-6           # the reference's remat test
KERNEL_RTOL, KERNEL_ATOL = 1e-3, 1e-4
#: the matrix: (mesh spec, ranks)
MATRIX = [(dict(data=2), 2), (dict(fsdp=2), 2), (dict(tensor=2), 2),
          (dict(fsdp=2, tensor=2), 4)]


def _linear_tables(n, parts, seed=0):
    """The reference test's ``_linear_df`` rows, as ``parts`` blocks."""
    rng = np.random.RandomState(seed)
    x = rng.random_sample((n, 2))
    y = x @ np.array([2.0, -3.0]) + 1.0 + rng.normal(0, 0.01, n)
    table = pa.table({"x1": x[:, 0], "x2": x[:, 1], "y": y})
    cuts = np.linspace(0, n, parts + 1).astype(int)
    return [table.slice(a, b - a) for a, b in zip(cuts[:-1], cuts[1:])]


def _flax_variables():
    from raydp_tpu.models import MLP as JaxMLP

    return jax.tree.map(np.asarray, JaxMLP(
        features=(32, 16), use_batch_norm=False).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))


def _kw(**extra):
    return {**dict(loss="mse", feature_columns=["x1", "x2"],
                   label_column="y", batch_size=64, num_epochs=3,
                   shuffle=False, feature_dtype=np.float32), **extra}


def _port_estimator(ckpt_dir=None, **extra):
    model = MLP(2, (32, 16), use_batch_norm=False, device="cpu")
    model.load_state_dict(mlp_variables_from_flax(_flax_variables()))
    return TorchEstimator(model=model,
                          optimizer=lambda p: torch.optim.SGD(p, lr=5e-2),
                          checkpoint_dir=ckpt_dir, device="cpu",
                          **_kw(**extra))


def _losses(history, key="train_loss"):
    return [h[key] for h in history]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's single-process fits on 1, 2 and 4 virtual
    devices."""
    import optax

    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.parallel import make_mesh
    from raydp_tpu.runtime import init_runtime, shutdown_runtime
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    def dataset(tables):
        return DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)

    def fit(spec, n_devices, train, evals=None, **extra):
        est = FlaxEstimator(
            model=JaxMLP(features=(32, 16), use_batch_norm=False),
            optimizer=optax.sgd(5e-2),
            mesh=make_mesh(spec, devices=jax.devices()[:n_devices]),
            **_kw(**extra))
        result = est.fit(dataset(train), None if evals is None
                         else dataset(evals))
        return est, result.history

    init_runtime()
    try:
        out = {}
        for spec, n in MATRIX:
            est, out[str(spec)] = fit(spec, n, _linear_tables(1536, 4))
            if spec == dict(fsdp=2, tensor=2):
                k = est.get_state().params["Dense_1"]["kernel"]
                out["dense_1"] = (tuple(k.sharding.spec),
                                  k.sharding.shard_shape(k.shape))
        est, out["single"] = fit(MeshSpec(), 1, _linear_tables(1536, 4))
        out["kernel"] = np.asarray(
            est.get_model()["params"]["Dense_0"]["kernel"])
        _, out["ragged"] = fit(MeshSpec(), 1, _linear_tables(1500, 4),
                               _linear_tables(300, 2, seed=1),
                               drop_last=False, metrics=["mae"])
    finally:
        shutdown_runtime()
    return out


@pytest.fixture(scope="module")
def port_runtime(reference):
    """The port's runtime, after the reference's stopped."""
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime

    yield init_runtime()
    shutdown_runtime()


def _store_dataset(tables):
    from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu_torch.runtime.object_store import get_client

    refs = get_client().put_arrow_many(tables)
    return DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                               for t, r in zip(tables, refs)],
                              tables[0].schema)


@pytest.fixture(scope="module")
def matrix(port_runtime, tmp_path_factory):
    """One gang a mesh of :data:`MATRIX`: ``{str(spec): (estimator,
    result)}``."""
    tmp = tmp_path_factory.mktemp("matrix")
    ds = _store_dataset(_linear_tables(1536, 4))
    out = {}
    for i, (spec, n) in enumerate(MATRIX):
        est = _port_estimator(str(tmp / f"m{i}"), mesh_spec=spec)
        out[str(spec)] = (est, est.fit_gang(ds, num_workers=n,
                                            run_timeout=600.0))
    return out


@pytest.mark.parametrize("spec,ranks", MATRIX, ids=[str(s) for s, _ in MATRIX])
def test_mesh_equivalence_matrix(reference, matrix, spec, ranks):
    """Per-epoch train losses of the port's gang on each mesh match the
    reference's single process on as many devices; the gloo gang runs
    every sharded step eagerly."""
    est, result = matrix[str(spec)]
    want = reference[str(spec)]
    assert [h["steps"] for h in result.history] == [24, 24, 24]
    np.testing.assert_allclose(_losses(result.history), _losses(want),
                               rtol=LOSS_RTOL, err_msg=str(spec))
    assert all(d["graph_replays"] == 0 for d in result.dispatch)


def test_role_specs_and_local_shards(reference, matrix):
    """Under fsdp=2 × tensor=2 the role policy gives ``Dense_1``'s (32, 16)
    kernel the reference's spec, and every rank holds the reference's
    shard."""
    est, result = matrix[str(dict(fsdp=2, tensor=2))]
    state = est.get_state()
    spec, shard = reference["dense_1"]
    assert state.specs["Dense_1.kernel"] == spec == ("fsdp", "tensor")
    assert [r["local_shapes"]["Dense_1.kernel"] for r in result.ranks] \
        == [tuple(shard)] * 4 == [(16, 8)] * 4
    # biases replicate; the driver's state is whole
    assert state.specs["Dense_1.bias"] == ()
    assert tuple(est.get_model().state_dict()["Dense_1.kernel"].shape) \
        == (32, 16)


def test_gathered_model_matches_the_reference(reference, matrix):
    """The model the fsdp=2 gang returns, gathered from both ranks' shards,
    holds the reference's single-process weights."""
    est, _ = matrix[str(dict(fsdp=2))]
    kernel = est.get_model().state_dict()["Dense_0.kernel"].numpy()
    assert kernel.shape == reference["kernel"].shape
    np.testing.assert_allclose(kernel, reference["kernel"],
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_sharded_export_serving_bitwise_matches_predict(matrix, tmp_path):
    """export_serving off the fsdp×tensor gang's state → load_servable →
    predict_table is bit-identical to the estimator's own predict."""
    from raydp_tpu_torch.serve.servable import load_servable

    est, _ = matrix[str(dict(fsdp=2, tensor=2))]
    rows = _linear_tables(512, 1, seed=3)[0].select(["x1", "x2"])
    ref = est.predict(TableDataset([rows]))
    sv = load_servable(est.export_serving(str(tmp_path / "bundle")),
                       device="cpu")
    assert np.array_equal(sv.predict_table(rows), ref)


@pytest.fixture(scope="module")
def fsdp_checkpoint(port_runtime, tmp_path_factory):
    """A 2-epoch fsdp=2 gang's checkpoint dir, its estimator and result."""
    ckpt_dir = str(tmp_path_factory.mktemp("fsdp-ckpt") / "ck")
    ds = _store_dataset(_linear_tables(1024, 2))
    est = _port_estimator(ckpt_dir, mesh_spec=dict(fsdp=2), num_epochs=2)
    return ckpt_dir, est, est.fit_gang(ds, num_workers=2, run_timeout=600.0)


def _latest_step_dir(ckpt_dir):
    steps = glob.glob(os.path.join(ckpt_dir, "step_*"))
    return sorted(steps, key=lambda p: int(p.rsplit("_", 1)[1]))[-1]


def test_gang_sharded_checkpoint_resume(fsdp_checkpoint, tmp_path):
    """Each rank writes its shards (2 manifests), rank 0 the COMPLETE
    marker; a second gang over the same dir resumes from the sharded
    checkpoint instead of retraining."""
    ckpt_dir, _, first = fsdp_checkpoint
    assert [h["epoch"] for h in first.history] == [0, 1]
    latest = _latest_step_dir(ckpt_dir)
    assert len(glob.glob(os.path.join(latest, "manifest_*.json"))) == 2
    assert os.path.exists(os.path.join(latest, "COMPLETE"))
    # a kernel's two halves land once each, one from each rank's file;
    # a replicated bias once, from rank 0's
    entries = ckpt._load_manifests(latest)
    kernel = entries["['model']['Dense_0.kernel']"]
    assert sorted(os.path.basename(f) for _, f in kernel) \
        == ["shard_0.npz", "shard_1.npz"]
    assert sorted(e["index"][1][0] for e, _ in kernel) == [0, 16]
    assert [os.path.basename(f) for _, f in
            entries["['model']['Dense_0.bias']"]] == ["shard_0.npz"]

    resumed_dir = str(tmp_path / "ck")
    shutil.copytree(ckpt_dir, resumed_dir)
    ds = _store_dataset(_linear_tables(1024, 2))
    second = _port_estimator(resumed_dir, mesh_spec=dict(fsdp=2),
                             num_epochs=4)
    r2 = second.fit_gang(ds, num_workers=2, run_timeout=600.0)
    # epochs 0-1 came from the restored sidecar; 2-3 were trained
    assert [h["epoch"] for h in r2.history] == [0, 1, 2, 3]
    assert [d["epoch"] for d in r2.dispatch] == [2, 3]
    assert r2.history[-1]["train_loss"] < first.history[-1]["train_loss"]
    assert ckpt.restore_extra(resumed_dir)["history"]
    single = _port_estimator(num_epochs=4).fit(TableDataset(
        _linear_tables(1024, 2)))
    np.testing.assert_allclose(_losses(r2.history), _losses(single.history),
                               rtol=LOSS_RTOL)


def test_checkpoint_roundtrip_across_mesh_shapes(fsdp_checkpoint, tmp_path):
    """The driver reassembles the fsdp=2 gang's sharded checkpoint into
    the whole state, bit for bit the state the gang returned; and a gang of
    another mesh shape (tensor=2) resumes from it."""
    ckpt_dir, est, _ = fsdp_checkpoint
    trained = est.get_state()
    restored, step = ckpt.restore(ckpt_dir, trained.state_dict())
    assert step == 1
    for key, t in ckpt._tensor_leaves(trained.state_dict()):
        want = dict(ckpt._tensor_leaves(restored))[key]
        assert torch.equal(t, want), key

    other = str(tmp_path / "ck")
    shutil.copytree(ckpt_dir, other)
    ds = _store_dataset(_linear_tables(1024, 2))
    tp = _port_estimator(other, mesh_spec=dict(tensor=2), num_epochs=3)
    r = tp.fit_gang(ds, num_workers=2, run_timeout=600.0)
    assert [h["epoch"] for h in r.history] == [0, 1, 2]
    assert [d["epoch"] for d in r.dispatch] == [2]
    single = _port_estimator(num_epochs=3).fit(TableDataset(
        _linear_tables(1024, 2)))
    np.testing.assert_allclose(_losses(r.history), _losses(single.history),
                               rtol=LOSS_RTOL)


def _fits_in_ranks(world, fits, env=None):
    """Each rank of a ``world``-rank job builds the mesh of every
    ``(label, spec, estimator kwargs, tables)`` in ``fits`` and runs
    ``fit(mesh=...)`` there — a user's own spmd job; returns rank 0's
    ``{label: history}``."""
    from raydp_tpu_torch.spmd import create_spmd_job

    def run(ctx, fits=fits):
        from raydp_tpu_torch.parallel import make_mesh

        out = {}
        for label, spec, kw, (train, evals) in fits:
            est = _port_estimator(mesh=make_mesh(spec, device_type="cpu"),
                                  **kw)
            result = est.fit(TableDataset(train), evals and TableDataset(
                evals))
            out[label] = result.history
        return out

    job = create_spmd_job("t-mesh-fits", world, env=env,
                          torch_distributed=True, timeout=120)
    job.start()
    try:
        return job.run(run, timeout=600)[0]
    finally:
        job.stop()


@pytest.fixture(scope="module")
def mesh_fits(reference):
    """One 2-rank job: accum=4 on three meshes, the three remat modes under
    fsdp=2 with accum=4, and the ragged train and eval tails under fsdp=2."""
    data = (_linear_tables(1536, 4), None)
    ragged = (_linear_tables(1500, 4), _linear_tables(300, 2, seed=1))
    fits = [(f"accum {s}", s, dict(accum_steps=4), data)
            for s in (dict(data=2), dict(fsdp=2), dict(tensor=2))]
    fits += [(f"remat {m}", dict(fsdp=2), dict(accum_steps=4, remat=m), data)
             for m in ("none", "dots", "full")]
    fits.append(("ragged", dict(fsdp=2),
                 dict(drop_last=False, metrics=["mae"]), ragged))
    return _fits_in_ranks(2, fits)


@pytest.mark.parametrize("spec", [dict(data=2), dict(fsdp=2), dict(tensor=2)],
                         ids=str)
def test_accum_parity_across_meshes(reference, mesh_fits, spec):
    """accum=4 reproduces the accum=1 per-epoch losses on dp, fsdp and tp
    meshes: row-weighted microbatch accumulation is the full-batch step's
    math, whatever the layout."""
    np.testing.assert_allclose(_losses(mesh_fits[f"accum {spec}"]),
                               _losses(reference["single"]), rtol=LOSS_RTOL)


def test_remat_modes_identical_losses(mesh_fits):
    """none/dots/full recompute, never approximate, under fsdp=2 with
    accumulation engaged (the recompute gathers the shards again)."""
    ref = _losses(mesh_fits["remat none"])
    for mode in ("dots", "full"):
        np.testing.assert_allclose(_losses(mesh_fits[f"remat {mode}"]), ref,
                                   rtol=REMAT_RTOL, err_msg=mode)


def test_ragged_train_and_eval_tails_pad(reference, mesh_fits):
    """drop_last=False with a 28-row train tail (1500 = 23×64 + 28) and a
    44-row eval tail (300 = 4×64 + 44): under fsdp=2 both pad and mask to
    a full batch — the same step count and losses as the reference's one
    device consuming the ragged batches natively."""
    got, want = mesh_fits["ragged"], reference["ragged"]
    assert [h["steps"] for h in got] == [h["steps"] for h in want] \
        == [24, 24, 24]
    for key in ("train_loss", "eval_loss", "eval_mae"):
        np.testing.assert_allclose(_losses(got, key), _losses(want, key),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_pad_tail_knob_restores_drop():
    """RDT_TRAIN_PAD_TAIL=0 drops the ragged train tail again: 23 steps an
    epoch where padding makes 24."""
    fits = [("drop", dict(fsdp=2), dict(drop_last=False, num_epochs=1),
             (_linear_tables(1500, 4), None))]
    history = _fits_in_ranks(2, fits, env={"RDT_TRAIN_PAD_TAIL": "0"})["drop"]
    assert [h["steps"] for h in history] == [23]


def test_plain_fit_on_a_sharded_spec_raises():
    """A plain fit runs on one device: a mesh with an extent above 1
    raises the reference's ValueError; fit_gang refuses a driver-built
    mesh, a staged mesh for a model that is not a PipelineModel, and sizes
    that do not multiply to the ranks."""
    from raydp_tpu.parallel.mesh import MeshSpec as RefMeshSpec

    ds = TableDataset(_linear_tables(256, 1))
    with pytest.raises(ValueError) as got:
        _port_estimator(mesh_spec=dict(fsdp=2)).fit(ds)
    with pytest.raises(ValueError) as want:
        RefMeshSpec(fsdp=2).sizes(1)
    assert str(got.value) == str(want.value)
    from raydp_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="builds its mesh inside the ranks"):
        _port_estimator(mesh=make_mesh()).fit_gang(ds, num_workers=2)
    with pytest.raises(ValueError, match="not a PipelineModel"):
        _port_estimator(mesh_spec=dict(stage=2)).fit_gang(ds, num_workers=2)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        _port_estimator(mesh_spec=dict(data=2, fsdp=2)).fit_gang(
            ds, num_workers=2)
