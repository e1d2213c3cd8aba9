"""The model families over a mesh of real ranks, on the CPU: expert-sharded
DLRM, a tensor-parallel TransformerLM step and row-sharded GBDT in the port
against the reference's single process, with the reference tests' own
tolerances.

- DLRM (``tests/test_gang_sharded.py::test_gang_expert_sharded_dlrm``):
  ``dlrm_param_rules("expert")`` on ``expert=2``, two ranks under
  ``gloo``, each looking up the ids in its half of every table, against
  the reference on 2 virtual devices: train losses within rtol 5e-4, the
  gathered table within rtol 1e-3, atol 1e-4;
- TransformerLM (``tests/test_transformer.py::
  test_lm_tensor_parallel_matches_replicated``): one SGD 1e-1 step under
  ``transformer_param_rules("tensor")`` on two ranks against the
  reference's replicated step from the same Flax init: loss rtol 1e-5,
  every updated parameter atol 2e-5, a q kernel holding half its heads;
- GBDT (``tests/test_gbdt.py::test_row_sharded_fit_matches_single_device``):
  ``fit_gbdt(mesh=)`` on two ranks, 3,001 rows (padded with zero weight):
  under 5 % of split nodes differ from the single fit's, margins within
  rtol 1e-3, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch.models import (
    DLRM, criteo_batch_preprocessor, dlrm_param_rules, dlrm_params_from_flax,
)
from raydp_tpu_torch.train import TorchEstimator

NUM_DENSE = 4
CAT_SIZES = [32, 16, 48, 64]
LOSS_RTOL = 5e-4
TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-4
LM_LOSS_RTOL, LM_PARAM_ATOL = 1e-5, 2e-5
SPLIT_FRACTION, MARGIN_RTOL, MARGIN_ATOL = 0.05, 1e-3, 1e-4


def _run_job(name, world, fn):
    from raydp_tpu_torch.spmd import create_spmd_job

    job = create_spmd_job(name, world, torch_distributed=True, timeout=120)
    job.start()
    try:
        return job.run(fn, timeout=600)
    finally:
        job.stop()


# ---- DLRM over expert=2 -----------------------------------------------------

def _criteo_table():
    """The reference test's 1,024 Criteo-shaped rows."""
    rng = np.random.RandomState(0)
    n = 1024
    data = {"label": rng.randint(0, 2, n).astype(np.float64)}
    for i in range(NUM_DENSE):
        data[f"d{i}"] = rng.random_sample(n)
    for j, vocab in enumerate(CAT_SIZES):
        data[f"c{j}"] = rng.randint(0, vocab, n)
    table = pa.Table.from_pandas(pd.DataFrame(data), preserve_index=False)
    return [table.slice(i * 256, 256) for i in range(4)]


FEATURES = [f"d{i}" for i in range(NUM_DENSE)] + \
    [f"c{j}" for j in range(len(CAT_SIZES))]
DLRM_KW = dict(loss="bce_with_logits", feature_columns=FEATURES,
               label_column="label", feature_dtype=np.float64,
               batch_size=128, num_epochs=2, shuffle=False)


def _flax_dlrm():
    from raydp_tpu.models import DLRM as JaxDLRM

    return JaxDLRM(categorical_sizes=CAT_SIZES, num_dense=NUM_DENSE,
                   embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(32, 16, 1))


@pytest.fixture(scope="module")
def dlrm_reference():
    """The reference's expert=2 fit on 2 virtual devices, and its init."""
    import optax

    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.models import criteo_batch_preprocessor as jax_prep
    from raydp_tpu.models import dlrm_param_rules as jax_rules
    from raydp_tpu.parallel import MeshSpec, make_mesh
    from raydp_tpu.runtime import init_runtime, shutdown_runtime
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    tables = _criteo_table()
    feats = np.stack([tables[0][c].to_numpy().astype(np.float64)
                      for c in FEATURES], 1)[:1]
    prep = jax_prep(NUM_DENSE)
    init = jax.tree.map(np.asarray, _flax_dlrm().init(
        jax.random.PRNGKey(0), prep({"features": jnp.asarray(feats),
                                     "label": jnp.zeros(1)})[0])["params"])
    init_runtime()
    try:
        ds = DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)
        est = FlaxEstimator(
            model=_flax_dlrm(), optimizer=optax.sgd(0.05),
            mesh=make_mesh(MeshSpec(expert=2), devices=jax.devices()[:2]),
            param_rules=jax_rules("expert"), batch_preprocessor=prep,
            **DLRM_KW)
        history = est.fit(ds).history
        table = np.asarray(
            est.get_model()["params"]["embedding_0"]["embedding"])
    finally:
        shutdown_runtime()
    return {"init": init, "history": history, "table": table}


@pytest.fixture(scope="module")
def port_runtime(dlrm_reference):
    from raydp_tpu_torch.runtime import init_runtime, shutdown_runtime

    yield init_runtime()
    shutdown_runtime()


def test_gang_expert_sharded_dlrm(dlrm_reference, port_runtime):
    """expert=2 (data extent 1) over 2 ranks: every table split by rows
    across the ranks, the batch REPLICATED on each — every rank feeds the
    whole global batch and looks its ids up in its own rows."""
    from raydp_tpu_torch.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu_torch.runtime.object_store import get_client

    tables = _criteo_table()
    refs = get_client().put_arrow_many(tables)
    ds = DistributedDataset([BlockMeta(num_rows=t.num_rows, ref=r)
                             for t, r in zip(tables, refs)], tables[0].schema)
    model = DLRM(CAT_SIZES, num_dense=NUM_DENSE, embedding_dim=8,
                 bottom_mlp=(16, 8), top_mlp=(32, 16, 1), device="cpu")
    model.load_state_dict(dlrm_params_from_flax(dlrm_reference["init"]))
    est = TorchEstimator(
        model=model, optimizer=lambda p: torch.optim.SGD(p, lr=0.05),
        batch_preprocessor=criteo_batch_preprocessor(NUM_DENSE),
        mesh_spec=dict(expert=2), param_rules=dlrm_param_rules("expert"),
        device="cpu", **DLRM_KW)
    result = est.fit_gang(ds, num_workers=2, run_timeout=600.0)
    np.testing.assert_allclose(
        [h["train_loss"] for h in result.history],
        [h["train_loss"] for h in dlrm_reference["history"]], rtol=LOSS_RTOL)
    table = est.get_model().state_dict()["embedding_0.embedding"].numpy()
    assert table.shape == dlrm_reference["table"].shape
    np.testing.assert_allclose(table, dlrm_reference["table"],
                               rtol=TABLE_RTOL, atol=TABLE_ATOL)
    assert est.get_state().specs["embedding_3.embedding"] == ("expert", None)
    assert [r["local_shapes"]["embedding_3.embedding"]
            for r in result.ranks] == [(32, 8), (32, 8)]
    # the MLPs replicate: each rank holds them whole
    assert result.ranks[1]["local_shapes"]["Dense_0.kernel"] == (NUM_DENSE,
                                                                 16)


# ---- TransformerLM over tensor=2 --------------------------------------------

def test_lm_tensor_parallel_matches_replicated():
    """Megatron-split params over tensor=2 (two ranks, each on its own
    head): one train step gives the reference's replicated loss and
    updated params; a q kernel holds half its heads a rank."""
    import optax

    from raydp_tpu.models import TransformerLM as JaxLM
    from raydp_tpu.models import lm_loss as jax_lm_loss
    from raydp_tpu.parallel import MeshSpec, make_mesh
    from raydp_tpu_torch.models import transformer_params_from_flax

    vocab, b, t = 64, 8, 32
    model = JaxLM(vocab_size=vocab, dim=32, num_heads=2, num_layers=2,
                  attention="dense")
    tokens = np.random.RandomState(0).randint(0, vocab, size=(b, t)).astype(
        np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    tx = optax.sgd(1e-1)
    with make_mesh(MeshSpec()):
        loss, grads = jax.value_and_grad(lambda p: jax_lm_loss(
            model.apply({"params": p}, jnp.asarray(tokens)),
            jnp.asarray(tokens)))(params)
        upd, _ = tx.update(grads, tx.init(params))
        want = transformer_params_from_flax(jax.tree.map(
            np.asarray, optax.apply_updates(params, upd)))
    init = transformer_params_from_flax(jax.tree.map(np.asarray, params))

    def tp_step(ctx, init=init, tokens=tokens):
        import torch

        from raydp_tpu_torch.models import (
            TransformerLM, lm_loss, transformer_param_rules,
        )
        from raydp_tpu_torch.parallel import ShardedModule, make_mesh

        lm = TransformerLM(64, dim=32, num_heads=2, num_layers=2,
                           attention="dense", device="cpu")
        lm.load_state_dict(init)
        sm = ShardedModule(lm, make_mesh(dict(tensor=2), device_type="cpu"),
                           transformer_param_rules("tensor"))
        opt = torch.optim.SGD(sm.parameters(), lr=1e-1)
        x = torch.from_numpy(tokens).long()
        loss = lm_loss(sm(x), x)
        loss.backward()
        sm.reduce_grads()
        opt.step()
        whole = sm.gather_state({"model": sm.state_dict()})["model"]
        return (loss.item(), whole,
                sm.local_shapes()["block_0.attn.q.kernel"])

    ranks = _run_job("t-lm-tp", 2, tp_step)
    for got_loss, got, q_local in ranks:
        np.testing.assert_allclose(got_loss, float(loss), rtol=LM_LOSS_RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=LM_PARAM_ATOL, err_msg=name)
        # the split took: a q kernel [dim, heads, head_dim] holds one head
        assert q_local == (32, 1, 16)


# ---- GBDT over data=2 -------------------------------------------------------

def _gbdt_rows():
    rng = np.random.RandomState(9)
    n = 3001  # not divisible by 2: exercises the zero-weight padding
    X = rng.rand(n, 5).astype(np.float32)
    y = (X[:, 0] - 2 * X[:, 1] + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def test_row_sharded_fit_matches_single_fit():
    """Rows split over two ranks: each level's partial histograms are
    summed with one all_reduce; the forest and the margins match the
    single fit's, the reference's and the port's."""
    from raydp_tpu.models.gbdt import fit_gbdt as ref_fit
    from raydp_tpu_torch.models.gbdt import fit_gbdt, make_bins

    X, y = _gbdt_rows()
    edges = make_bins(X, 64)
    kw = dict(num_trees=12, max_depth=4, num_bins=64, bin_edges=edges)

    def sharded(ctx, X=X, y=y, kw=kw):
        from raydp_tpu_torch.models.gbdt import fit_gbdt
        from raydp_tpu_torch.parallel import make_mesh

        model, margins, _ = fit_gbdt(
            X, y, mesh=make_mesh(device_type="cpu"), device="cpu", **kw)
        return model, margins

    ranks = _run_job("t-gbdt-rows", 2, sharded)
    plain, pred_plain, _ = fit_gbdt(X, y, device="cpu", **kw)
    ref, pred_ref, _ = ref_fit(X, y, **kw)
    for model, margins in ranks:
        assert margins.shape == (len(y),)
        for single, pred in ((plain, pred_plain),
                             (ref, np.asarray(pred_ref))):
            diff = np.mean(model.split_feature != single.split_feature)
            assert diff < SPLIT_FRACTION, f"{diff:.1%} of split nodes differ"
            np.testing.assert_allclose(margins, pred, rtol=MARGIN_RTOL,
                                       atol=MARGIN_ATOL)
    # every rank took the same splits
    assert np.array_equal(ranks[0][0].split_feature,
                          ranks[1][0].split_feature)
