"""The mesh and the partition specs in the port
(:mod:`raydp_tpu_torch.parallel.mesh`, ``roles``) against the reference's,
in one process.

Specs are computed from axis sizes alone, so each is held to the
reference's on a mesh of as many virtual CPU devices
(``tests/conftest.py``): ``MeshSpec.sizes`` and its error texts; the role
policy for every leaf of ``MLP``, ``DLRM`` and ``TransformerLM`` on
``dict(fsdp=4, tensor=2)``, ``dict(fsdp=8)`` and ``dict(expert=8)`` (the
port's dotted parameter names read as the reference's slashed paths);
``param_sharding_rules`` with rules first and under
``RDT_TRAIN_SHARD_ROLES=0``; the optimizer state inheriting its
parameter's spec; ``dlrm_param_rules`` and ``transformer_param_rules``;
the refusal of an uneven explicit split; each rank's batch rows; and
``GangShardIterator(row_range=)``. A plain fit (or GBDT fit) on a world-1
mesh is bitwise the fit without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.data.feed import GangShardIterator, process_local_batch_rows
from raydp_tpu_torch.models import (
    DLRM, MLP, TransformerLM, dlrm_param_rules, transformer_param_rules,
)
from raydp_tpu_torch.parallel import (
    Mesh, MeshSpec, ShardedModule, batch_sharding, data_axes, make_mesh,
    param_sharding_rules, replicated, role_partition_spec, shard_params,
)
from raydp_tpu_torch.train import TorchEstimator

SPECS = [dict(fsdp=4, tensor=2), dict(fsdp=8), dict(expert=8)]
CAT_SIZES = [32, 16, 48, 64]


def _ref_mesh(sizes):
    from raydp_tpu.parallel import make_mesh as ref_make_mesh

    n = int(np.prod(list(sizes.values())))
    return ref_make_mesh(sizes, devices=jax.devices()[:n])


def _flat_specs(shardings):
    """The reference's shardings by the port's dotted parameter name."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    return {".".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in flat}


def _families():
    """(name, Flax params, port module) of every model family."""
    from raydp_tpu.models import DLRM as JaxDLRM
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.models import TransformerLM as JaxLM

    mlp = JaxMLP(features=(32, 16), use_batch_norm=True)
    dlrm = JaxDLRM(categorical_sizes=CAT_SIZES, num_dense=4, embedding_dim=8,
                   bottom_mlp=(16, 8), top_mlp=(32, 16, 1))
    lm = JaxLM(vocab_size=64, dim=32, num_heads=2, num_layers=2,
               attention="dense")
    key = jax.random.PRNGKey(0)
    return [
        ("mlp", mlp.init(key, jnp.zeros((1, 2)), train=False)["params"],
         MLP(2, (32, 16), device="cpu")),
        ("dlrm", dlrm.init(key, {"dense": jnp.zeros((1, 4)),
                                 "sparse": jnp.zeros((1, 4), jnp.int32)})[
            "params"],
         DLRM(CAT_SIZES, num_dense=4, embedding_dim=8, bottom_mlp=(16, 8),
              top_mlp=(32, 16, 1), device="cpu")),
        ("lm", lm.init(key, jnp.zeros((1, 8), jnp.int32))["params"],
         TransformerLM(64, dim=32, num_heads=2, num_layers=2,
                       attention="dense", device="cpu")),
    ]


def test_mesh_spec_sizes_and_errors():
    from raydp_tpu.parallel import MeshSpec as RefMeshSpec

    for kw, n in [({}, 8), (dict(fsdp=4, tensor=2), 8), (dict(data=2,
                  fsdp=2), 4), (dict(expert=2), 2), ({}, 1)]:
        assert MeshSpec(**kw).sizes(n) == RefMeshSpec(**kw).sizes(n)
    for kw, n in [(dict(fsdp=3), 8), (dict(data=2, fsdp=2), 8),
                  (dict(fsdp=2), 1)]:
        with pytest.raises(ValueError) as got:
            MeshSpec(**kw).sizes(n)
        with pytest.raises(ValueError) as want:
            RefMeshSpec(**kw).sizes(n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        make_mesh(dict(model=2))


def test_mesh_layout_matches_the_reference():
    """Axis order, data axes, the batch spec and the replicated spec; a
    world-1 mesh without a process group; ranks laid out row-major."""
    from raydp_tpu.parallel import batch_sharding as ref_batch
    from raydp_tpu.parallel.mesh import data_axes as ref_data_axes

    for sizes in SPECS + [dict(data=2, fsdp=4)]:
        ref = _ref_mesh(sizes)
        mesh = Mesh(sizes)
        assert tuple(mesh.axis_names) == tuple(ref.axis_names)
        assert data_axes(mesh) == ref_data_axes(ref)
        assert batch_sharding(mesh) == tuple(ref_batch(ref).spec)
        assert replicated(mesh) == ()
    mesh = make_mesh()
    assert mesh.size == 1 and mesh.device_mesh is None
    assert Mesh(dict(fsdp=2, tensor=2), rank=3).coords == dict(
        stage=0, data=0, fsdp=1, expert=0, seq=0, tensor=1)
    seq = dict(data=4, seq=2)
    assert batch_sharding(Mesh(seq), seq=True) == tuple(
        ref_batch(_ref_mesh(seq), seq=True).spec) == ("data", "seq")


@pytest.mark.parametrize("sizes", SPECS, ids=str)
def test_role_specs_match_the_reference_for_every_leaf(sizes):
    from raydp_tpu.parallel import param_sharding_rules as ref_rules

    ref_mesh = _ref_mesh(sizes)
    for name, params, module in _families():
        want = _flat_specs(ref_rules(ref_mesh, None)(params))
        got = param_sharding_rules(sizes)(module)
        assert got == want, name
        # the policy itself, leaf by leaf, on a path like the reference's
        for path, p in module.named_parameters():
            assert role_partition_spec(sizes, path.replace(".", "/"),
                                       tuple(p.shape)) == want[path]


def test_rules_first_then_roles_then_the_legacy_fallback(monkeypatch):
    from raydp_tpu.parallel import param_sharding_rules as ref_rules

    sizes = dict(fsdp=4, tensor=2)
    rules = [("Dense_0/kernel", (None, "tensor")), ("bias", ("fsdp",))]
    _, params, module = _families()[0]
    for roles in ("1", "0"):
        monkeypatch.setenv("RDT_TRAIN_SHARD_ROLES", roles)
        for r in (rules, None):
            want = _flat_specs(ref_rules(_ref_mesh(sizes), r)(params))
            assert param_sharding_rules(sizes, r)(module) == want
    got = param_sharding_rules(sizes, rules)(module)
    assert got["Dense_0.kernel"] == (None, "tensor")
    assert got["Dense_1.bias"] == ("fsdp",)
    # the fallback: fsdp on the largest divisible dim, tensor unused
    assert got["Dense_1.kernel"] == ("fsdp", None)


def test_optimizer_state_inherits_param_specs():
    """Adam's moments mirror their parameters, so they take the same spec:
    in the specs of a (module, optimizer) pair and in the sharded state's
    checkpoint layout, where the step counters stay whole."""
    sizes = dict(fsdp=4, tensor=2)
    model = MLP(2, (32, 16), use_batch_norm=False, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    specs = param_sharding_rules(sizes)((model, opt))
    for name, _ in model.named_parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            assert specs[f"optimizer/state/{name}/{k}"] == specs[name]
        assert specs[f"optimizer/state/{name}/step"] == ()
    assert any(any(e is not None for e in s) for s in specs.values())

    sm = ShardedModule(MLP(2, (32, 16), use_batch_norm=False, device="cpu"),
                       Mesh(sizes, rank=5))
    opt = torch.optim.Adam(sm.parameters(), lr=1e-3)
    for p in sm.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    layout = sm.tensor_specs(opt)
    assert layout["['optimizer']['state'][2]['exp_avg']"] \
        == layout["['model']['Dense_1.kernel']"] == ("fsdp", "tensor")
    assert "['optimizer']['state'][2]['step']" not in layout
    # rank 5 = (fsdp 2, tensor 1): its block of Dense_1's (32, 16) kernel
    assert tuple(sm.module.Dense_1.kernel.shape) == (8, 8)


def test_dlrm_and_transformer_rules_are_the_reference_s():
    from raydp_tpu.models import dlrm_param_rules as ref_dlrm
    from raydp_tpu.models import transformer_param_rules as ref_tp

    for axis in ("expert", "fsdp"):
        assert dlrm_param_rules(axis) == ref_dlrm(axis)
    assert transformer_param_rules("tensor") == ref_tp("tensor")
    specs = param_sharding_rules(dict(tensor=2),
                                 transformer_param_rules("tensor"))(
        _families()[2][2])
    assert specs["block_1.attn.q.kernel"] == (None, "tensor", None)
    assert specs["block_0.attn.o.kernel"] == ("tensor", None, None)
    assert specs["embed.embedding"] == (None, "tensor")
    assert specs["block_0.ln1.scale"] == ()


def test_uneven_explicit_split_is_refused():
    """A 1,001-row table under dlrm_param_rules on expert=2 raises, as the
    reference's device_put does; the role policy degrades instead."""
    from raydp_tpu.parallel import shard_params as ref_shard

    table = {"embedding_0": {"embedding": np.zeros((1001, 8), np.float32)}}
    with pytest.raises(ValueError):
        ref_shard(table, _ref_mesh(dict(expert=2)), ref_dlrm_rules())
    with pytest.raises(ValueError, match="does not divide"):
        shard_params({"embedding_0.embedding": torch.zeros(1001, 8)},
                     Mesh(dict(expert=2)), dlrm_param_rules("expert"))
    with pytest.raises(ValueError, match="does not divide"):
        ShardedModule(DLRM([1001, 16], num_dense=4, embedding_dim=8,
                           bottom_mlp=(16, 8), top_mlp=(8, 1), device="cpu"),
                      Mesh(dict(expert=2)), dlrm_param_rules("expert"))
    assert role_partition_spec(dict(fsdp=2), "embedding_0/embedding",
                               (1001, 8)) == (None, None)
    half = shard_params({"embedding_0.embedding": torch.arange(
        1002.).reshape(1002, 1)}, Mesh(dict(expert=2), rank=1),
        dlrm_param_rules("expert"))["embedding_0.embedding"]
    assert half.shape == (501, 1) and half[0, 0] == 501


def ref_dlrm_rules():
    from raydp_tpu.models import dlrm_param_rules as ref_dlrm

    return ref_dlrm("expert")


def test_process_local_batch_rows():
    """A world-1 mesh feeds the whole batch; over a mesh's ranks the
    blocks cover the batch once when data × fsdp split it, and every rank
    feeds the whole batch when only expert or tensor ranks do."""
    assert process_local_batch_rows(make_mesh(MeshSpec()), 64) == (0, 64)
    for sizes in (dict(fsdp=8), dict(expert=8), dict(data=2, fsdp=4),
                  dict(fsdp=2, tensor=2)):
        n = int(np.prod(list(sizes.values())))
        rows = [process_local_batch_rows(Mesh(sizes, r), 64)
                for r in range(n)]
        if "expert" in sizes:
            assert rows == [(0, 64)] * n
        else:
            split = n // sizes.get("tensor", 1)
            assert sorted(set(rows)) == [(i * 64 // split,
                                          (i + 1) * 64 // split)
                                         for i in range(split)]
    with pytest.raises(ValueError, match="not divisible"):
        process_local_batch_rows(Mesh(dict(fsdp=3)), 64)


def test_gang_iterator_explicit_row_range():
    """row_range=(0, B) on every rank = full-batch replication semantics
    (the reference test's case)."""
    rows = np.arange(32, dtype=np.float64)

    class _Ds:
        def block_sizes(self):
            return [32]

        def get_block(self, i, zero_copy=False):
            return pa.table({"x": rows})

    for rank in (0, 1):
        it = GangShardIterator(_Ds(), global_batch=16, world_size=2,
                               rank=rank, columns={"x": ("x", np.float64)},
                               row_range=(0, 16))
        batches = list(it)
        assert [b["x"].shape for b in batches] == [(16,), (16,)]
        np.testing.assert_array_equal(batches[0]["x"], rows[:16])
    with pytest.raises(ValueError, match="out of range"):
        GangShardIterator(_Ds(), 16, 2, 0, {"x": ("x", np.float64)},
                          row_range=(8, 24))


def _tables(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.random_sample((n, 2)).astype(np.float32)
    y = (x @ np.array([2.0, -3.0], np.float32) + 1.0).astype(np.float32)
    return [pa.table({"x1": x[:, 0], "x2": x[:, 1], "y": y})]


def _estimator(**kw):
    return TorchEstimator(
        model=MLP(2, (16,), device="cpu"), loss="mse",
        feature_columns=["x1", "x2"], label_column="y", batch_size=32,
        num_epochs=2, device="cpu", seed=0, **kw)


def test_plain_fit_with_a_sharded_spec_raises():
    from raydp_tpu.parallel import MeshSpec as RefMeshSpec

    with pytest.raises(ValueError) as got:
        _estimator(mesh_spec=dict(fsdp=2)).fit(TableDataset(_tables(128)))
    with pytest.raises(ValueError) as want:
        RefMeshSpec(fsdp=2).sizes(1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("how", ["mesh_spec", "dict", "mesh"])
def test_world1_mesh_fit_is_bitwise_a_fit_without_one(how):
    """MeshSpec(), a dict of ones, or make_mesh()'s world-1 mesh: the
    same fit, bit for bit (resident and streaming eval alike)."""
    kw = {"mesh_spec": dict(mesh_spec=MeshSpec()),
          "dict": dict(mesh_spec=dict(fsdp=1, tensor=1)),
          "mesh": dict(mesh=make_mesh())}[how]
    train, evals = TableDataset(_tables(160)), TableDataset(_tables(70, 1))
    plain = _estimator().fit(train, evals)
    meshed = _estimator(**kw).fit(train, evals)
    for a, b in zip(plain.history, meshed.history):
        assert a["train_loss"] == b["train_loss"]
        assert a["eval_loss"] == b["eval_loss"]
    for (k, a), b in zip(plain.state.model.state_dict().items(),
                         meshed.state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_world1_mesh_gbdt_is_bitwise_the_unsharded_fit():
    from raydp_tpu_torch.models.gbdt import fit_gbdt

    rng = np.random.RandomState(2)
    X = rng.rand(501, 4).astype(np.float32)
    y = (X[:, 0] - X[:, 2]).astype(np.float32)
    a, pa_, _ = fit_gbdt(X, y, num_trees=4, max_depth=3, num_bins=16,
                         device="cpu")
    b, pb, _ = fit_gbdt(X, y, num_trees=4, max_depth=3, num_bins=16,
                        device="cpu", mesh=make_mesh())
    assert np.array_equal(pa_, pb)
    for n in ("split_feature", "split_bin", "leaf_value"):
        assert np.array_equal(getattr(a, n), getattr(b, n))
