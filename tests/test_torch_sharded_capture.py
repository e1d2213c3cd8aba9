"""Sharded steps made safe to capture as CUDA graphs, held on the CPU.

On the card a gang under ``nccl`` captures its ``k``-step chains, sharded
or replicated, with the collectives inside; under ``gloo`` every step is
eager. The capture itself runs only on the card (phase 16 of
``chip_smoke.py``); what a CPU can hold is here, on 2- and 4-rank gloo
gangs:

- (i) the capture rule, ``step_graph.graphs_allowed``, with the backend
  faked: true for a ``nccl`` gang, sharded or replicated, and for a single
  process, false for a ``gloo`` gang;
- (ii) no host read of a device value inside a sharded step: a
  ``TorchDispatchMode`` that raises on ``aten._local_scalar_dense``
  (``.item()``, ``float(t)``, a branch on a tensor) and ``aten.nonzero``
  (a shape that depends on the data) runs around every train step of
  sharded fits under ``fsdp=2`` (BatchNorm, a padded and masked tail),
  ``tensor=2``, ``expert=2`` (DLRM's row-split tables, Adagrad),
  ``stage=2`` (the GPipe schedule's exchanges) and ``fsdp=2 × tensor=2``
  (4 ranks) — what would break a capture on the card. The optimizer's
  update runs outside the guard: torch's optimizers read their step
  counters on the host on the CPU, and on the card
  ``step_graph.prepare_optimizer`` makes them capturable (Adam) or keeps
  them on the host on purpose (Adagrad), which the card's tests hold;
- (iii) for the meshes of ``test_torch_gang_sharded.py``'s ``MATRIX``,
  ``steps_per_dispatch=4`` gives train losses bitwise equal to ``k = 1``,
  both eagerly (the gloo rule) and through the ``StepRunner``'s static
  buffers (the nccl rule, taken here on the CPU, where the runner calls
  the chain on its static inputs instead of replaying a graph); and the
  chained losses are the reference's single process at the same
  ``steps_per_dispatch`` within the reference tests' rtol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)

from raydp_tpu_torch.parallel.mesh import Mesh, as_mesh_spec
from raydp_tpu_torch.train import step_graph

LOSS_RTOL = 5e-4      # the reference tests' across meshes
#: the mesh matrix of test_torch_gang_sharded.py: (spec, ranks)
MATRIX = [(dict(data=2), 2), (dict(fsdp=2), 2), (dict(tensor=2), 2),
          (dict(fsdp=2, tensor=2), 4)]
#: the ways a chain is dispatched: k=1, k=4 eager (gloo), k=4 through the
#: step runner's static buffers (the nccl rule)
MODES = {"k1": (1, False), "k4": (4, False), "k4_runner": (4, True)}
DIM = 8               # the pipeline's width
NUM_DENSE, CAT_SIZES = 4, [32, 16, 48, 64]


class HostRead(RuntimeError):
    """A device value read on the host inside a train step."""


class HostReadGuard(TorchDispatchMode):
    """Raises :class:`HostRead` on an op that copies a device value to the
    host (``aten._local_scalar_dense``) or whose output shape depends on
    the data (``aten.nonzero``); counts the ops it let through."""

    READS = ("_local_scalar_dense", "nonzero")

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten" and \
                func.overloadpacket.__name__ in self.READS:
            raise HostRead(f"{func} inside a train step: a CUDA graph "
                           f"cannot capture it")
        self.ops += 1
        return func(*args, **(kwargs or {}))


# ---- (i) the capture rule -----------------------------------------------------

@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_capture_rule_follows_the_backend_alone(monkeypatch, backend):
    """Every rank of a gang reads the same backend, so all of them capture
    or none do, sharded or replicated: nccl captures, gloo does not."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    for spec in (dict(data=2), dict(fsdp=2, tensor=2)):
        mesh = Mesh(as_mesh_spec(spec).sizes(2 * len(spec)), rank=1)
        assert step_graph.graphs_allowed(mesh) is (backend == "nccl")


def test_capture_rule_outside_a_gang():
    """A fit of one process (no mesh) may always capture: no collective."""
    assert step_graph.graphs_allowed(None) is True


def test_guard_catches_a_host_read():
    """The guard itself: ``.item()`` and ``nonzero`` raise, arithmetic
    passes."""
    x = torch.arange(4.0)
    with HostReadGuard() as guard:
        y = x * 2
        with pytest.raises(HostRead):
            y.sum().item()
        with pytest.raises(HostRead):
            torch.nonzero(y)
    assert guard.ops >= 2


# ---- the fits -------------------------------------------------------------------

def _linear_tables(n, parts, seed=0, dim=2):
    """The reference test's ``_linear_df`` rows (``dim`` 2) as ``parts``
    blocks; wider rows for the pipeline."""
    rng = np.random.RandomState(seed)
    x = rng.random_sample((n, dim))
    w = np.array([2.0, -3.0]) if dim == 2 else rng.normal(size=(dim,))
    y = x @ w + 1.0 + rng.normal(0, 0.01, n)
    data = {f"x{i + 1}": x[:, i] for i in range(dim)}
    data["y"] = y
    table = pa.table(data)
    cuts = np.linspace(0, n, parts + 1).astype(int)
    return [table.slice(a, b - a) for a, b in zip(cuts[:-1], cuts[1:])]


def _criteo_tables():
    """512 Criteo-shaped rows (test_torch_gang_sharded_models.py's shape)."""
    rng = np.random.RandomState(0)
    n = 512
    data = {"label": rng.randint(0, 2, n).astype(np.float64)}
    for i in range(NUM_DENSE):
        data[f"d{i}"] = rng.random_sample(n)
    for j, vocab in enumerate(CAT_SIZES):
        data[f"c{j}"] = rng.randint(0, vocab, n)
    table = pa.Table.from_pandas(pd.DataFrame(data), preserve_index=False)
    return [table.slice(i * 128, 128) for i in range(4)]


def _flax_variables():
    from raydp_tpu.models import MLP as JaxMLP

    return jax.tree.map(np.asarray, JaxMLP(
        features=(32, 16), use_batch_norm=False).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))


def _mlp_kw(**extra):
    return {**dict(loss="mse", feature_columns=["x1", "x2"],
                   label_column="y", batch_size=64, num_epochs=2,
                   shuffle=False, feature_dtype=np.float32), **extra}


def _mlp_estimator(init, **extra):
    """The reference's MLP(32, 16) from its Flax init, SGD 5e-2."""
    from raydp_tpu_torch.models import MLP
    from raydp_tpu_torch.train import TorchEstimator

    model = MLP(2, (32, 16), use_batch_norm=False, device="cpu")
    model.load_state_dict(init)
    return TorchEstimator(model=model,
                          optimizer=lambda p: torch.optim.SGD(p, lr=5e-2),
                          device="cpu", **_mlp_kw(**extra))


def _bn_estimator(**extra):
    """An MLP with BatchNorm (the global batch's statistics, masked on a
    padded tail), Adam."""
    from raydp_tpu_torch.models import MLP
    from raydp_tpu_torch.train import TorchEstimator

    return TorchEstimator(model=MLP(2, (32, 16), device="cpu"),
                          optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                          device="cpu", **_mlp_kw(**extra))


def _dlrm_estimator(**extra):
    """A small DLRM, its tables split by rows (``dlrm_param_rules``), the
    optax.adagrad mapping (host step counters)."""
    from raydp_tpu_torch.models import (
        DLRM, criteo_batch_preprocessor, dlrm_param_rules,
    )
    from raydp_tpu_torch.train import TorchEstimator

    model = DLRM(CAT_SIZES, num_dense=NUM_DENSE, embedding_dim=8,
                 bottom_mlp=(16, 8), top_mlp=(32, 16, 1), device="cpu")
    return TorchEstimator(
        model=model,
        optimizer=lambda p: torch.optim.Adagrad(
            p, lr=1e-2, initial_accumulator_value=0.1, eps=0.0),
        batch_preprocessor=criteo_batch_preprocessor(NUM_DENSE),
        param_rules=dlrm_param_rules("expert"), loss="bce_with_logits",
        feature_columns=[f"d{i}" for i in range(NUM_DENSE)]
        + [f"c{j}" for j in range(len(CAT_SIZES))], label_column="label",
        feature_dtype=np.float64, batch_size=64, num_epochs=2,
        shuffle=False, device="cpu", **extra)


def _pipeline_estimator(**extra):
    """A PipelineModel of four residual tanh blocks and a Dense head,
    4 microbatches a batch."""
    from raydp_tpu_torch.models.layers import _Dense, init_parameters
    from raydp_tpu_torch.train import PipelineModel, TorchEstimator

    cpu = torch.device("cpu")

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = _Dense((DIM,), (DIM,), None, cpu, use_bias=True)

        def forward(self, x):
            return x + torch.tanh(self.Dense_0(x))

    gen = torch.Generator().manual_seed(0)
    layers = [Block() for _ in range(4)]
    head = _Dense((DIM,), (1,), None, cpu, use_bias=True)
    for m in layers:
        init_parameters(m, gen)
    head.reset_parameters(gen)
    return TorchEstimator(
        model=PipelineModel(layers, head=head), loss="mse",
        feature_columns=[f"x{i + 1}" for i in range(DIM)], label_column="y",
        batch_size=64, num_epochs=2, shuffle=False, accum_steps=4,
        device="cpu", **extra)


def _fits_in_ranks(name, world, fits):
    """Each rank of a ``world``-rank gloo job runs ``fit(mesh=make_mesh(
    spec))`` for every ``(label, spec, make_estimator, tables, mode)`` in
    ``fits``, every train step under :class:`HostReadGuard`; ``mode`` picks
    ``steps_per_dispatch`` and the capture rule (``k4_runner``: the rule
    taken as under nccl). Returns rank 0's ``{label: (history, dispatch,
    ops the guard saw)}``."""
    from raydp_tpu_torch.spmd import create_spmd_job

    def run(ctx, fits=fits):
        from raydp_tpu_torch.data import TableDataset
        from raydp_tpu_torch.parallel import make_mesh
        from raydp_tpu_torch.train import torch_estimator as te

        in_place, allowed = te._in_place, te.graphs_allowed
        out = {}
        for label, spec, make, tables, mode in fits:
            k, runner = MODES[mode]
            guard = HostReadGuard()

            def guarded(train_step, state, acc, guard=guard):
                body = in_place(train_step, state, acc)
                update = state.optimizer.step

                def unguarded_update(*args, **kwargs):
                    with _disable_current_modes():
                        return update(*args, **kwargs)

                def step(batch):
                    with guard:
                        body(batch)

                state.optimizer.step = unguarded_update
                return step

            te._in_place = guarded
            if runner:
                te.graphs_allowed = lambda mesh: True
            try:
                est = make(steps_per_dispatch=k,
                           mesh=make_mesh(spec, device_type="cpu"))
                result = est.fit(TableDataset(tables))
            finally:
                te._in_place, te.graphs_allowed = in_place, allowed
            out[label] = (result.history, result.dispatch, guard.ops)
        return out

    job = create_spmd_job(name, world, torch_distributed=True, timeout=120)
    job.start()
    try:
        return job.run(run, timeout=600)[0]
    finally:
        job.stop()


@pytest.fixture(scope="module")
def reference():
    """The reference's single-process fit at steps_per_dispatch=4, and the
    Flax init the port's MLPs load."""
    import optax

    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.parallel import MeshSpec, make_mesh
    from raydp_tpu.runtime import init_runtime, shutdown_runtime
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    tables = _linear_tables(1536, 4)
    init_runtime()
    try:
        ds = DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)
        est = FlaxEstimator(
            model=JaxMLP(features=(32, 16), use_batch_norm=False),
            optimizer=optax.sgd(5e-2),
            mesh=make_mesh(MeshSpec(), devices=jax.devices()[:1]),
            steps_per_dispatch=4, **_mlp_kw())
        history = est.fit(ds).history
    finally:
        shutdown_runtime()
    from raydp_tpu_torch.models import mlp_variables_from_flax

    return {"history": history,
            "init": mlp_variables_from_flax(_flax_variables())}


@pytest.fixture(scope="module")
def fits(reference):
    """One 2-rank and one 4-rank job: every MATRIX mesh in the three modes,
    and the guard's sharded models through the runner (the nccl rule)."""
    init = reference["init"]
    tables = _linear_tables(1536, 4)

    def mlp(**kw):
        return _mlp_estimator(init, **kw)

    by_world = {2: [], 4: []}
    for spec, world in MATRIX:
        for mode in MODES:
            by_world[world].append(((str(spec), mode), spec, mlp, tables,
                                    mode))
    # the ragged tail: 1500 = 23 x 64 + 28 rows, padded and masked
    by_world[2] += [
        (("fsdp bn ragged", "k4_runner"), dict(fsdp=2),
         lambda **kw: _bn_estimator(drop_last=False, **kw),
         _linear_tables(1500, 4), "k4_runner"),
        (("expert dlrm", "k4_runner"), dict(expert=2), _dlrm_estimator,
         _criteo_tables(), "k4_runner"),
        (("stage pipeline", "k4_runner"), dict(stage=2),
         _pipeline_estimator, _linear_tables(256, 4, dim=DIM), "k4_runner"),
    ]
    out = {}
    for world, cases in by_world.items():
        out.update(_fits_in_ranks(f"t-capture-{world}", world, cases))
    return out


def _losses(history):
    return [h["train_loss"] for h in history]


GUARDED = {"fsdp=2 (BatchNorm, padded tail)": "fsdp bn ragged",
           "tensor=2": str(dict(tensor=2)),
           "expert=2 (DLRM)": "expert dlrm",
           "stage=2 (pipeline)": "stage pipeline",
           "fsdp=2 x tensor=2": str(dict(fsdp=2, tensor=2))}


@pytest.mark.parametrize("label", list(GUARDED), ids=list(GUARDED))
def test_no_host_read_inside_a_sharded_step(fits, label):
    """Every step of the sharded fit ran under the guard (which raises on a
    host read, failing the fit) through the runner's static buffers, and
    the guard saw the step's operations; the loss falls."""
    history, dispatch, ops = fits[(GUARDED[label], "k4_runner")]
    assert ops > 0
    assert sum(d["graph_replays"] for d in dispatch) > 0
    assert all(np.isfinite(_losses(history)))
    assert _losses(history)[-1] < _losses(history)[0]


@pytest.mark.parametrize("spec,ranks", MATRIX, ids=[str(s) for s, _ in MATRIX])
def test_chained_sharded_fit_is_bitwise_one_step_dispatch(reference, fits,
                                                          spec, ranks):
    """steps_per_dispatch=4 (eager under gloo, and through the runner as
    under nccl) restructures the dispatch and changes no number: train
    losses bitwise k=1's, every step run once; and the reference's single
    process at the same k within its tests' rtol."""
    one, _, _ = fits[(str(spec), "k1")]
    eager, eager_dispatch, _ = fits[(str(spec), "k4")]
    runner, runner_dispatch, _ = fits[(str(spec), "k4_runner")]
    assert _losses(eager) == _losses(one)
    assert _losses(runner) == _losses(one)
    assert all(d["graph_replays"] == 0 for d in eager_dispatch)
    # 24 steps an epoch, 6 stacks of 4: the fit's first stack eager (the
    # warm-up), every other one from the static buffers; each step once
    for d, h in zip(runner_dispatch, runner):
        assert d["graph_steps"] + d["eager_steps"] == h["steps"] == 24
    assert sum(d["graph_replays"] for d in runner_dispatch) > 0
    np.testing.assert_allclose(_losses(runner),
                               _losses(reference["history"]),
                               rtol=LOSS_RTOL)
