"""The row-sparse table path: a table that a row-wise SGD updates takes a
sparse COO gradient of the rows its step looked up, applied inside
``optimizer.step()`` by ``ops/row_sparse.py`` (``train/step_graph.py``
``use_row_sparse``, decided once a fit in ``TorchEstimator._init_state``).

- A tiny DLRM fit under SGD puts every table on the path and ends where the
  dense path ends; every other optimizer, accumulation, a sharded table,
  a width the kernel does not take and more tables than it takes keep the
  dense path.
- The gradient is sparse, with the dense gradient's values and norm; hooks
  the user registered see it before the tables move; ``maximize`` and an
  ``lr`` changed between steps are honoured; the module and state handed
  back carry nothing of the path (the module trains under Adam), while an
  online epoch takes it again; each epoch's dispatch record counts the
  tables on each path.
- The plain update lies within f32's summation bound of the exact one.
- On the card (``-m cuda``; this file imports no JAX, so
  ``python -m pytest --noconftest -m cuda tests/test_torch_row_sparse.py``
  runs it there): the kernel at the DLRM cell's shape (26 tables, 32,768
  lookups each, zipf(1.3) ids and one id looked up 20,000 times) within
  that bound of the exact update and the same bits on two runs, and a
  captured step replayed three times equal to three eager steps.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch
import torch.nn.functional as F

from raydp_tpu_torch.data import TableDataset
from raydp_tpu_torch.models import (
    DLRM, MLP, criteo_batch_preprocessor, dlrm_param_rules,
)
from raydp_tpu_torch.models.layers import _Embed
from raydp_tpu_torch.ops import row_sparse
from raydp_tpu_torch.parallel.mesh import Mesh
from raydp_tpu_torch.train import TorchEstimator
from raydp_tpu_torch.train.step_graph import use_row_sparse

SIZES = (12, 8, 6, 14)
WIDTHS = dict(embedding_dim=8, bottom_mlp=(16, 8), top_mlp=(16, 1))
FEATURES = [f"d{i}" for i in range(13)] + [f"c{j}" for j in range(len(SIZES))]
BATCH = 64
REL = 1e-6


class _DenseSGD(torch.optim.SGD):
    """SGD's own update through the dense path: ``use_row_sparse`` takes
    exactly ``torch.optim.SGD``, so a subclass keeps every table dense."""


def _columns(n=3 * BATCH, seed=0):
    rng = np.random.RandomState(seed)
    cols = {f"d{i}": np.log1p(rng.poisson(8, n)).astype(np.float32)
            for i in range(13)}
    for j, s in enumerate(SIZES):
        cols[f"c{j}"] = rng.randint(0, s, n).astype(np.float32)
    cols["y"] = (rng.random_sample(n) < 0.25).astype(np.float32)
    return cols


def _dataset(**kw):
    return TableDataset([pa.table(_columns(**kw))])


def _batches(steps=3):
    """The first ``steps`` batches of :func:`_columns`, as DLRM's inputs."""
    cols = _columns(steps * BATCH)
    feats = torch.from_numpy(np.stack([cols[f] for f in FEATURES], 1))
    prep = criteo_batch_preprocessor()
    return [prep({"features": feats[s * BATCH:(s + 1) * BATCH],
                  "label": torch.from_numpy(cols["y"][s * BATCH:
                                                      (s + 1) * BATCH])})
            for s in range(steps)]


def _model():
    return DLRM(SIZES, device="cpu", **WIDTHS)


def _tables(model):
    return [m for m in model.modules() if isinstance(m, _Embed)]


def _fit(optimizer, model=None, epochs=1, **kw):
    model = _model() if model is None else model
    est = TorchEstimator(
        model_creator=lambda: model, optimizer=optimizer, loss="bce",
        feature_columns=FEATURES, label_column="y", batch_size=BATCH,
        num_epochs=epochs, shuffle=False,
        batch_preprocessor=criteo_batch_preprocessor(), device="cpu", **kw)
    return est, est.fit(_dataset())


def _assert_close(a: torch.nn.Module, b: torch.nn.Module) -> None:
    """Every parameter of ``a`` within ``REL`` of ``b``'s, relative."""
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        gap = float(torch.linalg.vector_norm(x.detach() - y.detach()))
        assert gap <= REL * float(torch.linalg.vector_norm(y.detach())), name


def _loss(model, inputs, labels):
    return F.binary_cross_entropy_with_logits(model(inputs).squeeze(-1),
                                              labels)


def test_an_sgd_fit_ends_where_the_dense_path_ends():
    _, sparse = _fit(lambda p: torch.optim.SGD(p, lr=0.1))
    _, dense = _fit(lambda p: _DenseSGD(p, lr=0.1))
    assert sparse.history[0]["steps"] == 3
    assert sparse.state.row_sparse == tuple(_tables(sparse.state.model))
    assert dense.state.row_sparse == ()
    assert sparse.dispatch[-1]["row_sparse_tables"] == len(SIZES)
    _assert_close(sparse.state.model, dense.state.model)
    assert sparse.history[0]["train_loss"] == pytest.approx(
        dense.history[0]["train_loss"], rel=REL)


FALLBACKS = {
    "momentum": (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9), {}),
    "weight_decay": (lambda p: torch.optim.SGD(p, lr=0.1, weight_decay=1e-4),
                     {}),
    "nesterov": (lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9,
                                           nesterov=True), {}),
    "adagrad": (lambda p: torch.optim.Adagrad(p, lr=1e-2), {}),
    "adam": (lambda p: torch.optim.Adam(p, lr=1e-3), {}),
    "accum_steps": (lambda p: torch.optim.SGD(p, lr=0.1),
                    {"accum_steps": 2}),
    # a lane of the kernel moves four columns
    "width_6": (lambda p: torch.optim.SGD(p, lr=0.1),
                {"model": DLRM(SIZES, device="cpu",
                               **{**WIDTHS, "embedding_dim": 6,
                                  "bottom_mlp": (16, 6)})}),
}


class _ManyTables(torch.nn.Module):
    """More tables than the kernel takes in one launch."""

    def __init__(self, n=row_sparse.MAX_TABLES + 1):
        super().__init__()
        self.tables = torch.nn.ModuleList(
            _Embed(4, 8, None, torch.device("cpu")) for _ in range(n))


@pytest.mark.parametrize("case", [*FALLBACKS, "sharded", "65_tables"])
def test_other_updates_keep_the_dense_path(case):
    if case == "65_tables":
        model = _ManyTables()
        assert use_row_sparse(
            model, torch.optim.SGD(model.parameters(), lr=0.1), 1) == ()
        assert not any(m.row_sparse for m in _tables(model))
        return
    if case == "sharded":
        # a rank's shard of each table (ShardedModule sets split)
        est = TorchEstimator(
            model=_model(), optimizer=lambda p: torch.optim.SGD(p, lr=0.1),
            loss="bce", feature_columns=FEATURES, label_column="y",
            batch_size=BATCH, param_rules=dlrm_param_rules("expert"),
            device="cpu")
        state = est._init_state(mesh=Mesh(dict(expert=2)))
        tables = _tables(state.model)
        assert tables and all(m.split is not None for m in tables)
        assert state.row_sparse == ()
        assert use_row_sparse(state.model, state.optimizer, 1) == ()
        assert not any(m.row_sparse for m in tables)
        return
    optimizer, kw = FALLBACKS[case]
    _, result = _fit(optimizer, **kw)
    assert result.state.row_sparse == ()
    for m in _tables(result.state.model):
        assert not m.row_sparse
        grad = m.embedding.grad
        assert grad is not None and grad.layout == torch.strided
    assert result.dispatch[-1]["row_sparse_tables"] == 0
    assert result.dispatch[-1]["dense_tables"] == len(SIZES)


def test_the_gradient_is_sparse_with_the_dense_values_and_norm():
    sparse, dense = _model(), _model()
    use_row_sparse(sparse, torch.optim.SGD(sparse.parameters(), lr=0.1), 1)
    inputs, labels = _batches(1)[0]
    for m in (sparse, dense):
        _loss(m, inputs, labels).backward()
    for a, b in zip(_tables(sparse), _tables(dense)):
        g = a.embedding.grad
        assert g.is_sparse and not g.is_coalesced() and g._nnz() == BATCH
        torch.testing.assert_close(g.to_dense(), b.embedding.grad)
        assert float(g.norm()) == pytest.approx(float(b.embedding.grad.norm()),
                                                rel=REL)


def test_user_hooks_see_the_sparse_gradient_then_the_moved_tables():
    model = _model()
    tables = [m.embedding for m in _tables(model)]
    seen = []

    def factory(params):
        opt = torch.optim.SGD(params, lr=0.1)

        def pre(o, args, kwargs):
            seen.append({"sparse": [t.grad.is_sparse for t in tables],
                         "grad": [t.grad.to_dense() for t in tables],
                         "before": [t.detach().clone() for t in tables]})

        def post(o, args, kwargs):
            seen[-1]["dropped"] = [t.grad is None for t in tables]
            seen[-1]["after"] = [t.detach().clone() for t in tables]

        opt.register_step_pre_hook(pre)
        opt.register_step_post_hook(post)
        return opt

    _fit(factory, model=model)
    assert len(seen) == 3
    for step in seen:
        assert all(step["sparse"]) and all(step["dropped"])
        for g, before, after in zip(step["grad"], step["before"],
                                    step["after"]):
            moved = g.abs().sum(1) > 0
            assert bool(moved.any())
            assert torch.equal(after[~moved], before[~moved])
            torch.testing.assert_close(after, before - 0.1 * g)


@pytest.mark.parametrize("option", ["maximize", "lr_changed"])
def test_maximize_and_a_changed_lr_are_honoured(option):
    def run(cls):
        model = _model()
        opt = cls(model.parameters(), lr=0.1, maximize=option == "maximize")
        use_row_sparse(model, opt, 1)
        for step, (inputs, labels) in enumerate(_batches(3)):
            if option == "lr_changed" and step == 2:
                for g in opt.param_groups:
                    g["lr"] = 0.03
            opt.zero_grad(set_to_none=True)
            _loss(model, inputs, labels).backward()
            opt.step()
        return model

    sparse, dense = run(torch.optim.SGD), run(_DenseSGD)
    assert all(m.row_sparse for m in _tables(sparse))
    _assert_close(sparse, dense)


def test_the_state_handed_back_carries_nothing_of_the_path():
    est, result = _fit(lambda p: torch.optim.SGD(p, lr=0.1))
    state = est.get_state()
    assert len(state.row_sparse) == len(SIZES)
    model = est.get_model()
    assert model is state.model
    assert not any(m.row_sparse for m in _tables(model))
    assert list(model.state_dict()) == list(_model().state_dict())
    # the user trains it on under Adam, which takes no sparse gradient
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    before = [m.embedding.detach().clone() for m in _tables(model)]
    for inputs, labels in _batches(2):
        opt.zero_grad(set_to_none=True)
        _loss(model, inputs, labels).backward()
        assert all(m.embedding.grad.layout == torch.strided
                   for m in _tables(model))
        opt.step()
    assert not any(torch.equal(b, m.embedding)
                   for b, m in zip(before, _tables(model)))


def test_online_epochs_take_the_path_while_they_train():
    sparse_grads = []

    def factory(params):
        opt = torch.optim.SGD(params, lr=0.1)
        opt.register_step_pre_hook(lambda o, args, kwargs: sparse_grads.append(
            sum(p.grad is not None and p.grad.is_sparse
                for g in o.param_groups for p in g["params"])))
        return opt

    est = TorchEstimator(
        model_creator=_model, optimizer=factory, loss="bce",
        feature_columns=FEATURES, label_column="y", batch_size=BATCH,
        batch_preprocessor=criteo_batch_preprocessor(), device="cpu")
    for epoch in range(2):
        assert est._partial_fit_epoch(_dataset(), epoch)["steps"] == 3
        assert not any(m.row_sparse for m in _tables(est.get_model()))
    assert sparse_grads == [len(SIZES)] * 6


@pytest.mark.parametrize("kind,counts", [("dlrm", (len(SIZES), 0)),
                                         ("mlp", (0, 0))])
def test_every_dispatch_record_counts_the_tables(kind, counts):
    if kind == "dlrm":
        _, result = _fit(lambda p: torch.optim.SGD(p, lr=0.1), epochs=2)
    else:
        cols = _columns()
        est = TorchEstimator(
            model=MLP(2, (8,), device="cpu"),
            optimizer=lambda p: torch.optim.SGD(p, lr=0.1), loss="mse",
            feature_columns=["d0", "d1"], label_column="y",
            batch_size=BATCH, num_epochs=2, device="cpu")
        result = est.fit(TableDataset([pa.table(
            {k: cols[k] for k in ("d0", "d1", "y")})]))
    assert len(result.dispatch) == 2
    for d in result.dispatch:
        assert (d["row_sparse_tables"], d["dense_tables"]) == counts


def _lookups(rows, n, hot, rng):
    """``n`` zipf(1.3) ids modulo ``rows``, the first ``hot`` of them one id
    (a run longer than any chunk)."""
    ids = (rng.zipf(1.3, n) - 1) % rows
    ids[:hot] = rows // 2
    return torch.from_numpy(ids).long()


def _exact(weights, indices, values, alphas):
    """The update in f64."""
    out = [w.double().clone() for w in weights]
    row_sparse._apply_plain(out, indices, [v.double() for v in values],
                            alphas)
    return out


def _within_bound(got, exact, indices, values, alphas) -> float:
    """The largest share of its rounding bound any element uses (an exact
    element uses none, even where its bound is 0: a weight drawn as 0.0
    that no lookup moved)."""
    bounds = row_sparse._rounding_bound(exact, indices, values, alphas)
    worst = 0.0
    for g, e, b in zip(got, exact, bounds):
        gap = (g.double() - e).abs()
        worst = max(worst, float(torch.where(gap == 0, 0.0, gap / b).max()))
    return worst


@pytest.mark.parametrize("dim", [8, 6])
def test_the_plain_update_is_within_the_rounding_bound(dim):
    rng = np.random.RandomState(dim)
    rows = [50, 1, 3000]
    weights = [torch.randn(r, dim) for r in rows]
    indices = [_lookups(r, 4000, 2500, rng) for r in rows]
    values = [torch.randn(len(i), dim) for i in indices]
    alphas = [-0.1, -0.1, 0.05]
    exact = _exact(weights, indices, values, alphas)
    got = [w.clone() for w in weights]
    row_sparse.apply_rows(got, indices, values, alphas)
    assert _within_bound(got, exact, indices, values, alphas) <= 1.0
    for w, g, i in zip(weights, got, indices):
        untouched = torch.ones(len(w), dtype=torch.bool)
        untouched[i] = False
        assert torch.equal(g[untouched], w[untouched])


@pytest.fixture
def cuda():
    # decided here, not at import: every test worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


#: the DLRM cell's step: 26 tables of 128 columns, 32,768 lookups each
CELL_TABLES, CELL_BATCH, CELL_DIM = 26, 32768, 128


def cell_inputs(device, rows=200_000, seed=0):
    """Tables, ids, gradient rows and steps at the cell's shape (tables cut
    to ``rows`` rows, a few of them to 1, 2 and 8 rows, as the cell's
    smallest are); table 0's first 20,000 lookups are one id."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [rows] * CELL_TABLES
    sizes[5], sizes[12], sizes[8] = 1, 2, 8
    weights = [torch.randn(r, CELL_DIM, device=device, generator=gen)
               for r in sizes]
    indices = [_lookups(r, CELL_BATCH, 20_000 if t == 0 else 0, rng)
               .to(device) for t, r in enumerate(sizes)]
    values = [torch.randn(CELL_BATCH, CELL_DIM, device=device, generator=gen)
              for _ in sizes]
    return weights, indices, values, [-0.1] * CELL_TABLES


@pytest.mark.cuda
def test_the_kernel_at_the_cell_shape(cuda):
    weights, indices, values, alphas = cell_inputs(cuda)
    exact = _exact(weights, indices, values, alphas)
    runs = []
    for _ in range(2):
        got = [w.clone() for w in weights]
        launches = row_sparse.LAUNCHES
        row_sparse.apply_rows(got, indices, values, alphas)
        torch.cuda.synchronize()
        assert row_sparse.LAUNCHES == launches + 1
        runs.append(got)
    # f32 sums in the kernel's order against f64: within the bound of any
    # order of summation (ops/row_sparse.py _rounding_bound)
    assert _within_bound(runs[0], exact, indices, values, alphas) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for w, g, i in zip(weights, runs[0], indices):
        untouched = torch.ones(len(w), dtype=torch.bool, device=cuda)
        untouched[i] = False
        assert torch.equal(g[untouched], w[untouched])


class _Tables(torch.nn.Module):
    """26 tables looked up by one batch, then a linear read-out."""

    def __init__(self, device, rows=5000):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(0)
        for t in range(CELL_TABLES):
            self.add_module(f"embedding_{t}",
                            _Embed(rows, CELL_DIM, torch.bfloat16, device))
        self.out = torch.nn.Linear(CELL_DIM * CELL_TABLES, 1, device=device)
        for m in self.modules():
            if isinstance(m, _Embed):
                m.reset_parameters(gen)
        with torch.no_grad():
            torch.nn.init.normal_(self.out.weight, 0.0, 0.01, generator=gen)
            self.out.bias.zero_()

    def forward(self, ids):
        rows = [getattr(self, f"embedding_{t}")(ids[:, t])
                for t in range(CELL_TABLES)]
        return self.out(torch.cat(rows, 1).float())


@pytest.mark.cuda
def test_a_captured_step_replays_as_eager_steps(cuda):
    rng = np.random.RandomState(1)
    ids = torch.stack([_lookups(5000, CELL_BATCH, 0, rng)
                       for _ in range(CELL_TABLES)], 1).to(cuda)

    def make():
        model = _Tables(cuda)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        use_row_sparse(model, opt, 1)
        assert all(m.row_sparse for m in _tables(model))

        def step():
            opt.zero_grad(set_to_none=True)
            model(ids).square().mean().backward()
            opt.step()
        return model, step

    graphed, step = make()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                       # the eager warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(3):
        graph.replay()
    eager, step = make()
    for _ in range(4):
        step()
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(graphed.named_parameters(),
                                 eager.named_parameters()):
        assert torch.equal(a, b), name
