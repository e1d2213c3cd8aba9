"""Gang training in the port (``TorchEstimator.fit_gang``) against the
reference's SINGLE-PROCESS ``FlaxEstimator.fit``, on the CPU.

The reference's own gang test (``tests/test_gang_train.py``) holds its gang
against its single process, and its eval losses break that: its gang
iterator drops the ragged eval tail (ROADMAP queue 3). The port's gang pads
and masks the tail, so it is held to the single-process fit, which
evaluates every row: the same data (``_linear_df(n=2048, parts=4)``, split
0.75/0.25 with seed 1), the same model and optimizer, started from the
Flax init that ``FlaxEstimator`` draws, carried across with
``mlp_variables_from_flax``.

The reference's session runs first and is stopped; the port's runtime then
holds the same blocks in its object store (the two runtimes never run at
once). The gang's ranks are real subprocesses (2 of them, ``gloo``, the
CPU), as the reference's are.

- (i) the reference test's case: ``MLP(16)`` without BatchNorm, Adam 1e-2,
  mse, batch 64, 3 epochs, the gang chaining ``steps_per_dispatch=2``.
  Against the port's single-process ``fit`` the train and eval losses hold
  the reference test's own rtol 2e-5 (the gang against one process of the
  same framework; measured 1.4e-7 and 5.2e-7). Against the reference's
  single process they hold rtol 5e-5: the port's single-process fit is
  itself 2.41e-5 (train) and 1.88e-5 (eval) from it here, because
  ``torch.optim.Adam`` rounds its update other than ``optax.adam`` (one ulp
  of a parameter a step on identical gradients), which Adam at 1e-2 carries
  over 72 steps. The first kernel holds rtol 1e-4 / atol 1e-5;
- (ii) ``NYCTaxiModel`` (BatchNorm: the statistics of the global batch,
  reduced across the ranks) on ``test_torch_estimator.py``'s
  ``test_fit_matches_flax_estimator`` case (five features, smooth L1, Adam
  1e-3, three metrics) at that test's tolerance, 5e-4, for the losses and
  every metric (measured 5e-6). On (i)'s linear data at Adam 1e-2 a
  BatchNorm model is chaotic: the gradient of a bias below a BatchNorm is
  zero but for rounding, and Adam turns its sign into whole steps, so even
  the port's single process is 2 % (train) and 30 % (eval) from the
  reference there;
- (iii) a rank that dies at epoch 1 restarts the gang, which resumes from
  the checkpoint: history ``[0, 1, 2, 3]``;
- (iv)-(vii) :class:`GangShardIterator`: an indivisible batch raises, the
  rows are covered once, an over-cap iterator decodes slices, and the
  padded eval tail's masks count exactly the eval rows;
- (viii) ``fit_on_frame(num_workers=2)`` from the port's ETL session;
- BatchNorm across two ranks is BatchNorm over the global batch, and a
  plain ``fit`` inside a rank of a process group is no gang fit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from raydp_tpu_torch.data.feed import MASK_KEY, GangShardIterator
from raydp_tpu_torch.models import MLP, NYCTaxiModel, mlp_variables_from_flax
from raydp_tpu_torch.train import TorchEstimator

LOSS_RTOL = 2e-5            # the reference test's, train and eval
REF_RTOL = 5e-5             # (i) against the reference: see the docstring
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
BATCH_NORM_RTOL = 5e-4      # test_torch_estimator.py's EPOCH_RTOL
NYC_FEATURES = [f"f{i}" for i in range(5)]
SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")


def _linear_pdf(n=2048):
    """The reference test's ``_linear_df`` rows."""
    rng = np.random.RandomState(0)
    x = rng.random_sample((n, 2))
    y = x @ np.array([2.0, -3.0]) + 1.0 + rng.normal(0, 0.01, n)
    return pd.DataFrame({"x1": x[:, 0], "x2": x[:, 1], "y": y})


def _nyc_tables(sizes, seed):
    """``test_torch_estimator.py``'s ``_tables``: five features, a centred
    nonlinear label."""
    rng = np.random.RandomState(seed)
    w = np.array([1.5, -2.0, 0.5, 3.0, -1.0], np.float32)
    out = []
    for n in sizes:
        x = (rng.randn(n, 5) * [1, 2, 0.5, 1, 3]
             + [0, 1, -1, 2, 0]).astype(np.float32)
        y = (x @ w + 0.3 * np.sin(3 * x[:, 0]) + 0.1 * rng.randn(n)
             - 2.5).astype(np.float32)
        out.append(pa.table({**{f: x[:, i] for i, f in enumerate(NYC_FEATURES)},
                             "y": y}))
    return out


def _flax_model(case):
    from raydp_tpu.models import MLP as JaxMLP
    from raydp_tpu.models import NYCTaxiModel as JaxNYC

    return JaxMLP(features=(16,), use_batch_norm=False) if case == "mlp" \
        else JaxNYC()


def _port_model(case):
    """The port's model holding the Flax init ``FlaxEstimator`` draws
    (``PRNGKey(0)``)."""
    width = 2 if case == "mlp" else len(NYC_FEATURES)
    variables = jax.tree.map(np.asarray, _flax_model(case).init(
        jax.random.PRNGKey(0), jnp.zeros((1, width)), train=False))
    tm = MLP(2, (16,), use_batch_norm=False, device="cpu") if case == "mlp" \
        else NYCTaxiModel(width, device="cpu")
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return tm


def _kw(case="mlp", num_epochs=3, **extra):
    """Both estimators' arguments for ``case`` (the optimizer aside)."""
    if case == "mlp":
        kw = dict(loss="mse", feature_columns=["x1", "x2"])
    else:
        kw = dict(loss="smooth_l1", feature_columns=NYC_FEATURES,
                  metrics=["mse", "mae", "rmse"])
    return dict(label_column="y", batch_size=64, num_epochs=num_epochs,
                shuffle=False, **kw, **extra)


def _port_estimator(case, ckpt_dir, **extra):
    lr = 1e-2 if case == "mlp" else 1e-3
    return TorchEstimator(
        model=_port_model(case),
        optimizer=lambda p: torch.optim.Adam(p, lr=lr),
        checkpoint_dir=ckpt_dir, device="cpu", **_kw(case, **extra))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's single-process fits of both cases, and the blocks
    of its train and test splits."""
    import optax

    import raydp_tpu
    from raydp_tpu.data.dataset import BlockMeta, DistributedDataset
    from raydp_tpu.data.dataset import from_frame
    from raydp_tpu.runtime.object_store import get_client
    from raydp_tpu.train import FlaxEstimator

    def ref_dataset(tables):
        return DistributedDataset(
            [BlockMeta(num_rows=t.num_rows, ref=get_client().put_arrow(t))
             for t in tables], tables[0].schema)

    tmp = tmp_path_factory.mktemp("gang-ref")
    session = raydp_tpu.init("pytest-gang-ref", **SESSION)
    try:
        df = session.createDataFrame(_linear_pdf(), num_partitions=4)
        train_df, test_df = df.randomSplit([0.75, 0.25], seed=1)
        out = {"mlp": [from_frame(train_df), from_frame(test_df)],
               "nyctaxi": [ref_dataset(_nyc_tables((400, 333, 291), 0)),
                           ref_dataset(_nyc_tables((150, 53), 1))]}
        for case, lr in (("mlp", 1e-2), ("nyctaxi", 1e-3)):
            train_ds, test_ds = out[case]
            est = FlaxEstimator(model=_flax_model(case),
                                optimizer=optax.adam(lr),
                                checkpoint_dir=str(tmp / case), **_kw(case))
            result = est.fit(train_ds, test_ds)
            out[case] = {
                "blocks": [[ds.get_block(i) for i in range(ds.num_blocks())]
                           for ds in (train_ds, test_ds)],
                "history": result.history,
                "kernel": np.asarray(
                    est.get_model()["params"]["Dense_0"]["kernel"])}
    finally:
        raydp_tpu.stop()
    return out


@pytest.fixture(scope="module")
def port_runtime(reference):
    """The port's runtime, after the reference's session stopped."""
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


def _assert_histories(got, want, keys, rtol, what):
    for key in keys:
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=rtol,
                                   err_msg=f"{key} against {what}")


@pytest.mark.parametrize("case", ["mlp", "nyctaxi"])
def test_gang_losses_match_the_reference_single_process(
        reference, port_runtime, tmp_path, case):
    train, test = (_store_dataset(b) for b in reference[case]["blocks"])
    # the gang additionally chains (a 2-step chain per dispatch): matching
    # the unchained single process holds the chain too
    est = _port_estimator(case, str(tmp_path / "gang"),
                          steps_per_dispatch=2)
    result = est.fit_gang(train, test, num_workers=2, run_timeout=600.0)
    want = reference[case]["history"]
    assert [h["epoch"] for h in result.history] == [0, 1, 2]
    steps = want[0]["steps"]
    assert [h["steps"] for h in result.history] \
        == [h["steps"] for h in want] == [steps] * 3
    if case == "mlp":
        single = _port_estimator(case, str(tmp_path / "single")).fit(
            train, test).history
        _assert_histories(result.history, single,
                           ("train_loss", "eval_loss"), LOSS_RTOL,
                           "the port's single process")
        _assert_histories(result.history, want, ("train_loss", "eval_loss"),
                          REF_RTOL, "the reference's single process")
        np.testing.assert_allclose(
            est.get_model().state_dict()["Dense_0.kernel"].numpy(),
            reference[case]["kernel"], rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    else:
        keys = [f"{side}_{m}" for side in ("train", "eval")
                for m in ("loss", "mse", "mae", "rmse")]
        _assert_histories(result.history, want, keys, BATCH_NORM_RTOL,
                          "the reference's single process")
    # gloo: every step eager, no graph
    assert all(d["graph_replays"] == 0 and d["eager_steps"] == steps
               for d in result.dispatch)
    # the driver holds the chief's model: predict is a plain forward of it
    columns = _kw(case)["feature_columns"]
    x = np.concatenate([np.stack([t[c].to_numpy() for c in columns], 1)
                        for t in reference[case]["blocks"][1]])
    with torch.no_grad():
        plain = est.get_model()(torch.tensor(x, dtype=torch.float32))[:, 0]
    np.testing.assert_allclose(est.predict(test), plain.numpy(), atol=1e-6)


def test_gang_rank_failure_restarts_from_checkpoint(port_runtime, tmp_path):
    """Rank 1 dies at epoch 1, once; the gang restarts and resumes from the
    checkpoint rank 0 wrote (no epoch twice, none missing)."""
    import raydp_tpu_torch.train.checkpoint as ckpt

    flag = str(tmp_path / "crashed-once")

    def crash_once(report):
        import torch.distributed as dist

        if (report["epoch"] == 1 and dist.get_rank() == 1
                and not os.path.exists(flag)):
            open(flag, "w").close()
            os._exit(1)

    table = pa.Table.from_pandas(_linear_pdf(1024), preserve_index=False)
    ds = _store_dataset([table.slice(0, 512), table.slice(512)])
    est = _port_estimator("mlp", str(tmp_path / "ck"), num_epochs=4,
                          callbacks=[crash_once])
    result = est.fit_gang(ds, num_workers=2, max_retries=1,
                          run_timeout=600.0)
    assert os.path.exists(flag), "the injected crash never fired"
    assert [h["epoch"] for h in result.history] == [0, 1, 2, 3]
    # the resumed gang picked up the model AND the optimizer's moments:
    # its losses are an uninterrupted single process's
    single = _port_estimator("mlp", str(tmp_path / "single"),
                             num_epochs=4).fit(ds)
    _assert_histories(result.history, single.history, ("train_loss",),
                      LOSS_RTOL, "an uninterrupted single process")
    # at least one pre-crash epoch came from the restore
    assert ckpt.restore_extra(str(tmp_path / "ck"))["history"]
    # the second gang ran the epochs after the last checkpoint only: rank
    # 0 may have written epoch 1's before it saw rank 1 gone
    assert [d["epoch"] for d in result.dispatch] in ([1, 2, 3], [2, 3])


def test_fit_inside_a_process_group_is_no_gang_fit(port_runtime, tmp_path):
    """Only ``fit_gang``'s ranks train as a gang: a plain ``fit`` in each
    rank of a 2-rank process group (a sweep, one fit a rank) trains alone.
    The two fits take different step counts (a gang step would wait for
    the other rank's all-reduce), keep their BatchNorm statistics local
    (each equals the same fit outside any group) and write their own
    checkpoints."""
    from raydp_tpu_torch.spmd import create_spmd_job

    table = pa.Table.from_pandas(_linear_pdf(768), preserve_index=False)
    ds = _store_dataset([table.slice(0, 384), table.slice(384)])
    payload = ds.portable()
    root = str(tmp_path)

    def estimator(rank, ckpt_dir):
        est = TorchEstimator(
            model=NYCTaxiModel(2, device="cpu"), device="cpu",
            optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
            checkpoint_dir=ckpt_dir,
            **{**_kw("mlp", num_epochs=1 + rank), "batch_size": 64 * (1 + rank)})
        return est

    def own_fit(ctx, payload=payload, root=root):
        from raydp_tpu_torch.data.dataset import DistributedDataset

        ds = DistributedDataset.from_portable(payload)
        ckpt_dir = os.path.join(root, f"rank{ctx.rank}")
        result = estimator(ctx.rank, ckpt_dir).fit(ds)
        return ([h["train_loss"] for h in result.history],
                sorted(os.listdir(ckpt_dir)))

    job = create_spmd_job("t-own-fit", 2, torch_distributed=True, timeout=120)
    job.start()
    try:
        ranks = job.run(own_fit, timeout=300)
    finally:
        job.stop()
    for rank, (losses, steps) in enumerate(ranks):
        alone = estimator(rank, os.path.join(root, f"alone{rank}")).fit(ds)
        np.testing.assert_allclose(
            losses, [h["train_loss"] for h in alone.history], rtol=1e-5)
        assert steps == [f"step_{e}" for e in range(rank + 1)]


def test_gang_rejects_indivisible_batch():
    class _FakeDs:
        def block_sizes(self):
            return [10, 10]

    with pytest.raises(ValueError, match="divisible"):
        GangShardIterator(_FakeDs(), global_batch=10, world_size=3, rank=0,
                          columns={"x": ("x", np.float32)})


def _blocks_ds(sizes):
    rows = np.arange(sum(sizes), dtype=np.float64)
    blocks, start = [], 0
    for s in sizes:
        blocks.append(pa.table({"x": rows[start:start + s]}))
        start += s

    class _Ds:
        def block_sizes(self):
            return sizes

        def get_block(self, i, zero_copy=False):
            return blocks[i]

    return _Ds()


def test_gang_iterator_covers_rows_exactly_once():
    """_runs boundary math: every global batch row is read exactly once per
    epoch, across uneven block boundaries and both ranks."""
    ds = _blocks_ds([7, 13, 5, 22, 1])          # total 48
    got = []
    for rank in (0, 1):
        it = GangShardIterator(ds, global_batch=16, world_size=2,
                               rank=rank, columns={"x": ("x", np.float64)})
        assert len(it) == 3
        for batch in it:
            assert batch["x"].shape == (8,)
            got.extend(batch["x"].tolist())
    assert sorted(got) == list(range(48))


def test_gang_iterator_over_cap_decodes_slices_not_blocks(monkeypatch):
    """A block that exceeds the RDT_FEED_CACHE_MB budget is never decoded
    whole per batch: the iterator slices the Arrow table to the requested
    rows first, so over-cap feeds pay O(batch) decode work."""
    rows = np.arange(64, dtype=np.float64)
    table = pa.table({"x": rows})
    log = []

    class _SpyTable:
        def slice(self, off, n):
            log.append(("slice", off, n))
            return table.slice(off, n)

        def column(self, c):
            log.append(("full-decode", c))
            return table.column(c)

    class _Ds:
        def block_sizes(self):
            return [64]

        def get_block(self, i, zero_copy=False):
            return _SpyTable()

    def run():
        log.clear()
        it = GangShardIterator(_Ds(), global_batch=16, world_size=2, rank=0,
                               columns={"x": ("x", np.float64)})
        return np.concatenate([b["x"].copy() for b in it])

    monkeypatch.setenv("RDT_FEED_CACHE_MB", "0")   # block can never cache
    over = run()
    assert all(kind == "slice" for kind, *_ in log), log
    assert len(log) == 4                            # one slice per batch

    monkeypatch.setenv("RDT_FEED_CACHE_MB", "64")  # block caches on first use
    under = run()
    assert ("full-decode", "x") in log
    assert sum(1 for kind, *_ in log if kind == "full-decode") == 1
    np.testing.assert_array_equal(over, under)      # same rows either way


@pytest.mark.parametrize("sizes", [[7, 13, 5, 22, 1, 5], [20, 1], [16, 16]])
def test_padded_eval_tail_masks_count_the_eval_rows(sizes):
    """Over all ranks, the padded tail's masks count exactly the dataset's
    rows, the real rows are every row once, and pad rows are zeros; every
    batch has the rank's full slice and a mask."""
    ds = _blocks_ds(sizes)
    total = sum(sizes)
    real, masks = [], 0.0
    for rank in (0, 1):
        it = GangShardIterator(ds, global_batch=16, world_size=2, rank=rank,
                               columns={"x": ("x", np.float64)},
                               pad_remainder=True)
        assert len(it) == -(-total // 16)
        for batch in it:
            assert batch["x"].shape == batch[MASK_KEY].shape == (8,)
            keep = batch[MASK_KEY] > 0
            assert not batch["x"][~keep].any()
            real.extend(batch["x"][keep].tolist())
            masks += float(batch[MASK_KEY].sum())
    assert masks == total
    assert sorted(real) == list(range(total))


def test_fit_on_frame_trains_a_gang(tmp_path):
    """``fit_on_frame(num_workers=2)`` from the port's ETL session: the
    engine shuffles the train frame once (a gang always streams), two CPU
    ranks train, every eval row counts, and predict works afterwards."""
    import raydp_tpu_torch
    from raydp_tpu_torch.data.dataset import DistributedDataset, from_frame

    seeds = []
    real = DistributedDataset.random_shuffle

    def counted(self, seed=None):
        seeds.append(seed)
        return real(self, seed=seed)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DistributedDataset, "random_shuffle", counted)
        session = raydp_tpu_torch.init("pytest-gang-frame", **SESSION)
        try:
            df = session.createDataFrame(_linear_pdf(1500), num_partitions=3)
            train_df, test_df = df.randomSplit([0.8, 0.2], seed=1)
            est = TorchEstimator(
                model=NYCTaxiModel(2, device="cpu"), device="cpu",
                optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                checkpoint_dir=str(tmp_path / "ck"),
                **{**_kw("mlp", num_epochs=2), "shuffle": True, "seed": 3})
            result = est.fit_on_frame(train_df, test_df, num_workers=2)
            test = from_frame(test_df)
            preds = est.predict(test)
            n_test = test.count()
        finally:
            raydp_tpu_torch.stop()
    losses = [h["train_loss"] for h in result.history]
    assert seeds == [3]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert all(np.isfinite(h["eval_loss"]) for h in result.history)
    assert preds.shape == (n_test,) and np.isfinite(preds).all()


# ---------------------------------------------------------------------------
# BatchNorm across the gang
# ---------------------------------------------------------------------------

def _bn_step(x, share=1.0, global_stats=False):
    """One BatchNorm forward/backward: (loss, input grad, scale grad,
    running mean, running var)."""
    from raydp_tpu_torch.models.layers import BatchNorm
    from raydp_tpu_torch.parallel import gang

    bn = BatchNorm(x.shape[-1], None, torch.device("cpu"))
    if global_stats:
        gang.sync_batchnorm(bn)
    with torch.no_grad():
        bn.scale.mul_(1.5)
        bn.bias.add_(0.1)
    xx = x.clone().requires_grad_(True)
    y = bn(xx)
    loss = (y ** 3).mean(-1).mean() * share
    loss.backward()
    return (loss.item(), xx.grad, bn.scale.grad, bn.mean.clone(),
            bn.var.clone())


def test_batch_norm_across_two_ranks_is_the_global_batch_s():
    """Two ranks holding halves of a batch move BatchNorm exactly as one
    process over the whole batch: the loss, every input gradient, the
    parameter gradient (summed across the ranks) and the running
    statistics, to f32 rounding."""
    from raydp_tpu_torch.spmd import create_spmd_job

    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    whole = _bn_step(x)

    def halves(ctx, x=x):
        import torch.distributed as dist

        loss, gx, gs, mean, var = _bn_step(x[ctx.rank * 32:][:32],
                                           share=0.5, global_stats=True)
        dist.all_reduce(gs)
        return loss, gx, gs, mean, var

    job = create_spmd_job("t-bn", 2, torch_distributed=True, timeout=120)
    job.start()
    try:
        ranks = job.run(halves, timeout=120)
    finally:
        job.stop()
    assert ranks[0][0] + ranks[1][0] == pytest.approx(whole[0], rel=1e-6)
    torch.testing.assert_close(torch.cat([ranks[0][1], ranks[1][1]]),
                               whole[1], rtol=1e-5, atol=1e-6)
    for r in ranks:
        for got, want in zip(r[2:], whole[2:]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
