"""The port's continuous pipelines (``raydp_tpu_torch.stream``, a copy of
``raydp_tpu.stream`` over the port's ETL engine and object store) and
``TorchEstimator.partial_fit``, against the reference on the CPU.

The sources run without a session: the same epochs, the same replays and
the same retention as the reference's. The pipeline cases of
``tests/test_stream.py`` that need no Keras run through each package's ETL
session (2 executors × 1 core × 512MB): the reference's first, stopped,
then the port's, and their epochs, windows, ledger consumers and reports
must be equal. ``partial_fit`` starts both estimators from the Flax init
and trains the same stream epochs; the per-epoch losses agree within
``EPOCH_RTOL`` (5e-4, ``test_torch_estimator.py``: f32 sums in another
order, carried by Adam); its export cadence writes the same servables, and
on the port's session hot-swaps them into a live serving session.
"""

import os
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pyarrow as pa
import pytest
import torch

from raydp_tpu import stream as ref_stream
from raydp_tpu_torch import stream as port_stream
from raydp_tpu_torch.models import MLP, mlp_variables_from_flax
from raydp_tpu_torch.train import TorchEstimator

EPOCH_RTOL = 5e-4
SESSION = dict(num_executors=2, executor_cores=1, executor_memory="512MB")
ONLINE_EPOCHS = 3
STREAMS = {"ref": ref_stream, "port": port_stream}


def _table(seed, rows=32, keys=4):
    rng = np.random.RandomState(seed)
    return pa.table({
        "k": rng.randint(0, keys, rows),
        "v": rng.randint(0, 100, rows).astype(np.int64),
    })


def _reg_table(epoch, rows=70):
    """64 rows and a ragged 6-row tail at batch 32."""
    rng = np.random.RandomState(epoch)
    x = rng.random_sample((rows, 2))
    y = x @ np.array([2.0, -3.0]) + 1.0
    return pa.table({"x1": x[:, 0], "x2": x[:, 1], "y": y})


# ---------------------------------------------------------------------------
# sources (no session)
# ---------------------------------------------------------------------------

def _drain(src):
    out = []
    while True:
        mb = src.next_batch(timeout_s=0.1)
        if mb is None:
            return out
        out.append(mb)


def _replays(src, epochs):
    out = []
    for e in epochs:
        try:
            out.append(src.replay(e))
        except Exception as err:  # noqa: BLE001 - compared across packages
            out.append((type(err).__name__, str(err)))
    return out


@pytest.mark.parametrize("case", ["synthetic", "retention", "replay_log"])
def test_sources_equal_the_reference(monkeypatch, case):
    if case == "retention":
        monkeypatch.setenv("RDT_STREAM_RETAIN", "3")
    got = {}
    for side, mod in STREAMS.items():
        if case == "replay_log":
            src = mod.ReplayLogSource([_table(i, rows=8) for i in range(3)])
        else:
            src = mod.SyntheticSource(_table, max_epochs=5 if case ==
                                      "synthetic" else 6)
        batches = _drain(src)
        got[side] = {
            "epochs": [mb.epoch for mb in batches],
            "tables": [mb.table for mb in batches],
            "exhausted": src.exhausted, "emitted": src.epochs_emitted,
            "journal": sorted(src._journal),
            "replays": _replays(src, [0, 1, 2, 5, 7])}
    ref, port = got["ref"], got["port"]
    assert port["epochs"] == ref["epochs"] and port["exhausted"]
    assert port["emitted"] == ref["emitted"]
    assert port["journal"] == ref["journal"]
    assert all(a.equals(b) for a, b in zip(port["tables"], ref["tables"]))
    for a, b in zip(port["replays"], ref["replays"]):
        assert a == b if isinstance(b, tuple) else a.equals(b)


def test_file_tail_source_equals_the_reference(tmp_path):
    import pyarrow.parquet as pq

    pq.write_table(_table(0, rows=10), str(tmp_path / "a0.parquet"))
    pq.write_table(_table(1, rows=4), str(tmp_path / "a1.parquet"))
    got = {}
    for side, mod in STREAMS.items():
        src = mod.FileTailSource(str(tmp_path), rows_per_batch=4)
        got[side] = (src, _drain(src))
    (ref_src, ref), (port_src, port) = got["ref"], got["port"]
    assert [b.table.num_rows for b in port] == \
        [b.table.num_rows for b in ref] == [4, 4, 2, 4]
    for a, b in zip(port, ref):
        assert a.epoch == b.epoch and a.table.equals(b.table)
        assert port_src.replay(a.epoch).equals(ref_src.replay(b.epoch))
    # a file appearing later is picked up by the next poll of both
    pq.write_table(_table(2, rows=3), str(tmp_path / "a2.parquet"))
    a = port_src.next_batch(timeout_s=2.0)
    b = ref_src.next_batch(timeout_s=2.0)
    assert a.epoch == b.epoch == 4 and a.table.equals(b.table)


# ---------------------------------------------------------------------------
# pipelines and partial_fit, through each package's session
# ---------------------------------------------------------------------------

def _settles(client, count, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if client.stats()["num_objects"] == count:
            return True
        time.sleep(0.1)
    return client.stats()["num_objects"] == count


def _frames(tables):
    return [t.to_pandas() for t in tables]


def _estimator(side, **kw):
    """Each package's estimator over a Flax MLP(8)'s init (the init
    ``FlaxEstimator`` draws from ``PRNGKey(seed)`` on its first epoch)."""
    from raydp_tpu.models import MLP as JaxMLP
    jm = JaxMLP(features=(8,), use_batch_norm=False)
    args = dict(loss="mse", feature_columns=["x1", "x2"], label_column="y",
                batch_size=32, num_epochs=1, metrics=["mae"], **kw)
    if side == "ref":
        from raydp_tpu.train import FlaxEstimator
        return FlaxEstimator(model=jm, optimizer=optax.adam(1e-2), **args)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2)), train=False))
    tm = MLP(2, (8,), use_batch_norm=False, device="cpu")
    tm.load_state_dict(mlp_variables_from_flax(variables))
    return TorchEstimator(model=tm,
                          optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                          device="cpu", **args)


def _run_side(side: str) -> dict:
    """Every pipeline case through one package's session; plain data out."""
    if side == "ref":
        import raydp_tpu as root
        from raydp_tpu.etl.expressions import col
        from raydp_tpu.runtime.object_store import get_client
    else:
        import raydp_tpu_torch as root
        from raydp_tpu_torch.etl.expressions import col
        from raydp_tpu_torch.runtime.object_store import get_client
    stream = STREAMS[side]
    out = {}
    session = root.init(f"pytest-stream-{side}", **SESSION)
    try:
        client = get_client()

        # windows over a transform, and the ledger consumer
        before = client.stats()["num_objects"]
        pipe = stream.read_stream(stream.SyntheticSource(
            _table, max_epochs=4)).transform(
            lambda df: df.filter(col("v") >= 0)).window(
            size=2, keys=["k"], aggs={"v": ["sum", "mean", "count"]})
        consumer = pipe.epoch_stream()
        results = list(pipe.epochs())
        seen = []
        while True:
            item = consumer.next(timeout_s=2.0)
            if item is None:
                break
            seen.append(item)
        out["windows"] = {
            "epochs": [(er.epoch, er.input_rows, er.num_rows)
                       for er in results],
            "first": results[0].table().to_pandas(),
            "closed": [(er.epoch, w.start, w.end, w.table.to_pandas())
                       for er in results for w in er.windows],
            "seen": [(e, t.to_pandas()) for e, t in seen],
            "report": {k: v for k, v in pipe.report().items()
                       if not k.startswith("epoch_") and k != "pipeline"}}
        pipe.close()
        out["windows"]["settled"] = _settles(client, before)

        # a sliding window, and a consumer that replays a lost result
        before = client.stats()["num_objects"]
        pipe = stream.read_stream(stream.SyntheticSource(
            _table, max_epochs=3)).window(size=2, slide=1, keys=["k"],
                                          aggs={"v": "sum"})
        results = list(pipe.epochs())
        with pipe._lock:
            _, ref = pipe._results[1]
        client.free([ref])
        epoch, table = pipe.epoch_stream(from_epoch=1).next(timeout_s=5.0)
        with pipe._lock:
            gen = pipe._results[1][0]
        out["sliding"] = {
            "windows": [(w.start, w.end, w.table.to_pandas())
                        for er in results for w in er.windows],
            "replayed": (epoch, table.to_pandas()), "gen": gen,
            "replays": pipe.report()["replays"]}
        pipe.close()
        out["sliding"]["settled"] = _settles(client, before)

        # the background thread
        pipe = stream.read_stream(stream.SyntheticSource(_table,
                                                         max_epochs=3))
        bg = []
        pipe.start(sink=lambda er: bg.append(er.epoch))
        deadline = time.monotonic() + 30
        while len(bg) < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        pipe.stop()
        pipe.close()
        out["background"] = bg

        # a transform that joins a static frame of the same session
        dim = session.createDataFrame(
            pd.DataFrame({"k": [0, 1, 2, 3], "name": ["a", "b", "c", "d"]}),
            num_partitions=1)
        pipe = stream.read_stream(stream.SyntheticSource(
            _table, max_epochs=2)).transform(lambda df: df.join(dim, on="k"))
        out["join"] = [er.table().to_pandas().sort_values(
            ["k", "v", "name"]).reset_index(drop=True)
            for er in pipe.epochs()]
        pipe.close()

        # partial_fit over an inline pipeline (ragged epoch tails)...
        before = client.stats()["num_objects"]
        est = _estimator(side)
        pipe = stream.read_stream(stream.SyntheticSource(
            _reg_table, max_epochs=ONLINE_EPOCHS))
        res = est.partial_fit(pipe, export_every=0)
        pipe.close()
        out["online"] = {"epochs": res.epochs, "history": res.history,
                         "settled": _settles(client, before)}
        # ...and over the epoch stream of a background pipeline
        est = _estimator(side)
        pipe = stream.read_stream(stream.SyntheticSource(
            _reg_table, max_epochs=2))
        consumer = pipe.epoch_stream()
        pipe.start()
        try:
            res = est.partial_fit(consumer, timeout_s=5.0)
        finally:
            pipe.close()
        out["online_stream"] = {"epochs": res.epochs,
                                "history": res.history}

        # the export cadence: a servable every 2 epochs
        est = _estimator(side)
        export_dir = tempfile.mkdtemp(prefix=f"pytest-export-{side}-")
        pipe = stream.read_stream(stream.SyntheticSource(
            _reg_table, max_epochs=3))
        res = est.partial_fit(pipe, export_every=2, export_dir=export_dir)
        pipe.close()
        out["export"] = {
            "epochs": res.epochs,
            "exports": [(e, os.path.relpath(d, export_dir))
                        for e, d in res.exports],
            "complete": [os.path.exists(os.path.join(d, "servable.json"))
                         for _, d in res.exports],
            "rollouts": res.rollouts}
        if side == "port":
            out["hot_swap"] = _hot_swap_case(session, stream)
    finally:
        root.stop()
    return out


def _hot_swap_case(session, stream):
    """partial_fit(export_every=1) hot-swapping each export into a live
    CPU ServingSession on the session's executors while requests flow."""
    from raydp_tpu_torch.data import TableDataset
    from raydp_tpu_torch.serve import ServingSession, load_servable

    est = _estimator("port")
    est.fit(TableDataset([_reg_table(9)]))
    export_dir = tempfile.mkdtemp(prefix="pytest-hot-swap-")
    est.export_serving(os.path.join(export_dir, "v0"))
    rows = _reg_table(7).select(["x1", "x2"])
    srv = ServingSession(os.path.join(export_dir, "v0"), session=session,
                         name="online", device="cpu")
    try:
        stop, futs = threading.Event(), []

        def traffic():
            i = 0
            while not stop.is_set():
                futs.append(srv.predict_async(rows.slice(i % 60, 2)))
                i += 1
                time.sleep(0.005)

        t = threading.Thread(target=traffic)
        t.start()
        try:
            pipe = stream.read_stream(stream.SyntheticSource(
                _reg_table, max_epochs=2))
            res = est.partial_fit(pipe, export_every=1, serving=srv,
                                  export_dir=export_dir)
            pipe.close()
        finally:
            stop.set()
            t.join(timeout=30)
        answered = [f.result(timeout=60.0).shape for f in futs]
        latest = srv.predict(rows, timeout=60.0)
        rep = srv.serving_report()
    finally:
        srv.close()
    v2 = load_servable(os.path.join(export_dir, "v2"), device="cpu")
    return {"exports": [(e, os.path.relpath(d, export_dir))
                        for e, d in res.exports],
            "requests": len(futs), "answered": answered,
            "report": {k: rep[k] for k in ("hot_swaps", "failed", "shed")},
            "servable": rep["servable"],
            "bitwise_v2": bool(np.array_equal(latest,
                                              v2.predict_table(rows)))}


@pytest.fixture(scope="module")
def sides():
    ref = _run_side("ref")
    return ref, _run_side("port")


def _assert_frames_equal(a, b):
    pd.testing.assert_frame_equal(a.reset_index(drop=True),
                                  b.reset_index(drop=True))


def test_epochs_windows_and_ledger_consumer_equal_the_reference(sides):
    ref, port = (s["windows"] for s in sides)
    assert port["epochs"] == ref["epochs"] == [(e, 32, 32) for e in range(4)]
    _assert_frames_equal(port["first"], ref["first"])
    assert [c[:3] for c in port["closed"]] == \
        [c[:3] for c in ref["closed"]] == [(1, 0, 1), (3, 2, 3)]
    for a, b in zip(port["closed"], ref["closed"]):
        assert list(a[3].columns) == ["k", "v_sum", "v_mean", "v_count"]
        _assert_frames_equal(a[3], b[3])
    assert [e for e, _ in port["seen"]] == [e for e, _ in ref["seen"]] \
        == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(port["seen"], ref["seen"]):
        _assert_frames_equal(a, b)
    assert port["report"] == ref["report"]
    assert port["settled"] and ref["settled"]


def test_sliding_window_and_consumer_replay_equal_the_reference(sides):
    ref, port = (s["sliding"] for s in sides)
    assert [w[:2] for w in port["windows"]] == \
        [w[:2] for w in ref["windows"]] == [(0, 1), (1, 2)]
    for a, b in zip(port["windows"], ref["windows"]):
        _assert_frames_equal(a[2], b[2])
    assert port["replayed"][0] == ref["replayed"][0] == 1
    _assert_frames_equal(port["replayed"][1], ref["replayed"][1])
    _assert_frames_equal(port["replayed"][1], _table(1).to_pandas())
    assert port["gen"] >= 2 and port["replays"] == ref["replays"] == 1
    assert port["settled"] and ref["settled"]


def test_background_thread_and_static_join_equal_the_reference(sides):
    ref, port = sides
    assert port["background"] == ref["background"] == [0, 1, 2]
    assert len(port["join"]) == len(ref["join"]) == 2
    for a, b in zip(port["join"], ref["join"]):
        _assert_frames_equal(a, b)


@pytest.mark.parametrize("case", ["online", "online_stream"])
def test_partial_fit_matches_flax_estimator(sides, case):
    ref, port = (s[case] for s in sides)
    want_epochs = ONLINE_EPOCHS if case == "online" else 2
    assert port["epochs"] == ref["epochs"] == want_epochs
    assert [h["epoch"] for h in port["history"]] == \
        [h["epoch"] for h in ref["history"]] == list(range(want_epochs))
    for a, b in zip(port["history"], ref["history"]):
        assert a["steps"] == b["steps"] == 3       # 32 + 32 + a 6-row tail
        for key in ("train_loss", "train_mae"):
            np.testing.assert_allclose(a[key], b[key], rtol=EPOCH_RTOL,
                                       err_msg=key)
    assert set(port["history"][0]) == set(ref["history"][0])
    if case == "online":
        assert port["settled"] and ref["settled"]


def test_partial_fit_exports_like_the_reference(sides):
    """Every 2nd epoch exports a servable under ``export_dir/v<n>``: over 3
    epochs one export, of epoch 1, complete (``servable.json`` written)."""
    ref, port = (s["export"] for s in sides)
    assert port == ref
    assert port["exports"] == [(1, "v1")] and port["complete"] == [True]
    assert port["epochs"] == 3 and port["rollouts"] == []


def test_partial_fit_hot_swaps_into_a_live_serving_session(sides):
    """``export_every=1`` with a CPU ServingSession attached: two exports
    hot-swap in under live 2-row traffic, no request is dropped, and
    afterwards a request answers bitwise as ``v2``'s own servable does on
    the same batch."""
    got = sides[1]["hot_swap"]
    assert got["exports"] == [(0, "v1"), (1, "v2")]
    assert got["report"] == {"hot_swaps": 2, "failed": 0, "shed": 0}
    assert got["servable"]["tag"] == "epoch-1"
    assert got["servable"]["export_dir"].endswith("v2")
    assert got["requests"] > 0
    assert got["answered"] == [(2,)] * got["requests"]
    assert got["bitwise_v2"]


def test_partial_fit_state_persists_across_epochs():
    """One pass an epoch over the state the previous epoch left: two
    epochs of partial_fit equal one fit over both epochs' rows (whole
    batches, unshuffled), and get_model works mid-stream."""
    from raydp_tpu_torch.data import TableDataset

    class Epoch:
        def __init__(self, epoch, table):
            self.epoch, self._table = epoch, table

        def dataset(self):
            return TableDataset([self._table])

    tables = [_reg_table(e, rows=64) for e in range(2)]
    est = _estimator("port", shuffle=False)
    res = est.partial_fit([Epoch(e, t) for e, t in enumerate(tables)])
    assert [h["steps"] for h in res.history] == [2, 2]
    assert not est.get_model().training
    plain = _estimator("port", shuffle=False).fit(TableDataset(tables))
    np.testing.assert_allclose(np.mean([h["train_loss"]
                                        for h in res.history]),
                               plain.history[0]["train_loss"], rtol=1e-6)
    a = est.get_model().state_dict()
    b = plain.state.model.state_dict()
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                   rtol=1e-6, atol=1e-7)
