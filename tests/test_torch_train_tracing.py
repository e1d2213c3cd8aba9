"""The train loop and the feed trace themselves (``profiler.timed``).

- Under a ``torch.profiler`` the loop's host waits are named ranges of the
  profiler's own trace, and the epoch report's walls are the sums of the
  same spans in the ring.
- With no profiler the loop records one ``train:epoch`` span an epoch and
  nothing else new, and every dispatch record carries ``lead_s``.
- ``profiler.trace`` opens a profiler range only while one runs.
- ``torch_trace`` records the feed threads' spans where the installed torch
  can profile every thread.
- On the card (``-m cuda``; this file imports no JAX, so
  ``python -m pytest --noconftest -m cuda tests/test_torch_train_tracing.py``
  runs it there), a traced fit times each dispatch with CUDA events.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch
from torch.profiler import ProfilerActivity

from raydp_tpu_torch import profiler
from raydp_tpu_torch.data import DeviceFeed, TableDataset
from raydp_tpu_torch.models import MLP
from raydp_tpu_torch.train import TorchEstimator
from raydp_tpu_torch.train.step_graph import DispatchTimes

FEATURES = ["x1", "x2"]
#: the spans this plane adds; every one but train:epoch only while traced
LOOP_SPANS = {"train:epoch", "train:feed_wait", "train:dispatch",
              "train:sync", "train:eval", "train:checkpoint", "feed:decode",
              "feed:block", "feed:stage", "feed:h2d"}
#: what the loop reports from its CUDA events while traced on a card
DEVICE_KEYS = {"device_s", "gap_s", "step_device_max_ms"}


def _tables(n=640, blocks=3):
    rng = np.random.RandomState(0)
    x = rng.random_sample((n, 2)).astype(np.float32)
    y = (x @ np.array([2.0, -3.0], np.float32) + 1.0).astype(np.float32)
    cuts = np.linspace(0, n, blocks + 1).astype(int)
    return [pa.table({"x1": x[a:b, 0], "x2": x[a:b, 1], "y": y[a:b]})
            for a, b in zip(cuts[:-1], cuts[1:])]


def _estimator(device="cpu", **kw):
    # made on the host; the fit places it on its device
    model = MLP(2, (8,), device="cpu",
                generator=torch.Generator().manual_seed(0))
    args = dict(loss="mse", feature_columns=FEATURES, label_column="y",
                batch_size=64, num_epochs=2, device=device)
    return TorchEstimator(model=model, **{**args, **kw})


@pytest.fixture
def ring():
    """An empty span ring, the profiler enabled."""
    profiler.set_enabled(True)
    profiler.clear()
    yield
    profiler.clear()


def _children(spans, name, parent):
    return [s for s in spans if s["name"] == name
            and s.get("par") == parent["sid"]]


def test_a_traced_streaming_fit_names_every_host_wait(monkeypatch, ring):
    monkeypatch.setenv("RDT_DEVICE_CACHE", "0")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        result = _estimator(steps_per_dispatch=2).fit(
            TableDataset(_tables()))
    names = {e.name for e in prof.events()}
    assert {"train:epoch", "train:feed_wait", "train:dispatch",
            "train:sync"} <= names
    spans = profiler.spans()
    epochs = [s for s in spans if s["name"] == "train:epoch"]
    assert len(epochs) == len(result.history) == 2
    for h, ep in zip(result.history, epochs):
        waits = _children(spans, "train:feed_wait", ep)
        # one wait a stack of 2 batches, and the one that ends the epoch
        assert len(waits) == h["steps"] // 2 + 1
        assert abs(sum(s["dur"] for s in waits) / 1e6
                   - h["feed_time_s"]) <= 1e-6 * len(waits)
        dispatches = _children(spans, "train:dispatch", ep)
        assert len(dispatches) == h["steps"] // 2
        assert abs(sum(s["dur"] for s in dispatches) / 1e6
                   - h["dispatch_time_s"]) <= 1e-6 * len(dispatches)
        assert abs(ep["dur"] / 1e6 - h["epoch_time_s"]) <= 1e-6
    # the feed threads' spans go to the ring, each block with its args
    blocks = [s for s in spans if s["name"] == "feed:block"]
    assert len(blocks) == 3 * 2
    assert {b["args"]["cached"] for b in blocks} == {"0", "1"}
    assert sum(int(b["args"]["rows"]) for b in blocks) == 2 * 640
    for name in ("feed:decode", "feed:h2d"):
        assert any(s["name"] == name for s in spans), name
    for d in result.dispatch:
        assert d["lead_s"] >= 0 and not DEVICE_KEYS & set(d)


@pytest.mark.parametrize("cache", ["1", "0"], ids=["resident", "streaming"])
def test_untraced_fit_records_only_its_epochs(monkeypatch, ring, cache):
    monkeypatch.setenv("RDT_DEVICE_CACHE", cache)
    result = _estimator(steps_per_dispatch=2).fit(TableDataset(_tables()))
    spans = profiler.spans()
    assert {s["name"] for s in spans} & LOOP_SPANS == {"train:epoch"}
    epochs = [s for s in spans if s["name"] == "train:epoch"]
    assert [int(s["args"]["epoch"]) for s in epochs] == [0, 1]
    for h, ep in zip(result.history, epochs):
        assert abs(ep["dur"] / 1e6 - h["epoch_time_s"]) <= 1e-6
    for d, h in zip(result.dispatch, result.history):
        assert 0 <= d["lead_s"] <= h["epoch_time_s"]
        assert not DEVICE_KEYS & set(d)


def test_trace_opens_a_profiler_range_only_while_one_runs(monkeypatch,
                                                          ring):
    opened = []
    real = profiler._open_range

    def spy(name, args=None):
        opened.append(name)
        return real(name, args)

    monkeypatch.setattr(profiler, "_open_range", spy)
    with profiler.trace("train:place", "training"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.trace("train:place", "training"):
            pass
        profiler.set_enabled(False)
        try:
            with profiler.trace("train:accum", "training"):
                pass
        finally:
            profiler.set_enabled(True)
    assert opened == ["train:place"]
    assert "train:place" in {e.name for e in prof.events()}
    # the ring holds both train:place spans, and nothing while disabled
    assert [s["name"] for s in profiler.spans()] == ["train:place"] * 2


def test_torch_trace_records_the_feed_threads(tmp_path, ring):
    if profiler._all_threads_config() is None:
        pytest.skip("this torch's profiler has no profile_all_threads: a "
                    "trace sees no range of a thread started after it")
    feed = DeviceFeed(TableDataset(_tables()), 64,
                      {"x": (FEATURES, np.float32), "y": ("y", np.float32)},
                      device="cpu")
    with profiler.torch_trace(str(tmp_path), device="cpu") as log_dir:
        with profiler.trace("train:place", "training"):  # the main thread
            batches = sum(1 for _ in feed)
    assert batches == 10
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    (main,) = [e["tid"] for e in events if e.get("name") == "train:place"]
    blocks = [e for e in events if e.get("name") == "feed:block"]
    assert len(blocks) == 3
    assert all(e["tid"] != main for e in blocks)


class _Event:
    """A recorded timing event at ``t`` ms (``elapsed_time`` as CUDA's)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_dispatch_times_sum_the_device_time_and_the_gaps_between():
    times = DispatchTimes(torch.device("cpu"))
    # three dispatches of 2, 1 and 1 steps: 4, 1 and 3 ms on the card, the
    # card idle 0.5 ms before the second and 2 ms before the third
    starts, ends = [0.0, 4.5, 7.5], [4.0, 5.5, 10.5]
    times._pool = [(_Event(a), _Event(b)) for a, b in zip(starts, ends)]
    times._steps = [2, 1, 1]
    got = times.read()
    assert got["device_s"] == pytest.approx(8e-3)
    assert got["gap_s"] == pytest.approx(2.5e-3)
    assert got["step_device_max_ms"] == pytest.approx(3.0)
    times._steps = []
    assert times.read() == {}


@pytest.fixture
def cuda():
    # decided here, not at import: every test worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cache,chain", [("1", 1), ("0", 2), ("0", 1)],
                         ids=["resident", "chained", "eager"])
def test_traced_fit_times_each_dispatch_on_the_card(monkeypatch, ring, cuda,
                                                    cache, chain):
    monkeypatch.setenv("RDT_DEVICE_CACHE", cache)
    ds = TableDataset(_tables())
    plain = _estimator(cuda, steps_per_dispatch=chain).fit(ds)
    for d in plain.dispatch:
        assert d["lead_s"] >= 0 and not DEVICE_KEYS & set(d)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]):
        traced = _estimator(cuda, steps_per_dispatch=chain).fit(ds)
    for d, h in zip(traced.dispatch, traced.history):
        assert d["device_s"] > 0 and d["gap_s"] >= 0 and d["lead_s"] >= 0
        mean_ms = 1e3 * d["device_s"] / h["steps"]
        assert d["step_device_max_ms"] >= mean_ms * (1 - 1e-9)
