"""The readers of the program's own timings (``TrainingResult.dispatch``:
``lead_s`` always, ``device_s`` and ``gap_s`` while traced on a card), on
made-up records, and ``lead_s`` from a tiny fit on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from bench_port import program, spec
from bench_port.record import Record
from bench_port.tests import tiny
from bench_port.traffic import generate

NAMES = ("epoch_lead_ms", "dispatch_gap_pct", "step_device_ms")


def _record(dispatch, trace=SimpleNamespace(busy_s=0.9, window_s=2.0)):
    config = spec.cell("dlrm-mlperf.stream")["config_data"]
    return Record(workload="w", config=config, mix={}, path="stream",
                  setup_s=20.0, window_s=2.0, window_samples=128 * 32768,
                  epochs=[{"steps": 64}, {"steps": 64}], dispatch=dispatch,
                  trace=trace)


def _read(name, rec):
    return spec.load("metrics", name).read(rec)


def test_readers_by_hand():
    rec = _record([
        {"lead_s": 0.100, "device_s": 1.70, "gap_s": 0.010},
        {"lead_s": 0.120, "device_s": 1.72, "gap_s": 0.030}])
    assert _read("epoch_lead_ms", rec) == pytest.approx(110.0)
    # 40 ms of 2 s
    assert _read("dispatch_gap_pct", rec) == pytest.approx(2.0)
    # 3.42 s over 128 steps
    assert _read("step_device_ms", rec) == pytest.approx(26.71875)


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_without_the_keys(name):
    # the parent's program: no lead_s, and no device times
    assert _read(name, _record([{"graph_steps": 64}] * 2)) is None
    # an epoch whose record lacks the key
    assert _read(name, _record([{"lead_s": 0.1, "device_s": 1.7,
                                 "gap_s": 0.01}, {"graph_steps": 64}])) \
        is None
    assert _read(name, _record([])) is None


def test_the_gap_share_needs_a_trace():
    d = [{"lead_s": 0.1, "device_s": 1.7, "gap_s": 0.01}]
    assert _read("dispatch_gap_pct", _record(d, trace=None)) is None
    assert _read("epoch_lead_ms", _record(d, trace=None)) \
        == pytest.approx(100.0)


def test_a_tiny_fit_reports_each_epochs_lead():
    cell = tiny.cell("nyctaxi-mlp.resident")
    config, mix = cell["config_data"], cell["mix"]
    device = torch.device("cpu")
    seed = 3_000_000_019
    rows = generate.make(config, mix, seed, device)
    result, window, readout, _, _ = program.fit(
        config, mix, rows, seed, 0.3, device,
        spec.load("models", config["model"]),
        spec.load("reference", config["model"]).leaves(config))
    assert readout.error is None
    epochs, _ = window.window()
    rec = _record([d for d in result.dispatch if d["epoch"] in epochs])
    leads = [d["lead_s"] for d in rec.dispatch]
    assert leads and all(0 <= x < 1 for x in leads)
    assert _read("epoch_lead_ms", rec) == pytest.approx(
        1e3 * sum(leads) / len(leads))
    # no card: no device times
    assert _read("step_device_ms", rec) is None
