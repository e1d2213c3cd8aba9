"""The trace reduction and the per-layer readers on made-up records."""

from types import SimpleNamespace

import pytest
import torch

from bench_port import spec
from bench_port.record import Record
from bench_port.trace import CALLBACK_SPAN, reduce

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(name, start, end, device=CUDA, note=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=note,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_is_the_union_and_gaps_are_labelled():
    events = [_event("gemm", 0, 100), _event("copy", 50, 150),
              _event("gemm", 400, 500), _event("Optimizer.step", 0, 600,
                                               note=True),
              _event("aten::item", 140, 300, CPU),
              _event(CALLBACK_SPAN, 160, 380, CPU),
              _event("aten::randperm", 310, 390, CPU)]
    s = reduce(events, window_s=600e-6)
    assert s.busy_s == pytest.approx(250e-6)
    assert s.device_ops[0] == ("gemm", pytest.approx(200e-6))
    # one gap, 150..400 us, its middle at 275 us: inside the callback and
    # aten::item, the shorter (innermost) of the two
    assert s.idle_gaps == [(f"{CALLBACK_SPAN} > aten::item",
                            pytest.approx(250e-6))]


def _record(**kw):
    config = spec.cell("nyctaxi-mlp.resident")["config_data"]
    base = dict(workload="w", config=config, mix={}, path="resident",
                setup_s=20.0, window_s=8.0, window_samples=80_000_000,
                epochs=[{"steps": 512, "feed_time_s": 0.0,
                         "decode_time_s": 0.0}] * 2,
                dispatch=[{"graph_steps": 512}] * 2, peak_bytes=2**30)
    base.update(kw)
    return Record(**base)


def _read(name, rec):
    return spec.load("metrics", name).read(rec)


def test_end_to_end_readers():
    rec = _record()
    assert _read("train_samples_per_s", rec) == 10_000_000
    assert _read("peak_mem_gib", rec) == 1.0
    assert _read("setup_s", rec) == 20.0
    assert _read("replayed_step_share", rec) == 1.0


def test_trace_readers_need_a_trace():
    rec = _record()
    for name in ("device_idle_pct", "step_mfu_pct", "step_roofline_pct"):
        assert _read(name, rec) is None
    # a resident cell has no feed to read
    assert _read("feed_wait_ms_per_step", rec) is None
    assert _read("feed_decode_ms_per_step", rec) is None


def test_trace_readers():
    peaks = spec.peaks("NVIDIA H100 80GB HBM3")
    trace = SimpleNamespace(busy_s=0.9, window_s=1.0)
    rec = _record(trace=trace, peaks=peaks, traced_steps=1000,
                  step_flops=67e9, traced_bytes=[3.35e9] * 1000)
    assert _read("device_idle_pct", rec) == pytest.approx(10.0)
    # 1000 steps of 67 GFLOP in 1 s against 67 TFLOP/s
    assert _read("step_mfu_pct", rec) == pytest.approx(100.0)
    # each step needs 1 ms (both bounds alike) and 0.9 s were busy
    assert _read("step_roofline_pct", rec) == pytest.approx(1000 / 9)


def test_feed_readers_on_a_streaming_cell():
    rec = _record(path="stream", epochs=[{"steps": 64, "feed_time_s": 0.064,
                                          "decode_time_s": 0.64}])
    assert _read("feed_wait_ms_per_step", rec) == pytest.approx(1.0)
    assert _read("feed_decode_ms_per_step", rec) == pytest.approx(10.0)
