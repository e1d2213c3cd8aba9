"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names."""

import sys

import torch

from bench_port import run
from bench_port.tests import tiny


def test_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "raydp_tpu_torch_probe", object())
    assert "raydp_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raydp_tpu.probe", object())
    assert run.forbidden_modules() == ["raydp_tpu"]


def test_a_run_loads_no_jax():
    before = set(run.forbidden_modules())
    run.run(tiny.cell("nyctaxi-mlp.resident"), 7, 0.5, False,
            torch.device("cpu"))
    assert set(run.forbidden_modules()) == before
    import bench_port.control  # noqa: F401

    assert set(run.forbidden_modules()) == before
