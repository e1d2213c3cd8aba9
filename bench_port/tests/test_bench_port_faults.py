"""A run with the timed path broken underneath comes out not correct: once
for each fault a one-chip training cell can have (a step that leaves the
state unchanged; half of every batch left out, the mean taken over the
rest). The run skips the harness's look for a card and runs on the CPU at a
tiny size, against the cell's own limits; the same run unbroken is
correct."""

import importlib

import pytest
import torch

from bench_port import run, spec
from bench_port.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(workload, seed):
    out = run.run(tiny.cell(workload), seed, 0.3, False,
                  torch.device("cpu"))
    return out["correct"], out["checks"]


def _unchanged(monkeypatch):
    # the update functions the optimizers' steps call; the steps (and
    # their hooks) still run
    for name in ("sgd", "adam"):
        module = importlib.import_module(f"torch.optim.{name}")
        monkeypatch.setattr(module, name, lambda *a, **k: None)


def _half_batch(monkeypatch):
    from raydp_tpu_torch.train import torch_estimator

    strip = torch_estimator._strip_mask

    def half(batch):
        batch, mask = strip(batch)
        return {k: v[: v.shape[0] // 2] for k, v in batch.items()}, mask

    monkeypatch.setattr(torch_estimator, "_strip_mask", half)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    correct, checks = _run(workload, 21)
    assert correct, checks


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = _run(workload, 22)
    assert not correct
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
