"""The plain reference follows the port's first steps on the CPU at a tiny
size: the same weights, the same batches (resident and streamed), the same
losses, gradients and updates."""

import os

import pytest
import torch

from bench_port import check, program, spec
from bench_port.run import batch_rows
from bench_port.tests import tiny
from bench_port.traffic import generate


def _gaps(cell, seed):
    config, mix = cell["config_data"], cell["mix"]
    device = torch.device("cpu")
    ref_module = spec.load("reference", config["model"])
    leaves = ref_module.leaves(config)
    rows = generate.make(config, mix, seed, device)
    old = {k: os.environ.get(k) for k in mix["env"]}
    os.environ.update(mix["env"])
    try:
        _, window, readout, _, _ = program.fit(
            config, mix, rows, seed, 0, device,
            spec.load("models", config["model"]), leaves)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert readout.error is None
    assert window.setup_end is not None
    ref = ref_module.trajectory(
        config, rows.on_device(device),
        batch_rows(mix, rows, config["batch_size"], seed,
                   program.checked_steps(mix), device), seed, device)
    return check.gaps(readout.trajectory, ref)


@pytest.mark.parametrize("workload", ["dlrm-mlperf.resident",
                                      "dlrm-mlperf.stream"])
def test_dlrm_in_float32_matches(workload):
    # float32 on both sides: only the order of sums differs
    g = _gaps(tiny.cell(workload, compute_dtype="float32"), 11)
    assert g["loss_gap"] < 1e-5
    assert g["pred1_gap"] < 1e-5
    assert g["grad_gap"] < 1e-4
    assert g["change_gap"] < 1e-4
    assert g["moved_rows_gap"] == 0


def test_dlrm_in_bfloat16_is_close():
    g = _gaps(tiny.cell("dlrm-mlperf.resident"), 12)
    # bfloat16 may round a unit's only positive input below zero: one row
    # of a 480-row kernel then has no gradient on the program's side
    assert g["moved_rows_gap"] <= 1 / 400
    assert g["grad_gap"] < 0.05


def test_nyctaxi_matches():
    g = _gaps(tiny.cell("nyctaxi-mlp.resident"), 13)
    assert g["loss_gap"] < 1e-5
    assert g["loss1_gap"] < 1e-6
    assert g["pred1_gap"] < 1e-5
