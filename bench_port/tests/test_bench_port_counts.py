"""The FLOP and byte counts against hand counts."""

import pytest
import torch

from bench_port import counts, spec


def _config(name):
    return spec.cell(name)["config_data"]


def test_dlrm_flops_per_step():
    c = _config("dlrm-mlperf.resident")
    dlrm = spec.load("models", "dlrm")
    # 13-512-256-128 and 480-1024-1024-512-256-1
    assert dlrm.dense_macs_per_row(c) == 2_366_208
    assert dlrm.interaction_macs_per_row(c) == 27 * 27 * 128
    assert counts.flops_per_step(c) == pytest.approx(483.6e9, rel=1e-4)


def test_nyctaxi_flops_per_step():
    c = _config("nyctaxi-mlp.resident")
    mlp = spec.load("models", "nyctaxi_mlp")
    assert mlp.macs_per_row(c) == 48_400
    assert mlp.dense_params(c) == 49_793
    assert counts.flops_per_step(c) == pytest.approx(2.38e9, rel=1e-3)


def test_nyctaxi_bytes_per_step():
    c = _config("nyctaxi-mlp.resident")
    # inputs: 8192 rows x 26 float32; Adam: parameter + 2 states, each
    # read and written
    want = 8192 * 26 * 4 + 49_793 * 4 * 2 * 3
    assert counts.bytes_per_step(c) == want


def test_dlrm_bytes_per_step():
    c = _config("dlrm-mlperf.resident")
    # a batch whose ids take 100 distinct values in every table
    features = torch.zeros(32768, 13 + 26)
    features[:, 13:] = (torch.arange(32768) % 100).float()[:, None]
    # SGD keeps no state: each dense parameter and each touched row is
    # read and written once
    want = (32768 * 40 * 4 + 2_369_921 * 4 * 2
            + 32768 * 26 * 128 * 4 + 2600 * 128 * 4 * 2)
    assert counts.bytes_per_step(c, features) == want
    with pytest.raises(ValueError):
        counts.bytes_per_step(c)


@pytest.mark.parametrize("name,states", [("sgd", 0), ("adam", 2)])
def test_optimizer_states(name, states):
    assert spec.load("optimizers", name).STATES == states
