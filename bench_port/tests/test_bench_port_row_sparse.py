"""The reader of ``row_sparse_table_share`` (the program's dispatch
records: ``row_sparse_tables`` and ``dense_tables``), on made-up records
and on a tiny DLRM fit on the CPU, whose SGD puts every table on the
row-sparse path."""

import torch

from bench_port import program, spec
from bench_port.record import Record
from bench_port.tests import tiny
from bench_port.traffic import generate


def _read(dispatch):
    rec = Record(workload="w", config={}, mix={}, path="resident",
                 setup_s=20.0, window_s=2.0, window_samples=2 * 32768,
                 epochs=[{"steps": 1}] * len(dispatch), dispatch=dispatch)
    return spec.load("metrics", "row_sparse_table_share").read(rec)


def test_the_share_by_hand():
    assert _read([{"row_sparse_tables": 0, "dense_tables": 26},
                  {"row_sparse_tables": 26, "dense_tables": 0}]) == 1.0
    assert _read([{"row_sparse_tables": 13, "dense_tables": 13}]) == 0.5


def test_nothing_to_read_without_the_counts_or_tables():
    # the parent's program: no counts
    assert _read([{"graph_steps": 64}]) is None
    assert _read([{"row_sparse_tables": 26}]) is None
    assert _read([]) is None
    # a model without tables
    assert _read([{"row_sparse_tables": 0, "dense_tables": 0}]) is None


def test_a_tiny_dlrm_fit_puts_every_table_on_the_path():
    cell = tiny.cell("dlrm-mlperf.resident")
    config, mix = cell["config_data"], cell["mix"]
    device = torch.device("cpu")
    seed = 3_000_000_021
    rows = generate.make(config, mix, seed, device)
    result, window, readout, _, _ = program.fit(
        config, mix, rows, seed, 0.3, device,
        spec.load("models", config["model"]),
        spec.load("reference", config["model"]).leaves(config))
    assert readout.error is None
    epochs, _ = window.window()
    dispatch = [d for d in result.dispatch if d["epoch"] in epochs]
    assert _read(dispatch) == 1.0
    # every table's step-1 gradient was read, as the dense path's is
    norms = readout.trajectory.grad_norms
    assert all(norms[f"embedding_{t}.embedding"] > 0
               for t in range(len(config["table_rows"])))
