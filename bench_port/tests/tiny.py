"""Cells cut to a size the CPU runs in seconds: the model's own ``tiny``
cut (``models/<model>.py``), 16 batches of 256 rows."""

from __future__ import annotations

import copy

from bench_port import spec

BATCH = 256


def cell(workload: str, **config) -> dict:
    c = copy.deepcopy(spec.cell(workload))
    cfg, mix = c["config_data"], c["mix"]
    spec.load("models", cfg["model"]).tiny(cfg)
    cfg["batch_size"] = BATCH
    cfg.update(config)
    mix["rows"] = 16 * BATCH
    return c
