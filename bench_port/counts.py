"""The work a training step needs, from the configuration and the batch,
whatever implements it: model FLOPs and the bytes a step must move. The
model's part of each count is its module's (``models/<model>.py``:
``macs_per_row``, ``dense_params``, ``input_columns``, ``sparse_bytes``).

FLOPs (the 6N convention): a row's multiply-accumulates, times 2 for the
forward and 4 for the backward (its input's and its kernel's gradients).
So a DLRM row at the ``dlrm-mlperf`` widths needs ``6 × (2,366,208 +
93,312)`` FLOPs (483.6 GFLOP a step of 32,768), an NYCTaxi row
``6 × 48,400`` (2.38 GFLOP a step of 8,192).

Bytes, each read once and each written once: the step's inputs (every
feature and label as float32), the dense parameters and each of the
optimizer's state tensors of them (read and written), and what the model
adds from the step's batch (for DLRM the gathered rows and each distinct
row the step touches, with its optimizer state).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_port import spec

F32 = 4


def model(config: Dict):
    return spec.load("models", config["model"])


def optimizer_states(config: Dict) -> int:
    """State tensors the configuration's optimizer keeps per parameter."""
    return spec.load("optimizers", config["optimizer"]["name"]).STATES


def flops_per_step(config: Dict) -> float:
    return 6.0 * model(config).macs_per_row(config) * config["batch_size"]


def bytes_per_step(config: Dict,
                   features: Optional[torch.Tensor] = None) -> float:
    """The bytes one step must move; ``features``: the step's batch
    ``[B, F]`` as the dataset holds it (the model's ``sparse_bytes`` reads
    what it needs from it)."""
    m = model(config)
    states = optimizer_states(config)
    total = config["batch_size"] * m.input_columns(config) * F32
    total += m.dense_params(config) * F32 * 2 * (1 + states)
    total += m.sparse_bytes(config, features, states)
    return float(total)
