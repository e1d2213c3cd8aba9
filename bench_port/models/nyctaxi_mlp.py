"""The port's ``NYCTaxiModel`` (``raydp_tpu_torch.models.mlp``), and the
work its step needs."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def build(config: Dict, device: torch.device):
    from raydp_tpu_torch.models.mlp import NYCTaxiModel

    dtype = config["compute_dtype"]
    return NYCTaxiModel(config["num_features"],
                        dtype=None if dtype == "float32"
                        else getattr(torch, dtype),
                        use_batch_norm=True, device=device)


def preprocessor(config: Dict):
    return None


def _layers(config: Dict) -> List[Tuple[int, int]]:
    out, width = [], config["num_features"]
    for n in list(config["hidden"]) + [config["out_features"]]:
        out.append((width, n))
        width = n
    return out


def macs_per_row(config: Dict) -> int:
    return sum(a * b for a, b in _layers(config))


def dense_params(config: Dict) -> int:
    """Kernels and biases, and BatchNorm's scale and shift."""
    return sum(a * b + b for a, b in _layers(config)) \
        + 2 * sum(config["hidden"])


def input_columns(config: Dict) -> int:
    return config["num_features"] + 1


def sparse_bytes(config: Dict, features: Optional[torch.Tensor],
                 states: int) -> int:
    return 0


def tiny(config: Dict) -> None:
    """The published widths already run in seconds on the CPU."""
