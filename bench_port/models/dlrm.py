"""The port's DLRM (``raydp_tpu_torch.models.dlrm``) at a configuration's
widths, products in its ``compute_dtype`` over float32 parameters, and the
work its step needs."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

F32 = 4


def build(config: Dict, device: torch.device):
    from raydp_tpu_torch.models.dlrm import DLRM

    return DLRM(categorical_sizes=config["table_rows"],
                num_dense=config["num_dense_features"],
                embedding_dim=config["embedding_dim"],
                bottom_mlp=tuple(config["bottom_mlp"]),
                top_mlp=tuple(config["top_mlp"]),
                dtype=getattr(torch, config["compute_dtype"]),
                device=device)


def preprocessor(config: Dict):
    from raydp_tpu_torch.models.dlrm import criteo_batch_preprocessor

    return criteo_batch_preprocessor(config["num_dense_features"])


def _layers(config: Dict) -> List[Tuple[int, int]]:
    """``(in, out)`` of every dense layer: the bottom MLP, then the top MLP
    on the bottom output, the interaction's pairs and one pad column."""
    out, width = [], config["num_dense_features"]
    for n in config["bottom_mlp"]:
        out.append((width, n))
        width = n
    vectors = 1 + len(config["table_rows"])
    width = config["embedding_dim"] + vectors * (vectors - 1) // 2 + 1
    for n in config["top_mlp"]:
        out.append((width, n))
        width = n
    return out


def dense_macs_per_row(config: Dict) -> int:
    return sum(a * b for a, b in _layers(config))


def interaction_macs_per_row(config: Dict) -> int:
    """The dot interaction's ``n·n·d`` products of the ``n`` vectors."""
    vectors = 1 + len(config["table_rows"])
    return vectors * vectors * config["embedding_dim"]


def macs_per_row(config: Dict) -> int:
    return dense_macs_per_row(config) + interaction_macs_per_row(config)


def dense_params(config: Dict) -> int:
    return sum(a * b + b for a, b in _layers(config))


def input_columns(config: Dict) -> int:
    return config["num_dense_features"] + len(config["table_rows"]) + 1


def distinct_rows(config: Dict, features: torch.Tensor) -> List[int]:
    """The distinct ids a batch ``[B, dense + tables]`` holds in each
    table."""
    ids = features[:, config["num_dense_features"]:].long()
    s = ids.sort(0).values
    return (1 + (s[1:] != s[:-1]).sum(0)).tolist()


def sparse_bytes(config: Dict, features: Optional[torch.Tensor],
                 states: int) -> int:
    """The gathered rows (``B × tables × d`` float32, written once as the
    lookup's output), and each distinct row the batch touches in a table
    with its optimizer state, each read and written."""
    if features is None:
        raise ValueError("DLRM's bytes need the step's batch")
    dim = config["embedding_dim"]
    gathered = config["batch_size"] * len(config["table_rows"]) * dim * F32
    return gathered + sum(distinct_rows(config, features)) * dim * F32 * 2 \
        * (1 + states)


def tiny(config: Dict) -> None:
    """Tables of at most 997 rows and narrow MLPs."""
    config["table_rows"] = [min(n, 997) for n in config["table_rows"]]
    config["bottom_mlp"] = [64, 32, config["embedding_dim"]]
    config["top_mlp"] = [64, 32, 1]
