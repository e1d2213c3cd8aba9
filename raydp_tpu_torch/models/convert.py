"""Carry weights from the JAX reference's Flax variable trees to the port.

The port's modules keep Flax's parameter layout and names, so the mapping is
path for path: ``params["block_0"]["attn"]["q"]["kernel"]`` ([dim, H, hd])
becomes ``state_dict["block_0.attn.q.kernel"]``, ``params["Dense_0"]
["kernel"]`` ([in, out]) becomes ``state_dict["Dense_0.kernel"]``, and a
BatchNorm's running statistics ``batch_stats["BatchNorm_0"]["mean"]`` /
``["var"]`` become the buffers ``BatchNorm_0.mean`` / ``BatchNorm_0.var``
(Flax keeps them in their own collection; torch keeps buffers in the same
state_dict as parameters). Loading the result with ``load_state_dict``
(strict, the default) rejects a missing or unexpected key or a wrong shape.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "",
             state: dict | None = None) -> dict[str, torch.Tensor]:
    state = {} if state is None else state
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            _flatten(leaf, f"{prefix}{name}.", state)
        else:
            state[f"{prefix}{name}"] = torch.from_numpy(np.array(leaf))
    return state


def transformer_params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``TransformerLM`` params (nested mappings of arrays; numpy or any
    array with ``__array__``) → the port's ``TransformerLM`` state_dict."""
    return _flatten(params)


def mlp_variables_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``MLP`` / ``NYCTaxiModel`` variables (``{"params": ...,
    "batch_stats": ...}``; ``batch_stats`` absent without BatchNorm) → the
    port's ``MLP`` state_dict, parameters and BatchNorm buffers."""
    state = _flatten(variables["params"])
    return _flatten(variables.get("batch_stats", {}), state=state)


def dlrm_params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``DLRM`` params → the port's ``DLRM`` state_dict."""
    return _flatten(params)
