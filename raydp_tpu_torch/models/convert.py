"""Carry weights from the JAX reference's Flax param trees to the port.

The port's modules keep Flax's parameter layout and names, so the mapping is
path for path: ``params["block_0"]["attn"]["q"]["kernel"]`` ([dim, H, hd])
becomes ``state_dict["block_0.attn.q.kernel"]``, and likewise ``o``
([H, hd, dim]), ``gate``/``up`` ([dim, 4·dim]), ``down`` ([4·dim, dim]),
``ln1``/``ln2``/``ln_f`` ``scale`` ([dim]), ``embed.embedding`` ([V, dim]) and
``lm_head.kernel`` ([dim, V]). Loading the result with ``load_state_dict``
(strict, the default) rejects a missing or unexpected key or a wrong shape.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def transformer_params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``TransformerLM`` params (nested mappings of arrays; numpy or any
    array with ``__array__``) → the port's ``TransformerLM`` state_dict."""
    state: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
            else:
                state[f"{prefix}{name}"] = torch.from_numpy(np.array(leaf))

    walk(params, "")
    return state
