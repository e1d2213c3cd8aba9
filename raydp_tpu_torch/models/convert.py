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

A forest has no weights to load: :func:`gbdt_from_reference` builds the
port's ``GBDTModel`` from the reference model's fields.
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


def pipeline_params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The reference ``PipelineModel``'s params (``{"embed", "stage_stack",
    "head"}``, the layers' parameters stacked on a leading axis) → the
    port's ``PipelineModel`` state_dict: ``stage_stack.Dense_0.kernel``
    [n_layers, in, out] is ``params["stage_stack"]["Dense_0"]["kernel"]``."""
    return _flatten(params)


def gbdt_from_reference(fields: Mapping):
    """The reference ``GBDTModel``'s fields (a mapping of numpy arrays and
    scalars, e.g. ``dataclasses.asdict`` of it) → the port's
    :class:`~raydp_tpu_torch.models.gbdt.GBDTModel`, the same forest. A
    missing or unknown field raises."""
    import dataclasses

    from raydp_tpu_torch.models.gbdt import GBDTModel

    names = {f.name for f in dataclasses.fields(GBDTModel)}
    missing = sorted(names - set(fields) - {"best_iteration"})
    unknown = sorted(set(fields) - names)
    if missing or unknown:
        raise ValueError(f"not a GBDTModel's fields: missing {missing}, "
                         f"unknown {unknown}")
    best = fields.get("best_iteration")
    return GBDTModel(
        split_feature=np.asarray(fields["split_feature"], np.int32),
        split_bin=np.asarray(fields["split_bin"], np.int32),
        leaf_value=np.asarray(fields["leaf_value"], np.float32),
        bin_edges=np.asarray(fields["bin_edges"], np.float32),
        base_score=np.asarray(fields["base_score"], np.float32),
        max_depth=int(fields["max_depth"]),
        objective=str(fields["objective"]),
        best_iteration=None if best is None else int(best))
