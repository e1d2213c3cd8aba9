"""raydp_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of raydp_tpu.

The JAX package ``raydp_tpu`` is the reference; this package mirrors its
layout where a counterpart exists and imports nothing from it (nor JAX). Every
Pallas TPU kernel on a ported path becomes a kernel written by hand for
Hopper under ``raydp_tpu_torch/csrc/``, built at first use by
:mod:`raydp_tpu_torch.ops._build`.

Ported so far: the long-context ``TransformerLM``, inference and training
(:mod:`raydp_tpu_torch.models.transformer`), on the flash-attention forward
and backward kernels (:mod:`raydp_tpu_torch.ops.flash_attention`); the
training half of the main path (:mod:`raydp_tpu_torch.train`); the actor
runtime and the object store (:mod:`raydp_tpu_torch.runtime`) under the
store-backed :class:`~raydp_tpu_torch.data.DistributedDataset`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of quietly using the CPU.
Importing the package does not import torch, so the runtime's actor
processes start without it.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from raydp_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
