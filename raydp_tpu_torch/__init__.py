"""raydp_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of raydp_tpu.

The JAX package ``raydp_tpu`` is the reference; this package mirrors its
layout where a counterpart exists and imports nothing from it (nor JAX). Every
Pallas TPU kernel on a ported path becomes a kernel written by hand for
Hopper under ``raydp_tpu_torch/csrc/``, built at first use by
:mod:`raydp_tpu_torch.ops._build`.

Ported so far: the long-context ``TransformerLM``, inference and training
(:mod:`raydp_tpu_torch.models.transformer`), on the flash-attention forward
and backward kernels (:mod:`raydp_tpu_torch.ops.flash_attention`).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of quietly using the CPU.
"""

from raydp_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
