"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means ``cuda``: the port runs on the card unless the caller asks
    for the CPU explicitly. A CUDA device without CUDA raises rather than
    falling back to the CPU.

    Also turns TF32 off for float32 matrix products and convolutions, so that
    float32 on the card means float32 (parity with the JAX reference is held
    in float32).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: raydp_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run on the CPU explicitly")
    return dev


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor lies on one CUDA device; return that device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name} launches a CUDA kernel and needs CUDA tensors on one "
            f"device, got {sorted(str(d) for d in devices)}")
    return next(iter(devices))
