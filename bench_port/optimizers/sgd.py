"""SGD without momentum: ``p -= lr · g``. It keeps no state, so a
parameter whose gradient is zero does not move."""

from __future__ import annotations

from typing import Dict

import torch

TORCH = "SGD"
STATES = 0


class Plain:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr = lr

    @torch.no_grad()
    def step(self, params, grads) -> None:
        for n, p in params.items():
            p -= self.lr * grads[n]
