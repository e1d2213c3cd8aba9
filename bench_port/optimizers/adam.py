"""Adam with bias correction: ``p -= lr · m̂ / (√v̂ + eps)``."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

TORCH = "Adam"
STATES = 2


class Plain:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8):
        self.lr, self.eps = lr, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p -= self.lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt()
                                               + self.eps)
