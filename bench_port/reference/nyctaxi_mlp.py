"""Plain NYCTaxi MLP (RayDP ``examples/pytorch_nyctaxi.py``'s network, as
the port's ``NYCTaxiModel`` states it), trained for its first steps.

25 features; four hidden layers of 256, 128, 64 and 16, each a product
with a bias, ReLU, then batch normalisation over the batch (biased
variance, epsilon 1e-5, a learned scale and shift); one output; the mean
smooth L1 loss (beta 1). Kernels are ``[in, out]``. Initial weights as
``torch.nn.Linear``'s: kernel and bias ``U(-1/sqrt(in), 1/sqrt(in))``;
scale 1, shift 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from bench_port.reference.common import Precision, Trajectory, follow
from bench_port.reference.weights import Leaf, draw_leaf


def leaves(config: Dict) -> List[Leaf]:
    out: List[Leaf] = []
    width = config["num_features"]
    hidden = config["hidden"]
    for i, n in enumerate(list(hidden) + [config["out_features"]]):
        bound = 1.0 / math.sqrt(width)
        out.append((f"Dense_{i}.kernel", (width, n), ("uniform", bound)))
        out.append((f"Dense_{i}.bias", (n,), ("uniform", bound)))
        if i < len(hidden):
            out.append((f"BatchNorm_{i}.scale", (n,), ("const", 1.0)))
            out.append((f"BatchNorm_{i}.bias", (n,), ("const", 0.0)))
        width = n
    return out


def _batch_norm(x, scale, shift, eps=1e-5):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + shift


def _forward(config, params, x, prec: Precision):
    h = x
    layers = len(config["hidden"])
    for i in range(layers):
        h = torch.relu(prec.mm(h, params[f"Dense_{i}.kernel"])
                       + params[f"Dense_{i}.bias"])
        h = _batch_norm(h, params[f"BatchNorm_{i}.scale"],
                        params[f"BatchNorm_{i}.bias"])
    h = prec.mm(h, params[f"Dense_{layers}.kernel"]) \
        + params[f"Dense_{layers}.bias"]
    return h[:, 0]


def smooth_l1(preds, labels, beta=1.0):
    d = torch.abs(preds - labels)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta,
                                  d - 0.5 * beta))


def trajectory(config: Dict, inputs: Dict[str, torch.Tensor],
               rows: Sequence[torch.Tensor], seed: int,
               device: torch.device,
               precision: str = "float32") -> Trajectory:
    """Follow the first ``len(rows)`` steps from the seed's weights."""
    prec = Precision(precision)
    batches = []
    for r in rows:
        r = torch.as_tensor(r, device=device)
        batches.append((inputs["features"][r].float(),
                        inputs["label"][r].float()))
    params = {leaf[0]: draw_leaf(leaf, i, seed, device)
              for i, leaf in enumerate(leaves(config))}

    def loss_fn(p, batch):
        x, y = batch
        preds = _forward(config, p, x, prec)
        return smooth_l1(preds, y), preds

    return follow(params, loss_fn, batches, config["optimizer"])
