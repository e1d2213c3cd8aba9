"""Training metrics — port of :mod:`raydp_tpu.train.metrics`.

Each metric is a pair of functions: ``update`` maps a batch's (predictions,
labels[, mask]) to summable statistics and runs on the device inside the
train step (no host read per batch; the statistics are float32 tensors on
the device), ``compute`` turns the accumulated statistics into the final
value on the host at epoch end.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch


def _row_weights(labels: torch.Tensor, mask):
    """Per-ELEMENT weights from a per-row 0/1 mask (pad-and-mask feeds):
    broadcast the mask over the label's trailing dims so a padded row's
    elements weigh 0 in both the statistic sum and the count. ``mask=None``
    weighs every element 1."""
    if mask is None:
        return torch.ones_like(labels, dtype=torch.float32)
    return mask.reshape((-1,) + (1,) * (labels.ndim - 1)).expand(
        labels.shape).float()


class Metric:
    name: str = "metric"

    def init(self) -> Dict[str, float]:
        return {"sum": 0.0, "count": 0.0}

    def update(self, stats, preds, labels, mask=None):
        raise NotImplementedError

    def compute(self, stats) -> float:
        return float(stats["sum"] / np.maximum(stats["count"], 1e-12))


class MSE(Metric):
    name = "mse"

    def update(self, stats, preds, labels, mask=None):
        w = _row_weights(labels, mask)
        err = torch.sum(((preds - labels) ** 2) * w)
        return {"sum": stats["sum"] + err,
                "count": stats["count"] + torch.sum(w)}


class RMSE(MSE):
    name = "rmse"

    def compute(self, stats) -> float:
        return float(np.sqrt(stats["sum"] / np.maximum(stats["count"], 1e-12)))


class MAE(Metric):
    name = "mae"

    def update(self, stats, preds, labels, mask=None):
        w = _row_weights(labels, mask)
        err = torch.sum(torch.abs(preds - labels) * w)
        return {"sum": stats["sum"] + err,
                "count": stats["count"] + torch.sum(w)}


class Accuracy(Metric):
    name = "accuracy"

    def update(self, stats, preds, labels, mask=None):
        if preds.ndim > labels.ndim:
            pred_cls = torch.argmax(preds, dim=-1)
        else:
            pred_cls = (preds > 0.5).to(torch.int32)
        hits = (pred_cls == labels.to(pred_cls.dtype)).float()
        if mask is not None:
            hits = hits * mask
            rows = torch.sum(mask)
        else:
            rows = labels.shape[0]
        return {"sum": stats["sum"] + torch.sum(hits),
                "count": stats["count"] + rows}


class BinaryCrossEntropy(Metric):
    name = "bce"

    def update(self, stats, preds, labels, mask=None):
        w = _row_weights(labels, mask)
        p = torch.clamp(preds, 1e-7, 1 - 1e-7)
        ll = -torch.sum((labels * torch.log(p)
                         + (1 - labels) * torch.log(1 - p)) * w)
        return {"sum": stats["sum"] + ll,
                "count": stats["count"] + torch.sum(w)}


_REGISTRY = {m.name: m for m in (MSE(), RMSE(), MAE(), Accuracy(),
                                 BinaryCrossEntropy())}
_REGISTRY["mean_squared_error"] = _REGISTRY["mse"]
_REGISTRY["mean_absolute_error"] = _REGISTRY["mae"]


def build_metrics(specs: Sequence[Union[str, Metric]]) -> List[Metric]:
    """Accept names or instances."""
    out: List[Metric] = []
    for s in specs or []:
        if isinstance(s, Metric):
            out.append(s)
        elif isinstance(s, str):
            if s not in _REGISTRY:
                raise ValueError(f"unknown metric {s!r}; have {sorted(_REGISTRY)}")
            out.append(_REGISTRY[s])
        else:
            raise TypeError(f"metric spec must be str or Metric, got {type(s)}")
    return out
