"""Plain DLRM (facebookresearch/dlrm, the MLPerf ``recommendation/dlrm``
reference's architecture), trained for its first steps.

13 dense features through the bottom MLP (ReLU after every layer); one
row of each of the 26 tables; the dot products of every pair of the
27 vectors (bottom output and rows), kept below the diagonal in row-major
order, after the bottom output and before one zero pad column; the top MLP
(ReLU between layers) to one logit; the mean binary cross-entropy with
logits. Dense kernels are ``[in, out]``. A table is held here as just the
rows the steps touch: a row no batch reads has no gradient and, under
SGD, does not move, so the norms of a leaf's gradient and change are
those of its touched rows.

Initial weights (facebookresearch/dlrm ``create_mlp`` / ``create_emb``):
a kernel ``N(0, sqrt(2 / (in + out)))``, a bias ``N(0, sqrt(1 / out))``,
table ``t`` ``U(-sqrt(1 / n_t), sqrt(1 / n_t))`` with ``n_t`` its published
row count.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from bench_port.reference.common import Precision, Trajectory, follow
from bench_port.reference.weights import Leaf, draw_leaf, draw_rows


def leaves(config: Dict) -> List[Leaf]:
    """Every parameter, in the order its weights are drawn."""
    out: List[Leaf] = []
    width = config["num_dense_features"]
    layer = 0
    for n in config["bottom_mlp"]:
        out.append((f"Dense_{layer}.kernel", (width, n),
                    ("normal", math.sqrt(2.0 / (width + n)))))
        out.append((f"Dense_{layer}.bias", (n,),
                    ("normal", math.sqrt(1.0 / n))))
        width, layer = n, layer + 1
    dim = config["embedding_dim"]
    for t, (rows, published) in enumerate(zip(
            config["table_rows"], config["table_rows_published"])):
        out.append((f"embedding_{t}.embedding", (rows, dim),
                    ("uniform", math.sqrt(1.0 / published))))
    vectors = 1 + len(config["table_rows"])
    width = dim + vectors * (vectors - 1) // 2 + 1
    for n in config["top_mlp"]:
        out.append((f"Dense_{layer}.kernel", (width, n),
                    ("normal", math.sqrt(2.0 / (width + n)))))
        out.append((f"Dense_{layer}.bias", (n,),
                    ("normal", math.sqrt(1.0 / n))))
        width, layer = n, layer + 1
    return out


def _tril(n: int):
    rows = [i for i in range(n) for _ in range(i)]
    cols = [j for i in range(n) for j in range(i)]
    return rows, cols


def _dense(prec: Precision, x, kernel, bias):
    """A layer as the compute dtype holds it: the product rounded, then the
    rounded bias added and the sum rounded."""
    return prec.value(prec.value(prec.mm(x, kernel)) + prec.value(bias))


def _forward(config, params, dense, ids, prec: Precision):
    """Logits ``[B]`` of a batch; ``ids`` already index the held rows."""
    x = prec.value(dense)
    nb = len(config["bottom_mlp"])
    for i in range(nb):
        x = torch.relu(_dense(prec, x, params[f"Dense_{i}.kernel"],
                              params[f"Dense_{i}.bias"]))
    tables = len(config["table_rows"])
    rows = [prec.value(params[f"embedding_{t}.embedding"][ids[:, t]])
            for t in range(tables)]
    v = torch.stack([x] + rows, dim=1)                 # [B, 27, D]
    z = prec.value(prec.mm(v, v.mT))                   # [B, 27, 27]
    r, c = _tril(1 + tables)
    flat = z[:, r, c]
    h = torch.cat([x, flat, flat.new_zeros((flat.shape[0], 1))], dim=1)
    top = len(config["top_mlp"])
    for j in range(top):
        h = _dense(prec, h, params[f"Dense_{nb + j}.kernel"],
                   params[f"Dense_{nb + j}.bias"])
        if j < top - 1:
            h = torch.relu(h)
    return h[:, 0]


def bce_with_logits(logits, labels):
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def trajectory(config: Dict, inputs: Dict[str, torch.Tensor],
               rows: Sequence[torch.Tensor], seed: int,
               device: torch.device,
               precision: str = "float32") -> Trajectory:
    """Follow the first ``len(rows)`` steps from the seed's weights.
    ``inputs``: ``features`` ``[N, 13 + 26]`` (dense, then ids as float32)
    and ``label`` ``[N]``, on ``device``; ``rows``: each step's dataset
    rows."""
    prec = Precision(precision)
    nd = config["num_dense_features"]
    specs = leaves(config)
    batches = []
    for r in rows:
        r = torch.as_tensor(r, device=device)
        feats = inputs["features"][r]
        batches.append((feats[:, :nd].float(), feats[:, nd:].long(),
                        inputs["label"][r].float()))
    params: Dict[str, torch.Tensor] = {}
    held: Dict[int, torch.Tensor] = {}
    for index, leaf in enumerate(specs):
        name = leaf[0]
        if name.startswith("embedding_"):
            t = int(name.split("_")[1].split(".")[0])
            used = torch.unique(torch.cat([b[1][:, t] for b in batches]))
            held[t] = used
            params[name] = draw_rows(leaf, index, seed, used)
        else:
            params[name] = draw_leaf(leaf, index, seed, device)
    local = [(d, torch.stack([torch.searchsorted(held[t], ids[:, t].contiguous())
                              for t in range(ids.shape[1])], dim=1), y)
             for d, ids, y in batches]

    def loss_fn(p, batch):
        d, ids, y = batch
        logits = _forward(config, p, d, ids, prec)
        return bce_with_logits(logits, y), logits

    return follow(params, loss_fn, local, config["optimizer"])
