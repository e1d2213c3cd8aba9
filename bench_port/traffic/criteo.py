"""Criteo-shaped rows, a frozen copy of the repo's
``chip_smoke.criteo_tables`` drawn with torch instead of numpy (the same distributions; numpy's zipf
draws 54 million ids in about 8 s, the card in milliseconds): label
``_c0`` Bernoulli(0.25); 13 dense features ``_c1.._c13``
``log1p(poisson(8))`` with 10 % set to 0; 26 ids ``_c14.._c39``
``zipf(a)`` (numpy's rejection sampler, run on whole arrays) taken modulo
the table's rows on this chip, stored as float32 (exact below 2**24).
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_port.traffic.generate import Rows, block_sizes


def zipf(a: float, shape, gen: torch.Generator,
         device: torch.device) -> torch.Tensor:
    """``zipf(a)`` draws as float64 (numpy's rejection sampler)."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(shape, dtype=torch.float64, device=device).view(-1)
    todo = torch.arange(out.numel(), device=device)
    while todo.numel():
        n = todo.numel()
        u = 1.0 - torch.rand(n, dtype=torch.float64, device=device,
                             generator=gen)
        v = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1.0) & (x <= 2.0 ** 62) \
            & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out.view(shape)


def rows(config: Dict, mix: Dict, seed: int, device) -> Rows:
    n = int(mix["rows"])
    nd = config["num_dense_features"]
    tables = config["table_rows"]
    gen = torch.Generator(device=device).manual_seed(seed)
    label = (torch.rand(n, device=device, generator=gen) < 0.25).float()
    rate = torch.full((nd, n), 8.0, device=device)
    dense = torch.poisson(rate, generator=gen)
    dense[torch.rand((nd, n), device=device, generator=gen) < 0.1] = 0.0
    dense = torch.log1p(dense)
    ids = zipf(config["id_zipf_a"], (len(tables), n), gen, device)
    ids = torch.fmod(ids, torch.tensor(tables, dtype=torch.float64,
                                       device=device)[:, None])
    feats = torch.cat([dense, ids.float()]).cpu().numpy()
    names = [f"_c{i}" for i in range(1, 1 + nd + len(tables))]
    return Rows(names, "_c0", feats, label.cpu().numpy(),
                block_sizes(n, int(mix["blocks"])))
