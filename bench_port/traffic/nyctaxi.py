"""NYCTaxi-shaped rows, a frozen copy of the repo's
``chip_smoke.nyctaxi_tables`` drawn with torch: 25 standard normal
features ``feature_0..24`` and ``fare_amount = clip(11 + 6 x·w +
2 sin(2 x_0) + noise, 2.5, 249)`` with ``w`` a fixed unit vector.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench_port.traffic.generate import Rows, block_sizes


def rows(config: Dict, mix: Dict, seed: int, device) -> Rows:
    n = int(mix["rows"])
    nf = config["num_features"]
    w = np.random.RandomState(12345).randn(nf)
    w /= np.linalg.norm(w)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((nf, n), device=device, generator=gen)
    noise = torch.randn(n, device=device, generator=gen)
    fare = 11.0 + 6.0 * (torch.tensor(w, dtype=torch.float32,
                                      device=device) @ x) \
        + 2.0 * torch.sin(2.0 * x[0]) + noise
    fare = torch.clamp(fare, 2.5, 249.0)
    names = [f"feature_{i}" for i in range(nf)]
    return Rows(names, "fare_amount", x.cpu().numpy(), fare.cpu().numpy(),
                block_sizes(n, int(mix["blocks"])))
