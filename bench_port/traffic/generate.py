"""The one generator of the benchmark's rows: a configuration's ``data``
kind, sized by a traffic mix, drawn from ``--seed`` on the device in a few
large calls and handed to the program as Arrow blocks on the host.

Each data kind is a module ``traffic/<data>.py`` whose ``rows(config,
mix, seed, device)`` returns the mix's :class:`Rows`; a mix gives at least
``rows`` (how many) and ``blocks`` (how many Arrow blocks hold them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from bench_port import spec


@dataclass
class Rows:
    """A mix's rows: ``columns`` (feature names in the model's order),
    ``label``, ``features`` ``[F, N]`` and ``labels`` ``[N]`` float32 on the
    host, and the Arrow blocks built over them."""

    columns: List[str]
    label: str
    features: np.ndarray
    labels: np.ndarray
    block_sizes: List[int]

    def blocks(self):
        import pyarrow as pa

        out = []
        edges = np.cumsum([0] + self.block_sizes)
        for lo, hi in zip(edges[:-1], edges[1:]):
            cols = {c: self.features[i, lo:hi]
                    for i, c in enumerate(self.columns)}
            cols[self.label] = self.labels[lo:hi]
            out.append(pa.table(cols))
        return out

    def on_device(self, device) -> Dict[str, torch.Tensor]:
        """``features`` ``[N, F]`` and ``label`` ``[N]`` on ``device``."""
        feats = torch.from_numpy(self.features).to(device)
        return {"features": feats.T.contiguous(),
                "label": torch.from_numpy(self.labels).to(device)}


def block_sizes(rows: int, blocks: int) -> List[int]:
    return [int(n) for n in np.diff(
        np.linspace(0, rows, blocks + 1).astype(np.int64))]


def make(config: Dict, mix: Dict, seed: int, device) -> Rows:
    """The rows of ``mix`` for ``config``'s data kind."""
    return spec.load("traffic", config["data"]).rows(
        config, mix, int(seed) & ((1 << 63) - 1), torch.device(device))
