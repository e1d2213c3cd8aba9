"""The ``RDT_*`` environment knobs the port reads — its copy of the entries
of :mod:`raydp_tpu.knobs` on the ported training path, with the same names,
types, defaults and read semantics.

Every knob here is read per action: :func:`get` reads the environment at
the call, so tests and runs can flip a knob between fits. Stdlib only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

#: the truthiness convention every boolean knob shares (``RDT_X=0`` /
#: ``false`` / ``off`` / ``no`` disables; anything else enables)
_FALSY = ("0", "false", "off", "no")


@dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    type: str          # "bool" | "int" | "float" | "str"
    default: object
    doc: str

    def parse(self, raw: str) -> object:
        if self.type == "bool":
            return raw.strip().lower() not in _FALSY
        if self.type == "int":
            # int(float(...)) so "8e6"-style and "2048.0"-style values work
            return int(float(raw))
        if self.type == "float":
            return float(raw)
        return raw


_ALL = [
    Knob("RDT_PREFETCH_TO_DEVICE", "int", 2,
         "Already-placed batches the streaming feed keeps ahead of the "
         "train step (0 = place synchronously)."),
    Knob("RDT_FEED_CACHE_MB", "float", 2048.0,
         "Per-iterator budget (MiB) for the decoded-block host cache reused "
         "across epochs."),
    Knob("RDT_DEVICE_CACHE", "bool", True,
         "Device-resident dataset cache opt-out (0 always streams batches)."),
    Knob("RDT_DEVICE_CACHE_MB", "float", 2048.0,
         "Device-memory budget (MiB) under which a dataset is eligible for "
         "full device residency."),
    Knob("RDT_STAGE_THREADS", "int", 1,
         "Column fan-out threads of the native staging core (host decode)."),
    Knob("RDT_TRAIN_ACCUM_STEPS", "int", 1,
         "Gradient-accumulation microbatches per optimizer step. Must "
         "divide batch_size; the estimator accum_steps= argument "
         "overrides."),
]

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}


def get(name: str):
    """The typed value of knob ``name`` read from the environment NOW, or
    its declared default when unset or empty (empty string = unset, so
    ``RDT_X= python ...`` behaves like an absent var, never a parse
    error). An undeclared name raises ``KeyError``."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return knob.default
    return knob.parse(raw)
