"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same weights on the same
batches.

The numbers, each compared where ``limits/<cell>.json`` gives it a limit:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps whose
  loss the program read (every step but those inside a replayed chain; the
  first and the last always);
- ``loss1_gap``: the same for the first step alone (the same weights on
  the same batch: the forward's rounding and nothing else);
- ``pred1_gap``: the first step's predictions, row by row: the largest
  ``|pred - ref|`` over the rows' root mean square of ``ref`` (a per-row
  reading of the forward, which a batch mean can average away);
- ``grad_gap``: over the counted leaves, the largest gap between the
  program's and the reference's norm of the first gradient, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change after the
  steps;
- ``moved_rows_gap``: over every leaf, the largest gap between the
  program's and the reference's count of rows (slices along dim 0) that
  moved over the steps, over the reference's count of that leaf or of the
  median leaf, whichever is larger: a row of a table that no batch touched
  does not move, and every touched row does. (A leaf with few moving rows,
  as a bias whose units are mostly dead under ReLU, would otherwise read
  one unit that rounding keeps alive as a large share.)

A leaf is counted when the reference's first gradient is at least a
thousandth of the median leaf's: a leaf whose gradient is nought to
rounding moves under an adaptive optimizer by round-off alone. A leaf or a
step the program did not report reads as an infinite gap.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from bench_port.reference.common import Trajectory, median

NAMES = ("loss_gap", "loss1_gap", "pred1_gap", "grad_gap", "change_gap",
         "moved_rows_gap")
#: a leaf counts when its first gradient is at least this share of the
#: median leaf's
COUNTED = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               counted: List[str]) -> Dict[str, float]:
    if not counted:
        return {"": math.inf}
    floor = median([ref[n] for n in counted])
    return {n: _gap(prog.get(n, math.inf), ref[n], max(ref[n], floor))
            for n in counted}


def _gap(value: float, ref: float, scale: float) -> float:
    """``|value - ref| / scale``; a value that is not finite is an infinite
    gap."""
    if not math.isfinite(value):
        return math.inf
    return abs(value - ref) / scale


def _counted(ref: Trajectory) -> List[str]:
    floor = median(ref.grad_norms.values())
    return [n for n, g in ref.grad_norms.items() if g >= COUNTED * floor]


def _moved_gaps(prog: Dict[str, int], ref: Dict[str, int]
                ) -> Dict[str, float]:
    if not ref:
        return {"": math.inf}
    floor = max(median(ref.values()), 1)
    return {n: _gap(prog.get(n, math.inf), r, max(r, floor))
            for n, r in ref.items()}


def _per_leaf(prog: Trajectory, ref: Trajectory):
    counted = _counted(ref)
    return {"grad_gap": _leaf_gaps(prog.grad_norms, ref.grad_norms,
                                   counted),
            "change_gap": _leaf_gaps(prog.change_norms, ref.change_norms,
                                     counted),
            "moved_rows_gap": _moved_gaps(prog.moved_rows, ref.moved_rows)}


def worst_leaves(prog: Trajectory, ref: Trajectory) -> Dict[str, str]:
    """The leaf that sets each worst-leaf number."""
    return {name: max(gaps, key=gaps.get)
            for name, gaps in _per_leaf(prog, ref).items()}


def gaps(prog: Trajectory, ref: Trajectory) -> Dict[str, float]:
    losses = prog.losses
    if len(losses) != len(ref.losses) or not losses or losses[0] is None \
            or losses[-1] is None:
        per_step = [math.inf]
    else:
        per_step = [_gap(p, r, abs(r))
                    for p, r in zip(losses, ref.losses) if p is not None]
    out = {"loss_gap": max(per_step), "loss1_gap": per_step[0],
           "pred1_gap": _pred_gap(prog.first_preds, ref.first_preds)}
    for name, gaps in _per_leaf(prog, ref).items():
        out[name] = max(gaps.values())
    return out


def _pred_gap(prog, ref) -> float:
    if prog is None or ref is None or prog.shape != ref.shape:
        return math.inf
    prog, ref = prog.double().cpu(), ref.double().cpu()
    scale = float(ref.square().mean().sqrt())
    gap = float((prog - ref).abs().max()) / scale
    return gap if math.isfinite(gap) else math.inf


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that have
    a limit; a cell without limits is not correct."""
    out, ok = {}, bool(limits)
    for name in limits:
        value = values.get(name, math.inf)
        limit = limits[name]
        ok = ok and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out
