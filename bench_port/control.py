"""Readings that set a cell's correctness limits (``limits/<cell>.json``):

- ``program``: the program's warm-up steps against the reference, as a run
  reads them (the lower readings), on each of ``--program-seeds``;
- ``control``: the reference put in the program's place, one precision
  below the configuration's (float32 -> TF32, bfloat16 -> fp8), on each of
  ``--seeds``;
- ``half``: the reference put in the program's place with half of every
  batch left out, the mean taken over the rest (a fault), on ``--seeds``;
- ``frozen``: the reference put in the program's place with a step that
  leaves the state unchanged (learning rate 0; a fault), on ``--seeds``:
  it reads 1 on ``change_gap`` by construction, and this run gives its
  losses.

The benchmark's own runs never run this.

    python3 -m bench_port.control --workload <cell> --seeds 1,2,3 \\
        --program-seeds 4,5,...

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Dict, List

import torch

from bench_port import check, program, spec
from bench_port.reference.common import no_tf32
from bench_port.run import batch_rows
from bench_port.traffic import generate

#: the precision one step below a configuration's
LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell: Dict, seeds: List[int], program_seeds: List[int],
             device: torch.device,
             kinds=("control", "half", "frozen")) -> List[Dict]:
    config, mix = cell["config_data"], cell["mix"]
    os.environ.update({k: str(v) for k, v in mix.get("env", {}).items()})
    no_tf32()
    ref_module = spec.load("reference", config["model"])
    model_module = spec.load("models", config["model"])
    leaves = ref_module.leaves(config)
    batch = int(config["batch_size"])
    out = []
    for seed in sorted(set(seeds) | set(program_seeds)):
        t0 = time.perf_counter()
        rows = generate.make(config, mix, seed, device)
        runs = {}
        if seed in program_seeds:
            result, window, readout, model, opt = program.fit(
                config, mix, rows, seed, 0, device, model_module, leaves)
            runs["program"] = readout.trajectory
            error = readout.error
            del result, window, readout, model, opt
            _free(device)
            if error is not None:
                raise RuntimeError(error)
        inputs = rows.on_device(device)
        steps = batch_rows(mix, rows, batch, seed,
                           program.checked_steps(mix), device)
        ref = ref_module.trajectory(config, inputs, steps, seed, device)
        if seed in seeds:
            if "control" in kinds:
                runs["control"] = ref_module.trajectory(
                    config, inputs, steps, seed, device,
                    LOWER[config["compute_dtype"]])
            if "half" in kinds:
                runs["half"] = ref_module.trajectory(
                    config, inputs, [r[:batch // 2] for r in steps], seed,
                    device)
            if "frozen" in kinds:
                frozen = dict(config, optimizer=dict(config["optimizer"],
                                                     lr=0.0))
                runs["frozen"] = ref_module.trajectory(
                    frozen, inputs, steps, seed, device)
        for kind, traj in runs.items():
            line = {"workload": cell["name"], "seed": seed, "kind": kind,
                    **check.gaps(traj, ref),
                    "worst": check.worst_leaves(traj, ref),
                    "moved_rows": {n: [traj.moved_rows.get(n), r]
                                   for n, r in ref.moved_rows.items()},
                    "losses": traj.losses, "ref_losses": ref.losses,
                    "s": time.perf_counter() - t0}
            out.append(line)
            print(json.dumps(line), flush=True)
        del inputs, ref, runs
        _free(device)
    return out


def _ints(text: str) -> List[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--program-seeds", type=_ints, default=[])
    ap.add_argument("--kinds", default="control,half,frozen")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        print(torch.cuda.get_device_name(device), file=sys.stderr)
    cell = spec.cell(args.workload)
    readings(cell, args.seeds, args.program_seeds, device,
             tuple(args.kinds.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
