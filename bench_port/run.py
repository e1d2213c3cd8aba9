"""Run one cell of the benchmark and print its result.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (``setup_s``) runs from the process's start to the end of the
fit's warm-up epoch; the window then runs the epochs that fit in
``--seconds``. ``--trace 1`` profiles the window's first
``program.TRACE_EPOCHS`` epochs and reports the per-layer metrics instead
of the end-to-end ones. After the window the program is freed and the
plain reference follows the warm-up's first steps from the same weights and
batches (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (the compared numbers, and those over their
limit), ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit; the same numbers
are the last lines of standard error. Exits 2 without a result when the
cards are missing, 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

# the port's libraries may load JAX through a package that offers it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from bench_port import check, counts, program, spec  # noqa: E402
from bench_port.record import Record  # noqa: E402
from bench_port.reference.common import (  # noqa: E402
    no_tf32, resident_rows, stream_rows,
)
from bench_port.trace import Tracer  # noqa: E402
from bench_port.traffic import generate  # noqa: E402

T_IMPORTED = time.perf_counter()

#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "raydp_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def batch_rows(mix: Dict, rows, batch: int, seed: int, steps: int,
               device, epoch: int = 0):
    """The dataset rows of an epoch's first ``steps`` batches, as the
    program's feed for this mix forms them."""
    n = int(sum(rows.block_sizes))
    if mix["feed"] == "resident":
        return resident_rows(n, batch, seed, steps, device, epoch)
    return [torch.as_tensor(r, device=device)
            for r in stream_rows(rows.block_sizes, batch, seed, steps, epoch)]


def traced_bytes(config: Dict, mix: Dict, rows, inputs, seed: int,
                 epochs: List[int], steps_per_epoch: int,
                 device) -> List[float]:
    """Each traced step's bytes (``counts.bytes_per_step``), from its
    batch."""
    return [counts.bytes_per_step(config, inputs["features"][r])
            for e in epochs
            for r in batch_rows(mix, rows, config["batch_size"], seed,
                                steps_per_epoch, device, epoch=e)]


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: Optional[float] = None) -> Dict:
    """One run of a cell (:func:`bench_port.spec.cell`); returns the result
    line's object."""
    workload = cell["name"]
    config, mix = cell["config_data"], cell["mix"]
    os.environ.update({k: str(v) for k, v in mix.get("env", {}).items()})
    no_tf32()
    model_module = spec.load("models", config["model"])
    ref_module = spec.load("reference", config["model"])
    leaves = ref_module.leaves(config)

    t_inputs = time.perf_counter()
    rows = generate.make(config, mix, seed, device)
    t_inputs = time.perf_counter() - t_inputs
    if device.type == "cuda":
        # the inputs' making is the benchmark's, not the program's
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(device) if trace else None
    result, window, readout, model, opt = program.fit(
        config, mix, rows, seed, seconds, device, model_module, leaves,
        tracer)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    epochs, window_s = window.window()
    history = {h["epoch"]: h for h in result.history}
    dispatch = {d["epoch"]: d for d in result.dispatch}
    path = "stream" if history[0]["decode_time_s"] > 0 else "resident"
    batch = int(config["batch_size"])
    t0 = T_START if t_start is None else t_start
    warm = history[0]["epoch_time_s"]
    setup_split = {"imports": T_IMPORTED - T_START, "inputs": t_inputs,
                   "build": window.fit_start - window.build_start,
                   "fit_to_epoch0": window.setup_end - window.fit_start
                   - warm, "epoch0": warm}
    rec = Record(
        workload=workload, config=config, mix=mix, path=path,
        setup_s=window.setup_end - t0, window_s=window_s,
        window_samples=sum(history[e]["steps"] for e in epochs) * batch,
        epochs=[history[e] for e in epochs],
        dispatch=[dispatch[e] for e in epochs], peak_bytes=int(peak))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    summary = tracer.summary() if tracer is not None else None
    program_trajectory, readout_error = readout.trajectory, readout.error
    # the program's state goes before the reference runs
    del result, window, readout, model, opt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    inputs = rows.on_device(device)
    if summary is not None:
        rec.trace = summary
        rec.peaks = spec.peaks(kind)
        rec.step_flops = counts.flops_per_step(config)
        rec.traced_steps = sum(h["steps"] for h in rec.epochs)
        rec.traced_bytes = traced_bytes(
            config, mix, rows, inputs, seed, epochs,
            rec.traced_steps // max(1, len(epochs)), device)

    ref = ref_module.trajectory(
        config, inputs,
        batch_rows(mix, rows, batch, seed, program.checked_steps(mix),
                   device),
        seed, device)
    values = check.gaps(program_trajectory, ref) if readout_error is None \
        else {n: math.inf for n in check.NAMES}
    correct, checks = check.judge(values, spec.limits(workload))
    out_readings = {n: v for n, v in values.items() if n not in checks}
    notes = []
    if readout_error is not None:
        notes.append(readout_error)
    if path != mix["feed"]:
        correct = False
        notes.append(f"the fit took the {path} path, the mix asks for "
                     f"{mix['feed']}")

    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = spec.load("metrics", m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_out = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": kind, "count": int(cell["chips"]),
                  "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(checks),
           "failed": sum(1 for c in checks.values()
                         if not c["value"] <= c["limit"]),
           "metrics": metrics, "device": device_out}
    if summary is not None:
        device_out["busy_s"] = summary.busy_s
        device_out["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           summary.device_ops],
                            "idle_gaps": [list(x) for x in
                                          summary.idle_gaps]}
    out["setup_split"] = setup_split
    out["readings"] = out_readings
    out["checks"] = checks
    out["notes"] = notes
    return out


def _json_number(x):
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the system under test: absent from a checkout that holds only the
    # benchmark, where the run ends here
    import raydp_tpu_torch  # noqa: F401

    cell = spec.cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {found}", file=sys.stderr)
        return 3
    for note in out.pop("notes"):
        print(f"bench_port: {note}", file=sys.stderr)
    print("setup_split " + " ".join(
        f"{k}={v:.3f}" for k, v in out.pop("setup_split").items()),
        file=sys.stderr)
    for name, value in out.pop("readings").items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out["checks"] = {n: {k: _json_number(v) for k, v in c.items()}
                     for n, c in out["checks"].items()}
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
