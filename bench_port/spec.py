"""Everything a cell is, found by name: its entry in ``BENCHMARK.json``
(beside this folder), its configuration, traffic mix and data kind, model
module, reference module, optimizer, metric readers and limits."""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell(workload: str) -> Dict:
    """The workload's entry, with its ``config`` and ``traffic`` loaded
    (``config_data``, ``mix``) and the metrics it reports
    (``end_to_end``, ``per_layer``: lists of metric entries)."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    out = dict(entry)
    out["config_data"] = _json("configs", entry["config"])
    out["mix"] = _json("traffic", entry["traffic"])

    def reported(metrics: List[Dict]) -> List[Dict]:
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    out["end_to_end"] = reported(bench["end_to_end"])
    out["per_layer"] = reported(bench["per_layer"])
    out["run_seconds"] = bench["run_seconds"]
    return out


def limits(workload: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)["limits"]


def peaks(device_kind: str):
    with open(HERE / "peaks.json") as f:
        return json.load(f)["devices"].get(device_kind)


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (a name may hold dots and dashes),
    loaded once."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} module {name!r} ({path})")
    mod_name = f"bench_port.{kind}._{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
