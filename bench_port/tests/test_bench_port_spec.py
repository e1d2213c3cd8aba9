"""BENCHMARK.json names what the harness finds by name, and keeps the
contract's shape."""

import json
import math
import re

import pytest

from bench_port import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert NAME.match(entry["name"])
    data = json.load(open(spec.ROOT / entry["file"]))
    assert data["name"] == entry["name"]
    assert set(entry["reduced"]) <= set(data), "reduced names a key"
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])
    spec.load("models", data["model"])
    spec.load("traffic", data["data"])
    spec.load("optimizers", data["optimizer"]["name"])
    ref = spec.load("reference", data["model"])
    assert ref.leaves(data)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    cell = spec.cell(entry["name"])
    assert cell["chips"] in (1, 4)
    assert cell["mix"]["feed"] in ("resident", "stream")
    assert cell["mix"]["name"] == entry["traffic"]
    assert spec.limits(entry["name"]), "every cell has its limits"
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.load("metrics", metric["name"]).read)
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", []):
        spec.cell(w)


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_limits_are_finite_numbers():
    for w in BENCH["workloads"]:
        for name, value in spec.limits(w["name"]).items():
            assert math.isfinite(value) and value >= 0, (w["name"], name)
