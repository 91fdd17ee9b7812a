"""BENCHMARK.json against the benchmark's contract, and every cell found by
name: its configuration, traffic, driver, limits and metric readers."""

import json
import re

import pytest

from port_bench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.resolve(BENCH, name)
    driver = spec.load_driver(cell.traffic["driver"])
    assert hasattr(driver, "Run")
    assert cell.chips == 1
    assert cell.limits["limits"], "a cell compares at least one number"
    offered = set(driver.END_TO_END) | {"setup_s"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert names <= offered
    assert cell.per_layer, "a cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(spec.load_reader(m["name"]))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_configs_and_cells_are_named_once():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
