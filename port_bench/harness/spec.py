"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) resolves to:
- its configuration: the ``file`` of the ``configs`` entry it names;
- its traffic: ``port_bench/traffic/<traffic>.json``, whose ``driver``
  names ``port_bench/drivers/<driver>.py``;
- its limits: ``port_bench/workloads/<cell>.json`` (the numbers that
  decide ``correct``, each with its limit);
- its metrics: the ``end_to_end`` and ``per_layer`` entries that list it
  under ``workloads`` (or list no cells); a per-layer metric is read by
  ``port_bench/metrics/<metric>.py``'s ``read``.

Adding a cell or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Callable

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "port_bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m
            or cell in m["workloads"]]


def resolve(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "port_bench" / "workloads" / f"{name}.json").read_text())
    return Cell(name, w["chips"], config, traffic, limits,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def load_driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def load_reader(metric: str, root: pathlib.Path = ROOT) -> Callable:
    """``read`` of ``port_bench/metrics/<metric>.py`` (the file name may
    hold dots, so it is loaded by path)."""
    path = root / "port_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
