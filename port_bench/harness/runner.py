"""One run of one cell: set-up, the measured window (traced or not), the
memory peak, the program freed, the check, and the result line."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from port_bench.harness import check, program, spec, trace


@dataclasses.dataclass
class Record:
    """What a per-layer reader may read: the cell, the driver's run (its
    shapes and counts), the window's counts and the traced window."""

    cell: spec.Cell
    run: object
    window: dict
    trace: Optional[trace.TraceSummary]


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> tuple[dict, dict]:
    """(the result object, the numbers the check read, notes for the
    log: the set-up's phases in seconds, the window's counts, and for
    training the leaves the worst gaps are at)."""
    driver = spec.load_driver(cell.traffic["driver"])
    run = driver.Run(cell.config, cell.traffic, seed, device)
    try:
        before = time.perf_counter() - t_start
        run.setup()
        program.sync(device)
        setup_s = time.perf_counter() - t_start
        phases = dict(imports=before, **run.phases)
        if traced:
            window, summary = trace.profile(lambda: run.window_run(seconds))
        else:
            window, summary = run.window_run(seconds), None
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        record = Record(cell, run, window, summary)
        if traced:
            metrics = {}
            for m in cell.per_layer:
                value = spec.load_reader(m["name"])(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            offered = dict(run.end_to_end(window), setup_s=setup_s)
            metrics = {m["name"]: {"value": offered[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        run.release()
        numbers = run.check()
    finally:
        run.close()
    correct, compared = check.judge(numbers, cell.limits["limits"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if traced:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = summary.breakdown()
    result["check"] = compared
    notes = {"setup_phases": phases, "window": window,
             **getattr(run, "worst", {})}
    return result, numbers, notes
