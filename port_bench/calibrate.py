#!/usr/bin/env python3
"""The readings that the limits of ``port_bench/workloads/<cell>.json`` are
set from, in one process (one build, one import):

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--fault-seeds 31,32,33] [--seconds 3]

For each of ``--seeds``, a run of the cell as ``run.py`` makes it (set-up,
a window of ``--seconds``, the check): the program's numbers, the lower
readings. For each of ``--control-seeds``, the same run, then the control:
the reference one precision step below what the configuration states, in
the program's place (the upper readings). For each of ``--fault-seeds``,
a run with each fault of ``harness/faults.py`` that the cell's driver can
have planted under the timed path. One JSON line a run on standard output,
and the same lines in ``chiprun_out/calibrate_<cell>.jsonl``. The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench.harness import env  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    env.prepare(ROOT)
    import torch

    from port_bench.harness import check, faults, program, runner, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    kind = cell.traffic["driver"]
    driver = spec.load_driver(kind)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = open(out / f"calibrate_{cell.name}.jsonl", "a")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    def one(seed, control=False, fault=None):
        run = driver.Run(cell.config, cell.traffic, seed, "cuda")
        t0 = time.perf_counter()
        try:
            run.setup()
            program.sync("cuda")
            setup_s = time.perf_counter() - t0
            window = run.window_run(args.seconds)
            e2e = run.end_to_end(window)
            run.release()
            t1 = time.perf_counter()
            numbers = run.check()
            check_s = time.perf_counter() - t1
            rec = {"seed": seed, "fault": fault, "program": numbers,
                   "correct": check.judge(numbers, cell.limits["limits"])[0],
                   "setup_s": setup_s, "check_s": check_s, "window": window,
                   **e2e}
            rec.update(phases=getattr(run, "phases", None),
                       worst=getattr(run, "worst", None))
            if control:
                rec["control"] = run.control()
                rec["control_worst"] = getattr(run, "worst", None)
        finally:
            run.close()
        emit(rec)

    emit({"device": torch.cuda.get_device_name(0), "cell": cell.name,
          "start_s": time.perf_counter() - T_START})
    for seed in args.seeds:
        one(seed)
    for seed in args.control_seeds:
        one(seed, control=True)
    for seed in args.fault_seeds:
        for name in faults.FAULTS[kind]:
            with faults.plant(name, cell.config):
                one(seed, fault=name)
    # one run of run.py's own path, so the result line is seen too
    result, _, notes = runner.run_cell(cell, (args.seeds or [1])[0], args.seconds,
                                False, "cuda", time.perf_counter())
    emit({"run_cell": result, "notes": notes})
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
