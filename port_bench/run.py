#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``ai_music_generation_tpu_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card: set-up (import,
the kernel library, weights and inputs from the seed, a warm-up at the
cell's shapes; timed as ``setup_s``), then the measured window of
``--seconds`` (with ``--trace 1`` under ``torch.profiler``), then the check
against the plain reference. Prints the numbers compared beside their
limits as the last lines of standard error, and one JSON object as the
last line of standard output. Exits non-zero, printing no result, without
enough CUDA devices, or when a module of JAX or of the JAX package is
loaded once the window has closed.
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


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    env.prepare(ROOT)
    import torch

    from port_bench.harness import runner, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, numbers, notes = runner.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START)
    loaded = env.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"notes {json.dumps(notes)}", file=sys.stderr)
    for name, value in numbers.items():
        if name not in result["check"]:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
