"""The control of every cell, on the card: the plain reference one precision
step below what the configuration states (float8 products; an int8 cache
lowered to int4), put in the program's place, must fail the cell's
limits. At each cell's own size, with the shortest window its traffic
allows (a decode window of one greedy and one sampled generate)."""

import pytest
import torch

from port_bench.harness import check, program, spec

BENCH = spec.load_benchmark()
SHORTER = {"decode": {"greedy_every": 2}, "train": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [4_000_000_001, 4_000_000_002,
                                  4_000_000_003])
def test_control_fails_the_limits(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.resolve(BENCH, name)
    kind = cell.traffic["driver"]
    traffic = dict(cell.traffic, **SHORTER[kind])
    run = spec.load_driver(kind).Run(cell.config, traffic, seed, "cuda")
    try:
        run.setup()
        program.sync("cuda")
        run.window_run(0.0)
        run.release()
        sound = run.check()
        low = run.control()
    finally:
        run.close()
    assert check.judge(sound, cell.limits["limits"])[0], sound
    assert not check.judge(low, cell.limits["limits"])[0], low
