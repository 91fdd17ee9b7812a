"""A run driven past the look for a card, on the CPU at a tiny size, with
the timed path sound and then broken underneath (``harness/faults.py``):
``correct`` must come out true, then false for every fault the driver can
have. Also: such a run loads no module of JAX or of the JAX package."""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from port_bench.harness import faults, runner, spec

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[2]

MODEL = {"n_layer": 2, "n_head": 4, "n_embd": 64, "n_kv_head": 2,
         "block_size": 64, "vocab_size": 50, "bias": False,
         "dtype": "bfloat16", "param_dtype": "float32"}
CONFIG = {"model": MODEL,
          "decode": {"kv_quantized": True, "flat_kv": True, "window": 32},
          "train": {"dropout": 0.2, "learning_rate": 1e-3,
                    "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.99,
                    "grad_clip": 1.0, "warmup_iters": 100,
                    "lr_decay_iters": 5000, "min_lr": 1e-4}}
TRAFFIC = {
    "decode": {"driver": "decode", "batch": 8, "prompt_len": 5,
               "new_tokens": 60, "temperature": 0.8, "top_k": 20,
               "greedy_every": 2, "check_rows": 4},
    "train": {"driver": "train", "micro_batch": 4, "grad_accum": 2,
              "corpus_tokens": 100000, "log_interval": 2, "check_rows": 2},
}
# limits for this size, between its sound readings (greedy gap <= 1e-3,
# grad gap <= 2e-3) and its faults' (>= 0.04)
LIMITS = {
    "decode": {"greedy_gap": 0.02, "topk_gap": 0.02, "prompt_changed": 0},
    "train": {"loss_gap": 1e-3, "grad_gap": 0.02, "change_gap": 0.02},
}


def tiny_cell(kind):
    return spec.Cell(f"tiny.{kind}", 1, CONFIG, TRAFFIC[kind],
                     {"limits": LIMITS[kind]},
                     [{"name": "setup_s", "unit": "s"}], [])


def run(kind, seed=3_000_000_019):
    result, numbers, _ = runner.run_cell(tiny_cell(kind), seed, 0.05, False,
                                         "cpu", time.perf_counter())
    return result, numbers


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_sound_run_is_correct(kind):
    result, numbers = run(kind)
    assert result["correct"], numbers
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("kind,fault", [(k, f) for k, fs in
                                        faults.FAULTS.items() for f in fs])
def test_fault_makes_the_run_incorrect(kind, fault):
    with faults.plant(fault, CONFIG):
        result, numbers = run(kind)
    assert not result["correct"], numbers


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from port_bench.harness import env\n"
        "from port_bench.tests import test_port_bench_faults as t\n"
        "t.run('decode'); t.run('train')\n"
        "print(json.dumps(env.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
