"""Multi-process smoke: rendezvous, one sharded train step, one all-reduce
(the port of ``ai_music_generation_tpu/parallel/worker_smoke.py``).

N OS processes join one process group, as ``torchrun`` starts the
reference's DDP ranks (nanoGPT/train.py:86-99); each feeds its rows of one
global batch to a data-parallel GPT train step, and DDP's all-reduce
averages the gradients. The worker runs on the card over NCCL unless it is
given ``--device cpu``, where gloo carries it (the test harness). NCCL
takes one rank a card.

- :func:`run_smoke` builds a (world, 1) mesh over every rank, runs ONE
  sharded train step on a deterministic global batch and an explicit
  all-reduce, and returns scalars. Without a process group (one process)
  it runs the same step on one device: the result the workers must match.
- ``python -m ai_music_generation_tpu_torch.parallel.worker_smoke`` is one
  worker: it joins the group (arguments on process 0, the ``torchrun``
  environment variables on the others, both branches of
  ``parallel/distributed.py``), runs the smoke and prints one JSON line;
  only the main process writes its flag file.
- :func:`launch_multiprocess_smoke` spawns the workers on a free port and
  collects their reports (:func:`launch_workers` spawns any such worker:
  the tests' multi-process workers too).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

SMOKE_VOCAB = 64
SMOKE_BLOCK = 16
SMOKE_BATCH = 8


def run_smoke(device: str = "cuda") -> dict:
    """One (sharded) train step and one all-reduce; deterministic: weights
    from seed 0, the batch from an arange, so every launch topology
    computes the same global step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
    from ai_music_generation_tpu_torch.parallel.mesh import Layout, make_mesh
    from ai_music_generation_tpu_torch.parallel.sharding import parallelize
    from ai_music_generation_tpu_torch.train.optimizer import (
        cosine_warmup_schedule,
        make_optimizer,
    )
    from ai_music_generation_tpu_torch.train.step import make_train_step
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    device = resolve_device(device).type
    world = dist.get_world_size() if dist.is_initialized() else 1
    config = GPTConfig(block_size=SMOKE_BLOCK, vocab_size=SMOKE_VOCAB,
                       n_layer=2, n_head=2, n_embd=32, dropout=0.0,
                       dtype=torch.float32)
    model = GPT(config, device=device)
    init_weights(model, torch.Generator(device).manual_seed(0))
    plan = None
    if dist.is_initialized():
        _, plan = parallelize(model, Layout(make_mesh(world, 1, device)))
    optimizer = make_optimizer(model, 1e-3, 0.1, 0.9, 0.95)
    step = make_train_step(model, optimizer,
                           cosine_warmup_schedule(1e-3, 2, 10, 1e-4), 1.0,
                           plan)
    full_x = (np.arange(SMOKE_BATCH * SMOKE_BLOCK, dtype=np.int64)
              .reshape(1, SMOKE_BATCH, SMOKE_BLOCK) % SMOKE_VOCAB)
    full_y = np.roll(full_x, -1, axis=-1)
    rank = dist.get_rank() if dist.is_initialized() else 0
    rows = SMOKE_BATCH // world
    mine = slice(rank * rows, (rank + 1) * rows)
    metrics = step(torch.from_numpy(full_x[:, mine]).to(device),
                   torch.from_numpy(full_y[:, mine]).to(device), 0)

    # an explicit collective: each rank's index, summed
    value = torch.tensor(float(rank), device=device)
    if dist.is_initialized():
        dist.all_reduce(value)
    return {
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "step": 1,
        "psum": float(value),
        "n_devices": world,
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one rank a card; cpu: gloo")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from ai_music_generation_tpu_torch.parallel.distributed import (
        initialize_distributed,
        is_main_process,
        process_index,
        shutdown,
    )

    if args.process_id == 0:
        info = initialize_distributed(
            args.device, rank=0, world_size=args.num_processes,
            master_addr="localhost", master_port=args.port)
    else:  # the torchrun environment
        os.environ.update(RANK=str(args.process_id),
                          WORLD_SIZE=str(args.num_processes),
                          LOCAL_RANK=str(args.process_id),
                          MASTER_ADDR="localhost",
                          MASTER_PORT=str(args.port))
        info = initialize_distributed(args.device)
    try:
        result = run_smoke(args.device)
        # the only writer (the reference's master_process, nanoGPT/
        # train.py:90-95)
        if is_main_process():
            with open(os.path.join(args.out_dir,
                                   f"main_flag_{process_index()}"), "w") as f:
                f.write("writer\n")
    finally:
        shutdown()
    print(json.dumps({**info, **result}), flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_workers(argv: list[str], num_processes: int,
                   timeout: int = 300) -> list[str]:
    """Run ``python <argv> --port P --process-id i --num-processes n`` in
    ``num_processes`` OS processes (the torchrun role: one free port, one
    rank each) and return their standard outputs in rank order. A worker
    that fails raises with its output; past ``timeout`` seconds every
    worker is stopped and ``subprocess.TimeoutExpired`` raised."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # files, not pipes: a rank blocked on a full pipe would stall the
    # collectives of the others
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(num_processes)]
    procs = [subprocess.Popen(
        [sys.executable, *argv, "--port", str(port), "--process-id", str(i),
         "--num-processes", str(num_processes)],
        env=env, stdout=out, stderr=err, text=True)
        for i, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        outs = []
        for i, (p, (out, err)) in enumerate(zip(procs, logs)):
            out.seek(0)
            err.seek(0)
            outs.append(out.read())
            if p.returncode != 0:
                raise RuntimeError(f"worker {i} failed (rc={p.returncode}):"
                                   f"\n{outs[-1]}\n{err.read()[-20000:]}")
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def launch_multiprocess_smoke(out_dir: str, num_processes: int = 2,
                              timeout: int = 300,
                              device: str = "cuda") -> list[dict]:
    """Spawn the smoke worker on ``device`` in ``num_processes`` OS
    processes (:func:`launch_workers`) and return each one's report, with
    the main processes' flag files as ``main_flags``."""
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        if name.startswith("main_flag_"):
            os.unlink(os.path.join(out_dir, name))
    outs = launch_workers(
        ["-m", "ai_music_generation_tpu_torch.parallel.worker_smoke",
         "--out-dir", out_dir, "--device", device], num_processes, timeout)
    reports = [json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][-1]) for out in outs]
    flags = sorted(n for n in os.listdir(out_dir)
                   if n.startswith("main_flag_"))
    for r in reports:
        r["main_flags"] = flags
    return reports


if __name__ == "__main__":
    main()
