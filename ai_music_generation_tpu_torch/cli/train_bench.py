"""Training-step benchmark of the port (``ai_music_generation_tpu/cli/
train_bench.py``; nanoGPT's bench.py):

    python -m ai_music_generation_tpu_torch.cli.train_bench --remat=True

- simple mode: ``burn_in`` steps, then ``num_steps`` timed steps (host clock
  between two ``torch.cuda.synchronize()``), reporting ms/iter, MFU against
  the card's peak (``models/gpt.py::peak_flops_for``), the last loss and
  the peak device memory;
- profile mode (``--profile=True``): the timed steps under
  ``torch.profiler``, a Chrome trace written to ``trace_dir`` and the top
  device operations printed.

Batches are memmap samples when ``dataset`` is given, else random tokens
from a ``torch.Generator`` seeded with ``seed`` on the device, new for every
step. The step is ``train/step.py``'s with AdamW at lr 6e-4 and a clip at 1.
``--n_expert=4`` (with ``--expert_top_k``, ``--capacity_factor``,
``--moe_aux_coef``) times an MoE model; its MFU counts every expert, as
JAX's does, so it is inflated. The run is on the card unless
``--device=cpu``.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ai_music_generation_tpu_torch.data.memmap import BinDataset
from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    estimate_mfu,
    peak_flops_for,
)
from ai_music_generation_tpu_torch.train.optimizer import make_optimizer
from ai_music_generation_tpu_torch.train.step import make_train_step
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides
from ai_music_generation_tpu_torch.utils.device import resolve_device

DEFAULTS = dict(
    batch_size=12,
    block_size=1024,
    n_layer=12,
    n_head=12,
    n_embd=768,
    dropout=0.0,
    bias=False,
    vocab_size=50304,
    dataset="",  # optional: data_root/<dataset>/train.bin for real batches
    data_root="data",
    profile=False,
    trace_dir="bench_trace",
    burn_in=5,
    num_steps=20,
    seed=1337,
    dtype="bfloat16",
    device="cuda",
    remat=False,
    attn_impl="xla",  # "flash": scaled_dot_product_attention
    n_expert=0,  # Mixture-of-Experts (models/moe.py): experts a block MLP
    expert_top_k=2,
    capacity_factor=1.25,
    moe_aux_coef=0.01,
)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(c: dict) -> dict:
    """The bench's model (init weights from ``seed``), step and batches:
    {config, model, step, get_batch, n_params, device}."""
    device = resolve_device(c["device"])
    cfg = GPTConfig(
        block_size=c["block_size"], vocab_size=c["vocab_size"],
        n_layer=c["n_layer"], n_head=c["n_head"], n_embd=c["n_embd"],
        dropout=c["dropout"], bias=c["bias"], remat=c["remat"],
        attn_impl=c["attn_impl"], n_expert=c["n_expert"],
        expert_top_k=c["expert_top_k"],
        capacity_factor=c["capacity_factor"],
        moe_aux_coef=c["moe_aux_coef"],
        dtype=torch.bfloat16 if c["dtype"] == "bfloat16" else torch.float32,
    )
    model = init_weights(GPT(cfg, device=device),
                         torch.Generator(device).manual_seed(c["seed"]))
    step = make_train_step(model, make_optimizer(model, 6e-4))
    shape = (1, c["batch_size"], c["block_size"])
    if c["dataset"]:
        ds = BinDataset(os.path.join(c["data_root"], c["dataset"],
                                     "train.bin"))

        def get_batch(it):
            x, y = ds.sample(c["seed"], it, shape[:2], c["block_size"])
            return (torch.from_numpy(x).to(device),
                    torch.from_numpy(y).to(device))
    else:
        gen = torch.Generator(device).manual_seed(c["seed"])

        def get_batch(it):
            return tuple(torch.randint(0, c["vocab_size"], shape,
                                       generator=gen, device=device)
                         for _ in range(2))
    return dict(config=cfg, model=model, step=step, get_batch=get_batch,
                n_params=model.num_params(), device=device)


def timed_steps(b: dict, first: int, n: int, seed: int) -> tuple[float, float]:
    """Steps ``first .. first+n-1``: (seconds per step, last loss)."""
    sync(b["device"])
    t0 = time.perf_counter()
    for it in range(first, first + n):
        metrics = b["step"](*b["get_batch"](it), it, seed)
    loss = float(metrics["loss"])
    sync(b["device"])
    return (time.perf_counter() - t0) / n, loss


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    c = apply_overrides(dict(DEFAULTS), argv)
    b = setup(c)
    device = b["device"]
    peak = peak_flops_for(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"parameters: {b['n_params']/1e6:.2f}M | peak {peak/1e12:.0f} "
          f"TFLOP/s | {name}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timed_steps(b, 0, c["burn_in"], c["seed"])
    first = c["burn_in"]
    if c["profile"]:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            dt, loss = timed_steps(b, first, c["num_steps"], c["seed"])
        os.makedirs(c["trace_dir"], exist_ok=True)
        prof.export_chrome_trace(os.path.join(c["trace_dir"], "trace.json"))
        sort = ("self_cuda_time_total" if device.type == "cuda"
                else "self_cpu_time_total")
        print(prof.key_averages().table(sort_by=sort, row_limit=15))
        print(f"trace written to {c['trace_dir']}")
    else:
        dt, loss = timed_steps(b, first, c["num_steps"], c["seed"])
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else None)
    mfu = estimate_mfu(b["config"], b["n_params"], c["batch_size"], dt, peak)
    print(f"time per iteration: {dt*1000:.4f}ms, MFU: {mfu*100:.2f}%, loss "
          f"{loss:.4f}" + ("" if peak_bytes is None else
                           f", peak memory {peak_bytes / 2**30:.2f} GiB"))
    return dict(ms=dt * 1e3, mfu=mfu, loss=loss, peak_bytes=peak_bytes)


if __name__ == "__main__":
    main()
