"""The training step's MFU, split into forward, backward and optimizer:
the port of ``docs/experiments/mfu_sweep.py``.

    python -m ai_music_generation_tpu_torch.experiments.mfu_sweep \\
        [--model=124m|music] [--variants=fwd,fwdbwd,full,flash,remat,big] \\
        [--device=cuda]

Models (:data:`MODELS`, the script's ``:55-68``): ``124m`` GPT-2 124M
(12L/12H/768d, block 1024, vocab 50304) at batch 12, its big batches 24
then 16; ``music`` the music shape (6L/6H/384d, block 256, vocab 95) at
batch 64, its big batches 512, 256, 128. bf16 compute over fp32
parameters, no dropout, seeded init weights. Variants, each on a fresh
copy of the same weights:

- ``fwd``: the loss only (no gradients);
- ``fwdbwd``: the loss and its backward, no optimizer;
- ``full``: ``train/step.py::make_train_step`` with
  ``make_optimizer(6e-4)`` (the trainer's step: the clip at 1 and AdamW);
- ``flash``: ``full`` with ``attn_impl="flash"`` (the port's SDPA);
- ``remat``: ``full`` with ``remat=True``;
- ``big``: ``full`` at the first big batch that fits; only
  ``torch.cuda.OutOfMemoryError`` moves on to the next.

Each runs 3 burn-in steps, then 5 steps timed with CUDA events (the host
clock on the CPU), on batches of random ids from a seeded device
``torch.Generator``. Prints the MFU table (``models/gpt.py::estimate_mfu``
against ``peak_flops_for()``: 989 TFLOP/s on an H100; it counts 6N FLOPs
a token whatever the variant, as the script does), the line
``breakdown @ B=...: fwd / bwd / optimizer+state``, then one JSON line.
These paths launch none of the port's kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import torch

from ai_music_generation_tpu_torch.experiments.decode_studies import free

# (batch, GPTConfig widths, big batches): mfu_sweep.py:55-68
MODELS = {
    "124m": (12, dict(block_size=1024, vocab_size=50304, n_layer=12,
                      n_head=12, n_embd=768), (24, 16)),
    "music": (64, dict(block_size=256, vocab_size=95, n_layer=6, n_head=6,
                       n_embd=384), (512, 256, 128)),
}
VARIANTS = ("fwd", "fwdbwd", "full", "flash", "remat", "big")
# the table's row names (mfu_sweep.py:151-236)
LABELS = {
    "fwd": "fwd (loss only)",
    "fwdbwd": "fwdbwd (no optimizer)",
    "full": "full step (accum-1 fast path)",
    "flash": "full step, flash attention",
    "remat": "full step, block remat",
}
BURN, STEPS, SEED, LR = 3, 5, 0, 6e-4


def make_config(widths: dict, **overrides):
    from ai_music_generation_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(dropout=0.0, bias=False, **widths, **overrides)


def init_state(cfg, seed: int = SEED) -> dict:
    """Seeded init weights as a CPU state dict: every variant's start."""
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def build(cfg, state: dict, device):
    """A GPT of ``cfg`` on ``device`` holding ``state``."""
    from ai_music_generation_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device=device)
    model.load_state_dict(state)
    return model


def loss_only(model, x, y) -> torch.Tensor:
    """The ``fwd`` variant: the mean loss, no gradients recorded."""
    with torch.no_grad():
        return model(x, y)[1]


def loss_and_grads(model, x, y) -> torch.Tensor:
    """The ``fwdbwd`` variant: the mean loss, its gradients left in each
    parameter's ``.grad`` (set anew, not summed)."""
    for p in model.parameters():
        p.grad = None
    loss = model(x, y)[1]
    loss.backward()
    return loss.detach()


def full_step(model) -> Callable:
    """The ``full`` variant (and ``flash``, ``remat``, ``big``): the
    trainer's step with AdamW at lr 6e-4."""
    from ai_music_generation_tpu_torch.train.optimizer import make_optimizer
    from ai_music_generation_tpu_torch.train.step import make_train_step

    step = make_train_step(model, make_optimizer(model, LR))
    return lambda x, y, it: step(x[None], y[None], it)["loss"]


def batches(vocab: int, batch: int, T: int, n: int, device,
            seed: int = SEED) -> list:
    """``n`` (x, y) pairs of [batch, T] random ids from a seeded
    ``torch.Generator`` on ``device``, drawn before the clock starts."""
    gen = torch.Generator(device).manual_seed(seed)
    return [tuple(torch.randint(0, vocab, (batch, T), generator=gen,
                                device=device) for _ in range(2))
            for _ in range(n)]


def time_variant(fn: Callable, data: list, burn: int = BURN,
                 steps: int = STEPS) -> tuple[float, float]:
    """(seconds a step, the last loss) of ``fn(x, y, it)`` over ``steps``
    timed steps after ``burn`` burn-in ones (CUDA events on the card)."""
    x0 = data[0][0]
    cuda = x0.device.type == "cuda"
    for it in range(burn):
        fn(*data[it], it)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for it in range(burn, burn + steps):
        loss = fn(*data[it], it)
    if cuda:
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1000 / steps
    else:
        dt = (time.perf_counter() - t0) / steps
    return dt, float(loss)


def first_big(run_at: Callable[[int], tuple], big_batches) -> tuple:
    """(batch, ``run_at(batch)``, failures) for the first big batch whose
    run fits: ``torch.cuda.OutOfMemoryError`` moves on to the next (its
    text in ``failures``), any other error propagates; (None, None,
    failures) when none fits."""
    failures = []
    for b in big_batches:
        try:
            return b, run_at(b), failures
        except torch.cuda.OutOfMemoryError as exc:
            failures.append(f"batch {b}: {str(exc)[:120]}")
            print(f"  batch {b} failed: {type(exc).__name__}: "
                  f"{str(exc)[:120]}", flush=True)
        # the traceback (and the failed run's tensors) is gone here
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return None, None, failures


def mfu_table(cfg, n_params: int, results: dict, peak: float) -> dict:
    """Each result's MFU: ``estimate_mfu(cfg, n_params, batch, dt,
    peak)`` (the script's ``:238-242``)."""
    from ai_music_generation_tpu_torch.models.gpt import estimate_mfu

    return {name: estimate_mfu(cfg, n_params, r["batch"], r["s"], peak)
            for name, r in results.items()}


def breakdown(results: dict) -> Optional[dict]:
    """fwd, bwd (fwdbwd - fwd) and optimizer+state (full - fwdbwd) in ms,
    when the three variants ran (the script's ``:244-251``)."""
    if not all(k in results for k in ("fwd", "fwdbwd", "full")):
        return None
    fwd, fb, full = (results[k]["s"] * 1e3 for k in ("fwd", "fwdbwd",
                                                      "full"))
    return dict(batch=results["full"]["batch"], fwd_ms=fwd, bwd_ms=fb - fwd,
                optimizer_ms=full - fb)


def run(model: str = "124m", variants=VARIANTS, device: str = "cuda",
        widths: Optional[dict] = None, batch: Optional[int] = None,
        big_batches=None, burn: int = BURN, steps: int = STEPS) -> dict:
    """The sweep of ``variants`` at ``model``'s shapes (``widths``,
    ``batch`` and ``big_batches`` override them: a cut run)."""
    from ai_music_generation_tpu_torch.models.gpt import peak_flops_for

    device = torch.device(device)
    B, base, bigs = MODELS[model]
    B = batch or B
    bigs = tuple(big_batches or bigs)
    cfg = make_config(dict(base, **(widths or {})))
    T, vocab = cfg.block_size, cfg.vocab_size
    state = init_state(cfg)
    n_params = build(cfg, state, "cpu").num_params()
    peak = peak_flops_for(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"params {n_params / 1e6:.2f}M  peak {peak / 1e12:.0f} TFLOP/s  "
          f"device {name}", flush=True)
    n = burn + steps
    data = batches(vocab, B, T, n, device)
    results, failures = {}, []

    def timed(key, fn, data, batch):
        dt, loss = time_variant(fn, data, burn, steps)
        results[key] = dict(s=dt, batch=batch, loss=loss)
        print(f"  {key}: {dt * 1e3:.1f} ms/iter", flush=True)

    def full_at(overrides: dict) -> Callable:
        model = build(dataclasses.replace(cfg, **overrides), state, device)
        return full_step(model)

    if "fwd" in variants:
        m = build(cfg, state, device).eval()
        timed("fwd", lambda x, y, it: loss_only(m, x, y), data, B)
    if "fwdbwd" in variants:
        m = build(cfg, state, device).eval()
        timed("fwdbwd", lambda x, y, it: loss_and_grads(m, x, y), data, B)
    m = None
    free(device)
    for key, overrides in (("full", {}), ("flash", dict(attn_impl="flash")),
                           ("remat", dict(remat=True))):
        if key in variants:
            timed(key, full_at(overrides), data, B)
            free(device)
    if "big" in variants:
        def run_at(b):
            return time_variant(full_at({}), batches(vocab, b, T, n, device),
                                burn, steps)

        b, out, failures = first_big(run_at, bigs)
        if b is not None:
            results[f"full{b}"] = dict(s=out[0], batch=b, loss=out[1])
            print(f"  full{b}: {out[0] * 1e3:.1f} ms/iter", flush=True)
    mfu = mfu_table(cfg, n_params, results, peak)
    print(f"\n{'variant':36s} {'ms/iter':>9s} {'MFU':>7s}")
    for key, r in results.items():
        label = LABELS.get(key, f"full step @ batch {r['batch']}")
        print(f"{label:36s} {r['s'] * 1e3:9.1f} {mfu[key] * 100:6.1f}%",
              flush=True)
    split = breakdown(results)
    if split:
        print(f"\nbreakdown @ B={split['batch']}: fwd {split['fwd_ms']:.1f} "
              f"ms, bwd {split['bwd_ms']:.1f} ms, optimizer+state "
              f"{split['optimizer_ms']:.1f} ms")
    return dict(
        study="mfu_sweep", model=model, device=str(device.type),
        device_name=name, batch=B, block_size=T, n_params=n_params,
        peak_flops=peak, big_failures=failures,
        variants={k: dict(ms=r["s"] * 1e3, batch=r["batch"], loss=r["loss"],
                          mfu=mfu[k]) for k, r in results.items()},
        breakdown=split)


def main(argv=None) -> dict:
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="124m", choices=sorted(MODELS))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--burn", type=int, default=BURN)
    ap.add_argument("--steps", type=int, default=STEPS)
    # a cut run (tests, rehearsals): the model's widths and batches
    for k in ("n_layer", "n_head", "n_embd", "block_size", "vocab_size",
              "batch"):
        ap.add_argument(f"--{k}", type=int, default=None)
    ap.add_argument("--big_batches", default=None,
                    help="comma-separated (default: the model's)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    variants = tuple(a.variants.split(","))
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)} (of {VARIANTS})")
    widths = {k: getattr(a, k) for k in ("n_layer", "n_head", "n_embd",
                                          "block_size", "vocab_size")
              if getattr(a, k) is not None}
    bigs = (tuple(int(b) for b in a.big_batches.split(","))
            if a.big_batches else None)
    result = run(a.model, variants, device.type, widths, a.batch, bigs,
                 a.burn, a.steps)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
