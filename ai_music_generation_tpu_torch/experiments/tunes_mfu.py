"""TunesFormer training-step MFU on the card: the port of
``docs/experiments/tunes_mfu.py``.

    python -m ai_music_generation_tpu_torch.experiments.tunes_mfu \\
        [--batches=8,32] [--device=cuda]

Protocol (the JAX probe's): the reference-width TunesFormer
(``TunesFormerConfig(dropout=0.0)``: 9 patch + 3 char layers, 768 wide, 12
heads, a 128 x 32 patch grid), bf16 compute over fp32 parameters, the
port's train step (``train/tunes_step.py``) with ``optax_adamw`` at a
constant lr ``LR``; batches of ASCII bodies (3..127) framed by bos (column 0)
and eos (column S-1), drawn from a seeded ``torch.Generator`` before the
clock starts (no time salt). Per batch size: one step under
``torch.utils.flop_counter.FlopCounterMode`` (the FLOP count, in place of
the JAX probe's XLA cost analysis), two more burn-in steps, then ``STEPS``
steps timed with CUDA events; MFU is the count over the mean step time over
``peak_flops_for()`` (989 TFLOP/s on an H100). :func:`analytic_flops` is
the count by formula, which the CPU tests hold FlopCounterMode's to.

Prints one line of JSON: ``{"tunes_mfu": [{"batch", "ms_per_iter",
"tflop_per_step", "analytic_tflop", "mfu", "peak_gib", "loss"}, ...],
"device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ai_music_generation_tpu_torch.models.gpt import peak_flops_for
from ai_music_generation_tpu_torch.models.tunesformer import (
    CHAR_VOCAB,
    TunesFormerConfig,
)

# the JAX probe's protocol: timed steps, burn-in steps (the first under
# FlopCounterMode), the seed of the weights and batches, the constant lr
STEPS, BURN_IN, SEED, LR = 10, 3, 0, 5e-5


def analytic_flops(cfg: TunesFormerConfig, B: int) -> int:
    """The step's matmul FLOPs by formula: 3 x the forward's (the backward
    takes two products for each forward one), the forward ``2 x tokens x
    weights`` of each core (its blocks' four projections, 12 C^2 a layer;
    the char core also the tied head's 128 x C) plus the attention's ``4 x
    tokens x T x C`` a layer (Q K^T and P V over the full T x T: the einsum
    chain computes the masked half too). The patch core sees B x P tokens
    of T = P; the char core B x (P - 1) bars of T = S tokens."""
    P, S, C = cfg.patch_length, cfg.patch_size, cfg.n_embd
    lp, lc = (cfg.patch_core_config().n_layer, cfg.char_core_config().n_layer)
    patch_tokens, char_tokens = B * P, B * (P - 1) * S
    forward = (2 * patch_tokens * lp * 12 * C * C
               + 2 * char_tokens * (lc * 12 * C * C + CHAR_VOCAB * C)
               + 4 * patch_tokens * P * C * lp
               + 4 * char_tokens * S * C * lc)
    return 3 * forward


def ascii_batch(gen: torch.Generator, B: int, cfg: TunesFormerConfig,
                device) -> torch.Tensor:
    """[B, P, S] int32: ASCII bodies (3..127), bos (1) in column 0, eos (2)
    in column S-1 (JAX docs/experiments/tunes_mfu.py:77-81)."""
    body = torch.randint(3, 128, (B, cfg.patch_length, cfg.patch_size),
                         generator=gen, device=device, dtype=torch.int32)
    body[:, :, 0] = 1
    body[:, :, -1] = 2
    return body


def count_flops(fn) -> int:
    """FLOPs of ``fn()`` as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def run(B: int, cfg: TunesFormerConfig, steps: int = STEPS,
        burn_in: int = BURN_IN, device="cuda") -> dict:
    """One batch size of the protocol (the module docstring)."""
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import TunesFormer
    from ai_music_generation_tpu_torch.train.optimizer import optax_adamw
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_train_step,
    )

    device = torch.device(device)
    cuda = device.type == "cuda"
    model = TunesFormer(cfg, device="cpu")
    init_tunesformer_weights(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    opt = optax_adamw(model.parameters())
    step = make_tunesformer_train_step(
        model, opt, lambda count: torch.full_like(count, LR))
    gen = torch.Generator(device).manual_seed(SEED)
    batches = [ascii_batch(gen, B, cfg, device)
               for _ in range(burn_in + steps)]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    flops = count_flops(lambda: step(batches[0], 0))
    for it in range(1, burn_in):
        step(batches[it], it)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    else:
        t0 = time.perf_counter()
    for it in range(burn_in, burn_in + steps):
        loss = step(batches[it], it)
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    return dict(batch=B, ms_per_iter=ms, tflop_per_step=flops / 1e12,
                analytic_tflop=analytic_flops(cfg, B) / 1e12,
                mfu=flops / (ms / 1e3) / peak_flops_for(device),
                peak_gib=peak, loss=float(loss))


def main(argv=None) -> dict:
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,32")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    cfg = TunesFormerConfig(dropout=0.0)
    results = []
    for B in (int(b) for b in a.batches.split(",")):
        results.append(run(B, cfg, device=device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {"tunes_mfu": results,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
