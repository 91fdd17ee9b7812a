"""A decode loop over one layer's cache converted once to the storage
dtype: the port of ``docs/experiments/int4_cache_probe.py``.

    python -m ai_music_generation_tpu_torch.experiments.int4_cache_probe \\
        [--batch 4096] [--seq 256] [--steps 200] [--variants int8,int4] \\
        [--device cuda]

k and v int8 [B, S, H, D] of random values in [-7, 7] from a seeded
``torch.Generator``, bf16 scales of 1; each call converts them to the
variant's dtype (int8, or PyTorch's ``torch.int4``) and runs ``--steps``
T=1 attention steps over them (``bthd,bshd->bhts`` with the k scales,
fp32 softmax, bf16), carrying an fp32 state from step to step. One call
as a warm-up, then one timed with CUDA events: ms a step and the GB/s of
the cache bytes a step reads (one byte a value for int8, half for int4).
A variant that PyTorch cannot run prints its ``FAILED`` line and the probe
goes on. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from ai_music_generation_tpu_torch.experiments.decode_studies import free
from ai_music_generation_tpu_torch.experiments.int4_probe import (
    SEED,
    failure,
    timed_calls,
)

H, D = 6, 64
VARIANTS = ("int8", "int4")
DTYPES = {"int8": torch.int8, "int4": torch.int4}
CARRY = 1e-6  # the state's step (int4_cache_probe.py:34)


def attn_step(q, ck, cv, ks, vs) -> torch.Tensor:
    """int4_cache_probe.py:10-15 (the v scales are passed and unused, as
    there)."""
    att = torch.einsum("bthd,bshd->bhts", q, ck.to(torch.bfloat16)) * (
        1.0 / q.shape[-1] ** 0.5)
    att = att * torch.swapaxes(ks, 1, 2)[:, :, None, :].to(torch.bfloat16)
    att = torch.softmax(att.float(), dim=-1).to(torch.bfloat16)
    return torch.einsum("bhts,bshd->bthd", att, cv.to(torch.bfloat16))


def make_loop(dtype, steps: int):
    """``loop(c0, ck8, cv8, ks, vs)`` (int4_cache_probe.py:26-36): the
    one-time conversion, then ``steps`` steps; the fp32 sum of the state."""

    @torch.inference_mode()
    def loop(c0, ck8, cv8, ks, vs) -> torch.Tensor:
        ck, cv = ck8.to(dtype), cv8.to(dtype)
        B = c0.shape[0]
        c = c0
        for i in range(steps):
            q = (c + i).to(torch.bfloat16).reshape(B, 1, H, D)
            y = attn_step(q, ck, cv, ks, vs)
            c = c + y.reshape(B, H, D).float() * CARRY
        return c.sum()

    return loop


def run(batch: int = 4096, seq: int = 256, steps: int = 200,
        variants=VARIANTS, device: str = "cuda") -> dict:
    gen = torch.Generator(device).manual_seed(SEED)
    shape = (batch, seq, H, D)
    ck8, cv8 = (torch.randint(-7, 8, shape, generator=gen, dtype=torch.int8,
                              device=device) for _ in range(2))
    ks = torch.ones((batch, seq, H), dtype=torch.bfloat16, device=device)
    vs = torch.ones_like(ks)
    c0 = torch.zeros((batch, H, D), device=device)
    out = {}
    for name in variants:
        try:
            loop = make_loop(DTYPES[name], steps)
            _, ms = timed_calls(lambda: loop(c0, ck8, cv8, ks, vs), 1,
                                device)
        except Exception as exc:  # the probe records what PyTorch refuses
            out[name] = failure(name, exc)
            free(device)
            continue
        per_step = ms / steps
        gb = 2 * batch * seq * H * D * (1 if name == "int8" else 0.5) / 1e9
        out[name] = dict(ms_per_call=ms, ms_per_step=per_step,
                         gb_per_step=gb, gb_s=gb / per_step * 1e3)
        print(f"{name}: {ms:.1f} ms a call, {per_step:.3f} ms/step, cache "
              f"read {gb:.2f} GB/step -> {gb / per_step * 1e3:.0f} GB/s",
              flush=True)
        free(device)
    return dict(study="int4_cache_probe", device=torch.device(device).type,
                batch=batch, seq=seq, steps=steps, variants=out)


def main(argv=None) -> dict:
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    result = run(a.batch, a.seq, a.steps, tuple(a.variants.split(",")),
                 device.type)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
