"""Can PyTorch itself store and read a half-byte KV cache? The port of
``docs/experiments/int4_probe.py``: a stripped decode-attention loop over
loop-carried caches, one storage scheme a variant.

    python -m ai_music_generation_tpu_torch.experiments.int4_probe \\
        [--batch 4096] [--seq 256] [--steps 16] \\
        [--variants int8,packed,int4] [--device cuda]

Each step reads ``L`` = 6 layers' caches (the production einsum chain at
T=1, with [B, H, S] bf16 scales; a fresh q between layers, ``q = q + o *
1e-3``) and writes one fresh quantized row of each layer's k and v in
place (row 0), so the caches are really carried by the Python loop.
Storage schemes:

  int8    k/v int8 [B, S, H, D] (the production layout)
  packed  k/v int8 [B, S, H, D/2], two int4 nibbles a byte: the first D/2
          values in the low nibbles, the second D/2 in the high ones
          (:func:`pack_nibbles`); read through :func:`unpack_nibbles`
          (integer shifts and a concatenation, then bf16)
  int4    k/v ``torch.int4`` [B, S, H, D] (PyTorch's own dtype)

A variant that PyTorch cannot run prints its ``FAILED`` line and the probe
goes on. Each variant is called once (a warm-up), then 3 more times,
timed with CUDA events (the host clock on the CPU). The caches are
allocated inside the call, as the script's jit creates them. K7
(``experiments/int4_kernel_probe.py``) is the kernel answer to the same
question; this probe measures PyTorch's own storage. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ai_music_generation_tpu_torch.experiments.decode_studies import free
from ai_music_generation_tpu_torch.experiments.int4_kernel_probe import (
    HBM_BYTES_PER_S,
    _bf16,
)

H, D, L = 6, 64, 6
VARIANTS = ("int8", "packed", "int4")
STEP = _bf16(1e-3)  # q = q + o * bf16(1e-3), as the script's constants
SCALE = 0.01  # every cache scale (int4_probe.py:157-158)
REPS, SEED = 3, 0  # timed calls after the warm-up; the seed of q0


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 [..., D] of values in [-8, 7] -> int8 [..., D/2]: element j in
    the low nibble and element D/2 + j in the high one
    (int4_probe.py:127-133)."""
    half = q.shape[-1] // 2
    return (q[..., :half] & 0xF) | torch.bitwise_left_shift(q[..., half:], 4)


def unpack_nibbles(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [..., D/2] -> ``dtype`` [..., D]: the sign-extended low nibbles,
    then the high ones (int4_probe.py:135-140, int4_probe2.py:90-95)."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(x, 4), 4)
    hi = torch.bitwise_right_shift(x, 4)
    return torch.cat([lo, hi], dim=-1).to(dtype)


def as_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim bf16 constant (a bf16 product rounds once, as in XLA)."""
    return torch.tensor(_bf16(x), dtype=torch.bfloat16, device=like.device)


def attend(q4, ck, cv, ks, vs, unpack=as_bf16) -> torch.Tensor:
    """The production T=1 chain ``bthd,bshd->bhts`` (int4_probe.py:
    94-104): q4 [B, 1, H, D] bf16, ck/cv the stored caches (``unpack``
    reads them as bf16 [B, S, H, D]), ks/vs [B, H, S] bf16 scales; returns
    [B, 1, H, D] bf16."""
    sm = _const(1.0 / math.sqrt(q4.shape[-1]), q4)
    att = torch.einsum("bthd,bshd->bhts", q4, unpack(ck)) * sm
    att = att * ks[:, :, None, :]
    att = torch.softmax(att.float(), dim=-1).to(torch.bfloat16)
    att = att * vs[:, :, None, :]
    return torch.einsum("bhts,bshd->bthd", att, unpack(cv))


def quantizer(scheme: str):
    """(storage dtype, stored last dim, row quantizer, unpack) of
    ``scheme``: the row quantizer maps bf16 [B, 1, H, D] to storage."""
    if scheme == "int8":
        return (torch.int8, D, lambda x: torch.clamp(
            torch.round(x.float()), -127, 127).to(torch.int8), as_bf16)
    if scheme == "int4":
        return (torch.int4, D, lambda x: torch.clamp(
            torch.round(x.float()), -7, 7).to(torch.int4), as_bf16)
    if scheme == "packed":
        return (torch.int8, D // 2, lambda x: pack_nibbles(torch.clamp(
            torch.round(x.float()), -7, 7).to(torch.int8)), unpack_nibbles)
    raise ValueError(f"unknown scheme {scheme!r} (of {VARIANTS})")


def make_run(scheme: str, batch: int, seq: int, steps: int):
    """``run(q0)``: ``steps`` steps of the loop over fresh zero caches of
    ``scheme`` (int4_probe.py:142-171); returns the fp32 sum of the last
    q, a 0-dim tensor."""
    dtype, last, quant, unpack = quantizer(scheme)

    @torch.inference_mode()
    def run(q0: torch.Tensor) -> torch.Tensor:
        dev = q0.device
        caches = [(torch.zeros((batch, seq, H, last), dtype=dtype,
                               device=dev),
                   torch.zeros((batch, seq, H, last), dtype=dtype,
                               device=dev),
                   torch.full((batch, H, seq), SCALE, dtype=torch.bfloat16,
                              device=dev),
                   torch.full((batch, H, seq), SCALE, dtype=torch.bfloat16,
                              device=dev))
                  for _ in range(L)]
        step = _const(STEP, q0)
        q = q0
        for _ in range(steps):
            for ck, cv, ks, vs in caches:
                o = attend(q[:, None], ck, cv, ks, vs, unpack)[:, 0]
                q = q + o * step
                row = quant(q[:, None] * 8)
                ck[:, :1] = row  # the fresh row, in place
                cv[:, :1] = row
        return q.float().sum()

    return run


def timed_calls(fn, reps: int, device) -> tuple[float, float]:
    """(first call's wall s, mean ms of ``reps`` more calls): CUDA events
    on the card, the host clock on the CPU; ``fn()`` returns a tensor."""
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    float(fn())
    first = time.perf_counter() - t0
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        float(out)
        ms = (time.perf_counter() - t0) * 1e3 / reps
    return first, ms


def failure(label: str, exc: Exception, width: int = 300) -> dict:
    """A variant PyTorch could not run: its ``FAILED`` line, as the script
    prints it, and its record."""
    text = f"{type(exc).__name__}: {str(exc)[:width]}"
    print(f"{label}: FAILED {text}", flush=True)
    return {"failed": text}


def run(batch: int = 4096, seq: int = 256, steps: int = 16,
        variants=VARIANTS, device: str = "cuda") -> dict:
    gen = torch.Generator(device).manual_seed(SEED)
    q0 = torch.randn((batch, H, D), generator=gen, device=device).to(
        torch.bfloat16)
    out = {}
    for scheme in variants:
        try:
            fn = make_run(scheme, batch, seq, steps)
            first, ms = timed_calls(lambda: fn(q0), REPS, device)
            out[scheme] = dict(first_s=first, ms_per_call=ms,
                               ms_per_step=ms / steps,
                               ms_per_layer_read=ms / steps / L)
            print(f"{scheme}: first call {first:.1f}s; {ms:.1f} ms/call x"
                  f"{REPS} -> {ms / steps:.3f} ms/step "
                  f"({ms / steps / L:.3f} ms/layer-read)", flush=True)
        except Exception as exc:  # the probe records what PyTorch refuses
            out[scheme] = failure(scheme, exc)
        free(device)
    cache_bytes = 2 * L * batch * seq * H * D  # int8, both caches
    return dict(study="int4_probe", device=torch.device(device).type,
                batch=batch, seq=seq, steps=steps, reps=REPS,
                int8_cache_bytes=cache_bytes,
                int8_floor_ms_per_step=cache_bytes / HBM_BYTES_PER_S * 1e3,
                variants=out)


def main(argv=None) -> dict:
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=16)
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
