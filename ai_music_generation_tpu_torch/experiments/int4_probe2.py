"""The pure cache-read cost of each storage scheme in PyTorch (no
loop-carried caches, no row writes): the port of
``docs/experiments/int4_probe2.py``.

    python -m ai_music_generation_tpu_torch.experiments.int4_probe2 \\
        [--batch 4096] [--seq 256] [--device cuda]

The caches are built once on the device: ``L`` = 6 layers of k and v,
[L, 2, B, S, H, D] int8 of random values in [-7, 7] from a seeded
``torch.Generator``; the ``int4`` scheme converts them to ``torch.int4``,
the ``packed`` one packs two values a byte (``int4_probe.pack_nibbles``).
Cases (the script's ``:145-152``):

- ``attn-<scheme>``: six production-shaped T=1 attention reads over the
  caches (``bthd,bshd->bhts``, fp32 softmax, bf16; a fresh q between
  layers) - the read with its compute;
- ``sum-<scheme>``: one int32 sum over the stored values
  (``torch.sum(c, dtype=torch.int32)``, the script's ``jnp.sum(
  c.astype(jnp.int32))``), reported in GB/s over the stored bytes (one
  byte a value for int8, half a byte for int4 and packed). The script
  took it as the storage's best read rate; PyTorch converts the input to
  int32 before it reduces, so here it is the rate of that call.

Each case is called once (a warm-up), then 3 more times, timed with CUDA
events. A case that PyTorch cannot run prints its ``FAILED`` line and the
probe goes on. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ai_music_generation_tpu_torch.experiments.int4_probe import (
    D,
    H,
    HBM_BYTES_PER_S,
    L,
    REPS,
    SEED,
    _const,
    as_bf16,
    failure,
    pack_nibbles,
    timed_calls,
    unpack_nibbles,
)
from ai_music_generation_tpu_torch.experiments.decode_studies import free
from ai_music_generation_tpu_torch.experiments.int4_kernel_probe import STEP

SCHEMES = ("int8", "int4", "packed")


def build(batch: int, seq: int, device) -> torch.Tensor:
    """The int8 caches [L, 2, B, S, H, D], values in [-7, 7]
    (int4_probe2.py:100-111)."""
    gen = torch.Generator(device).manual_seed(SEED)
    return torch.randint(-7, 8, (L, 2, batch, seq, H, D), generator=gen,
                         dtype=torch.int8, device=device)


def attend(q4, ck, cv, unpack) -> torch.Tensor:
    """int4_probe2.py:117-121: the T=1 chain without scales."""
    sm = _const(1.0 / math.sqrt(q4.shape[-1]), q4)
    att = torch.einsum("bthd,bshd->bhts", q4, unpack(ck)) * sm
    att = torch.softmax(att.float(), dim=-1).to(torch.bfloat16)
    return torch.einsum("bhts,bshd->bthd", att, unpack(cv))


@torch.inference_mode()
def six_layers(q, caches, unpack) -> torch.Tensor:
    """int4_probe2.py:123-127: each layer's read, q carried between."""
    step = _const(STEP, q)
    for layer in range(L):
        o = attend(q[:, None], caches[layer, 0], caches[layer, 1],
                   unpack)[:, 0]
        q = q + o * step
    return q.float().sum()


@torch.inference_mode()
def sum_bytes(cache) -> torch.Tensor:
    """One pass over the stored bytes (the sum in int32)."""
    return torch.sum(cache, dtype=torch.int32)


def run(batch: int = 4096, seq: int = 256, device: str = "cuda") -> dict:
    c8 = build(batch, seq, device)
    gen = torch.Generator(device).manual_seed(SEED + 1)
    q0 = torch.randn((batch, H, D), generator=gen, device=device).to(
        torch.bfloat16)
    bytes8 = c8.numel()  # one byte a value
    stored = {"int8": (lambda: c8, as_bf16, bytes8),
              "int4": (lambda: c8.to(torch.int4), as_bf16, bytes8 // 2),
              "packed": (lambda: pack_nibbles(c8), unpack_nibbles,
                         bytes8 // 2)}
    out = {}
    for scheme in SCHEMES:
        make, unpack, nbytes = stored[scheme]
        try:
            cache = make()
        except Exception as exc:  # the probe records what PyTorch refuses
            for kind in ("attn", "sum"):
                out[f"{kind}-{scheme}"] = failure(f"{kind}-{scheme}", exc,
                                                  250)
            continue
        for kind, fn in (("attn", lambda: six_layers(q0, cache, unpack)),
                         ("sum", lambda: sum_bytes(cache))):
            label = f"{kind}-{scheme}"
            try:
                _, ms = timed_calls(fn, REPS, device)
            except Exception as exc:
                out[label] = failure(label, exc, 250)
                continue
            gbs = nbytes / (ms / 1e3) / 1e9
            out[label] = dict(ms_per_call=ms, bytes=nbytes, gb_s=gbs)
            print(f"  {label}: {ms:.2f} ms/call x{REPS} ({gbs:.0f} GB/s "
                  f"over {nbytes / 1e6:.0f} MB)", flush=True)
        del cache
        free(device)
    return dict(study="int4_probe2", device=torch.device(device).type,
                batch=batch, seq=seq, reps=REPS,
                hbm_gb_s=HBM_BYTES_PER_S / 1e9, cases=out)


def main(argv=None) -> dict:
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    result = run(a.batch, a.seq, device.type)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
