"""The lean T=1 decode-attention probe (K7) on the card: ms per layer-read
of a 6-layer read loop over an int8 or a position-packed int4 cache, beside
the plain int8 einsum step, each against its byte floor.

Port of ``docs/experiments/int4_kernel_probe.py`` (its ``run_variant`` and
``main``). Variants, each a read loop over ``L`` = 6 per-layer caches with a
fresh q between layers (``q = q + o * 1e-3`` in bf16):

  xla8   the plain PyTorch einsum step over an int8 [B, S, H, D] cache with
         [B, S, H] bf16 scales
  lean8  ``ops.lean_attention`` over an unpacked int8 [B, S, HD] cache
  lean4  ``ops.lean_attention`` over a position-packed int4 [B, S/2, HD]
         cache: two distinct random int4 values in every byte
         (``ops.lean_attention.pack_int4``)

Caches and queries come from an explicit ``torch.Generator`` seeded with
``seed``; each layer's caches are separate tensors. A step is timed with
CUDA events over ``iters`` steps after one warm-up step; the floor is the
bytes one layer-read must move (each input read once, each output written
once) over the card's 3.35 TB/s. The probe runs on the card and raises
without one, unless the caller passes ``device="cpu"`` (the tests), which
runs the same steps through the plain twins and times nothing.

Run on a machine with a CUDA card:

    python -m ai_music_generation_tpu_torch.experiments.int4_kernel_probe \\
        [--batch 4096] [--seq 256] [--variants lean8,lean4,xla8]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from ai_music_generation_tpu_torch.ops.lean_attention import (
    lean_attention,
    pack_int4,
)

L, H, D = 6, 6, 64
HD = H * D
VARIANTS = ("lean8", "lean4", "xla8")
# published H100 SXM device-memory rate (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12


def _bf16(x: float) -> float:
    """x rounded to bf16, as JAX's ``jnp.bfloat16(x)`` constants are."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


STEP = _bf16(1e-3)


def random_layer(name, batch, seq, generator):
    """One layer's (k, v, k_scale, v_scale) of variant ``name`` on the
    generator's device. xla8: int8 [B, S, H, D] in [-127, 127], scales
    [B, S, H]; lean8: int8 [B, S, HD] in [-128, 127]; lean4: [B, S/2, HD]
    bytes of two independent int4 values in [-8, 7]; lean scales [B, H, S].
    Scales are bf16 draws from [0.5, 1.5)."""
    kw = dict(generator=generator, device=generator.device)
    if name == "xla8":
        k, v = (torch.randint(-127, 128, (batch, seq, H, D), dtype=torch.int8,
                              **kw) for _ in range(2))
        scale_shape = (batch, seq, H)
    elif name == "lean8":
        k, v = (torch.randint(-128, 128, (batch, seq, HD), dtype=torch.int8,
                              **kw) for _ in range(2))
        scale_shape = (batch, H, seq)
    elif name == "lean4":
        if seq % 2:
            raise ValueError(f"lean4 packs position halves: seq {seq} must "
                             f"be even")
        k, v = (pack_int4(*(torch.randint(-8, 8, (batch, seq // 2, HD),
                                          dtype=torch.int8, **kw)
                            for _ in range(2))) for _ in range(2))
        scale_shape = (batch, H, seq)
    else:
        raise ValueError(f"unknown variant {name!r}: one of {VARIANTS}")
    k_scale, v_scale = (torch.empty(scale_shape, device=generator.device)
                        .uniform_(0.5, 1.5, generator=generator)
                        .to(torch.bfloat16) for _ in range(2))
    return k, v, k_scale, v_scale


def random_query(name, batch, generator):
    """The step's first query, bf16 normal: [B, H, D] for xla8, [B, HD] for
    the lean variants."""
    shape = (batch, H, D) if name == "xla8" else (batch, HD)
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(torch.bfloat16)


def lean_step(q, layers, packed: bool, record=None):
    """One read of every layer through ``lean_attention`` (the kernel on the
    card, the twin on the CPU), q updated between layers. Appends each
    layer's (q, out) to ``record`` when one is given. Returns the last q."""
    for k, v, k_scale, v_scale in layers:
        o = lean_attention(q, k, v, k_scale, v_scale, packed, n_head=H)
        if record is not None:
            record.append((q, o))
        q = q + o.to(torch.bfloat16) * STEP
    return q


def xla8_step(q, layers):
    """One read of every layer through the plain einsum chain of the JAX
    probe's xla8 step (int4_kernel_probe.py:241-258): the int8 cache cast
    to bf16, scores and PV in bf16, softmax in fp32. q [B, H, D] bf16."""
    sm = _bf16(1.0 / math.sqrt(D))
    for ck, cv, ks, vs in layers:
        att = torch.einsum("bthd,bshd->bhts", q[:, None],
                           ck.to(torch.bfloat16)) * sm
        att = att * ks.transpose(1, 2)[:, :, None, :]
        att = torch.softmax(att.float(), dim=-1).to(torch.bfloat16)
        att = att * vs.transpose(1, 2)[:, :, None, :]
        o = torch.einsum("bhts,bshd->bthd", att, cv.to(torch.bfloat16))[:, 0]
        q = q + o * STEP
    return q


def layer_bytes(q, layer) -> int:
    """Bytes one layer-read must move: q, K, V and their scales read once,
    the output written once (fp32 [B, HD] for the lean variants, bf16
    [B, H, D] for xla8)."""
    out = q.numel() * (2 if q.dim() == 3 else 4)
    return q.nbytes + sum(t.nbytes for t in layer) + out


def run_variant(name, batch=4096, seq=256, device="cuda", seed=0, iters=3):
    """Build variant ``name``'s L layers and first query from ``seed``, run
    one step (the warm-up), then on the card time ``iters`` more with CUDA
    events. Returns a dict: ``steps`` (all steps run), ``q`` (the last
    step's result), ``q0`` and ``layers`` (the inputs), ``ms_per_layer``
    (None on the CPU, where nothing is timed), ``floor_ms`` and
    ``floor_bytes`` (per layer-read)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probe runs on a CUDA card and none is "
                           "available (pass device='cpu' to run it on the "
                           "CPU, untimed)")
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}: one of {VARIANTS}")
    g = torch.Generator(device=device).manual_seed(seed)
    layers = [random_layer(name, batch, seq, g) for _ in range(L)]
    q0 = random_query(name, batch, g)
    if name == "xla8":
        step = lambda: xla8_step(q0, layers)  # noqa: E731
    else:
        step = lambda: lean_step(q0, layers, name == "lean4")  # noqa: E731
    q = step()
    ms = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            q = step()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters / L
    n_bytes = layer_bytes(q0, layers[0])
    return dict(name=name, steps=1 + (iters if ms is not None else 0), q=q,
                q0=q0, layers=layers, ms_per_layer=ms, floor_bytes=n_bytes,
                floor_ms=n_bytes / HBM_BYTES_PER_S * 1e3)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated, of " + ", ".join(VARIANTS))
    parser.add_argument("--device", default="cuda",
                        help="cuda (timed) or cpu (untimed, the twins)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    with torch.inference_mode():
        for name in args.variants.split(","):
            t0 = time.perf_counter()
            r = run_variant(name, args.batch, args.seq, args.device)
            total = float(r["q"].float().sum())
            print(f"{name}: built and ran {r['steps']} steps in "
                  f"{time.perf_counter() - t0:.1f} s (sum of q {total:.1f})",
                  flush=True)
            ms, floor = r["ms_per_layer"], r["floor_ms"]
            timing = ("not timed on the CPU" if ms is None else
                      f"{ms:.4f} ms per layer-read, {floor / ms:.3f} of "
                      f"the floor")
            print(f"  {name} B={args.batch} S={args.seq}: floor {floor:.4f} "
                  f"ms ({r['floor_bytes'] / 1e6:.1f} MB); {timing}",
                  flush=True)
            del r
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
