"""K1 (``ops/csrc/gqa_decode*.cu``) of two or more source trees, timed
against each other on the card in one process.

Builds the ``gqa_decode*.cu`` sources of this checkout's ``ops/csrc``, of
``--base`` (another version's ``ops/csrc`` directory, e.g. a parent
commit's unpacked with ``git archive`` into a git-ignored directory) and of
each ``--variant NAME=DIR`` (a copy of the sources with one part changed)
into a library each, under ``_build/k1_ab/``. At each shape the versions
run in alternating rounds (base, this, variants, then the reverse, ...):
CUDA events over ``--iters`` calls after a warm-up, each round's ms
printed, then each version's median and spread ((max - min) / min over its
rounds) and its median's change from base's.

Before timing, every version takes the same seeded inputs once: the caches
(and int8 scales) it writes must equal base's bit for bit. At G = H/KH > 1
the output must equal base's bit for bit too. At G = 1 (gqa_decode_mha.cuh
since its redesign) a version may sum in another order, so the output is
compared as the largest difference over the output's range, and must stay
within one bf16 ulp of it (2^-7).

Shapes (D = 64, every row's step at pos S - 1):
- ``gpt_ring``: the GPT serving tick, int8 cache, H=6, KH=2, B=8192, S=128,
  ring, random lengths (chip_smoke.py phase 19's ring timing);
- ``gpt_lockstep``: the same in lockstep mode;
- ``tunes_ring``: the TunesFormer server's patch step, bf16 cache,
  H=KH=12, B=1024, S=128, ring;
- ``tunes_char``: its char step, lockstep, S=32;
- ``moe_step``: the MoE model's decode step, bf16, lockstep, B=256, S=256,
  H=KH=6 (chip_smoke.py phase 36);
- ``gpt2_step``: GPT-2 124M's decode step, bf16, lockstep, B=256, S=1024,
  H=KH=12 (phase 43);
- ``mha_int8``: the bench shape at MHA, int8, lockstep, B=4096, S=128,
  H=KH=6.

Run on a machine with a CUDA card:

    python -m ai_music_generation_tpu_torch.experiments.k1_ab \\
        --base DIR [--variant NAME=DIR ...] [--shapes NAME,...] \\
        [--rounds 5] [--iters 50]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import torch

from ai_music_generation_tpu_torch.ops import _build

# name: (int8 cache, ring, B, S, H, KH)
SHAPES = {
    "gpt_ring": (True, True, 8192, 128, 6, 2),
    "gpt_lockstep": (True, False, 8192, 128, 6, 2),
    "tunes_ring": (False, True, 1024, 128, 12, 12),
    "tunes_char": (False, False, 1024, 32, 12, 12),
    "moe_step": (False, False, 256, 256, 6, 6),
    "gpt2_step": (False, False, 256, 1024, 12, 12),
    "mha_int8": (True, False, 4096, 128, 6, 6),
}
D = 64


def build(csrc: pathlib.Path, name: str) -> ctypes.CDLL:
    """The ``gqa_decode*.cu`` sources of ``csrc`` (with its headers) built
    alone into a library under ``_build/k1_ab/<name>`` (one nvcc each, in
    parallel); returns it loaded, after printing ptxas's registers and
    spills of its D=64 kernels."""
    d = _build.BUILD_DIR / "k1_ab" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    srcs = sorted(d.glob("gqa_decode*.cu"))
    objs = [str(src.with_suffix(".o")) for src in srcs]
    log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                            obj, str(src)] for src, obj in zip(srcs, objs)])
    lib = d / "libk1.so"
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        elif kernel and "Li64E" in kernel and ("Used" in line
                                               or "spill" in line):
            print(f"{name} {kernel}: {line.split(':', 1)[-1].strip()}")
    _build._run_all([[_build._nvcc(), *_build.LINK_FLAGS, "-o", str(lib),
                      *objs]])
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.gqa_decode_update_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return cdll


def inputs(quant, ring, B, S, H, KH, seed=0) -> list:
    """One K1 step's operands, drawn on the card from a seeded generator
    (the order of ``gqa_decode_update``), pos = S - 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")

    def bf(*shape):
        return torch.randn(shape, **kw).to(torch.bfloat16)

    q, k_slab, v_slab = bf(B, H, D), bf(B, KH * D), bf(B, KH * D)
    k_scale = v_scale = mask_rel = None
    if quant:
        k, v = (torch.randint(-127, 128, (B, S, KH * D), dtype=torch.int8,
                              **kw) for _ in range(2))
        k_scale, v_scale = ((torch.rand((B, KH, S), **kw) * 0.1
                             + 0.01).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, KH * D), bf(B, S, KH * D)
    if ring:
        lengths = torch.randint(0, S, (B,), **kw)
        offset = (S - 1 - torch.arange(S, device="cuda")) % S
        mask_rel = (lengths[:, None] - offset[None, :]).to(torch.int32)
    pos = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    return [q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos]


def launch(cdll, x, shape) -> torch.Tensor:
    quant, _, B, S, H, KH = shape
    out = torch.empty_like(x[0])
    rc = cdll.gqa_decode_update_launch(
        *[None if t is None else t.data_ptr() for t in x], out.data_ptr(),
        B, S, H, KH, D, int(quant), 0,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: {rc}")
    return out


def ms_per_call(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_ms(x, shape, iters) -> dict:
    """ms of ``scaled_dot_product_attention`` over the same step's columns
    (attention only: no column write), the yardstick of chip_smoke.py's K1
    rows: K and V copied to [B, H, S, D] once, outside the timed calls (as
    chip_smoke.py times it), and the cache's own layout viewed so."""
    import torch.nn.functional as F

    _, _, B, S, H, _ = shape
    q, k, v, mask = x[0][:, :, None, :], x[1], x[2], x[7]
    kt, vt = (t.view(B, S, H, D).transpose(1, 2) for t in (k, v))
    m = None if mask is None else (mask >= 0)[:, None, None, :]
    res = {}
    for layout, (kk, vv) in (("[B, H, S, D] copies", (kt.contiguous(),
                                                       vt.contiguous())),
                             ("the cache's [B, S, H*D]", (kt, vt))):
        res[layout] = min(ms_per_call(lambda: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=m), iters) for _ in range(2))
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True,
                        help="another version's ops/csrc directory")
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=DIR",
                        help="one more version's ops/csrc directory")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="comma-separated names of SHAPES to time")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ab: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dirs = {"base": pathlib.Path(args.base), "this": _build.CSRC}
    for spec in args.variant:
        name, _, d = spec.partition("=")
        dirs[name] = pathlib.Path(d)
    libs = {name: build(d, name) for name, d in dirs.items()}
    order = list(libs)
    for name in args.shapes.split(","):
        shape = SHAPES[name]
        quant, ring, H, KH = shape[0], shape[1], shape[4], shape[5]
        xs = {v: inputs(*shape) for v in libs}
        outs = {v: launch(libs[v], xs[v], shape) for v in libs}
        torch.cuda.synchronize()
        ref = outs["base"].float()
        diffs = {}
        for v in order[1:]:
            for i in (1, 2, 5, 6):
                a, b = xs["base"][i], xs[v][i]
                if a is not None and not torch.equal(a, b):
                    raise AssertionError(f"{name}: {v} wrote other caches "
                                         f"than base (argument {i})")
            diffs[v] = (outs[v].float() - ref).abs().max().item() \
                / ref.abs().max().item()
            if H > KH and diffs[v] != 0:
                raise AssertionError(f"{name}: {v}'s output differs from "
                                     f"base's at G > 1 ({diffs[v]})")
            if not diffs[v] <= 2.0 ** -7:
                raise AssertionError(f"{name}: {v}'s output differs from "
                                     f"base's by {diffs[v]} of the range")
        times = {v: [] for v in libs}
        for r in range(args.rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                times[v].append(ms_per_call(
                    lambda: launch(libs[v], xs[v], shape), args.iters))
        med = {v: statistics.median(t) for v, t in times.items()}
        spread = {v: (max(t) - min(t)) / min(t) for v, t in times.items()}
        print(f"{name} (B={shape[2]} S={shape[3]} H={H} KH={KH} "
              f"{'int8' if quant else 'bf16'} "
              f"{'ring' if ring else 'lockstep'}): out differs from base's by"
              f" {diffs} of the range; ms per call by round {times}")
        for v in order:
            print(f"  {name} {v}: median {med[v]:.4f} ms (spread "
                  f"{spread[v]:.4f}), change {med[v] / med['base'] - 1:+.4f}")
        if H == KH and not quant:
            for layout, ms in sdpa_ms(xs["base"], shape, args.iters).items():
                print(f"  {name} SDPA over {layout}: {ms:.4f} ms (attention "
                      f"only, best of 2)")
        del xs, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
