"""K1 (``ops/csrc/gqa_decode*.cu``) of two source trees, timed against
each other on the card in one process.

Builds the ``gqa_decode*.cu`` sources of this checkout's ``ops/csrc`` and of
``--base``
(another version's ``ops/csrc`` directory, e.g. a parent commit's unpacked
with ``git archive`` into a git-ignored directory) into a library each,
under ``_build/k1_ab/``. At each shape the two run in alternating rounds
(base, this, this, base, ...): CUDA events over ``--iters`` calls after a
warm-up, each round's ms printed, then each version's median and spread
((max - min) / min over its rounds) and its median's change from base's.

Before timing, both versions take the same seeded inputs once: the caches
(and int8 scales) they write must be equal bit for bit; the outputs must be
equal bit for bit in lockstep mode and are compared as the largest
difference over the output's range in ring mode (a version may sum a ring
row's columns in another order).

Shapes (D = 64, every row's step at pos S - 1):
- ``gpt_ring``: the GPT serving tick, int8 cache, H=6, KH=2, B=8192, S=128,
  ring, random lengths (chip_smoke.py phase 19's ring timing);
- ``gpt_lockstep``: the same in lockstep mode;
- ``tunes_ring``: the TunesFormer server's patch step, bf16 cache,
  H=KH=12, B=1024, S=128, ring;
- ``tunes_char``: its char step, lockstep, S=32.

Run on a machine with a CUDA card:

    python -m ai_music_generation_tpu_torch.experiments.k1_ab \\
        --base DIR [--rounds 5] [--iters 50]
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
    """One K1 step's operands on the card (the order of
    ``gqa_decode_update``), pos = S - 1."""
    g = torch.Generator().manual_seed(seed)

    def bf(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    q, k_slab, v_slab = bf(B, H, D), bf(B, KH * D), bf(B, KH * D)
    k_scale = v_scale = mask_rel = None
    if quant:
        k, v = (torch.randint(-127, 128, (B, S, KH * D), generator=g,
                              dtype=torch.int8) for _ in range(2))
        k_scale, v_scale = ((torch.rand((B, KH, S), generator=g) * 0.1
                             + 0.01).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = bf(B, S, KH * D), bf(B, S, KH * D)
    if ring:
        lengths = torch.randint(0, S, (B,), generator=g)
        offset = (S - 1 - torch.arange(S)) % S
        mask_rel = (lengths[:, None] - offset[None, :]).to(torch.int32)
    pos = torch.tensor(S - 1, dtype=torch.int32)
    return [None if t is None else t.cuda()
            for t in (q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                      pos)]


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True,
                        help="another version's ops/csrc directory")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ab: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"base": build(pathlib.Path(args.base), "base"),
            "this": build(_build.CSRC, "this")}
    for name, shape in SHAPES.items():
        quant, ring = shape[0], shape[1]
        xs = {v: inputs(*shape) for v in libs}
        outs = {v: launch(libs[v], xs[v], shape) for v in libs}
        torch.cuda.synchronize()
        for i in (1, 2, 5, 6):
            a, b = xs["base"][i], xs["this"][i]
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{name}: the versions wrote other "
                                     f"caches (argument {i})")
        ref = outs["base"].float()
        diff = (outs["this"].float() - ref).abs().max().item() \
            / ref.abs().max().item()
        if not ring and diff != 0:
            raise AssertionError(f"{name}: lockstep outputs differ ({diff})")
        times = {v: [] for v in libs}
        for r in range(args.rounds):
            for v in (("base", "this") if r % 2 == 0 else ("this", "base")):
                times[v].append(ms_per_call(
                    lambda: launch(libs[v], xs[v], shape), args.iters))
        med = {v: statistics.median(t) for v, t in times.items()}
        spread = {v: (max(t) - min(t)) / min(t) for v, t in times.items()}
        print(f"{name} (B={shape[2]} S={shape[3]} H={shape[4]} "
              f"KH={shape[5]} {'int8' if quant else 'bf16'} "
              f"{'ring' if ring else 'lockstep'}): out differs by {diff:.3e}"
              f" of the range; ms per call by round {times}; median base "
              f"{med['base']:.4f} (spread {spread['base']:.4f}), this "
              f"{med['this']:.4f} (spread {spread['this']:.4f}), change "
              f"{med['this'] / med['base'] - 1:+.4f}")
        del xs, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
