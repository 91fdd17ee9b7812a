"""The register cap of the speculative-verify kernel's fp32 verify blocks,
measured on the card.

``ops/csrc/spec_attention_mma.cuh::mma_min_blocks`` names the blocks of a
regime that share an SM, and so caps each thread's registers. This builds
copies of ``ops/csrc`` whose cap for an fp32 q's verify blocks over an int8
cache is each of ``--caps`` (every other cap as the source has it), and
times K2 (``spec_attention_update``) with each library at the bench spec
shape (B=4096, S=256, H=6, D=64, int8 cache): a verify step (T=5 at cursor
S-8, 248 live history columns) and a refresh (T=128 at cursor 0, no
history), with an fp32 q and with a bf16 q. The libraries run in turn and
then in reverse order, CUDA events over ``--iters`` calls after a warm-up;
the best of each pair is printed, beside nvcc's register and spill report
for the kernels at D=64. Every library's output must equal the first's bit
for bit (a cap moves registers, not arithmetic).

Run on a machine with a CUDA card:

    python -m ai_music_generation_tpu_torch.experiments.register_caps \\
        [--caps 8,7,6,5] [--iters 20]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys

import torch

from ai_music_generation_tpu_torch.models.gpt import KVCache
from ai_music_generation_tpu_torch.ops import _build

SOURCES = ("spec_attention.cu", "spec_attention_f32.cu",
           "spec_attention_dots.cu")
# the cap of an fp32 q's verify blocks over an int8 cache in mma_min_blocks
CAP = re.compile(r"(std::is_same<QT, float>::value \? )(\d+)( : 8\))")


def build(cap: int):
    """A library of the spec sources with the fp32 verify cap set to
    ``cap``; returns it loaded, and nvcc's report."""
    d = _build.BUILD_DIR / "register_caps" / f"cap{cap}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    header = d / "spec_attention_mma.cuh"
    text, n = CAP.subn(rf"\g<1>{cap}\g<3>", header.read_text())
    if n != 1:
        raise RuntimeError("mma_min_blocks no longer holds the fp32 verify cap")
    header.write_text(text)
    objs = [str(d / f"{s}.o") for s in SOURCES]
    log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", o,
                            str(d / s)] for s, o in zip(SOURCES, objs)])
    lib = d / "libspec.so"
    _build._run_all([[_build._nvcc(), *_build.LINK_FLAGS, "-o", str(lib),
                      *objs]])
    cdll = ctypes.CDLL(str(lib))
    for name in ("spec_attention_launch", "spec_attention_f32_launch"):
        fn = getattr(cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return cdll, log


def report(log: str) -> list[str]:
    """nvcc's registers and spills of the tensor-core kernels at D=64."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if not name or "spec_attention_mma_kernel" not in name \
                or "Li64E" not in name:
            continue
        q = "fp32" if re.search(r"I(fa|ff)Li64", name) else "bf16"
        cache = ("int8" if "aLi64" in name else
                 "fp32" if "IffLi64" in name else "bf16")
        rows_ = 16 if "Li64ELi1E" in name else 64
        if "spill" in line or "Used" in line:
            rows.append(f"  q {q}, cache {cache}, {rows_} rows: "
                        f"{line.split(':', 1)[-1].strip()}")
    return rows


def inputs(fp32: bool, T: int, cursor: int, n_live: int, B=4096, S=256,
           H=6, D=64, seed=1) -> dict:
    """One K2 call's operands on the card: every row reads the n_live
    history columns outside the write window and the T fresh ones."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    HD, Tw = H * D, -(-T // 8) * 8
    hist = torch.cat([torch.arange(cursor), torch.arange(cursor + Tw, S)])
    col_pos = torch.full((B, S), KVCache.INVALID_POS, dtype=torch.int32)
    col_pos[:, hist[:n_live]] = torch.arange(n_live, dtype=torch.int32)
    col_pos[:, cursor:cursor + T] = n_live + torch.arange(T,
                                                          dtype=torch.int32)
    k, v, k_slab, v_slab = (torch.randint(-127, 128, (B, n, HD),
                                          dtype=torch.int8, **kw)
                            for n in (S, S, Tw, Tw))
    k_scale, v_scale = ((torch.rand((B, H, S), **kw) * 0.02 + 0.002)
                        .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, T, HD), **kw)
    return dict(q=q if fp32 else q.to(torch.bfloat16), k=k, v=v,
                k_slab=k_slab, v_slab=v_slab, k_scale=k_scale,
                v_scale=v_scale, col_pos=col_pos.cuda(),
                lengths=torch.full((B,), n_live, dtype=torch.int32,
                                   device="cuda"),
                cursor=torch.tensor(cursor, dtype=torch.int32,
                                    device="cuda"))


def launch(cdll, x: dict, H: int = 6, dots: bool = False) -> torch.Tensor:
    """K2 through ``cdll``, as ops/spec_attention.py::_launch calls it
    (``dots``: in int8_dots mode)."""
    q = x["q"]
    B, T, HD = q.shape
    out = torch.empty_like(q)
    args = [x[n].data_ptr() for n in ("q", "k", "v", "k_slab", "v_slab",
                                      "k_scale", "v_scale", "col_pos",
                                      "lengths", "cursor")]
    args += [out.data_ptr(), B, T, x["k"].shape[1], H, HD // H, 1]
    stream = torch.cuda.current_stream().cuda_stream
    rc = (cdll.spec_attention_f32_launch if q.dtype == torch.float32
          else cdll.spec_attention_launch)(*args, int(dots), stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: {rc}")
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
    parser.add_argument("--caps", default="8,7,6,5")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("register_caps: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {}
    for cap in (int(c) for c in args.caps.split(",")):
        libs[cap], log = build(cap)
        print(f"cap {cap}:\n" + "\n".join(report(log)))
    for label, fp32, T, cursor, n_live in (
            ("fp32 q verify", True, 5, 248, 248),
            ("fp32 q refresh", True, 128, 0, 0),
            ("bf16 q verify", False, 5, 248, 248),
            ("bf16 q refresh", False, 128, 0, 0)):
        x = inputs(fp32, T, cursor, n_live)
        first, times = None, {cap: [] for cap in libs}
        for cap in list(libs) + list(libs)[::-1]:
            out = launch(libs[cap], x)
            if first is None:
                first = out
            elif not torch.equal(out, first):
                raise AssertionError(f"{label}: cap {cap} changed the output")
            times[cap].append(ms_per_call(lambda: launch(libs[cap], x),
                                          args.iters))
        print(f"{label} (B=4096 S=256 T={T} int8), ms per call by cap: "
              + ", ".join(f"{cap}: {min(t):.4f}" for cap, t in times.items()))
        del x, first
    return 0


if __name__ == "__main__":
    sys.exit(main())
