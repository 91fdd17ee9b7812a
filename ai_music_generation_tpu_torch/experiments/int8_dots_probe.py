"""Where K2's int8_dots mode spends its time beside the bf16-dot mode,
measured on the card.

Builds copies of ``ops/csrc`` in each of which one part of the int8_dots
mode of ``ops/csrc/spec_attention_mma.cuh`` is changed (``VARIANTS``), and
times K2 (``spec_attention_update``) with each library at spec_trace's
shapes (B=4096, S=256, H=6, D=64, int8 cache, bf16 q): verify steps (T=8,
the write window at the end of ``--histories`` live history columns) and a
refresh (T=128 at cursor 0, no history), beside the bf16-dot mode (the same
call with int8_dots off) of the unchanged library. The libraries run in
turn and then in reverse order, CUDA events over ``--iters`` calls after a
warm-up; the best of each pair is printed, beside nvcc's register and spill
report for the int8_dots kernels at D=64. A variant marked exact must give
the unchanged library's output bit for bit; the others remove work and are
timed only.

Run on a machine with a CUDA card:

    python -m ai_music_generation_tpu_torch.experiments.int8_dots_probe \\
        [--histories 8,56,120,184,248] [--iters 20]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys

import torch

from ai_music_generation_tpu_torch.experiments import register_caps
from ai_music_generation_tpu_torch.ops import _build

HEADER = "spec_attention_mma.cuh"
DOTS = "spec_attention_dots.cu"
# the body of div_rn: x / s from r = 1/s and two fma steps
DIV_BODY = ("  float y = __fmul_rn(x, r);\n"
            "  y = fmaf(fmaf(-s, y, x), r, y);\n"
            "  return fmaf(fmaf(-s, y, x), r, y);")
# the probabilities' quantizer: a word of 4 values, one fma each
P8 = ("pack_rounded(fmaf(x[0], pc, kRound), fmaf(x[4], pc, kRound),\n"
      "                                   fmaf(x[8], pc, kRound), "
      "fmaf(x[12], pc, kRound))")


def _p8(value: str) -> str:
    """P8's word with ``value`` (of ``x``) in place of each fma."""
    return "pack_rounded(" + ", ".join(
        value.format(x=f"x[{i}]") for i in (0, 4, 8, 12)) + ")"


# name -> (exact, [(text in the header, its replacement)]); each text must
# occur in the header once
VARIANTS = {
    "source": (True, []),
    # q quantized with an IEEE division a value: the same quotients, so
    # the same output
    "ieee_div": (True, [(DIV_BODY, "  return x / s;")]),
    # P quantized in the twin's order, p = e v_scale / sum, then p / ps
    # rounded as an IEEE division (div_rn)
    "p8_div": (False, [(P8, _p8(
        "__fadd_rn(div_rn({x} * inv, ps, 1.f / ps), kRound)"))]),
    # ... and with an IEEE division a value (the mode's first form)
    "p8_ieee": (False, [(P8, _p8("__fadd_rn({x} * inv / ps, kRound)"))]),
    # ... the same, a zero probability quantized without the division
    "p8_ieee_nz": (False, [(P8, _p8(
        "__fadd_rn({x} == 0.f ? 0.f : {x} * inv / ps, kRound)"))]),
    # P rounded by a float-to-int conversion, clipped to [0, 127]
    "p8_f2i": (False, [(P8, "(" + " | ".join(
        f"(static_cast<uint32_t>(min(max(__float2int_rn(x[{i}] * pc), 0), "
        f"127)) << {2 * i})" for i in (0, 4, 8, 12)) + ")")]),
    # q's quantizer skipped (D <= 64): q8 = the bits of q
    "no_q8": (False, [("pack_rounded(q8(f[i][0].x), q8(f[i][0].y), 0.f, 0.f)",
                       "__float_as_uint(f[i][0].x)")]),
    # the probabilities' quantizer pass skipped: P8 never written
    "no_p8": (False, [("if (on) {\n              const float* src",
                       "if (false) {\n              const float* src")]),
}


def variant_header(text: str, edits: list[tuple[str, str]]) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the header no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build(common: list[str]) -> tuple[dict, str]:
    """One library per variant: the bf16 and fp32 sources compiled once
    (the int8_dots mode is not in them), the int8_dots source once per
    variant, every nvcc started together. Returns the libraries loaded and
    nvcc's output."""
    root = _build.BUILD_DIR / "int8_dots_probe"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "common")
    header = (_build.CSRC / HEADER).read_text()
    cmds, objs = [], {}
    for name, (_, edits) in VARIANTS.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        (d / HEADER).write_text(variant_header(header, edits))
        objs[name] = str(d / (DOTS + ".o"))
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                     objs[name], str(d / DOTS)])
    shared = [str(root / "common" / (s + ".o")) for s in common]
    cmds += [[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", o,
              str(root / "common" / s)] for s, o in zip(common, shared)]
    log = _build._run_all(cmds)
    libs = {}
    for name, obj in objs.items():
        lib = root / name / "libspec.so"
        _build._run_all([[_build._nvcc(), *_build.LINK_FLAGS, "-o", str(lib),
                          *shared, obj]])
        cdll = ctypes.CDLL(str(lib))
        for fn_name in ("spec_attention_launch", "spec_attention_f32_launch"):
            fn = getattr(cdll, fn_name)
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[name] = cdll
    return libs, log


def report(log: str) -> list[str]:
    """nvcc's registers and spills of the int8_dots kernels (bf16 q, D=64)
    of each variant's source."""
    rows, where, name = [], None, None
    for line in log.splitlines():
        m = re.match(r"\$ .* (\S+)/" + re.escape(DOTS) + "$", line)
        if m:
            where = m.group(1).rsplit("/", 1)[-1]
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if (name and "13__nv_bfloat16aLi64E" in name and "Lb1E" in name
                and ("spill" in line or "Used" in line)):
            rows_ = 16 if "Li64ELi1ELb1E" in name else 64
            rows.append(f"  {where}, {rows_} rows: "
                        f"{line.split(':', 1)[-1].strip()}")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--histories", default="8,56,120,184,248")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_dots_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs, log = build([s for s in register_caps.SOURCES if s != DOTS])
    print("\n".join(report(log)))
    shapes = [(f"verify, {h} live history columns", 8, h, h)
              for h in (int(x) for x in args.histories.split(","))]
    shapes.append(("refresh", 128, 0, 0))
    runs = [(name, True) for name in libs] + [("source", False)]
    for label, T, cursor, n_live in shapes:
        x = register_caps.inputs(False, T, cursor, n_live)
        k0, v0 = x["k"].clone(), x["v"].clone()
        first, times = None, {run: [] for run in runs}
        for name, dots in runs + runs[::-1]:
            x["k"].copy_(k0)
            x["v"].copy_(v0)
            out = register_caps.launch(libs[name], x, dots=dots)
            if first is None:
                first = out
            elif dots and VARIANTS[name][0] and not torch.equal(out, first):
                raise AssertionError(f"{label}: {name} changed the output")
            times[(name, dots)].append(register_caps.ms_per_call(
                lambda: register_caps.launch(libs[name], x, dots=dots),
                args.iters))
        print(f"{label} (B=4096 S=256 T={T} int8, bf16 q), ms per call: "
              + ", ".join(f"{name if dots else 'bf16-dot'} {min(t):.4f}"
                          for (name, dots), t in times.items()))
        del x, k0, v0, first
    return 0


if __name__ == "__main__":
    sys.exit(main())
