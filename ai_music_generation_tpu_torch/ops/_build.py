"""Build the port's CUDA kernels from ``ops/csrc/*.cu`` at first use.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes``. No source includes PyTorch's headers, so a build
takes seconds: every source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects. The
library goes to ``ai_music_generation_tpu_torch/_build/`` (git-ignored)
under a name keyed by a hash of the sources and the flags: an edited source
or flag builds a new library, and a stale one is never loaded. nvcc's output
(including ``-Xptxas -v``: registers, shared memory, spills per kernel) is
kept beside the library as ``<name>.log``.

Nothing here runs at import time; the CPU tests import this module on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"

# sm_90a (not sm_90): the target of Hopper's wgmma/setmaxnreg, which the
# kernels' later, faster versions need. No --use_fast_math: it makes float
# division approximate, and the int8 scales must stay bit-exact with
# models/gpt.py::quantize_int8.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# what a launcher returns, without launching, when the buffers of one block
# at the call's shape exceed shared memory (each source computes its own
# layout); every other non-zero return is a cudaError_t
TOO_LARGE = -1


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS + ("--link",) + LINK_FLAGS:
        h.update(flag.encode() + b"\0")
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libaimg_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use")
    return found


def _run_all(commands: list[list[str]]) -> str:
    """Run the commands concurrently; return their joined output, or raise
    with it if any failed. Every process is waited for."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    logs, failed = [], []
    for cmd, proc in zip(commands, procs):
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode})")
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return log


def build(path: pathlib.Path) -> None:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into ``path``; write nvcc's output to ``path.with_suffix('.log')``.
    Raises with that output on failure."""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory and rename: a concurrent loader never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, path.name)
        log += "\n" + _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        path.with_suffix(".log").write_text(log)
        os.replace(lib, path)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if it is missing."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr, n_int in (("gqa_decode_update_launch", 10, 6),
                               ("spec_attention_launch", 11, 7),
                               ("decode_attention_launch", 7, 5),
                               ("lean_attention_launch", 6, 5)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        fn.restype = i32
    return lib
