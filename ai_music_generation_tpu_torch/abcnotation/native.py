"""ctypes bindings for the native ABC compiler.

The port's copy of ``ai_music_generation_tpu/abcnotation/native.py`` over
its own copy of the C++ compiler, ``ai_music_generation_tpu_torch/native/
abc_compiler.cpp``. That source is built at first use with ``g++ -O2
-std=c++17 -fPIC -shared`` (the flags of ``native/Makefile``) into the
git-ignored ``ai_music_generation_tpu_torch/_build/``, under a name keyed by
a hash of the source and the flags, so an edited source never loads a stale
library. When there is no compiler or the build fails, :func:`get_parser`
falls back to the pure-Python parser, as the JAX package's loader does; the
two parsers give equal tunes (tests/test_torch_host_copies.py).

``compile_abc`` returns the same :class:`AbcTune` structure as the Python
parser.
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
from fractions import Fraction
from typing import Optional

from ai_music_generation_tpu_torch.abcnotation.parser import AbcNote, AbcParser, AbcTune

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / "abc_compiler.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")


class _AbcEventC(ctypes.Structure):
    _fields_ = [
        ("pitch", ctypes.c_int32),
        ("start_num", ctypes.c_int64),
        ("start_den", ctypes.c_int64),
        ("dur_num", ctypes.c_int64),
        ("dur_den", ctypes.c_int64),
        ("voice", ctypes.c_int32),
    ]


class _AbcResultC(ctypes.Structure):
    _fields_ = [
        ("events", ctypes.POINTER(_AbcEventC)),
        ("n_events", ctypes.c_int32),
        ("meter_num", ctypes.c_int32),
        ("meter_den", ctypes.c_int32),
        ("sharps", ctypes.c_int32),
        ("tempo_bpm", ctypes.c_double),
        ("unit_num", ctypes.c_int64),
        ("unit_den", ctypes.c_int64),
        ("n_voices", ctypes.c_int32),
        ("accomp_voice", ctypes.c_int32),  # -1 = none
    ]


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    for flag in CXX_FLAGS:
        h.update(flag.encode() + b"\0")
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libabc_compiler_{h.hexdigest()[:16]}.so"


def build(path: pathlib.Path) -> None:
    """Compile :data:`SOURCE` into ``path``; raises with g++'s output on
    failure. Built in a temporary directory and renamed, so a concurrent
    loader never sees a half-written library."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        lib = os.path.join(tmp, path.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", lib, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, path)


@functools.cache
def load_library() -> Optional[ctypes.CDLL]:
    """The compiler's shared library, built first if it is missing; None when
    it cannot be built (the Python parser is a full fallback)."""
    path = library_path()
    if not path.exists():
        try:
            build(path)
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            return None
    lib = ctypes.CDLL(str(path))
    lib.abc_compile.argtypes = [ctypes.c_char_p]
    lib.abc_compile.restype = ctypes.POINTER(_AbcResultC)
    lib.abc_compile_opts.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.abc_compile_opts.restype = ctypes.POINTER(_AbcResultC)
    lib.abc_free.argtypes = [ctypes.POINTER(_AbcResultC)]
    lib.abc_free.restype = None
    return lib


def native_available() -> bool:
    return load_library() is not None


def compile_abc(abc_text: str, gchord: bool = False) -> AbcTune:
    """Parse via the native compiler. Raises RuntimeError if it cannot be
    built."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(
            f"native ABC compiler not built (g++ {' '.join(CXX_FLAGS)} "
            f"{SOURCE} failed)"
        )
    res_ptr = lib.abc_compile_opts(abc_text.encode("utf-8"), int(gchord))
    try:
        res = res_ptr.contents
        tune = AbcTune(
            meter=(res.meter_num, res.meter_den),
            unit_length=Fraction(res.unit_num, res.unit_den),
            tempo_bpm=res.tempo_bpm,
            sharps=res.sharps,
            n_voices=res.n_voices,
            accomp_voice=res.accomp_voice if res.accomp_voice >= 0 else None,
        )
        for k in range(res.n_events):
            e = res.events[k]
            tune.notes.append(
                AbcNote(
                    pitch=e.pitch,
                    start=Fraction(e.start_num, e.start_den),
                    duration=Fraction(e.dur_num, e.dur_den),
                    voice=e.voice,
                )
            )
        tune.notes.sort(key=lambda n: (n.voice, n.start, n.pitch))
        return tune
    finally:
        lib.abc_free(res_ptr)


class NativeAbcParser:
    """Drop-in parser using the C++ compiler."""

    def __init__(self, gchord: bool = False):
        self.gchord = gchord

    def parse(self, abc_text: str) -> AbcTune:
        return compile_abc(abc_text, gchord=self.gchord)


def get_parser(prefer_native: bool = True, gchord: bool = False):
    """Best available parser: native if it builds, else the Python one."""
    if prefer_native and native_available():
        return NativeAbcParser(gchord=gchord)
    return AbcParser(gchord=gchord)
