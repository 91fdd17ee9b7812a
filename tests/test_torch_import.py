"""The port imports without JAX, Triton or nvcc.

Each check runs in a fresh interpreter: this test process has jax loaded
already (tests/conftest.py imports it).
"""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "ai_music_generation_tpu_torch",
    "ai_music_generation_tpu_torch.decode.generate",
    "ai_music_generation_tpu_torch.decode.speculative",
    "ai_music_generation_tpu_torch.experiments",
    "ai_music_generation_tpu_torch.experiments.int4_kernel_probe",
    "ai_music_generation_tpu_torch.models.convert",
    "ai_music_generation_tpu_torch.models.gpt",
    "ai_music_generation_tpu_torch.ops._build",
    "ai_music_generation_tpu_torch.ops.decode_attention",
    "ai_music_generation_tpu_torch.ops.decode_attention_int8",
    "ai_music_generation_tpu_torch.ops.gqa_decode",
    "ai_music_generation_tpu_torch.ops.lean_attention",
    "ai_music_generation_tpu_torch.ops.spec_attention",
]


def _run(code, **env):
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, **env})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_never_imports_jax():
    out = _run(
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ai_music_generation_tpu')))\n")
    assert out.strip() == "[]"


def test_port_imports_without_triton_or_nvcc():
    """Importing (and running on the CPU) builds nothing: no nvcc on PATH
    and no triton module are needed."""
    out = _run(
        "import importlib, sys\n"
        "sys.modules['triton'] = None  # any import of triton raises\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import dataclasses, torch\n"
        "from ai_music_generation_tpu_torch.decode.generate import Generator\n"
        "from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig\n"
        "from ai_music_generation_tpu_torch.ops import _build\n"
        "from ai_music_generation_tpu_torch.ops.gqa_decode import "
        "gqa_decode_update\n"
        "from ai_music_generation_tpu_torch.decode.speculative import "
        "SpecGenerator\n"
        "from ai_music_generation_tpu_torch.ops.spec_attention import "
        "spec_attention_update\n"
        "from ai_music_generation_tpu_torch.ops.decode_attention import "
        "decode_attention\n"
        "cfg = GPTConfig(block_size=16, vocab_size=16, n_layer=1, n_head=2, "
        "n_embd=32)\n"
        "GPT(cfg, device='cpu')(torch.zeros((1, 4), dtype=torch.int32))\n"
        "Generator(GPT(dataclasses.replace(cfg, attn_impl='pallas'), "
        "device='cpu'), max_new_tokens=4).generate([[1, 2, 3]])\n"
        "SpecGenerator(GPT(cfg, device='cpu'), max_new_tokens=4).generate("
        "[[1, 2, 3]])\n"
        "from ai_music_generation_tpu_torch.experiments.int4_kernel_probe "
        "import run_variant\n"
        "from ai_music_generation_tpu_torch.ops.lean_attention import "
        "lean_attention\n"
        "run_variant('lean4', batch=2, seq=4, device='cpu')\n"
        "print(_build.load_library.cache_info().currsize, "
        "gqa_decode_update.launches, spec_attention_update.launches, "
        "decode_attention.launches, lean_attention.launches)\n",
        PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent")
    assert out.split() == ["0", "0", "0", "0", "0"]


def test_build_key_tracks_sources_and_flags(monkeypatch, tmp_path):
    from ai_music_generation_tpu_torch.ops import _build

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert _build.library_path() == path  # stable
    assert [p.name for p in _build.sources()] == [
        "decode_attention.cu", "gqa_decode.cu", "lean_attention.cu",
        "spec_attention.cu"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path() != path
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.undo()
    src = tmp_path / "k.cu"
    src.write_text("// edited")
    monkeypatch.setattr(_build, "sources", lambda: [src])
    before = _build.library_path()
    src.write_text("// edited again")
    assert _build.library_path() != before
