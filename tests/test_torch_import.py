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
    "ai_music_generation_tpu_torch.__main__",
    "ai_music_generation_tpu_torch.abcnotation.from_musicxml",
    "ai_music_generation_tpu_torch.abcnotation.music21_oracle",
    "ai_music_generation_tpu_torch.abcnotation.native",
    "ai_music_generation_tpu_torch.abcnotation.parser",
    "ai_music_generation_tpu_torch.abcnotation.to_midi",
    "ai_music_generation_tpu_torch.cli.abc_to_midi_wav_and_aesthetics",
    "ai_music_generation_tpu_torch.cli.add_control_codes",
    "ai_music_generation_tpu_torch.cli.aesthetics_ab",
    "ai_music_generation_tpu_torch.cli.audio_aes",
    "ai_music_generation_tpu_torch.cli.bach_pipeline",
    "ai_music_generation_tpu_torch.cli.batch_convert_xml",
    "ai_music_generation_tpu_torch.cli.build_synthetic_4parts",
    "ai_music_generation_tpu_torch.cli.create_generations_ranking",
    "ai_music_generation_tpu_torch.cli.irishman_pipeline",
    "ai_music_generation_tpu_torch.cli.midi_and_wav_to_aesthetics",
    "ai_music_generation_tpu_torch.cli.midi_to_text",
    "ai_music_generation_tpu_torch.cli.midi_to_wav_and_aesthetics",
    "ai_music_generation_tpu_torch.cli.prepare",
    "ai_music_generation_tpu_torch.cli.random_baselines",
    "ai_music_generation_tpu_torch.cli.replay_goldens",
    "ai_music_generation_tpu_torch.cli.sample",
    "ai_music_generation_tpu_torch.cli.sample_tunesformer",
    "ai_music_generation_tpu_torch.cli.serve",
    "ai_music_generation_tpu_torch.cli.serve_bench",
    "ai_music_generation_tpu_torch.cli.serve_tunesformer",
    "ai_music_generation_tpu_torch.cli.text_to_midi",
    "ai_music_generation_tpu_torch.cli.train",
    "ai_music_generation_tpu_torch.cli.train_bench",
    "ai_music_generation_tpu_torch.cli.transfer_experiment",
    "ai_music_generation_tpu_torch.cli.tunesformer_generate",
    "ai_music_generation_tpu_torch.cli.tunesformer_train",
    "ai_music_generation_tpu_torch.codec.encoding_settings",
    "ai_music_generation_tpu_torch.codec.instrument_types",
    "ai_music_generation_tpu_torch.codec.midi_io",
    "ai_music_generation_tpu_torch.codec.quantized_converter",
    "ai_music_generation_tpu_torch.codec.score",
    "ai_music_generation_tpu_torch.configs",
    "ai_music_generation_tpu_torch.configs.generate_configs",
    "ai_music_generation_tpu_torch.data.chorales",
    "ai_music_generation_tpu_torch.data.curation",
    "ai_music_generation_tpu_torch.data.gpt2_bpe",
    "ai_music_generation_tpu_torch.data.memmap",
    "ai_music_generation_tpu_torch.data.prepare",
    "ai_music_generation_tpu_torch.decode.generate",
    "ai_music_generation_tpu_torch.decode.speculative",
    "ai_music_generation_tpu_torch.decode.tunes_generate",
    "ai_music_generation_tpu_torch.eval.aesthetics",
    "ai_music_generation_tpu_torch.eval.audiobox",
    "ai_music_generation_tpu_torch.eval.calculate",
    "ai_music_generation_tpu_torch.eval.pipeline",
    "ai_music_generation_tpu_torch.eval.plotting",
    "ai_music_generation_tpu_torch.eval.similarities",
    "ai_music_generation_tpu_torch.eval.vectorization",
    "ai_music_generation_tpu_torch.eval.wavlm",
    "ai_music_generation_tpu_torch.experiments",
    "ai_music_generation_tpu_torch.experiments.decode_studies",
    "ai_music_generation_tpu_torch.experiments.fuzz_campaign",
    "ai_music_generation_tpu_torch.experiments.gqa_quality",
    "ai_music_generation_tpu_torch.experiments.int4_cache_probe",
    "ai_music_generation_tpu_torch.experiments.int4_kernel_probe",
    "ai_music_generation_tpu_torch.experiments.int4_probe",
    "ai_music_generation_tpu_torch.experiments.int4_probe2",
    "ai_music_generation_tpu_torch.experiments.int8_dots_probe",
    "ai_music_generation_tpu_torch.experiments.int8_quality",
    "ai_music_generation_tpu_torch.experiments.k1_ab",
    "ai_music_generation_tpu_torch.experiments.mfu_sweep",
    "ai_music_generation_tpu_torch.experiments.moe_probe",
    "ai_music_generation_tpu_torch.experiments.realpath_bench_r5",
    "ai_music_generation_tpu_torch.experiments.realpath_window_r5",
    "ai_music_generation_tpu_torch.experiments.refresh_quality",
    "ai_music_generation_tpu_torch.experiments.register_caps",
    "ai_music_generation_tpu_torch.experiments.serve_soak",
    "ai_music_generation_tpu_torch.experiments.spec_decode",
    "ai_music_generation_tpu_torch.experiments.spec_trace",
    "ai_music_generation_tpu_torch.experiments.tunes_mfu",
    "ai_music_generation_tpu_torch.experiments.window64_probe",
    "ai_music_generation_tpu_torch.experiments.window_flat_probe",
    "ai_music_generation_tpu_torch.experiments.window_quality",
    "ai_music_generation_tpu_torch.models.convert",
    "ai_music_generation_tpu_torch.models.gpt",
    "ai_music_generation_tpu_torch.models.hf_import",
    "ai_music_generation_tpu_torch.models.moe",
    "ai_music_generation_tpu_torch.models.nanogpt_ckpt",
    "ai_music_generation_tpu_torch.models.tunesformer",
    "ai_music_generation_tpu_torch.models.tunesformer_export",
    "ai_music_generation_tpu_torch.models.tunesformer_import",
    "ai_music_generation_tpu_torch.ops._build",
    "ai_music_generation_tpu_torch.ops.decode_attention",
    "ai_music_generation_tpu_torch.ops.decode_attention_int8",
    "ai_music_generation_tpu_torch.ops.dropout",
    "ai_music_generation_tpu_torch.ops.gqa_decode",
    "ai_music_generation_tpu_torch.ops.lean_attention",
    "ai_music_generation_tpu_torch.ops.ring_attention",
    "ai_music_generation_tpu_torch.ops.spec_attention",
    "ai_music_generation_tpu_torch.parallel",
    "ai_music_generation_tpu_torch.parallel.collectives",
    "ai_music_generation_tpu_torch.parallel.distributed",
    "ai_music_generation_tpu_torch.parallel.mesh",
    "ai_music_generation_tpu_torch.parallel.pipeline",
    "ai_music_generation_tpu_torch.parallel.sequence",
    "ai_music_generation_tpu_torch.parallel.sharding",
    "ai_music_generation_tpu_torch.parallel.worker_smoke",
    "ai_music_generation_tpu_torch.project",
    "ai_music_generation_tpu_torch.project.framework",
    "ai_music_generation_tpu_torch.project.pipelines",
    "ai_music_generation_tpu_torch.project.pipelines.data_processing",
    "ai_music_generation_tpu_torch.project.pipelines.data_processing.nodes",
    "ai_music_generation_tpu_torch.project.pipelines.data_processing.pipeline",
    "ai_music_generation_tpu_torch.serve.engine",
    "ai_music_generation_tpu_torch.serve.http",
    "ai_music_generation_tpu_torch.serve.mesh",
    "ai_music_generation_tpu_torch.serve.tunes_engine",
    "ai_music_generation_tpu_torch.synth.piano_bank",
    "ai_music_generation_tpu_torch.synth.render",
    "ai_music_generation_tpu_torch.synth.sf2",
    "ai_music_generation_tpu_torch.synth.wav_io",
    "ai_music_generation_tpu_torch.tokenizers",
    "ai_music_generation_tpu_torch.tokenizers.patchilizer",
    "ai_music_generation_tpu_torch.tokenizers.simple",
    "ai_music_generation_tpu_torch.train",
    "ai_music_generation_tpu_torch.train.checkpoint",
    "ai_music_generation_tpu_torch.train.optimizer",
    "ai_music_generation_tpu_torch.train.step",
    "ai_music_generation_tpu_torch.train.trainer",
    "ai_music_generation_tpu_torch.train.tunes_step",
    "ai_music_generation_tpu_torch.utils.configurator",
    "ai_music_generation_tpu_torch.utils.device",
    "ai_music_generation_tpu_torch.utils.hash32",
    "ai_music_generation_tpu_torch.utils.scaling_laws",
    "ai_music_generation_tpu_torch.utils.sizing",
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
        "('jax', 'jaxlib', 'flax', 'ai_music_generation_tpu', 'tests') "
        "or m.startswith(('test_', 'conftest'))))\n")
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
        "from ai_music_generation_tpu_torch.ops.dropout import dropout_apply\n"
        "cfg = GPTConfig(block_size=16, vocab_size=16, n_layer=1, n_head=2, "
        "n_embd=32)\n"
        "GPT(cfg, device='cpu')(torch.zeros((1, 4), dtype=torch.int32))\n"
        "GPT(dataclasses.replace(cfg, n_expert=2), device='cpu')("
        "torch.zeros((1, 4), dtype=torch.int32))\n"
        "Generator(GPT(dataclasses.replace(cfg, attn_impl='pallas'), "
        "device='cpu'), max_new_tokens=4).generate([[1, 2, 3]])\n"
        "SpecGenerator(GPT(cfg, device='cpu'), max_new_tokens=4).generate("
        "[[1, 2, 3]])\n"
        "from ai_music_generation_tpu_torch.experiments.int4_kernel_probe "
        "import run_variant\n"
        "from ai_music_generation_tpu_torch.ops.lean_attention import "
        "lean_attention\n"
        "run_variant('lean4', batch=2, seq=4, device='cpu')\n"
        "from ai_music_generation_tpu_torch.serve.engine import "
        "GenerationServer\n"
        "srv = GenerationServer(GPT(dataclasses.replace(cfg, "
        "kv_quantized=True), device='cpu'), n_slots=2, ticks_per_call=4)\n"
        "srv.submit([1, 2], max_new_tokens=6)\n"
        "assert len(srv.run_until_idle()[0].generated) == 6\n"
        "from ai_music_generation_tpu_torch.decode.tunes_generate import "
        "TunesGenerator\n"
        "from ai_music_generation_tpu_torch.models.tunesformer import "
        "TunesFormer, TunesFormerConfig\n"
        "from ai_music_generation_tpu_torch.serve.tunes_engine import "
        "TunesServer\n"
        "tf = TunesFormer(TunesFormerConfig(patch_length=8, patch_size=8, "
        "patch_layers=1, char_layers=1, n_embd=32, n_head=2), device='cpu')\n"
        "assert len(TunesGenerator(tf).generate_tunes('K:C\\nab', "
        "num_tunes=2, max_patch=5)) == 2\n"
        "tsrv = TunesServer(tf, n_slots=2)\n"
        "tsrv.submit('K:C\\nab|', max_patch=5)\n"
        "assert len(tsrv.run_until_idle()) == 1\n"
        "import contextlib, io\n"
        "from ai_music_generation_tpu_torch.cli import train_bench\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    train_bench.main(['--device=cpu', '--n_layer=1', '--n_head=2', "
        "'--n_embd=32', '--block_size=16', '--batch_size=2', "
        "'--vocab_size=16', '--burn_in=1', '--num_steps=1', "
        "'--dropout=0.1'])\n"
        "from ai_music_generation_tpu_torch.experiments import tunes_mfu\n"
        "r = tunes_mfu.run(2, TunesFormerConfig(patch_length=8, "
        "patch_size=8, patch_layers=1, char_layers=1, n_embd=32, n_head=2, "
        "dropout=0.1), steps=1, burn_in=1, device='cpu')\n"
        "assert r['tflop_per_step'] == r['analytic_tflop']\n"
        "from ai_music_generation_tpu_torch.synth.render import "
        "render_events\n"
        "assert render_events([[60.0, 0.0, 800.0, 0.5]], 1600, "
        "device='cpu').shape == (1600,)\n"
        "import numpy as np\n"
        "from ai_music_generation_tpu_torch.eval.audiobox import "
        "AesPredictor, AudioboxConfig\n"
        "from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig\n"
        "aes = AesPredictor(AudioboxConfig(wavlm=WavLMConfig(hidden_size=32, "
        "num_layers=1, num_heads=2, intermediate_size=32, conv_dim=(8, 8), "
        "conv_kernel=(10, 3), conv_stride=(5, 2), num_conv_pos_embeddings=4, "
        "num_conv_pos_embedding_groups=2, num_buckets=8, max_distance=16)), "
        "batch=2, chunk_seconds=0.1, device='cpu')\n"
        "assert len(aes.score_wave(np.zeros(2000, np.float32))) == 4\n"
        "print(_build.load_library.cache_info().currsize, "
        "gqa_decode_update.launches, spec_attention_update.launches, "
        "decode_attention.launches, lean_attention.launches, "
        "dropout_apply.launches)\n",
        PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent")
    assert out.split() == ["0", "0", "0", "0", "0", "0"]


def test_build_key_tracks_sources_and_flags(monkeypatch, tmp_path):
    from ai_music_generation_tpu_torch.ops import _build

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert _build.library_path() == path  # stable
    assert [p.name for p in _build.sources()] == [
        "decode_attention.cu", "dropout.cu", "gqa_decode.cu",
        "gqa_decode_mha.cu",
        "gqa_decode_mha_ring.cu", "gqa_decode_ring.cu", "lean_attention.cu",
        "spec_attention.cu", "spec_attention_dots.cu",
        "spec_attention_f32.cu"]
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
    # the shared headers are part of the key
    assert [p.name for p in _build.headers()] == [
        "common.cuh", "gqa_decode.cuh", "gqa_decode_mha.cuh", "hash32.cuh",
        "spec_attention_mma.cuh"]
    header = tmp_path / "common.cuh"
    header.write_text("// shared")
    monkeypatch.setattr(_build, "headers", lambda: [header])
    before = _build.library_path()
    header.write_text("// shared, edited")
    assert _build.library_path() != before


def test_every_jax_module_has_a_port_counterpart():
    """The two packages' ``.py`` file lists differ by ``cli/convert_ckpt.py``
    alone: reading orbax checkpoints needs jax, so it stays with the JAX
    package."""
    def files(pkg):
        root = os.path.join(ROOT, pkg)
        return {os.path.relpath(os.path.join(base, name), root)
                for base, _, names in os.walk(root) for name in names
                if name.endswith(".py")}

    missing = files("ai_music_generation_tpu") - files(
        "ai_music_generation_tpu_torch")
    assert sorted(missing) == [os.path.join("cli", "convert_ckpt.py")]


# docs/experiments/ scripts the port has no counterpart for yet: none (a
# script added there needs its port, or a place here with its reason)
NOT_YET_PORTED = set()
# the scripts ported under another name
RENAMED = {"moe_tpu.py": "moe_probe.py"}


def test_experiment_scripts_without_a_counterpart_are_the_queued_ones():
    """Every ``docs/experiments/*.py`` has a module of the same name (or
    its ``RENAMED`` one) in ``ai_music_generation_tpu_torch/experiments/``,
    but the ``NOT_YET_PORTED`` set."""
    scripts = {n for n in os.listdir(os.path.join(ROOT, "docs",
                                                  "experiments"))
               if n.endswith(".py")}
    ported = set(os.listdir(os.path.join(
        ROOT, "ai_music_generation_tpu_torch", "experiments")))
    missing = {n for n in scripts if RENAMED.get(n, n) not in ported}
    assert missing == NOT_YET_PORTED
