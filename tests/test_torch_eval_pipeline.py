"""The port's eval pipeline (``eval/pipeline.py``) and its two render CLIs
against the JAX package's, on the CPU.

Each case runs JAX's pipeline into ``<tmp>/out``, moves that tree aside,
then runs the port's into the same ``<tmp>/out`` (the JSONLs hold absolute
paths), and compares the two trees: the same files; MIDI, structural JSONLs
and aggregates byte-equal; WAVs of equal length within +-1 LSB
(``write_wav`` truncates ``pcm * 32767``, so a render an ulp apart can
land on the other side of an integer); the proxy scores within what one
LSB can move them (``PROXY_ABS``).
"""

import filecmp
import json
import os
import shutil
import wave

import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import abc_to_midi_wav_and_aesthetics as jax_abc_cli
from ai_music_generation_tpu.cli import midi_and_wav_to_aesthetics as jax_mw_cli
from ai_music_generation_tpu.cli import midi_to_wav_and_aesthetics as jax_midi_cli
from ai_music_generation_tpu.eval import pipeline as jax_pipeline
from ai_music_generation_tpu_torch.abcnotation.to_midi import abc_file_to_midi_file
from ai_music_generation_tpu_torch.cli import abc_to_midi_wav_and_aesthetics as abc_cli
from ai_music_generation_tpu_torch.cli import midi_and_wav_to_aesthetics as mw_cli
from ai_music_generation_tpu_torch.cli import midi_to_wav_and_aesthetics as midi_cli
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.eval import aesthetics
from ai_music_generation_tpu_torch.eval import pipeline

torch.set_num_threads(1)

# PQ moves by 6 x one rfft bin of the 1024-sample frame over Nyquist when
# a sample's LSB moves the 95% rolloff across a bin (2/1024 of the band),
# CU by half of that; CE and PC are continuous in the samples. With one
# LSB in 2^15 they move by ~1e-5; 1e-3 covers that tenfold.
PROXY_ABS = {"PQ": 6 * 2 / 1024 + 1e-3, "CU": 0.5 * 6 * 2 / 1024 + 1e-3,
             "CE": 1e-3, "PC": 1e-3}
# short tunes: the JAX render scans its 512 padded events over 120 s
SHORT_TUNES = [
    "X:3\nL:1/8\nM:4/4\nK:C\nCDEF GABc|c2B2 A2G2|",
    "X:7\nL:1/4\nM:3/4\nK:G\n[GBd] e f|g3|",
]


def _abc_dir(root, tunes):
    os.makedirs(root)
    for i, text in enumerate(tunes):
        with open(os.path.join(root, f"sample_{i}.abc"), "w") as f:
            f.write(text)
    return root


def _reference_dir(root, tunes):
    """Reference MIDIs named as the generated ones' ``file_<X:>.mid``."""
    os.makedirs(root)
    for text in tunes:
        idx = pipeline.extract_index(text, "")
        src = os.path.join(root, f"{idx}.abc")
        with open(src, "w") as f:
            f.write(text)
        abc_file_to_midi_file(src, os.path.join(root, f"file_{idx}.mid"))
        os.remove(src)
    return root


def _run_both(tmp_path, run_jax, run_port):
    out = str(tmp_path / "out")
    want = run_jax(out)
    shutil.move(out, str(tmp_path / "out_jax"))
    got = run_port(out)
    return got, want, out, str(tmp_path / "out_jax")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _pcm(path):
    with wave.open(path, "rb") as w:
        return (w.getframerate(),
                np.frombuffer(w.readframes(w.getnframes()), "<i2"))


def _check_trees(ours, theirs):
    """Same files; every one byte-equal but the WAVs (equal length, +-1
    LSB) and the aesthetics files (the proxy within PROXY_ABS)."""
    files = _files(theirs)
    assert _files(ours) == files and files
    for rel in files:
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        name = os.path.basename(rel)
        if name.endswith(".wav"):
            (ra, pa), (rb_, pb) = _pcm(a), _pcm(b)
            assert ra == rb_ and len(pa) == len(pb), rel
            assert np.abs(pa.astype(np.int32) - pb).max() <= 1, rel
        elif name == "aesthetics.jsonl":
            rows = [[json.loads(line) for line in open(p)] for p in (a, b)]
            assert len(rows[0]) == len(rows[1])
            for x, y in zip(*rows):
                assert x.keys() == y.keys() and x["proxy"] and y["proxy"]
                for axis, tol in PROXY_ABS.items():
                    assert abs(x[axis] - y[axis]) <= tol, (rel, axis)
        elif name == "aesthetics_aggregated.jsonl":
            x, y = json.load(open(a)), json.load(open(b))
            assert x.keys() == y.keys()
            for stat in x:
                for axis, tol in PROXY_ABS.items():
                    if stat in ("mean", "ci95_lower", "ci95_upper"):
                        assert abs(x[stat][axis] - y[stat][axis]) <= tol
                    else:  # the spread: each score moves by tol at most
                        assert abs(x[stat][axis] - y[stat][axis]) <= 2 * tol
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


@pytest.mark.parametrize("extra", [
    {},
    {"n_conditioned_measures": 2},
    {"n_conditioned_measures": 3, "reference": True},
], ids=["plain", "conditioned", "reference"])
def test_structural_tree_equals_jax(tmp_path, extra):
    """render_wav=False: the same tree, byte for byte (MIDI, the three
    structural JSONLs, aggregated_similarities.json)."""
    tunes = random_tunes(6, seed=31)
    abc = _abc_dir(str(tmp_path / "abc"), tunes)
    extra = dict(extra)
    if extra.pop("reference", False):
        # half the tunes have a reference, each a different tune
        extra["reference_midi_files_dir"] = _reference_dir(
            str(tmp_path / "ref"), [f"X:{i}" + t[t.index("\n"):] for i, t in
                                    enumerate(random_tunes(3, seed=32))])

    def config(mod, out):
        return mod.PipelineConfig(abc_input_folder=abc, base_output_dir=out,
                                  render_wav=False, metrics_processes=1,
                                  **extra)

    got, want, ours, theirs = _run_both(
        tmp_path,
        lambda out: jax_pipeline.EvalPipeline(config(jax_pipeline, out)).run(),
        lambda out: pipeline.EvalPipeline(config(pipeline, out)).run())
    assert got.pop("stage_seconds").keys() == {
        "abc_to_midi", "render", "write", "metrics", "scoring"}
    assert json.dumps(got) == json.dumps(want) and got["n_failed"] == 0
    _check_trees(ours, theirs)


def test_abc_cli_renders_as_jax_does(tmp_path):
    """cli/abc_to_midi_wav_and_aesthetics.py through ``main`` on the CPU
    against JAX's: WAV lengths equal to JAX's, samples within +-1 LSB,
    the proxy scores and aggregates within PROXY_ABS, every other file
    byte-equal."""
    abc = _abc_dir(str(tmp_path / "abc"), SHORT_TUNES)
    got, want, ours, theirs = _run_both(
        tmp_path, lambda out: jax_abc_cli.main([abc, out]),
        lambda out: abc_cli.main([abc, out, "--device=cpu"]))
    assert got["n_failed"] == want["n_failed"] == 0
    assert got["aesthetics_engine"] == want["aesthetics_engine"] == "proxy"
    assert got["aggregated_similarities"] == want["aggregated_similarities"]
    assert got["stage_seconds"]["render"] > 0
    _check_trees(ours, theirs)
    assert len(_files(os.path.join(ours, "wav"))) == len(SHORT_TUNES)


def test_midi_cli_renders_as_jax_does(tmp_path):
    """cli/midi_to_wav_and_aesthetics.py through ``main`` on the CPU, with
    a reference directory and a conditioned prefix (the reference's
    ``sample_`` prefix mapping)."""
    midi_dir = str(tmp_path / "midi")
    os.makedirs(midi_dir)
    for i, text in enumerate(SHORT_TUNES):
        src = os.path.join(str(tmp_path), f"{i}.abc")
        with open(src, "w") as f:
            f.write(text)
        abc_file_to_midi_file(src, os.path.join(midi_dir, f"sample_{i}.mid"))
    ref = _reference_dir(str(tmp_path / "ref"),
                         [f"X:{i}\nL:1/8\nM:4/4\nK:D\nDEFG ABcd|dcBA GFED|"
                          for i in range(2)])
    flags = [f"--reference_midi_files_dir={ref}", "--n_conditioned_measures=1"]
    got, want, ours, theirs = _run_both(
        tmp_path, lambda out: jax_midi_cli.main([midi_dir, out, *flags]),
        lambda out: midi_cli.main([midi_dir, out, *flags, "--device=cpu"]))
    assert got["n_failed"] == want["n_failed"] == 0
    assert got["aggregated_similarities"] == want["aggregated_similarities"]
    assert got["aggregated_similarities"]["reference"]["mean"]
    _check_trees(ours, theirs)


def test_music21_converter_fails_every_tune_as_jax_does(tmp_path):
    """music21 is not installed: each tune fails to convert and is counted,
    on both sides, and the trees are the same."""
    abc = _abc_dir(str(tmp_path / "abc"), SHORT_TUNES)
    flags = ["--abc_to_midi_converter=music21", "--no_wav"]
    got, want, ours, theirs = _run_both(
        tmp_path, lambda out: jax_abc_cli.main([abc, out, *flags]),
        lambda out: abc_cli.main([abc, out, *flags, "--device=cpu"]))
    assert got["n_failed"] == want["n_failed"] == len(SHORT_TUNES)
    _check_trees(ours, theirs)


def test_audiobox_weights_raise_naming_item_5b(tmp_path, monkeypatch):
    """Where JAX scores with its Audiobox predictor, so does the port (it
    raised here, naming ROADMAP item 5b, until the scorer was ported):
    with ``$AUDIOBOX_WEIGHTS`` naming a checkpoint, ``run_aesthetics``
    scores with ``eval/audiobox.py`` on the caller's device and returns
    True, and the pipeline reports ``aesthetics_engine: "audio-aes"`` with
    model rows (no ``proxy`` key). It never scores with the proxy in its
    place; a name that is no file leaves the proxy, as in JAX."""
    from ai_music_generation_tpu_torch.eval import audiobox
    from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig

    cfg = audiobox.AudioboxConfig(wavlm=WavLMConfig(
        hidden_size=32, num_layers=1, num_heads=2, intermediate_size=48,
        conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=32))
    model = audiobox.init_audiobox_weights(audiobox.AudioboxAesthetics(cfg),
                                           torch.Generator().manual_seed(0))
    weights = str(tmp_path / "audiobox.pth")
    torch.save(model.state_dict(), weights)
    real, devices = audiobox.AesPredictor, []

    def short_chunks(*args, **kwargs):  # CPU attention is quadratic in frames
        devices.append(kwargs.get("device"))
        return real(*args, **dict(kwargs, chunk_seconds=0.5))

    monkeypatch.setattr(audiobox, "AesPredictor", short_chunks)
    monkeypatch.setattr(aesthetics.shutil, "which", lambda _: None)
    paths = tmp_path / "wav_paths.jsonl"
    paths.write_text(json.dumps({"path": str(tmp_path / "x.wav")}) + "\n")
    monkeypatch.setenv("AUDIOBOX_WEIGHTS", weights)
    out = tmp_path / "out.jsonl"
    assert aesthetics.run_aesthetics(str(paths), str(out), device="cpu")
    assert [k for k, v in json.loads(out.read_text()).items()
            if v == v] == []  # the unreadable file's row: all NaN
    result = abc_cli.main([_abc_dir(str(tmp_path / "abc"), SHORT_TUNES[:1]),
                           str(tmp_path / "out"), "--device=cpu"])
    assert result["aesthetics_engine"] == "audio-aes"
    assert devices == ["cpu", "cpu"]
    rows = [json.loads(line) for line in open(os.path.join(
        str(tmp_path / "out"), "audiobox_aesthetics", "builtin", "tpu_synth",
        "builtin_sample_bank", "aesthetics.jsonl"))]
    assert len(rows) == 1 and set(rows[0]) == {"CE", "CU", "PC", "PQ"}
    assert all(np.isfinite(v) for v in rows[0].values())
    monkeypatch.delenv("AUDIOBOX_WEIGHTS")
    assert aesthetics.run_aesthetics(str(paths), str(tmp_path / "o.jsonl"),
                                     weights=str(tmp_path / "missing")) \
        is False  # a name that is no file leaves the proxy, as in JAX


def test_midi_and_wav_cli_writes_jax_tree_without_aesthetics(tmp_path):
    """cli/midi_and_wav_to_aesthetics.py keeps the JAX CLI's behaviour: the
    pipeline runs with render_wav=False, so the structural tree is written
    (byte-equal to JAX's) and no aesthetics stage runs on either side;
    no stage needs a card."""
    midi_dir = str(tmp_path / "midi")
    os.makedirs(midi_dir)
    for i, text in enumerate(SHORT_TUNES):
        src = os.path.join(str(tmp_path), f"{i}.abc")
        with open(src, "w") as f:
            f.write(text)
        abc_file_to_midi_file(src, os.path.join(midi_dir, f"sample_{i}.mid"))
    flags = ["--n_conditioned_measures=1"]
    got, want, ours, theirs = _run_both(
        tmp_path, lambda out: jax_mw_cli.main([midi_dir, out, *flags]),
        lambda out: mw_cli.main([midi_dir, out, *flags]))
    assert got["n_failed"] == want["n_failed"] == 0
    assert "aesthetics_engine" not in got and "aesthetics_engine" not in want
    assert got["aggregated_similarities"] == want["aggregated_similarities"]
    assert not [f for f in _files(ours)
                if f.endswith((".wav", "aesthetics.jsonl"))]
    _check_trees(ours, theirs)


def test_no_card_no_mesh(tmp_path, monkeypatch):
    """Asked for the card without one, the pipeline raises before any
    stage; ``shard_synth`` in a plain process renders on the one device
    (no mesh), as JAX's ``make_mesh()`` over one device (the sharded render
    over processes: tests/test_torch_serve_mesh.py)."""
    abc = _abc_dir(str(tmp_path / "abc"), SHORT_TUNES[:1])
    assert pipeline.EvalPipeline(pipeline.PipelineConfig(
        abc_input_folder=abc, base_output_dir=str(tmp_path / "o"),
        shard_synth=True, device="cpu")).mesh is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        abc_cli.main([abc, str(tmp_path / "out")])
    # without a render the device is not used
    assert abc_cli.main([abc, str(tmp_path / "out"), "--no_wav"])[
        "n_failed"] == 0
