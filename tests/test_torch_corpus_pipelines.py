"""The port's corpus entry points against the JAX package's: the chorale
synthesizer (``data/chorales.py``), every ``cli/bach_pipeline.py``
subcommand, ``cli/build_synthetic_4parts.py``, ``cli/midi_to_text.py`` /
``cli/text_to_midi.py`` and the four ``cli/random_baselines.py``
generators. All of them are deterministic for a given seed, so each output
tree (every file's name and bytes, MIDI and JSON alike), return value and
printed line must be the original's exactly.
"""

import contextlib
import io
import json
import os
import pathlib
import random
import re
import subprocess
import sys

import pytest
import torch

from ai_music_generation_tpu.cli import bach_pipeline as jax_bach
from ai_music_generation_tpu.cli import build_synthetic_4parts as jax_b4
from ai_music_generation_tpu.cli import midi_to_text as jax_m2t
from ai_music_generation_tpu.cli import random_baselines as jax_rb
from ai_music_generation_tpu.cli import text_to_midi as jax_t2m
from ai_music_generation_tpu.codec import midi_io as jax_midi_io
from ai_music_generation_tpu.codec.quantized_converter import (
    MidiQuantizedConverter as JaxConverter,
)
from ai_music_generation_tpu.codec.score import score_to_midi as jax_to_midi
from ai_music_generation_tpu.data import chorales as jax_chorales
from ai_music_generation_tpu_torch.cli import bach_pipeline
from ai_music_generation_tpu_torch.cli import build_synthetic_4parts as b4
from ai_music_generation_tpu_torch.cli import midi_to_text
from ai_music_generation_tpu_torch.cli import random_baselines as rb
from ai_music_generation_tpu_torch.cli import text_to_midi
from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.codec.encoding_settings import (
    EncodingSetting,
)
from ai_music_generation_tpu_torch.codec.score import score_to_midi
from ai_music_generation_tpu_torch.data import chorales

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree(root) -> dict:
    """Every file under ``root``: its path relative to ``root`` -> bytes."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def run(fn, *args, **kwargs):
    """``fn``'s return value and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kwargs)
    return result, buf.getvalue()


def both(jax_fn, fn, tmp_path, name, make_args):
    """Run the original and the port, each into its own output directory
    ``<tmp_path>/<side>/<name>`` (``make_args(out_dir, side)`` builds the
    call's arguments), and hold the trees, return values and printed lines
    (output paths aside) equal."""
    outs = {}
    for side, f in (("jax", jax_fn), ("port", fn)):
        out = str(tmp_path / side / name)
        result, printed = run(f, *make_args(out, side))
        outs[side] = (tree(out), result, printed.replace(out, "<out>"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0], f"{name} wrote nothing"
    return outs["port"]


def fresh_cli(module):
    """``module``'s CLI as a function of argv that runs ``python -m
    module`` in a fresh interpreter, prints what it printed and returns the
    counts of its ``converted N files, M failures`` line. A pool forks
    safely there: this test process holds jax's and torch's threads."""
    def main(argv):
        proc = subprocess.run(
            [sys.executable, "-m", module, *argv], capture_output=True,
            text=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
        assert proc.returncode == 0, proc.stderr
        print(proc.stdout, end="")
        return tuple(map(int, re.search(r"converted (\d+) files, (\d+) "
                                        r"failures", proc.stdout).groups()))
    return main


# -- data/chorales.py ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 100_003, 3 * 999_983 + 7])
def test_synthesize_chorale_midi_bytes_equal_jax(seed):
    port = midi_io.write_midi_bytes(score_to_midi(
        chorales.synthesize_chorale(seed)))
    jax = jax_midi_io.write_midi_bytes(jax_to_midi(
        jax_chorales.synthesize_chorale(seed)))
    assert port == jax


def test_chorale_tables_equal_jax():
    assert chorales.RANGES == jax_chorales.RANGES
    assert chorales.VOICES == jax_chorales.VOICES
    assert chorales.CHORALS_TO_OMIT == jax_chorales.CHORALS_TO_OMIT
    assert chorales.PROGRESSION == jax_chorales.PROGRESSION


@pytest.mark.parametrize("num_pieces,seed,blacklisted",
                         [(6, 3, 3), (30, 0, 0)])
def test_synthesize_corpus_names_and_bytes_equal_jax(tmp_path, num_pieces,
                                                     seed, blacklisted):
    written = {}
    for side, mod in (("jax", jax_chorales), ("port", chorales)):
        out = str(tmp_path / side)
        paths = mod.synthesize_corpus(out, num_pieces=num_pieces, seed=seed,
                                      include_blacklisted=blacklisted)
        written[side] = ([os.path.relpath(p, out) for p in paths], tree(out))
    assert written["port"] == written["jax"]
    assert len(written["port"][0]) == num_pieces + blacklisted


# -- cli/bach_pipeline.py -----------------------------------------------------

def _tiny_corpus(src):
    """tests/test_corpus_pipelines.py's fixture: four 4-part two-bar
    pieces written through the codec, a blacklisted name and a non-bwv
    name."""
    conv = JaxConverter()
    os.makedirs(src)
    for i in range(4):
        parts = " ".join(
            f"/{v} clef_G_2_0 key_signature_0 time_signature_4/4 "
            + " ".join(f"o{12*j} p{60 + v * 3 + j} d12" for j in range(4))
            for v in range(4)
        )
        text = parts + " / o48 | " + " ".join(
            f"/{v} " + " ".join(f"o{12*j} p{62 + v * 3 + j} d12"
                                for j in range(4))
            for v in range(4)
        ) + " / o48 |"
        jax_midi_io.write_midi_file(jax_to_midi(conv.text_to_score(text)),
                                    os.path.join(src, f"bwv{100 + i}.mid"))
    with open(os.path.join(src, "bwv100.mid"), "rb") as f:
        data = f.read()
    for name in ("bwv277.mid", "other.mid"):
        with open(os.path.join(src, name), "wb") as f:
            f.write(data)


@pytest.mark.parametrize("corpus", ["tiny", "synthesized"])
def test_bach_pipeline_subcommands_equal_jax(tmp_path, corpus):
    """ground-truth -> split -> score-templates -> measure-templates ->
    generate, each side on its own outputs, every tree byte-equal; the
    synthesized corpus comes from each side's ``synthesize-corpus``."""
    if corpus == "tiny":
        src = {side: str(tmp_path / "src") for side in ("jax", "port")}
        _tiny_corpus(src["jax"])
        val_ratio = "0.25"
    else:
        both(jax_bach.main, bach_pipeline.main, tmp_path, "raw",
             lambda out, side: (["synthesize-corpus", f"--out_dir={out}",
                                 "--num_pieces=8", "--seed=3"],))
        src = {side: str(tmp_path / side / "raw") for side in ("jax", "port")}
        val_ratio = "0.34"

    def step(name, argv_of):
        return both(jax_bach.main, bach_pipeline.main, tmp_path, name,
                    lambda out, side: (argv_of(out, side),))

    gt = step("gt", lambda out, s: ["ground-truth", src[s],
                                    f"--out_dir={out}"])[0]
    assert len(gt) == (4 if corpus == "tiny" else 8)
    split = step("split", lambda out, s: [
        "split", str(tmp_path / s / "gt"), f"--out_dir={out}",
        f"--val_ratio={val_ratio}"])[0]
    assert len(split) == len(gt)
    stats = step("stats", lambda out, s: [
        "score-templates", str(tmp_path / s / "gt"), f"--out_dir={out}"])[0]
    assert json.loads(stats["score_templates.json"])
    # measure-templates writes beside score-templates, as generate reads
    stats = step("stats", lambda out, s: [
        "measure-templates", str(tmp_path / s / "gt"), f"--out_dir={out}"])[0]
    assert json.loads(stats["bach_progression.json"])
    assert json.loads(stats["notes_counts.json"])["chord_notes"] > 0
    gen = step("gen", lambda out, s: [
        "generate", str(tmp_path / s / "stats"), f"--out_dir={out}",
        "--num_pieces=3",
        "--max_measures=6", "--seed=5"])[0]
    assert sorted(gen) == [f"generated_{i}.mid" for i in range(3)]
    assert midi_io.parse_midi_bytes(gen["generated_0.mid"]).notes


# -- cli/build_synthetic_4parts.py ---------------------------------------------

def _melody_text(pitches, tsig="4/4", ksig=0):
    """tests/test_corpus_pipelines.py's monophonic queue-format text."""
    bars = []
    for i, chunk in enumerate(pitches):
        notes = " ".join(f"o{12*j} p{p} d12" for j, p in enumerate(chunk))
        if i == 0:
            bars.append(f"/0 clef_G_2_0 key_signature_{ksig} "
                        f"time_signature_{tsig} {notes} / o48 |")
        else:
            bars.append(f"/0 {notes} / o48 |")
    return " ".join(bars)


@pytest.fixture()
def melody_dir(tmp_path):
    """Melodies in two meters and three keys (seeded lengths and pitches)
    and two malformed files the builders skip."""
    d = tmp_path / "melodies"
    d.mkdir()
    rng = random.Random(11)
    for i in range(22):
        tsig = "4/4" if i % 3 else "3/4"
        bars = [[rng.randint(55, 79) for _ in range(4)]
                for _ in range(rng.randint(2, 5))]
        (d / f"mel_{i:02d}.txt").write_text(
            _melody_text(bars, tsig=tsig, ksig=i % 3 - 1))
    (d / "bad_no_tsig.txt").write_text("/0 o0 p60 d12 / o48 |")
    (d / "bad_no_melody.txt").write_text(
        "/1 time_signature_4/4 o0 p60 d12 / o48 |")
    return str(d)


@pytest.mark.parametrize("resample,same_key,seed", [
    (True, True, 0), (True, True, 1), (False, True, 1), (False, False, 2)])
def test_build_synthetic_4parts_equal_jax(tmp_path, melody_dir, resample,
                                          same_key, seed):
    out, n, _ = both(
        jax_b4.create_dataset, b4.create_dataset, tmp_path, "pieces",
        lambda out, side: (melody_dir, out, 3, resample, same_key, seed))
    assert len(out) == n > 0
    for path in sorted(pathlib.Path(melody_dir).iterdir()):
        try:
            want = jax_b4.parse_file(path)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                b4.parse_file(path)
            assert str(err.value) == str(e)
            continue
        assert b4.parse_file(path) == want


def test_build_synthetic_4parts_main_equal_jax(tmp_path, melody_dir):
    both(jax_b4.main, b4.main, tmp_path, "cli", lambda out, side: (
        [melody_dir, out, "--pieces_per_sig=2", "--seed=4"],))
    both(jax_b4.main, b4.main, tmp_path, "cli_no_resample",
         lambda out, side: ([melody_dir, out, "--no_resample",
                             "--no_same_key", "--seed=4"],))


# -- cli/midi_to_text.py, cli/text_to_midi.py --------------------------------

@pytest.fixture(scope="module")
def chorale_midis(tmp_path_factory):
    d = tmp_path_factory.mktemp("chorales")
    jax_chorales.synthesize_corpus(str(d), num_pieces=5, seed=2,
                                   include_blacklisted=1)
    (d / "broken.mid").write_bytes(b"MThd not a midi file")
    return str(d)


@pytest.mark.parametrize("processes,flags", [
    (1, []),
    (2, ["--transpositions", "0", "2", "-3"]),
    (1, ["--no_offsets", "--joining", "Join parallel measures"]),
])
def test_midi_to_text_and_back_equal_jax(tmp_path, chorale_midis, processes,
                                         flags):
    """midi_to_text (with transpositions, the port's pool of two in a
    fresh interpreter against the original's serial run, no offsets, the
    other joining) then text_to_midi on each side's texts: both trees
    byte-equal, the broken file a failure on both."""
    port = (midi_to_text.main if processes == 1 else
            fresh_cli("ai_music_generation_tpu_torch.cli.midi_to_text"))
    texts, counts, _ = both(jax_m2t.main, port, tmp_path, "texts",
                            lambda out, side: (
                                [chorale_midis, out] + flags + [
                                    f"--processes="
                                    f"{processes if side == 'port' else 1}"],))
    assert counts == (6, 1)
    n_tr = 3 if "-3" in flags else 1
    assert len(texts) == 6 * n_tr
    back_flags = ["--no_offsets"] if "--no_offsets" in flags else []
    midis, back, _ = both(
        jax_t2m.main, text_to_midi.main, tmp_path, "midis",
        lambda out, side: ([str(tmp_path / side / "texts"), out]
                           + back_flags,))
    assert back == (len(texts), 0) and len(midis) == len(texts)


def test_convert_directory_settings_equal_jax(tmp_path, chorale_midis):
    """The library calls with explicit settings (SATB parts only)."""
    settings = EncodingSetting(only_SATB_parts=True)
    jax_settings = jax_m2t.EncodingSetting(only_SATB_parts=True)
    outs = {}
    for side, mod, s in (("jax", jax_m2t, jax_settings),
                         ("port", midi_to_text, settings)):
        out = str(tmp_path / side)
        outs[side] = (run(mod.convert_directory, chorale_midis, out, s, [0, 1],
                          1)[0], tree(out))
    assert outs["port"] == outs["jax"]


# -- cli/random_baselines.py -------------------------------------------------

@pytest.fixture(scope="module")
def validation_json(tmp_path_factory):
    """IrishMAN-style validation sheets: random tunes with repeat and
    final bars, and a sheet with no measures."""
    path = tmp_path_factory.mktemp("val") / "validation.json"
    sheets = [{"abc notation": t.replace(" | ", " :| ", 1) + "]"}
              for t in rb.random_tunes(12, seed=3)]
    sheets.append({"abc notation": "X:1\nK:C\n"})
    path.write_text(json.dumps(sheets))
    return str(path)


def test_measures_from_validation_equals_jax(validation_json):
    pools = rb.measures_from_validation(validation_json)
    assert pools == jax_rb.measures_from_validation(validation_json)
    assert len(pools) == 12
    assert rb.abc_content(3, ["A B", "c d"], "6/8", "Dm") == \
        jax_rb.abc_content(3, ["A B", "c d"], "6/8", "Dm")


@pytest.mark.parametrize("mode", ["random", "repeated", "repeated_measures",
                                  "sampled_measures"])
@pytest.mark.parametrize("seed", [0, 1, 9])
def test_random_baselines_equal_jax(tmp_path, validation_json, mode, seed):
    files, n, _ = both(
        jax_rb.generate, rb.generate, tmp_path, mode,
        lambda out, side: (mode, out, 15, 40, validation_json, seed))
    assert n == len(files) == 15


def test_random_baselines_main_and_errors_equal_jax(tmp_path):
    both(jax_rb.main, rb.main, tmp_path, "main", lambda out, side: (
        ["random", out, "--num_files=4", "--seed=2"],))
    for mode in ("repeated_measures", "sampled_measures", "nope"):
        with pytest.raises(ValueError) as jax_err:
            jax_rb.generate(mode, str(tmp_path / "e"), num_files=1)
        with pytest.raises(ValueError, match=str(jax_err.value)):
            rb.generate(mode, str(tmp_path / "e"), num_files=1)
