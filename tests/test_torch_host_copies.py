"""The port's copies of JAX-package host code against their originals (the
port imports nothing of the JAX package, so it keeps its own copies; these
tests show when either side changes): the configurator, the memmap file
helpers, the random-note corpus helpers, ``prepare_char``, the
experiment config grid (all 26 files) and its generator, TunesFormer's
Patchilizer,
and the control-code curation (``data/curation.py``) with its
``cli/add_control_codes.py``; the ABC -> WAV path's host modules: the ABC
parser, its native compiler (the port builds its own copy), ``to_midi``
and ``midi_io``, the piano bank, the sf2 reader and writer, the WAV I/O,
the structural metrics (``codec/``, ``eval/{vectorization,similarities,
calculate}.py``) and the aesthetics scorer's proxy and aggregates.
Everything here is deterministic, so every comparison is exact (the batch
sampler's copy is held to its original in tests/test_torch_train_pieces.py).
"""

import filecmp
import importlib.util
import json
import math
import os
import random

import numpy as np
import pytest
import torch

from ai_music_generation_tpu.abcnotation import music21_oracle as jax_m21
from ai_music_generation_tpu.abcnotation import parser as jax_parser
from ai_music_generation_tpu.abcnotation import to_midi as jax_to_midi
from ai_music_generation_tpu.cli import add_control_codes as jax_acc
from ai_music_generation_tpu.codec import midi_io as jax_midi_io
from ai_music_generation_tpu.codec import quantized_converter as jax_qc
from ai_music_generation_tpu.eval import aesthetics as jax_aes
from ai_music_generation_tpu.eval import calculate as jax_calc
from ai_music_generation_tpu.eval import pipeline as jax_pipeline
from ai_music_generation_tpu.eval import similarities as jax_sim
from ai_music_generation_tpu.eval import vectorization as jax_vec
from ai_music_generation_tpu.synth import piano_bank as jax_bank
from ai_music_generation_tpu.synth import sf2 as jax_sf2
from ai_music_generation_tpu.synth import wav_io as jax_wav
from ai_music_generation_tpu.cli import random_baselines as jax_rb
from ai_music_generation_tpu.data import curation as jax_cur
from ai_music_generation_tpu.data import memmap as jax_memmap
from ai_music_generation_tpu.data import prepare as jax_prepare
from ai_music_generation_tpu.tokenizers import patchilizer as jax_patch
from ai_music_generation_tpu.utils import configurator as jax_conf
from ai_music_generation_tpu_torch.abcnotation import music21_oracle as m21
from ai_music_generation_tpu_torch.abcnotation import native
from ai_music_generation_tpu_torch.abcnotation import parser as abc_parser
from ai_music_generation_tpu_torch.abcnotation import to_midi
from ai_music_generation_tpu_torch.cli import add_control_codes as acc
from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.codec import quantized_converter as qc
from ai_music_generation_tpu_torch.eval import aesthetics
from ai_music_generation_tpu_torch.eval import calculate
from ai_music_generation_tpu_torch.eval import pipeline
from ai_music_generation_tpu_torch.eval import similarities
from ai_music_generation_tpu_torch.eval import vectorization
from ai_music_generation_tpu_torch.synth import piano_bank
from ai_music_generation_tpu_torch.synth import sf2
from ai_music_generation_tpu_torch.synth import wav_io
from ai_music_generation_tpu_torch.cli import random_baselines as rb
from ai_music_generation_tpu_torch.data import curation
from ai_music_generation_tpu_torch.data import memmap
from ai_music_generation_tpu_torch.data import prepare
from ai_music_generation_tpu_torch.tokenizers import patchilizer
from ai_music_generation_tpu_torch.utils import configurator as conf

torch.set_num_threads(1)

DEFAULTS = dict(n_layer=6, lr=1e-3, name="out", flag=False, maybe=None)


@pytest.mark.parametrize("argv", [
    [],
    ["--n_layer=4", "--lr=2", "--name=abc", "--flag=True"],
    ["--maybe=[1, 2]", "--name=x y"],
    ["--lr=3e-4", "--n_layer=8", "--n_layer=2"],
], ids=["none", "typed", "raw-and-literal", "repeat"])
def test_apply_overrides_equals_jax(argv):
    got = conf.apply_overrides(DEFAULTS, argv)
    assert got == jax_conf.apply_overrides(DEFAULTS, argv)
    assert [type(v) for v in got.values()] == \
        [type(v) for v in jax_conf.apply_overrides(DEFAULTS, argv).values()]


@pytest.mark.parametrize("argv", [["--n_layer"], ["--nope=1"],
                                  ["--n_layer=True"], ["--flag=3"]])
def test_apply_overrides_errors_equal_jax(argv):
    with pytest.raises(Exception) as ours:
        conf.apply_overrides(DEFAULTS, argv)
    with pytest.raises(Exception) as theirs:
        jax_conf.apply_overrides(DEFAULTS, argv)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


def test_config_file_and_snapshot_equal_jax(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text("n_layer = 3\nname = 'from-file'\nunused = 1\n")
    argv = [str(path), "--lr=0.5"]
    got = conf.apply_overrides(DEFAULTS, argv)
    assert got == jax_conf.apply_overrides(DEFAULTS, argv)
    assert conf.config_snapshot(dict(got, obj=object())) == \
        jax_conf.config_snapshot(dict(got, obj=object()))


def test_memmap_helpers_write_the_same_bytes(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 60000, 1000)
    meta = {"vocab_size": 3, "itos": {0: "a"}, "stoi": {"a": 0},
            "bin_dtype": "uint16"}
    for mod, sub in ((memmap, "port"), (jax_memmap, "jax")):
        os.makedirs(tmp_path / sub)
        mod.write_bin(tokens, str(tmp_path / sub / "t.bin"))
        mod.write_bin(tokens, str(tmp_path / sub / "t32.bin"), np.uint32)
        mod.write_meta(meta, str(tmp_path / sub / "meta.pkl"))
    for name in ("t.bin", "t32.bin", "meta.pkl"):
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False)
    path = str(tmp_path / "port" / "meta.pkl")
    assert memmap.load_meta(path) == jax_memmap.load_meta(path) == meta
    assert memmap.load_meta(str(tmp_path / "missing.pkl")) is None


def test_random_note_tables_and_sequences_equal_jax():
    assert rb.NOTES == jax_rb.NOTES
    assert rb.TIME_SIGNATURES == jax_rb.TIME_SIGNATURES
    assert rb.KEY_SIGNATURES == jax_rb.KEY_SIGNATURES
    for seed in range(5):
        assert rb.random_note_seq(random.Random(seed), 50) == \
            jax_rb.random_note_seq(random.Random(seed), 50)


def test_random_tunes_equal_the_recipe_on_the_originals():
    """``random_tunes`` is docs/experiments/realpath_bench_r5.py:49-56,
    built here from the JAX package's own helpers."""
    rng = random.Random(7)
    want = []
    for i in range(200):
        measures = [" ".join(jax_rb.random_note_seq(rng, rng.randint(3, 6)))
                    for _ in range(rng.randint(8, 24))]
        want.append(
            f"X:{i}\nL:1/8\nM:{rng.choice(jax_rb.TIME_SIGNATURES)}\n"
            f"K:{rng.choice(jax_rb.KEY_SIGNATURES)}\n" + " | ".join(measures)
            + " |")
    assert rb.random_tunes(200, seed=7) == want


def test_prepare_char_writes_the_same_files(tmp_path):
    tunes = rb.random_tunes(60, seed=1)
    entries = [{"abc notation": "  " + t + "\n"} for t in tunes]
    got = prepare.prepare_char(entries[:50], entries[50:],
                               str(tmp_path / "port"))
    want = jax_prepare.prepare_char(entries[:50], entries[50:],
                                    str(tmp_path / "jax"))
    assert got == want
    for name in ("train.bin", "val.bin", "meta.pkl"):
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    assert prepare.entries_to_text(entries[:3]) == \
        jax_prepare.entries_to_text(entries[:3])


CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ai_music_generation_tpu", "configs")
# the JAX package's 26 experiment configs (its generator and __init__ aside)
CONFIG_NAMES = sorted(n for n in os.listdir(CONFIG_DIR) if n.endswith(".py")
                      and n not in ("generate_configs.py", "__init__.py"))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_training_config_copies_equal_jax(name):
    """Each copy sets the same keys to the same values as its original, and
    both apply to the trainers' defaults alike."""
    from ai_music_generation_tpu.train.trainer import DEFAULTS as JAX_DEFAULTS
    from ai_music_generation_tpu_torch.train.trainer import DEFAULTS

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, pkg, "configs", name) for pkg in
             ("ai_music_generation_tpu_torch", "ai_music_generation_tpu")]
    spaces = []
    for path in paths:
        space = {}
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), space)
        space.pop("__builtins__")
        spaces.append(space)
    assert spaces[0] == spaces[1] and spaces[0]
    ours = conf.apply_overrides(DEFAULTS, [paths[0]])
    theirs = jax_conf.apply_overrides(JAX_DEFAULTS, [paths[1]])
    assert {k: ours[k] for k in spaces[0]} == {k: theirs[k] for k in
                                               spaces[1]}


def test_config_generator_renders_the_jax_grid(tmp_path):
    """The port's generator renders every config byte-equal to JAX's, its
    grid is the 26 files of both packages, and ``main(out_dir=)`` writes
    there."""
    from ai_music_generation_tpu.configs import generate_configs as jax_gen
    from ai_music_generation_tpu_torch.configs import generate_configs as gen

    assert len(CONFIG_NAMES) == 26
    assert gen.CONFIGS == jax_gen.CONFIGS
    assert sorted(f"{n}.py" for n in gen.CONFIGS) == CONFIG_NAMES
    for name, config in gen.CONFIGS.items():
        assert gen.render(name, config) == jax_gen.render(name, config)
    port_dir = os.path.join(os.path.dirname(os.path.dirname(CONFIG_DIR)),
                            "ai_music_generation_tpu_torch", "configs")
    assert gen.HERE == port_dir
    for name, mod in (("port", gen), ("jax", jax_gen)):
        os.makedirs(tmp_path / name)
        assert mod.main(out_dir=str(tmp_path / name)) == 26
    for name in CONFIG_NAMES:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
        assert filecmp.cmp(tmp_path / "port" / name,
                           os.path.join(port_dir, name), shallow=False), name


# headers, control codes, every bar delimiter, a leading one, a trailing
# fragment, a bare delimiter body, %%score, long lines and non-ASCII text
PATCH_CORPUS = [
    "S:2\nB:9\nE:4\nB:9\nL:1/8\nM:3/4\nK:D\n de|",
    "X:1\nT:Caf\u00e9 na Gaillimhe\nK:G\n|:GABc dedB|dedB dedB::c2ec B2dB"
    ":|[|abc||def|]g\n%%score (1 2)\nV:1\nabc|def|tail",
    "K:C\n|",
    "K:C\n" + "x" * 60 + "|" + "y|" * 40,
    "\u00c5ngstr\u00f6m \u2014 \u266b\nL:1/4\nM:C|\nK:Bb\n[|A B|]C::D",
    "",
    "no header at all | just | bars",
]


@pytest.mark.parametrize("text", PATCH_CORPUS)
def test_patchilizer_copy_equals_jax(text):
    """Bit for bit: the constants, ``_ascii``, ``split_bars``,
    ``bar2patch`` / ``patch2bar``, ``encode`` (with and without special
    patches, at several sizes), ``decode`` and ``encode_array``."""
    assert (patchilizer.PATCH_LENGTH, patchilizer.PATCH_SIZE,
            patchilizer.DELIMITERS) == (jax_patch.PATCH_LENGTH,
                                        jax_patch.PATCH_SIZE,
                                        jax_patch.DELIMITERS)
    ours, theirs = patchilizer.Patchilizer(), jax_patch.Patchilizer()
    assert patchilizer._ascii(text) == jax_patch._ascii(text)
    assert ours.split_bars(text) == theirs.split_bars(text)
    for bar in ours.split_bars(text) + [text]:
        for size in (8, 32):
            patch = ours.bar2patch(bar, size)
            assert patch == theirs.bar2patch(bar, size)
            assert ours.patch2bar(patch) == theirs.patch2bar(patch)
    for length, size in ((128, 32), (4, 8), (16, 16)):
        for special in (False, True):
            got = ours.encode(text, length, size, special)
            assert got == theirs.encode(text, length, size, special)
            assert ours.decode(got) == theirs.decode(got)
            arr, n = ours.encode_array(text, length, size, special)
            want, wn = theirs.encode_array(text, length, size, special)
            assert n == wn and arr.dtype == want.dtype
            np.testing.assert_array_equal(arr, want)


# tunes for the curation: random ones, and hand-made cases for each branch
# (sections and their similarities, a volta continuation merged into its
# section, one that has nothing to merge into, more than 8 sections, a
# section over 32 bars, a multi-voice tune, comments, filtered fields,
# metadata only, non-ASCII text)
CURATION_CORPUS = rb.random_tunes(40, seed=4) + [
    "X:1\nT:Two parts\nL:1/8\nK:G\n|:GABc dedB|dedB dedB:|\n"
    "|:c2ec B2dB|c2ec BAGA:|",
    "X:2\nL:1/8\nK:D\n|:de fe|dA FA|1 d2 d2:|2 d4||\nfg ag|fd ed|]",
    "X:3\nL:1/8\nK:D\n1 d2 d2:|2 d4||",
    "X:4\nL:1/4\nK:C\n" + "".join(f"|:ab{i}|cd:|" for i in range(9)),
    "X:5\nL:1/4\nK:C\n" + "a|" * 40 + "]",
    "X:6\nT:Duet\nK:C\nV:1\nabc|def|\nV:2\ncde|fga|",
    "X:7\n% a comment line\nL:1/8\nK:Em\nEFG A2B|% tail: |: x :|\n"
    "c2B A3::efg|ab%c%d:|",
    "X:8\nT:Only\nR:reel\nK:C\nM:4/4\n",
    "X:9\nT:Caf\u00e9\nW:words\nw:lyrics\nK:G\nG\nGA\u00e9B|cd:|",
    "",
]


@pytest.mark.parametrize("i", range(len(CURATION_CORPUS)))
def test_curation_copy_equals_jax(i):
    """Bit for bit on each tune: ``run_filter``, ``split_sections``,
    ``add_control_codes`` (on the filtered and the raw text), ``levenshtein``
    and ``ld_sim`` of its sections, ``is_one_voice``."""
    text = CURATION_CORPUS[i]
    cleaned = curation.run_filter(text)
    assert cleaned == jax_cur.run_filter(text)
    for t in (cleaned, text):
        assert curation.split_sections(t) == jax_cur.split_sections(t)
        assert curation.add_control_codes(t) == jax_cur.add_control_codes(t)
    _, sections = curation.split_sections(cleaned)
    for a in (sections or [])[:3]:
        for b in (sections or [])[:3]:
            assert curation.levenshtein(a, b) == jax_cur.levenshtein(a, b)
            assert curation.ld_sim(a, b) == jax_cur.ld_sim(a, b)
    assert curation.is_one_voice(text) == jax_cur.is_one_voice(text)


def test_curation_dataset_and_irishman_helpers_equal_jax():
    got = curation.build_control_code_dataset(CURATION_CORPUS)
    assert got == jax_cur.build_control_code_dataset(CURATION_CORPUS)
    assert 0 < len(got) < len(CURATION_CORPUS)  # some are rejected
    assert any(e["control code"].count("E:") for e in got)
    entries = [{"abc notation": f"X: {i}\nK:C\nabc|", "k": i}
               for i in range(9)] + [{"abc notation": "K:C\nno id|"}]
    stripped = curation.strip_x_header(entries)
    assert stripped == jax_cur.strip_x_header(entries)
    ids = {"1", 3, "7"}
    assert curation.filter_by_ids(stripped, ids) == \
        jax_cur.filter_by_ids(stripped, ids)
    for seed in (0, 42):
        assert curation.split_validation(stripped, seed) == \
            jax_cur.split_validation(stripped, seed)
    assert curation.SECTION_DELIMITERS == jax_cur.SECTION_DELIMITERS


def test_add_control_codes_cli_writes_the_same_data_json(tmp_path):
    """The port's CLI and the JAX CLI over one directory of ABC files (the
    curation corpus, one tune a file): data.json byte for byte."""
    os.makedirs(tmp_path / "abc")
    for i, text in enumerate(CURATION_CORPUS):
        (tmp_path / "abc" / f"t{i:02d}.abc").write_text(text,
                                                        encoding="utf-8")
    (tmp_path / "abc" / "skip.txt").write_text("K:C\nabc|")
    n = acc.main([str(tmp_path / "abc"), f"--output={tmp_path / 'p.json'}"])
    m = jax_acc.main([str(tmp_path / "abc"),
                      f"--output={tmp_path / 'j.json'}"])
    assert n == m > 0
    assert filecmp.cmp(tmp_path / "p.json", tmp_path / "j.json",
                       shallow=False)


def _abc_fixtures():
    """tests/test_native_abc.py's cases (plain, graces and decorations;
    gchord ones flagged), read from that file: its module is a test module,
    not a package."""
    path = os.path.join(os.path.dirname(__file__), "test_native_abc.py")
    spec = importlib.util.spec_from_file_location("_native_abc_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return ([(t, False) for t in module.CASES + module.FEATURE_CASES]
            + [(t, True) for t in module.GCHORD_CASES])


ABC_CORPUS = ([(t, False) for t in rb.random_tunes(24, seed=11)]
              + _abc_fixtures())


def _tune_rows(tune):
    return (tune.meter, tune.unit_length, tune.tempo_bpm, tune.sharps,
            tune.n_voices, tune.accomp_voice,
            [(n.pitch, n.start, n.duration, n.voice) for n in tune.notes])


@pytest.mark.parametrize("prefer_native", [True, False],
                         ids=["native", "python"])
def test_abc_to_midi_bytes_equal_jax(prefer_native):
    """MIDI bytes from the port's parser (its native copy, or the Python
    one) and ``to_midi`` equal the JAX package's Python parser's, over the
    random-baseline corpus and tests/test_native_abc.py's cases; the bytes
    parse back to the same files on both sides."""
    if prefer_native:
        assert native.native_available()
    for text, gchord in ABC_CORPUS:
        ours = midi_io.write_midi_bytes(to_midi.abc_to_midi(
            text, prefer_native=prefer_native, gchord=gchord))
        theirs = jax_midi_io.write_midi_bytes(jax_to_midi.abc_to_midi(
            text, prefer_native=False, gchord=gchord))
        assert ours == theirs, text
        assert midi_io.write_midi_bytes(midi_io.parse_midi_bytes(ours)) == \
            jax_midi_io.write_midi_bytes(jax_midi_io.parse_midi_bytes(ours))


def test_native_copy_equals_the_python_parser():
    """The port's build of its own native/abc_compiler.cpp parses every
    case as the Python parser does (and JAX's parser as well)."""
    for text, gchord in ABC_CORPUS:
        got = native.NativeAbcParser(gchord=gchord).parse(text)
        assert _tune_rows(got) == \
            _tune_rows(abc_parser.AbcParser(gchord=gchord).parse(text)) == \
            _tune_rows(jax_parser.AbcParser(gchord=gchord).parse(text)), text
    assert native.library_path().parent == native.BUILD_DIR
    assert native.CXX_FLAGS == ("-O2", "-std=c++17", "-fPIC", "-Wall",
                                "-shared")  # native/Makefile's
    with open(native.SOURCE, "rb") as ours, open(os.path.join(
            os.path.dirname(os.path.dirname(__file__)), "native",
            "abc_compiler.cpp"), "rb") as theirs:
        assert ours.read() == theirs.read()


def test_native_falls_back_to_python_when_it_cannot_build(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "missing.so")
    monkeypatch.setenv("CXX", "no-such-compiler")
    native.load_library.cache_clear()
    try:
        assert not native.native_available()
        assert isinstance(native.get_parser(), abc_parser.AbcParser)
        with pytest.raises(RuntimeError, match="not built"):
            native.compile_abc("X:1\nK:C\nC|")
    finally:
        native.load_library.cache_clear()


def test_music21_converter_raises_as_jax_does(tmp_path):
    abc = tmp_path / "t.abc"
    abc.write_text("X:1\nK:C\nC|")
    errors = []
    for mod in (m21, jax_m21):
        with pytest.raises(RuntimeError) as err:
            mod.abc_file_to_midi_file_music21(str(abc), str(tmp_path / "o.mid"))
        errors.append((type(err.value).__name__, str(err.value),
                       type(err.value.__cause__)))
    assert errors[0] == errors[1]
    assert issubclass(errors[0][2], ImportError)


@pytest.mark.parametrize("rate", [16_000, 22_050])
def test_piano_bank_bit_equal(rate):
    ours, theirs = piano_bank.get_bank(rate), jax_bank.get_bank(rate)
    assert ours[0].dtype == theirs[0].dtype == np.float32
    assert np.array_equal(ours[0], theirs[0])
    assert np.array_equal(ours[1], theirs[1])


def _sine(freq, n=4800, rate=16_000):
    t = np.arange(n) / rate
    return (0.8 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


SF2_ZONES = [
    dict(wave=_sine(220.0), root=57, key_range=(0, 63), vel_range=(0, 63),
         loop=(800, 4000), release_tc=-3600, fine_tune=7),
    dict(wave=_sine(330.0, rate=22_050), root=57, key_range=(0, 63),
         vel_range=(64, 127), release_tc=-2400, sample_rate=22_050),
    dict(wave=_sine(880.0), root=81, key_range=(64, 127), attack_tc=-7200,
         sustain_cb=200, atten_cb=60, coarse_tune=-1),
]


def test_sf2_writer_parser_and_bank_equal_jax(tmp_path):
    paths = [str(tmp_path / f"{side}.sf2") for side in ("port", "jax")]
    sf2.write_sf2(paths[0], SF2_ZONES, preset_name="TestPiano")
    jax_sf2.write_sf2(paths[1], SF2_ZONES, preset_name="TestPiano")
    assert filecmp.cmp(*paths, shallow=False)
    ours, theirs = sf2.parse_sf2(paths[0]), jax_sf2.parse_sf2(paths[0])
    assert np.array_equal(ours.sample_data, theirs.sample_data)
    assert repr(ours.presets) == repr(theirs.presets)
    for rate, seconds in ((16_000, 3.0), (22_050, 1.0)):
        got = sf2.bank_from_sf2(paths[0], rate, seconds)
        want = jax_sf2.bank_from_sf2(paths[0], rate, seconds)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_wav_round_trip_equal_jax(tmp_path):
    wave = np.concatenate([np.linspace(-1.5, 1.5, 4001, dtype=np.float32),
                           _sine(440.0), np.zeros(7, np.float32)])
    paths = [str(tmp_path / f"{side}.wav") for side in ("port", "jax")]
    wav_io.write_wav(paths[0], wave, 16_000)
    jax_wav.write_wav(paths[1], wave, 16_000)
    assert filecmp.cmp(*paths, shallow=False)
    got, want = wav_io.read_wav(paths[0]), jax_wav.read_wav(paths[0])
    assert got[1] == want[1] == 16_000 and np.array_equal(got[0], want[0])
    # +-1 LSB: write truncates pcm * 32767 toward zero
    assert np.abs(got[0] - np.clip(wave, -1, 1)).max() <= 1 / 32767


def _metric_midis(tmp_path, n=6):
    paths = []
    for i, text in enumerate(rb.random_tunes(n, seed=21)):
        paths.append(str(tmp_path / f"file_{i}.mid"))
        midi_io.write_midi_file(to_midi.abc_to_midi(text), paths[-1])
    return paths


def _dump(result):
    return json.dumps(result.model_dump(mode="json"))


def test_vectorization_similarities_and_calculate_equal_jax(tmp_path):
    """The structural metrics of the pipeline: feature vectors, the
    similarity functions and matrices, the three calculators (JSON of each
    result) and ``structural_metrics`` with a reference and a prefix."""
    paths = _metric_midis(tmp_path)
    vec, jvec = vectorization.MidiVectorizer(), jax_vec.MidiVectorizer()
    for path in paths:
        assert vec.midi_or_score_to_notes_and_offsets_feature_vectors(path) \
            == jvec.midi_or_score_to_notes_and_offsets_feature_vectors(path)
    pf, of = vec.midi_or_score_to_notes_and_offsets_feature_vectors(paths[0])
    rpf, rof = vec.midi_or_score_to_notes_and_offsets_feature_vectors(
        paths[1])
    assert np.array_equal(similarities.cyclic_pitch_similarity_matrix(pf, rpf),
                          jax_sim.cyclic_pitch_similarity_matrix(pf, rpf))
    assert [similarities.rhythmic_similarity(a, b) for a in of for b in rof] \
        == [jax_sim.rhythmic_similarity(a, b) for a in of for b in rof]
    for mode in ("first", "closest", "all"):
        for ours, theirs in (
                (calculate.calculate_inner_similarity_of_music_vectors(
                    of, similarities.rhythmic_similarity,
                    return_best_matches=mode),
                 jax_calc.calculate_inner_similarity_of_music_vectors(
                     of, jax_sim.rhythmic_similarity,
                     return_best_matches=mode)),
                (calculate.calculate_reference_similarity_of_music_vectors(
                    pf, rpf, similarities.cyclic_pitch_similarity,
                    return_best_matches=mode, n_measures_to_skip=2),
                 jax_calc.calculate_reference_similarity_of_music_vectors(
                     pf, rpf, jax_sim.cyclic_pitch_similarity,
                     return_best_matches=mode, n_measures_to_skip=2)),
                (calculate.calculate_conditioned_similarity_of_music_vectors(
                    pf, 3, matrix_fn=similarities.cyclic_pitch_similarity_matrix,
                    return_best_matches=mode),
                 jax_calc.calculate_conditioned_similarity_of_music_vectors(
                     pf, 3, matrix_fn=jax_sim.cyclic_pitch_similarity_matrix,
                     return_best_matches=mode))):
            assert _dump(ours) == _dump(theirs)
    results = [calculate.calculate_inner_similarity_of_music_vectors(
        pf, similarities.cyclic_pitch_similarity) for _ in range(2)]
    jresults = [jax_calc.calculate_inner_similarity_of_music_vectors(
        pf, jax_sim.cyclic_pitch_similarity) for _ in range(2)]
    assert _dump(calculate.aggregate_similarity_results(results)) == \
        _dump(jax_calc.aggregate_similarity_results(jresults))
    for path in paths:
        got = pipeline.structural_metrics(path, vec, paths[1], 2)
        want = jax_pipeline.structural_metrics(path, jvec, paths[1], 2)
        assert [_dump(r) for pair in got for r in pair] == \
            [_dump(r) for pair in want for r in pair]


def test_quantized_converter_texts_equal_jax(tmp_path):
    paths = _metric_midis(tmp_path, 3)
    for settings in ({}, {"joining_parts_strategy": "Join parallel measures",
                          "include_offset_in_notes": False}):
        ours = qc.MidiQuantizedConverter(
            qc.EncodingSetting(**settings))
        theirs = jax_qc.MidiQuantizedConverter(
            jax_qc.EncodingSetting(**settings))
        for path in paths:
            texts = ours.filepath_to_texts(path)
            assert texts == theirs.filepath_to_texts(path) and texts
            for text in texts.values():
                assert repr(ours.text_to_score(text)) == \
                    repr(theirs.text_to_score(text))


def test_proxy_scores_equal_jax():
    rng = np.random.default_rng(0)
    t = np.arange(16_000 * 6) / 16_000
    waves = [(0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
             rng.normal(0, 0.4, 16_000 * 3).astype(np.float32),
             np.zeros(16_000, np.float32), np.ones(3000, np.float32),
             np.clip(rng.normal(0, 2.0, 16_000 * 2), -1, 1).astype(np.float32)]
    for wave in waves:
        assert aesthetics.proxy_score_wave(wave) == \
            jax_aes.proxy_score_wave(wave)


def test_aggregates_equal_jax_with_nan_rows(tmp_path):
    """``aggregate_jsonl_stats`` (JSON, NaN rows skipped by the mean and the
    sem) and ``frame_ci_stats``; an empty and a missing file give the same
    error."""
    rows = [{"CE": 5.5, "CU": 4.0, "PC": 2.0, "PQ": 7.25, "proxy": True},
            {"CE": float("nan"), "CU": 3.0, "PC": float("nan"), "PQ": 6.0,
             "proxy": True},
            {"CE": 6.0, "CU": 2.5, "PC": 9.0, "PQ": float("nan"),
             "proxy": True},
            {"CE": 1.0, "CU": 1.0, "PC": 1.0, "PQ": 1.0, "proxy": True}]
    path = tmp_path / "a.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    (tmp_path / "empty.jsonl").write_text("")
    for p, cols in ((path, ["CE", "CU", "PC", "PQ"]), (path, None),
                    (path, ["PQ", "nope"]), (tmp_path / "empty.jsonl", None),
                    (tmp_path / "missing.jsonl", None)):
        ours = aesthetics.aggregate_jsonl_stats(str(p), cols)
        assert json.dumps(ours) == \
            json.dumps(jax_aes.aggregate_jsonl_stats(str(p), cols))
    # the NaN rows are skipped, not propagated
    ce = aesthetics.aggregate_jsonl_stats(str(path))["mean"]["CE"]
    assert math.isclose(ce, (5.5 + 6.0 + 1.0) / 3)
    import pandas as pd

    frame = pd.DataFrame({"melody": [0.5, float("nan"), 0.75, 1.0],
                          "rhythm": [0.25, 0.5, float("nan"), 0.0]})
    assert json.dumps(aesthetics.frame_ci_stats(frame)) == \
        json.dumps(jax_aes.frame_ci_stats(frame))


# -- the eval tree's last host copies: plotting, the ranking, the IrishMAN
# pipeline and the A/B harness ----------------------------------------------


def _similarity_results(tmp_path):
    """The same SimilarityResult from each package's calculator (one of a
    tune, one with no best-match distances, one with an empty matrix)."""
    paths = _metric_midis(tmp_path, 2)
    pf, _ = vectorization.MidiVectorizer() \
        .midi_or_score_to_notes_and_offsets_feature_vectors(paths[0])
    pairs = [(calculate.calculate_inner_similarity_of_music_vectors(
        pf, similarities.cyclic_pitch_similarity),
        jax_calc.calculate_inner_similarity_of_music_vectors(
            pf, jax_sim.cyclic_pitch_similarity))]
    for matrix, best in (([[1.0, 0.25], [0.25, 1.0]], [(0.25, [0], [])]),
                         ([], [])):
        pairs.append(tuple(mod.SimilarityResult(
            similarity_matrix=matrix, best_matches=best,
            mean_best_similarities=0.5) for mod in (calculate, jax_calc)))
    return pairs


def _figure_data(fig):
    ax = fig.axes[0]
    return dict(title=ax.get_title(), x=ax.get_xlabel(), y=ax.get_ylabel(),
                images=[np.asarray(im.get_array()).tolist()
                        for im in ax.images],
                bars=[(p.get_x(), p.get_width(), p.get_height())
                      for p in ax.patches])


def test_plotting_copy_equals_jax(tmp_path):
    """eval/plotting.py: each figure's data (the matrix image, the
    histograms' bars, titles and labels) and the saved PNG bytes equal
    the original's."""
    import matplotlib.pyplot as plt

    from ai_music_generation_tpu.eval import plotting as jax_plotting
    from ai_music_generation_tpu_torch.eval import plotting

    for i, (ours, theirs) in enumerate(_similarity_results(tmp_path)):
        for name in ("plot_similarity_matrix",
                     "plot_distribution_of_best_similarities",
                     "plot_distribution_of_best_match_measure_distances"):
            figs = [getattr(mod, name)(res) for mod, res in
                    ((plotting, ours), (jax_plotting, theirs))]
            assert _figure_data(figs[0]) == _figure_data(figs[1]), name
            for fig in figs:
                plt.close(fig)
            saved = [str(tmp_path / f"{name}_{i}_{tag}.png")
                     for tag in ("port", "jax")]
            getattr(plotting, name)(ours, save_path=saved[0])
            getattr(jax_plotting, name)(theirs, save_path=saved[1])
            assert filecmp.cmp(*saved, shallow=False), name


def _ranking_inputs(root):
    """Structural similarity JSONLs (with ties, a file missing from the
    prefix metric) and the aesthetics dir the ranking CLI joins."""
    sm, ad = root / "structure", root / "aes"
    sm.mkdir()
    ad.mkdir()
    names = ["file_sample_bwv103.6", "sample_7", "file_12", "plain"]
    rng = np.random.default_rng(3)

    def rows(n):
        return "".join(json.dumps({
            "path": f"/gen/{name}.mid",
            "melody": {"mean_best_similarities": float(v[0])},
            "rhythm": {"mean_best_similarities": float(v[1])}}) + "\n"
            for name, v in zip(names[:n], np.round(
                rng.uniform(size=(n, 2)), 1)))

    (sm / "inner_similarity.jsonl").write_text(rows(4))
    (sm / "conditional_prefix_similarity.jsonl").write_text(rows(3))
    (sm / "reference_similarity.jsonl").write_text(rows(4))
    (ad / "wav_paths.jsonl").write_text("".join(
        json.dumps({"path": f"/wav/{n}.wav"}) + "\n" for n in names))
    (ad / "aesthetics.jsonl").write_text("".join(
        json.dumps({a: float(v) for a, v in zip(("CE", "CU", "PC", "PQ"),
                                                np.round(rng.uniform(
                                                    1, 10, 4), 0))}) + "\n"
        for _ in names[:3]))
    return str(sm), str(ad)


@pytest.mark.parametrize("with_reference", [False, True],
                         ids=["plain", "reference"])
def test_create_generations_ranking_equals_jax(tmp_path, with_reference):
    """cli/create_generations_ranking.py: all_metrics.csv,
    detailed_ranking.csv, final_ranking.csv and ranked_identifiers.txt
    byte-equal to the original's (ties ranked with method="min", a file
    without aesthetics), and the same returned frame."""
    from ai_music_generation_tpu.cli import create_generations_ranking as jax_rank
    from ai_music_generation_tpu_torch.cli import create_generations_ranking

    sm, ad = _ranking_inputs(tmp_path)
    flags = ["--include_reference_similarities"] if with_reference else []
    got = create_generations_ranking.main(
        [sm, ad, str(tmp_path / "port"), *flags])
    want = jax_rank.main([sm, ad, str(tmp_path / "jax"), *flags])
    assert got.equals(want)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "all_metrics.csv", "detailed_ranking.csv", "final_ranking.csv",
        "ranked_identifiers.txt"]
    for name in files:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    assert create_generations_ranking.extract_identifier_from_path(
        "/a/file_sample_x.1.wav") == "x.1"


IRISH = [{"abc notation": f"X:{i}\nL:1/8\nM:4/4\nK:{key}\n{body}|\n",
          "control code": f"S:{i % 3}"}
         for i, (key, body) in enumerate([
             ("C", "CDEF GABc"), ("G", "GABc d2B2"), ("D", "DEFG A4"),
             ("A", "ABcd e4"), ("C", "c2B2 A2G2"), ("F", "FGAB c4")])]
IRISH.append({"abc notation": "L:1/8\nK:C\nCDEF|\n"})  # no X: header


def _irish_run(main, root, inputs):
    """preprocess, leadsheet-subset, split-validation and to-midi through
    one CLI's ``main``, writing under ``root``."""
    pre = os.path.join(root, "pre")
    main(["preprocess", *inputs, "--out_dir", pre])
    ids = os.path.join(root, "ids.json")
    with open(ids, "w") as f:
        json.dump([1, "3", 5, 99], f)
    pre_files = [os.path.join(pre, os.path.basename(p)) for p in inputs]
    main(["leadsheet-subset", *pre_files, "--leadsheet_ids", ids,
          "--out_dir", os.path.join(root, "lead")])
    main(["split-validation", pre_files[0], "--out_dir",
          os.path.join(root, "split"), "--seed", "7"])
    main(["to-midi", pre_files[0], "--out_dir", os.path.join(root, "midi")])


def test_irishman_pipeline_equals_jax(tmp_path):
    """cli/irishman_pipeline.py: the preprocess, leadsheet-subset and
    split-validation JSON byte-equal to the original's, and to-midi's .abc
    and MIDI bytes equal (a tune without an X: header included)."""
    from ai_music_generation_tpu.cli import irishman_pipeline as jax_irish
    from ai_music_generation_tpu_torch.cli import irishman_pipeline

    inputs = []
    for name, entries in (("train.json", IRISH), ("valid.json", IRISH[2:5])):
        inputs.append(str(tmp_path / name))
        with open(inputs[-1], "w") as f:
            json.dump(entries, f)
    _irish_run(irishman_pipeline.main, str(tmp_path / "port"), inputs)
    _irish_run(jax_irish.main, str(tmp_path / "jax"), inputs)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    files = tree(tmp_path / "jax")
    assert files == tree(tmp_path / "port")
    assert sum(f.endswith(".mid") for f in files) == len(IRISH)
    for rel in files:
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel,
                           shallow=False), rel


def test_irishman_to_midi_renders_and_scores_on_the_device(tmp_path,
                                                          monkeypatch):
    """to-midi --render_wav renders and scores on ``--device`` (cpu here):
    a WAV per tune, a proxy row each, the aggregate; without a card the
    default device raises before any tune is written."""
    from ai_music_generation_tpu_torch.cli import irishman_pipeline

    src = str(tmp_path / "tunes.json")
    with open(src, "w") as f:
        json.dump(IRISH[:2], f)
    out = tmp_path / "out"
    irishman_pipeline.main(["to-midi", src, "--out_dir", str(out),
                            "--render_wav", "--device", "cpu"])
    assert sorted(os.listdir(out / "wav")) == ["0.wav", "1.wav"]
    rows = [json.loads(line) for line in open(out / "aesthetics.jsonl")]
    assert len(rows) == 2 and all(r["proxy"] for r in rows)
    assert set(json.load(open(out / "aesthetics_aggregated.json"))) >= {
        "mean", "ci95_lower"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        irishman_pipeline.main(["to-midi", src, "--out_dir",
                                str(tmp_path / "none"), "--render_wav"])
    assert not os.path.exists(tmp_path / "none")


def test_aesthetics_ab_report_equals_jax(tmp_path, monkeypatch):
    """cli/aesthetics_ab.py without audio-aes on PATH: proxy.jsonl
    byte-equal to the original's and the same ab_report.json (its
    ``real_available: false``, the proxy file's path aside)."""
    from ai_music_generation_tpu.cli import aesthetics_ab as jax_ab_cli
    from ai_music_generation_tpu_torch.cli import aesthetics_ab

    monkeypatch.setattr(aesthetics.shutil, "which", lambda _: None)
    rng = np.random.default_rng(8)
    paths = []
    for i, sec in enumerate((1.5, 3.0)):
        paths.append(str(tmp_path / f"{i}.wav"))
        wav_io.write_wav(paths[-1], (0.3 * rng.normal(size=int(16000 * sec)))
                         .astype(np.float32))
    paths.append(str(tmp_path / "missing.wav"))
    jsonl = tmp_path / "wav_paths.jsonl"
    jsonl.write_text("".join(json.dumps({"path": p}) + "\n" for p in paths))
    got = aesthetics_ab.main([str(jsonl), str(tmp_path / "port"),
                              "--device", "cpu"])
    want = jax_ab_cli.main([str(jsonl), str(tmp_path / "jax")])
    assert got["real_available"] is want["real_available"] is False
    assert filecmp.cmp(tmp_path / "port" / "proxy.jsonl",
                       tmp_path / "jax" / "proxy.jsonl", shallow=False)
    reports = [json.load(open(tmp_path / side / "ab_report.json"))
               for side in ("port", "jax")]
    for report, side in zip(reports, ("port", "jax")):
        assert report.pop("proxy_jsonl") == str(tmp_path / side /
                                                "proxy.jsonl")
    assert reports[0] == reports[1] == {"real_available": False, "axes": {}}
