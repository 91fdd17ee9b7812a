"""The port's copies of JAX-package host code against their originals (the
port imports nothing of the JAX package, so it keeps its own copies; these
tests show when either side changes): the configurator, the memmap file
helpers, the random-note corpus helpers, ``prepare_char``, the training
configs that chip_smoke.py and the tests run, TunesFormer's Patchilizer,
and the control-code curation (``data/curation.py``) with its
``cli/add_control_codes.py``. Everything here is
deterministic, so every comparison is exact (the batch sampler's copy is
held to its original in tests/test_torch_train_pieces.py).
"""

import filecmp
import os
import random

import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import add_control_codes as jax_acc
from ai_music_generation_tpu.cli import random_baselines as jax_rb
from ai_music_generation_tpu.data import curation as jax_cur
from ai_music_generation_tpu.data import memmap as jax_memmap
from ai_music_generation_tpu.data import prepare as jax_prepare
from ai_music_generation_tpu.tokenizers import patchilizer as jax_patch
from ai_music_generation_tpu.utils import configurator as jax_conf
from ai_music_generation_tpu_torch.cli import add_control_codes as acc
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


@pytest.mark.parametrize("name", ["irishman_char.py", "train_gpt2.py"])
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
