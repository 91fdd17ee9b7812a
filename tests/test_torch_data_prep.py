"""The port's data preparation (``data/prepare.py``, ``data/gpt2_bpe.py``,
``tokenizers/simple.py``, ``cli/prepare.py``) against the JAX package's, on
the inputs of tests/test_data_prep.py and tests/test_prepare_goldens.py:
every file each mode writes, its return value and what it prints.

The char, whitespace, midi-text and GPT-2 BPE modes are deterministic, so
their bins and meta.pkl are byte-equal. The BPE and WordPiece modes train
with the ``tokenizers`` package, whose vocabulary is a hash map: its key
order (hence meta.pkl's bytes) changes from call to call, in the JAX
package too, and so do WordPiece's non-special ids (two JAX calls on the
same input assign them differently). There the BPE bins are byte-equal and
its meta, ``vocab.json`` and ``tokenizer.json`` equal as parsed objects;
the WordPiece vocabulary, special ids and token sequence are equal, and its
bins are byte-equal once the port's ids are mapped through its ``itos``
and JAX's ``stoi``.
"""

import contextlib
import filecmp
import io
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import prepare as jax_cli
from ai_music_generation_tpu.data import gpt2_bpe as jax_bpe
from ai_music_generation_tpu.data import prepare as jax_prepare
from ai_music_generation_tpu.tokenizers import simple as jax_simple
from ai_music_generation_tpu_torch.cli import prepare as cli
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.data import gpt2_bpe
from ai_music_generation_tpu_torch.data import prepare
from ai_music_generation_tpu_torch.tokenizers import simple

torch.set_num_threads(1)

# tests/test_data_prep.py
ENTRIES = [
    {"abc notation": "L:1/8\nK:G\nGABc dedB|dedB dedB|"},
    {"abc notation": "L:1/8\nK:D\nABcd efga|"},
]
# tests/test_prepare_goldens.py
TRAIN_ENTRIES = [
    {"abc notation": "X:1\nL:1/8\nK:G\nGABc dedB|\n"},
    {"abc notation": "  X:2\nL:1/4\nK:D\nDEFG A2|\n  "},
]
VALID_ENTRIES = [{"abc notation": "X:3\nL:1/8\nK:C\nCDEF G2|\n"}]
TUNES = [{"abc notation": "  " + t + "\n"} for t in random_tunes(60, seed=1)]
SPLITS = {"test_data_prep": (ENTRIES, ENTRIES[:1]),
          "goldens": (TRAIN_ENTRIES, VALID_ENTRIES),
          "tunes": (TUNES[:50], TUNES[50:])}
TEXTS = ["aaabab", "hello world", "don't stop", "naïve — déjà vu\n",
         "a1b2 33", "  two  spaces\n\nand\ttabs ", "X:1\nK:G\nGABc|]"]


def _quiet(fn, *args, **kw):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _remapped(port_dir, jax_dir, name):
    """The port's ``name`` bin with each id mapped to JAX's id of its
    token."""
    ours, theirs = (_load(os.path.join(d, "meta.pkl"))
                    for d in (port_dir, jax_dir))
    dtype = np.dtype(ours["bin_dtype"])
    ids = np.fromfile(os.path.join(port_dir, name), dtype)
    lut = np.array([theirs["stoi"][ours["itos"][i]]
                    for i in range(len(ours["itos"]))], dtype)
    return lut[ids] if len(ids) else ids


def assert_same_files(port_dir, jax_dir, mode):
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    for name in names:
        ours, theirs = (os.path.join(d, name) for d in (port_dir, jax_dir))
        if mode not in ("bpe", "wordpiece") or (mode == "bpe"
                                                and name.endswith(".bin")):
            assert filecmp.cmp(ours, theirs, shallow=False), name
        elif name.endswith(".bin"):
            want = np.fromfile(theirs, np.uint16)
            np.testing.assert_array_equal(
                _remapped(port_dir, jax_dir, name), want, err_msg=name)
        elif name == "meta.pkl":
            a, b = _load(ours), _load(theirs)
            if mode == "bpe":
                assert a == b
            else:
                assert set(a["stoi"]) == set(b["stoi"])
                assert {k: v for k, v in a.items()
                        if k not in ("stoi", "itos")} == \
                    {k: v for k, v in b.items() if k not in ("stoi", "itos")}
                for special in ("[UNK]", "[CLS]", "[SEP]", "[PAD]",
                                "[MASK]"):
                    assert a["stoi"][special] == b["stoi"][special]
        else:  # tokenizer.json, vocab.json
            with open(ours) as f, open(theirs) as g:
                a, b = json.load(f), json.load(g)
            if mode == "wordpiece":
                a["model"]["vocab"] = set(a["model"]["vocab"])
                b["model"]["vocab"] = set(b["model"]["vocab"])
            assert a == b, name


def _run_both(tmp_path, fn_name, *args, **kw):
    got = _quiet(getattr(prepare, fn_name), *args,
                 str(tmp_path / "port"), **kw)
    want = _quiet(getattr(jax_prepare, fn_name), *args,
                  str(tmp_path / "jax"), **kw)
    assert got == want
    return str(tmp_path / "port"), str(tmp_path / "jax")


@pytest.mark.parametrize("mode", ["char", "whitespace", "bpe", "wordpiece"])
@pytest.mark.parametrize("split", list(SPLITS))
def test_entry_modes_write_the_jax_files(tmp_path, mode, split):
    train, valid = SPLITS[split]
    kw = {"vocab_size": 300} if mode in ("bpe", "wordpiece") else {}
    port_dir, jax_dir = _run_both(tmp_path, f"prepare_{mode}", train, valid,
                                  **kw)
    assert_same_files(port_dir, jax_dir, mode)
    assert prepare.entries_to_text(train) == \
        jax_prepare.entries_to_text(train)


def _write_texts(d, texts):
    os.makedirs(d, exist_ok=True)
    for i, t in enumerate(texts):
        with open(os.path.join(d, f"{i:03d}.txt"), "w") as f:
            f.write(t)
    return str(d)


MIDI_CASES = {
    # tests/test_data_prep.py::test_prepare_midi_texts_union_vocab
    "union": (["p60 d12 | p62 d12 |"], ["p64 d24 |"],
              [["p99 d48 | rest d12 |"]]),
    # tests/test_prepare_goldens.py::test_midi_texts_prefix_and_union_vocab
    "goldens": (["p60 d4 o0 / p62 d4 o4", "time_signature_3/4 p64 d2 o0"],
                ["p60 d2 o0"], [["p72 d8 o0 / p74 d8 o8"]]),
    # ... and its uint32 switchover (a vocab of 2**16 + 1)
    "uint32": ([" ".join(f"w{i}" for i in range(2 ** 16))], ["w0 w1"], []),
    "no-extra": (["p60 d4 | p62 d4", "p64 d2 o2"], ["p60 d4"], []),
}


@pytest.mark.parametrize("case", list(MIDI_CASES))
def test_midi_texts_write_the_jax_files(tmp_path, case):
    train, valid, extras = MIDI_CASES[case]
    dirs = [_write_texts(tmp_path / "in" / "train", train),
            _write_texts(tmp_path / "in" / "valid", valid)]
    extra = [_write_texts(tmp_path / "in" / f"extra{i}", t)
             for i, t in enumerate(extras)]
    port_dir, jax_dir = _run_both(tmp_path, "prepare_midi_texts", *dirs,
                                  extra_vocab_dirs=extra)
    assert_same_files(port_dir, jax_dir, "midi")
    assert prepare.load_texts_from_directory(dirs[0]) == \
        jax_prepare.load_texts_from_directory(dirs[0])
    texts = prepare.load_texts_from_directory(dirs[0])
    assert prepare.texts_to_midi_corpus(texts) == \
        jax_prepare.texts_to_midi_corpus(texts)


def _fixture_assets(root, merges=("a a", "aa a", "a b")):
    """tests/test_data_prep.py's fixture vocab: the 256 byte tokens plus one
    token a merge."""
    base = [gpt2_bpe.bytes_to_unicode()[b] for b in range(256)]
    encoder = {c: i for i, c in enumerate(base)}
    for m in merges:
        encoder["".join(m.split())] = len(encoder)
    d = root / "gpt2_assets"
    d.mkdir()
    (d / "encoder.json").write_text(json.dumps(encoder))
    (d / "vocab.bpe").write_text("#version: 0.2\n" + "\n".join(merges)
                                 + "\n")
    return str(d)


@pytest.fixture(scope="module")
def trained_assets(tmp_path_factory):
    """A fuller merge table: a byte-level BPE trained (vocab 600) on the
    random tunes, written as encoder.json + vocab.bpe."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(
        [e["abc notation"] for e in TUNES] + TEXTS,
        trainers.BpeTrainer(
            vocab_size=600,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    state = json.loads(tok.to_str())
    d = tmp_path_factory.mktemp("trained") / "assets"
    d.mkdir()
    (d / "encoder.json").write_text(json.dumps(state["model"]["vocab"]))
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in state["model"]["merges"]]
    (d / "vocab.bpe").write_text("#version: 0.2\n" + "\n".join(merges))
    return str(d)


def test_byte_table_equals_jax():
    assert gpt2_bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()
    assert gpt2_bpe._GPT2_SPLIT == jax_bpe._GPT2_SPLIT


@pytest.mark.parametrize("assets", ["fixture", "trained"])
def test_gpt2_bpe_ids_equal_jax(tmp_path, trained_assets, assets):
    path = (_fixture_assets(tmp_path) if assets == "fixture"
            else trained_assets)
    ours, theirs = (m.load_gpt2_codec(path) for m in (gpt2_bpe, jax_bpe))
    assert ours.n_vocab == theirs.n_vocab
    texts = TEXTS + [e["abc notation"] for e in TUNES[:20]]
    for s in texts:
        ids = ours.encode_ordinary(s)
        assert ids == theirs.encode_ordinary(s), s
        assert ours.decode(ids) == theirs.decode(ids) == s
    if assets == "fixture":  # lowest rank first: [aaa, b, ab]
        assert ours.encode_ordinary("aaabab") == [257, ord("b"), 258]


def _fake_tiktoken(fail=False):
    class Enc:
        n_vocab = 7

        def encode_ordinary(self, text):
            return [len(text)]

        def decode(self, ids):
            return "x" * sum(ids)

    def get_encoding(name):
        assert name == "gpt2"
        if fail:
            raise ConnectionError("no network")
        return Enc()

    return types.SimpleNamespace(get_encoding=get_encoding)


def _fake_transformers(assets):
    """transformers with a GPT2TokenizerFast whose local cache holds the
    fixture vocab and merges (as ``tokenizer.json`` serializes them)."""
    with open(os.path.join(assets, "encoder.json")) as f:
        vocab = json.load(f)
    with open(os.path.join(assets, "vocab.bpe")) as f:
        merges = [ln for ln in f.read().split("\n")[1:] if ln]

    class Fast:
        @classmethod
        def from_pretrained(cls, name, local_files_only):
            assert name == "gpt2" and local_files_only
            return cls()

        def get_vocab(self):
            return dict(vocab)

        backend_tokenizer = types.SimpleNamespace(to_str=lambda: json.dumps(
            {"model": {"merges": merges}}))

    return types.SimpleNamespace(GPT2TokenizerFast=Fast)


@pytest.mark.parametrize("source", ["assets", "env", "tiktoken", "hf_cache",
                                    "none"])
def test_codec_resolution_order_and_errors_equal_jax(tmp_path, monkeypatch,
                                                      source):
    """assets_dir (or GPT2_BPE_DIR) first, then tiktoken, then the HF cache,
    then Gpt2AssetsUnavailable with the same text; a bad assets_dir falls
    through, as in the original. tiktoken and transformers are faked: no
    source reaches for the network."""
    good = _fixture_assets(tmp_path)
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.delenv("GPT2_BPE_DIR", raising=False)
    monkeypatch.setitem(sys.modules, "tiktoken",
                        _fake_tiktoken(fail=source != "tiktoken"))
    monkeypatch.setitem(sys.modules, "transformers",
                        _fake_transformers(good) if source == "hf_cache"
                        else None)
    arg = {"assets": good, "env": None}.get(source, str(empty))
    if source == "env":
        monkeypatch.setenv("GPT2_BPE_DIR", good)
    results = []
    for mod in (gpt2_bpe, jax_bpe):
        if source == "none":
            with pytest.raises(mod.Gpt2AssetsUnavailable) as info:
                mod.load_gpt2_codec(arg)
            results.append(str(info.value))
        else:
            codec = mod.load_gpt2_codec(arg)
            results.append((type(codec).__name__, codec.n_vocab,
                            codec.encode_ordinary("aaabab ab"),
                            codec.decode([1, 2])))
    assert results[0] == results[1]
    if source == "none":
        assert "encoder.json" in results[0] and "tiktoken" in results[0]
    else:
        assert results[0][0] == ("_TiktokenCodec" if source == "tiktoken"
                                 else "Gpt2Bpe")


def test_prepare_gpt2bpe_writes_the_jax_files(tmp_path, trained_assets):
    """90/10 character split, uint16 bins, no meta.pkl."""
    text = " ".join(e["abc notation"] for e in TUNES)
    port_dir, jax_dir = _run_both(tmp_path, "prepare_gpt2bpe", text,
                                  assets_dir=trained_assets)
    assert sorted(os.listdir(port_dir)) == ["train.bin", "val.bin"]
    assert_same_files(port_dir, jax_dir, "gpt2bpe")


@pytest.mark.parametrize("argv", [
    ["char", "--train_json={tj}", "--valid_json={vj}"],
    ["whitespace", "--train_json={tj}", "--valid_json={vj}"],
    ["bpe", "--train_json={tj}", "--valid_json={vj}", "--vocab_size=280"],
    ["wordpiece", "--train_json={tj}", "--valid_json={vj}",
     "--vocab_size=280"],
    ["char", "--text={txt}", "--val_ratio=0.2"],
    ["whitespace", "--text={txt}"],
    ["midi", "--train_dir={td}", "--valid_dir={vd}",
     "--extra_vocab_dirs", "{xd}"],
    ["gpt2bpe", "--text={txt}", "--bpe_assets={assets}"],
], ids=["char", "whitespace", "bpe", "wordpiece", "char-text",
        "whitespace-text", "midi", "gpt2bpe"])
def test_prepare_cli_writes_the_jax_files(tmp_path, argv):
    tj, vj, txt = (tmp_path / n for n in ("train.json", "valid.json",
                                          "input.txt"))
    tj.write_text(json.dumps(TUNES[:50]))
    vj.write_text(json.dumps(TUNES[50:]))
    txt.write_text("\n".join(e["abc notation"] for e in TUNES))
    fill = dict(tj=tj, vj=vj, txt=txt,
                td=_write_texts(tmp_path / "td", ["p60 d4 | p62 d4"]),
                vd=_write_texts(tmp_path / "vd", ["p64 d2 o2"]),
                xd=_write_texts(tmp_path / "xd", ["p99 d48 |"]),
                assets=_fixture_assets(tmp_path))
    args = [a.format(**fill) for a in argv]
    mode = argv[0]
    got = _quiet(cli.main, args + [f"--out_dir={tmp_path / 'port'}"])
    want = _quiet(jax_cli.main, args + [f"--out_dir={tmp_path / 'jax'}"])
    assert got == want
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), mode)


@pytest.mark.parametrize("argv", [["gpt2bpe"], ["nope"], []],
                         ids=["gpt2bpe-without-text", "unknown-mode",
                              "no-mode"])
def test_prepare_cli_errors_equal_jax(tmp_path, capsys, argv):
    codes = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as info:
            main(argv + [f"--out_dir={tmp_path}"])
        codes.append((info.value.code, capsys.readouterr().err))
    assert codes[0] == codes[1] and codes[0][0] == 2


def test_simple_tokenizers_equal_jax():
    text = "\n".join(e["abc notation"] for e in TUNES[:10])
    for ours, theirs in (
            (simple.CharTokenizer.from_text(text),
             jax_simple.CharTokenizer.from_text(text)),
            (simple.WhitespaceTokenizer.from_texts(text.split("\n")),
             jax_simple.WhitespaceTokenizer.from_texts(text.split("\n")))):
        assert ours.meta() == theirs.meta()
        assert ours.vocab_size == theirs.vocab_size
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
        back = simple.tokenizer_from_meta(ours.meta())
        assert type(back).__name__ == type(
            jax_simple.tokenizer_from_meta(theirs.meta())).__name__
        np.testing.assert_array_equal(simple.encode_to_bin(ours, text),
                                      jax_simple.encode_to_bin(theirs, text))
        assert simple.encode_to_bin(ours, text).dtype == np.uint16
