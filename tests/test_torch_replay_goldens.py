"""The port's golden-replay harness (``cli/replay_goldens.py``, run with
``--device cpu``) against the JAX package's ``main`` on the same fixtures
(tests/test_replay_goldens.py's): the same report rows (stage, status and
detail, with each run's out_dir written as ``<out>``) and the same exit
code, stage by stage. Fake ``abc2midi`` / ``fluidsynth`` binaries stand in
for the real ones, a stand-in predictor for the A/B leg, and the
Audiobox stage scores with a tiny seeded checkpoint at 0.5-s chunks.
"""

import json
import os
import stat
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import replay_goldens as jax_replay
from ai_music_generation_tpu.eval import audiobox as jax_ab
from ai_music_generation_tpu_torch.cli import replay_goldens as replay
from ai_music_generation_tpu_torch.eval import audiobox as ab

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fixtures(tmp_path):
    train = [{"abc notation": "X:1\nK:C\nCDEF GABc|"}] * 3
    valid = [{"abc notation": "X:2\nK:G\nGABc defg|"}]
    (tmp_path / "train.json").write_text(json.dumps(train))
    (tmp_path / "valid.json").write_text(json.dumps(valid))
    for split, texts in (("train", ["p60 d4 | p62 d4", "p64 d2 o2"]),
                         ("valid", ["p60 d4"])):
        d = tmp_path / "bach" / split
        d.mkdir(parents=True)
        for i, t in enumerate(texts):
            (d / f"{i}.txt").write_text(t)

    # a reference-format weights.pth written by the JAX package
    from ai_music_generation_tpu.models.tunesformer import (
        TunesFormer, TunesFormerConfig)
    from ai_music_generation_tpu.models.tunesformer_export import (
        save_reference_checkpoint)

    tcfg = TunesFormerConfig(patch_length=8, patch_size=16, patch_layers=2,
                             char_layers=2, n_embd=32, n_head=2, dropout=0.0,
                             share_weights=False, dtype=jnp.float32)
    params = TunesFormer(tcfg).init(jax.random.PRNGKey(1),
                                    jnp.ones((1, 8, 16), jnp.int32))
    save_reference_checkpoint(str(tmp_path / "weights.pth"), params, tcfg,
                              epoch=1, best_epoch=1, min_eval_loss=1.0)

    from ai_music_generation_tpu_torch.data.prepare import (
        entries_to_text, texts_to_midi_corpus)

    tr_text, va_text = entries_to_text(train), entries_to_text(valid)
    bach_tr = texts_to_midi_corpus(["p60 d4 | p62 d4", "p64 d2 o2"])
    bach_va = texts_to_midi_corpus(["p60 d4"])
    goldens = {
        "irishman_char": {"vocab": len(set(tr_text + va_text)),
                          "train_tokens": len(tr_text),
                          "val_tokens": len(va_text)},
        "bach_midi": {
            "vocab": len(set(bach_tr.split()) | set(bach_va.split())),
            "train_tokens": len(bach_tr.split()),
            "val_tokens": len(bach_va.split())},
        "tunesformer": {"patch_layers": 2, "char_layers": 2, "n_embd": 32,
                        "patch_size": 16},
    }
    (tmp_path / "goldens.json").write_text(json.dumps(goldens))
    return tmp_path


def _run(tmp_path, *extra):
    """{package: (exit code, [(stage, status, detail)])} of both mains."""
    res = {}
    for name, main, dev in (("port", replay.main, ["--device", "cpu"]),
                            ("jax", jax_replay.main, [])):
        out = tmp_path / f"out_{name}"
        rc = main(["--out_dir", str(out), "--goldens",
                   str(tmp_path / "goldens.json"), *extra, *dev])
        report = json.loads((out / "replay_report.json").read_text())
        res[name] = (rc, [(r["stage"], r["status"],
                           r["detail"].replace(str(out), "<out>"))
                          for r in report])
    assert res["port"] == res["jax"]
    rc, rows = res["port"]
    return rc, {stage: status for stage, status, _ in rows}


def test_all_stages_skip_without_inputs(fixtures):
    rc, statuses = _run(fixtures)
    assert rc == 0 and set(statuses.values()) == {"SKIP"}
    assert set(statuses) == {"irishman_char", "leadsheet_char", "bach_midi",
                             "tunesformer", "audiobox", "abc2midi_diff",
                             "fluidsynth_ab", "shakespeare_gpt2"}


def test_stages_pass_on_fixture_goldens(fixtures):
    rc, statuses = _run(
        fixtures,
        "--irishman_train", str(fixtures / "train.json"),
        "--irishman_valid", str(fixtures / "valid.json"),
        "--bach_train_dir", str(fixtures / "bach" / "train"),
        "--bach_valid_dir", str(fixtures / "bach" / "valid"),
        "--tunesformer_weights", str(fixtures / "weights.pth"),
    )
    assert rc == 0
    for stage in ("irishman_char", "bach_midi", "tunesformer_arch",
                  "tunesformer_bridge"):
        assert statuses[stage] == "PASS", stage
    assert statuses["leadsheet_char"] == statuses["audiobox"] == "SKIP"


def test_wrong_goldens_fail_with_exit_1(fixtures):
    goldens = json.loads((fixtures / "goldens.json").read_text())
    goldens["irishman_char"]["vocab"] = 9999
    goldens["tunesformer"]["n_embd"] = 64
    (fixtures / "goldens.json").write_text(json.dumps(goldens))
    rc, statuses = _run(
        fixtures,
        "--irishman_train", str(fixtures / "train.json"),
        "--irishman_valid", str(fixtures / "valid.json"),
        "--tunesformer_weights", str(fixtures / "weights.pth"),
    )
    assert rc == 1
    assert statuses["irishman_char"] == statuses["tunesformer_arch"] == "FAIL"


def test_missing_file_skips_not_errors(fixtures):
    rc, statuses = _run(
        fixtures,
        "--irishman_train", str(fixtures / "train.json"),
        "--irishman_valid", str(fixtures / "nonexistent.json"),
    )
    assert rc == 0 and statuses["irishman_char"] == "SKIP"


def test_default_goldens_are_jax_goldens():
    assert replay.GOLDENS == jax_replay.GOLDENS


def test_device_flag_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the scorer runs on the card; with no card that
    raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("w.pt", "in.jsonl"):
        (tmp_path / name).write_text("")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        replay.main(["--out_dir", str(tmp_path / "out"), "--audiobox_ckpt",
                     str(tmp_path / "w.pt"), "--wav_jsonl",
                     str(tmp_path / "in.jsonl")])


def _fake_bin(tmp_path, name, body):
    """An executable python script with the repository on sys.path (its
    root taken from this file's place)."""
    p = tmp_path / name
    p.write_text("#!" + sys.executable + "\n" + textwrap.dedent(
        f"import sys\nsys.path.insert(0, {ROOT!r})\n")
        + textwrap.dedent(body))
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(p)


@pytest.fixture()
def abc_fixture(tmp_path):
    d = tmp_path / "abc"
    d.mkdir()
    (d / "a.abc").write_text("X:1\nL:1/8\nM:4/4\nK:C\nCDEF GABc|c4 z4|\n")
    (d / "b.abc").write_text("X:2\nL:1/8\nM:6/8\nK:G\nGAB dBG|B3 z3|\n")
    (tmp_path / "goldens.json").write_text("{}")
    return tmp_path, d


@pytest.mark.parametrize("shift", [0, 3], ids=["agreeing", "transposing"])
def test_abc2midi_stage(abc_fixture, shift):
    """A fake abc2midi that is the port's compiler: every note matches, the
    stage PASSes; one transposing every note: match rate 0, FAIL, exit 1."""
    tmp_path, d = abc_fixture
    fake = _fake_bin(tmp_path, "abc2midi", f"""
        from ai_music_generation_tpu_torch.abcnotation.to_midi import (
            abc_to_midi)
        from ai_music_generation_tpu_torch.codec.midi_io import (
            write_midi_file)
        midi = abc_to_midi(open(sys.argv[1]).read())  # argv: abc -o mid
        for n in midi.notes:
            n.pitch += {shift}
        write_midi_file(midi, sys.argv[3])
    """)
    rc, statuses = _run(tmp_path, "--abc2midi_bin", fake, "--abc_dir",
                        str(d))
    assert (rc, statuses["abc2midi_diff"]) == ((0, "PASS") if shift == 0
                                               else (1, "FAIL"))
    rows = [json.loads(x) for x in (tmp_path / "out_port"
                                    / "abc2midi_diff.jsonl").read_text()
            .splitlines()]
    assert [r["note_match"] for r in rows] == [1.0 if shift == 0 else 0.0] * 2


@pytest.fixture()
def midi_fixture(tmp_path):
    from ai_music_generation_tpu_torch.abcnotation.to_midi import (
        abc_file_to_midi_file)
    from ai_music_generation_tpu_torch.synth.sf2 import write_sf2

    d = tmp_path / "midi"
    d.mkdir()
    abc = tmp_path / "t.abc"
    abc.write_text("X:1\nL:1/8\nK:C\nCDEF|\n")
    abc_file_to_midi_file(str(abc), str(d / "t.mid"))
    sf2 = tmp_path / "tiny.sf2"
    wave = (0.5 * np.sin(2 * np.pi * 440 / 16000
                         * np.arange(4800))).astype(np.float32)
    write_sf2(str(sf2), [dict(wave=wave, root=69, loop=(1600, 3200))])
    (tmp_path / "goldens.json").write_text("{}")
    fake = _fake_bin(tmp_path, "fluidsynth", """
        import numpy as np
        from ai_music_generation_tpu_torch.synth.wav_io import write_wav
        write_wav(sys.argv[5], np.zeros(1600, np.float32))  # -F wav
    """)
    return tmp_path, d, sf2, fake


def test_fluidsynth_stage_renders_and_gates_on_ckpt(midi_fixture):
    """The port renders its side through its synth on the device;
    without --audiobox_ckpt the render leg PASSes and the A/B SKIPs."""
    tmp_path, d, sf2, fake = midi_fixture
    rc, statuses = _run(tmp_path, "--fluidsynth_bin", fake, "--sf2",
                        str(sf2), "--midi_dir", str(d))
    assert rc == 0 and statuses["fluidsynth_render"] == "PASS"
    assert statuses["fluidsynth_ab"] == "SKIP"
    for side in ("fs_ref", "fs_ours"):
        assert (tmp_path / "out_port" / side / "t.wav").exists()


@pytest.mark.parametrize("skew", [0.0, 1.0], ids=["within-tol", "skewed"])
def test_fluidsynth_stage_ab_ci_check(midi_fixture, monkeypatch, skew):
    """A stand-in predictor scoring both sets equally PASSes; one skewing
    the reference set beyond tol + CI FAILs, exit 1."""
    tmp_path, d, sf2, fake = midi_fixture
    ckpt = tmp_path / "aes.ckpt"
    ckpt.write_text("placeholder")

    class FakePred:
        def __init__(self, config=None, weights=None, batch=8, **kw):
            assert weights == str(ckpt)

        def score_jsonl(self, inp, out):
            rows = [json.loads(x) for x in open(inp)]
            with open(out, "w") as f:
                for r in rows:
                    s = skew if "fs_ref" in r["path"] else 0.0
                    f.write(json.dumps(
                        {a: 5.0 + s for a in ("CE", "CU", "PC", "PQ")})
                        + "\n")

    monkeypatch.setattr(ab, "AesPredictor", FakePred)
    monkeypatch.setattr(jax_ab, "AesPredictor", FakePred)
    rc, statuses = _run(tmp_path, "--fluidsynth_bin", fake, "--sf2",
                        str(sf2), "--midi_dir", str(d), "--audiobox_ckpt",
                        str(ckpt), "--wav_jsonl",
                        str(tmp_path / "missing.jsonl"))
    assert (rc, statuses["fluidsynth_ab"]) == ((0, "PASS") if skew == 0
                                               else (1, "FAIL"))


def test_audiobox_stage_maps_every_key(tmp_path, monkeypatch):
    """A seeded tiny checkpoint: every key mapped (PASS), the parity leg
    SKIPs without the audio-aes CLI, and the port's scores are within 2e-4
    of JAX's."""
    import shutil

    from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig
    from ai_music_generation_tpu_torch.synth.wav_io import write_wav

    cfg = ab.AudioboxConfig(wavlm=WavLMConfig(
        hidden_size=32, num_layers=1, num_heads=2, intermediate_size=48,
        conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
        num_buckets=16))
    model = ab.init_audiobox_weights(ab.AudioboxAesthetics(cfg),
                                     torch.Generator().manual_seed(1))
    ckpt = tmp_path / "w.pt"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    rng = np.random.default_rng(0)
    with open(tmp_path / "in.jsonl", "w") as f:
        for i in range(3):
            path = tmp_path / f"{i}.wav"
            write_wav(str(path), (0.1 * rng.standard_normal(
                4000 + 3000 * i)).astype(np.float32))
            f.write(json.dumps({"path": str(path)}) + "\n")
    for mod in (ab, jax_ab):  # both predictors at 0.5-s chunks
        real = mod.AesPredictor

        def tiny(*args, _real=real, **kwargs):
            return _real(*args, **dict(kwargs, chunk_seconds=0.5))
        monkeypatch.setattr(mod, "AesPredictor", tiny)
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: None
                        if name == "audio-aes" else which(name))
    (tmp_path / "goldens.json").write_text("{}")
    rc, statuses = _run(tmp_path, "--audiobox_ckpt", str(ckpt),
                        "--wav_jsonl", str(tmp_path / "in.jsonl"))
    assert rc == 0 and statuses["audiobox_keys"] == "PASS"
    assert statuses["audiobox_parity"] == "SKIP"
    got, want = ([json.loads(x) for x in (tmp_path / f"out_{n}"
                                          / "audiobox_ours.jsonl")
                  .read_text().splitlines()] for n in ("port", "jax"))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for axis in ("CE", "CU", "PC", "PQ"):
            assert abs(a[axis] - b[axis]) <= 2e-4


@pytest.mark.parametrize("goldens, want", [
    (None, (0, "PASS")), ({"train_tokens": 1, "val_tokens": 1},
                          (1, "FAIL"))], ids=["fixture", "wrong"])
def test_shakespeare_gpt2_stage_with_fixture_assets(tmp_path, goldens,
                                                    want):
    from ai_music_generation_tpu_torch.data.gpt2_bpe import bytes_to_unicode

    assets = tmp_path / "assets"
    assets.mkdir()
    (assets / "encoder.json").write_text(json.dumps(
        {bytes_to_unicode()[b]: b for b in range(256)}))
    (assets / "vocab.bpe").write_text("#version: 0.2\n")
    inp = tmp_path / "input.txt"
    inp.write_text("to be or not to be " * 20)
    n = len(inp.read_text())
    split = int(n * 0.9)
    (tmp_path / "goldens.json").write_text(json.dumps(
        {"shakespeare_gpt2": goldens or {"train_tokens": split,
                                         "val_tokens": n - split}}))
    rc, statuses = _run(tmp_path, "--shakespeare_txt", str(inp),
                        "--bpe_assets", str(assets))
    assert (rc, statuses["shakespeare_gpt2"]) == want
