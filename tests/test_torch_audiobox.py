"""The port's Audiobox-aesthetics predictor (``eval/audiobox.py``), its
checkpoint loader, ``run_aesthetics``'s Audiobox leg and ``cli/audio_aes.py``
against the JAX package's, on the CPU.

The same random-init weights go through both packages, both ways: JAX's
params into the port through ``models/convert.py::
audiobox_state_dict_from_jax``, and the port's ``state_dict()`` into JAX
through its own ``convert_torch_state_dict``. Scores are held within 2e-4
(the bound of the JAX package's head test, tests/test_audiobox.py), the
host code (``_to_mono_16k``, the loader's placement, the composed
weight-norm kernel) bit for bit. TINY geometry and 0.5-s chunks (attention
is quadratic in frames on the CPU).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import audio_aes as jax_cli
from ai_music_generation_tpu.eval import aesthetics as jax_aes
from ai_music_generation_tpu.eval import audiobox as jax_ab
from ai_music_generation_tpu.eval.wavlm import WavLMConfig as JaxWavLMConfig
from ai_music_generation_tpu_torch.cli import audio_aes
from ai_music_generation_tpu_torch.eval import aesthetics
from ai_music_generation_tpu_torch.eval import audiobox as ab
from ai_music_generation_tpu_torch.eval.wavlm import WavLMConfig
from ai_music_generation_tpu_torch.models.convert import (
    audiobox_state_dict_from_jax,
)
from ai_music_generation_tpu_torch.synth.wav_io import write_wav

torch.set_num_threads(1)

TINY = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
    conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=32, max_distance=80,
)
CHUNK = 0.5
AXES = ("CE", "CU", "PC", "PQ")
CFG = ab.AudioboxConfig(wavlm=WavLMConfig(**TINY))
JAX_CFG = jax_ab.AudioboxConfig(wavlm=JaxWavLMConfig(**TINY))


@pytest.fixture(scope="module")
def jax_params():
    """JAX's random-init predictor params (numpy leaves)."""
    model = jax_ab.AudioboxAesthetics(JAX_CFG)
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 800), jnp.float32),
        jnp.full((1,), 800)))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two WAVs (0.7 s and 1.9 s: 2 and 4 chunks, ragged tails) and the
    jsonl naming them and a missing file."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, sec in enumerate((0.7, 1.9)):
        p = str(root / f"t{i}.wav")
        write_wav(p, (0.1 * rng.normal(size=int(16000 * sec)))
                  .astype(np.float32), 16000)
        paths.append(p)
    paths.append(str(root / "missing.wav"))
    jsonl = root / "in.jsonl"
    jsonl.write_text("".join(json.dumps({"path": p}) + "\n" for p in paths))
    return str(jsonl), paths


def _rows(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


def _assert_rows_close(got, want, tol=2e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(AXES)
        np.testing.assert_allclose([g[a] for a in AXES],
                                   [w[a] for a in AXES], rtol=tol, atol=tol)


def test_predictor_scores_match_jax(jax_params, wavs, tmp_path):
    """``score_jsonl`` over the same bridged params: rows within 2e-4 of
    JAX's ``AesPredictor``, all NaN for the missing file; a file alone
    scores as it does among others (the mask reaches the encoder)."""
    inp, _ = wavs
    jax_pred = jax_ab.AesPredictor(
        JAX_CFG, weights=jax_params, batch=2, chunk_seconds=CHUNK)
    pred = ab.AesPredictor(
        CFG, weights=audiobox_state_dict_from_jax(jax_params, CFG), batch=2,
        chunk_seconds=CHUNK, device="cpu")
    assert pred.unmapped == []
    jax_pred.score_jsonl(inp, str(tmp_path / "jax.jsonl"))
    pred.score_jsonl(inp, str(tmp_path / "port.jsonl"))
    got, want = _rows(tmp_path / "port.jsonl"), _rows(tmp_path / "jax.jsonl")
    assert all(np.isnan(v) for v in got[2].values())
    _assert_rows_close(got[:2], want[:2])

    rng = np.random.default_rng(1)
    wave = (0.05 * rng.normal(size=12345)).astype(np.float32)
    alone = pred.score_wave(wave)
    crowd = pred.score_waves([(np.zeros(16000, np.float32), 16000),
                              (wave, 16000)])[1]
    for a in AXES:
        np.testing.assert_allclose(alone[a], crowd[a], rtol=1e-5)


def test_port_weights_score_the_same_in_jax(wavs):
    """The reverse route: the port's seeded ``state_dict()`` goes through
    JAX's own converter with nothing unmapped, and the two packages score
    the same waves within 2e-4 (a ragged batch, the mask in the encoder)."""
    pred = ab.AesPredictor(CFG, batch=2, chunk_seconds=CHUNK, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in pred.model.state_dict().items()}
    model = jax_ab.AudioboxAesthetics(JAX_CFG)
    template = model.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 800), jnp.float32))
    params, loaded, unmapped = jax_ab.convert_torch_state_dict(sd, template)
    assert unmapped == [] and len(loaded) == len(sd)
    rng = np.random.default_rng(5)
    wave = (0.3 * rng.normal(size=(2, 8000))).astype(np.float32)
    n_valid = np.array([8000, 5000], np.int32)
    wave[1, 5000:] = 0.0
    want = np.asarray(model.apply(params, jnp.asarray(wave),
                                  jnp.asarray(n_valid)))
    got = pred.score_block(wave, n_valid)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


class _TorchAesReplica(torch.nn.Module):
    """tests/test_audiobox.py's torch replica of the predictor head:
    per-axis softmax weighting over the L+1 hidden states, masked mean
    pool, Linear->GELU->Linear, affine de-normalization; its keys are the
    spellings HEAD_KEY_HINTS accepts."""

    def __init__(self, n_states, d, hidden=256):
        super().__init__()
        g = torch.Generator().manual_seed(7)
        for ax in AXES:
            setattr(self, f"layer_weights_{ax}",
                    torch.nn.Parameter(torch.randn(n_states, generator=g)))
            setattr(self, f"proj_{ax}", torch.nn.Sequential(
                torch.nn.Linear(d, hidden), torch.nn.GELU(),
                torch.nn.Linear(hidden, 1)))
        self.out_mean = {ax: 3.0 + 0.5 * i for i, ax in enumerate(AXES)}
        self.out_std = {ax: 1.0 + 0.25 * i for i, ax in enumerate(AXES)}

    def forward(self, hiddens, frame_mask):
        denom = frame_mask.sum(-1, keepdim=True) + 1e-6
        outs = []
        for ax in AXES:
            w = torch.softmax(getattr(self, f"layer_weights_{ax}"), dim=0)
            feat = torch.einsum("l,lbfd->bfd", w, hiddens)
            pooled = (feat * frame_mask[..., None]).sum(1) / denom
            y = getattr(self, f"proj_{ax}")(pooled)[:, 0]
            outs.append(y * self.out_std[ax] + self.out_mean[ax])
        return torch.stack(outs, dim=-1)


def _hf_encoder():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WavLMConfig(
        hidden_size=TINY["hidden_size"], num_hidden_layers=TINY["num_layers"],
        num_attention_heads=TINY["num_heads"],
        intermediate_size=TINY["intermediate_size"],
        conv_dim=TINY["conv_dim"], conv_kernel=TINY["conv_kernel"],
        conv_stride=TINY["conv_stride"],
        num_conv_pos_embeddings=TINY["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=TINY["num_conv_pos_embedding_groups"],
        num_buckets=TINY["num_buckets"],
        max_bucket_distance=TINY["max_distance"],
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0,
        mask_feature_prob=0.0, apply_spec_augment=False)
    torch.manual_seed(0)
    return transformers.WavLMModel(cfg).eval()


def test_head_path_matches_the_torch_replica():
    """HF's WavLM encoder + the replica head on a ragged batch against the
    port loaded from their state dicts through the loader (every head
    tensor placed), its output de-normalization set as the replica's:
    scores within 2e-4."""
    hf = _hf_encoder()
    head = _TorchAesReplica(TINY["num_layers"] + 1, TINY["hidden_size"]).eval()
    rng = np.random.default_rng(11)
    T = 2400
    valid = np.array([T, 1500], np.int64)
    wave = (rng.normal(size=(2, T)) * 0.3).astype(np.float32)
    wave[1, valid[1]:] = 0.0
    wcfg = CFG.wavlm
    nf = np.array([wcfg.frames_for_samples(int(v)) for v in valid])
    frames = wcfg.frames_for_samples(T)
    frame_mask = torch.from_numpy(
        (np.arange(frames)[None, :] < nf[:, None]).astype(np.float32))
    am = torch.from_numpy(
        (np.arange(T)[None, :] < valid[:, None]).astype(np.int64))
    with torch.no_grad():
        enc = hf(torch.from_numpy(wave), attention_mask=am,
                 output_hidden_states=True)
        hiddens = torch.stack(enc.hidden_states) * frame_mask[None, :, :, None]
        want = head(hiddens, frame_mask).numpy()

    model = ab.AudioboxAesthetics(CFG).eval()
    loaded, unmapped = ab.load_state_dict(
        model, {**hf.state_dict(), **head.state_dict()})
    assert unmapped == [], unmapped
    assert sum(k.startswith(("proj_", "layer_weights_")) for k in loaded) == 20
    model.out_mean.copy_(torch.tensor([head.out_mean[a] for a in AXES]))
    model.out_std.copy_(torch.tensor([head.out_std[a] for a in AXES]))
    with torch.no_grad():
        got = model(torch.from_numpy(wave),
                    torch.from_numpy(valid.astype(np.int32))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _jax_template():
    model = jax_ab.AudioboxAesthetics(JAX_CFG)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 800), jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _load_both(sd, template):
    """The dict through JAX's converter and the port's loader; the port's
    resulting weights back through JAX's converter, so both sit in JAX's
    layout: (port's loaded, unmapped, its leaves; JAX's ditto)."""
    jparams, jloaded, junmapped = jax_ab.convert_torch_state_dict(
        dict(sd), template)
    model = ab.AudioboxAesthetics(CFG)
    ab.init_audiobox_weights(model, torch.Generator().manual_seed(0))
    loaded, unmapped = ab.load_state_dict(model, dict(sd))
    # the paths the dict does not name keep each side's init: callers
    # compare only the paths it names
    placed = {k: v.numpy() for k, v in model.state_dict().items()}
    back, _, _ = jax_ab.convert_torch_state_dict(placed, template)
    return (loaded, unmapped, _flat(back)), (jloaded, junmapped, _flat(jparams))


@pytest.mark.parametrize("spelling", [
    "proj_PQ.{}", "head.CE.{}", "head_CU.{}", "headPC.{}"])
def test_loader_places_head_spellings_as_jax(spelling):
    """Each head spelling HEAD_KEY_HINTS accepts (fc1/dense1/0 and
    fc2/dense2/out/2 layer names, with and without separators and
    prefixes) lands where JAX puts it, with the same values."""
    template = _jax_template()
    d, hh = TINY["hidden_size"], 256
    rng = np.random.default_rng(2)
    names = {"proj_PQ.{}": ("0", "2"), "head.CE.{}": ("fc1", "fc2"),
             "head_CU.{}": ("dense1", "dense2"), "headPC.{}": ("0", "out")}
    first, last = names[spelling]
    axis = spelling.replace("proj_", "").replace("head", "").strip("._{}")
    sd = {"model." + spelling.format(first) + ".weight":
          rng.normal(size=(hh, d)).astype(np.float32),
          spelling.format(first) + ".bias":
          rng.normal(size=(hh,)).astype(np.float32),
          "module." + spelling.format(last) + ".weight":
          rng.normal(size=(1, hh)).astype(np.float32),
          spelling.format(last) + ".bias": np.ones((1,), np.float32),
          f"layer_weights.{axis}": rng.normal(size=(3,)).astype(np.float32)}
    (loaded, unmapped, got), (jloaded, junmapped, want) = _load_both(
        sd, template)
    assert loaded == jloaded and len(loaded) == 5
    assert unmapped == junmapped == []
    for path in want:
        if path.startswith(f"params/head_{axis}") or \
                path == f"params/layer_weights_{axis}":
            np.testing.assert_array_equal(got[path], want[path], path)


def test_loader_reports_unmapped_and_raises_on_shape():
    """A key no rule maps is reported (as JAX reports it), a key the model
    lacks (a layer-norm of conv 1 in group mode) too; ``masked_spec_embed``
    is dropped; a shape mismatch raises naming both shapes."""
    template = _jax_template()
    sd = {"totally.unknown.key": np.zeros((3, 3), np.float32),
          "feature_extractor.conv_layers.1.layer_norm.weight":
          np.ones((24,), np.float32),
          "masked_spec_embed": np.zeros((64,), np.float32),
          "wavlm.encoder.layers.1.attention.q_proj.bias":
          np.full((64,), 0.5, np.float32)}
    (loaded, unmapped, got), (jloaded, junmapped, want) = _load_both(
        sd, template)
    assert loaded == jloaded == ["encoder.layers.1.attention.q_proj.bias"]
    assert unmapped == junmapped == [
        "totally.unknown.key",
        "feature_extractor.conv_layers.1.layer_norm.weight"]
    np.testing.assert_array_equal(
        got["params/encoder/layer_1/attention/q_proj/bias"], 0.5)
    bad = {"encoder.layers.0.attention.q_proj.bias": np.zeros((7,),
                                                              np.float32)}
    with pytest.raises(ValueError, match=r"shape \(7,\) != \(64,\)"):
        ab.load_state_dict(ab.AudioboxAesthetics(CFG), bad)


@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
def test_weight_norm_spellings_compose_as_jax(spelling):
    """Both weight-norm spellings of the positional conv compose into JAX's
    kernel bit for bit; ``config_from_state_dict`` reads its geometry from
    either."""
    rng = np.random.default_rng(4)
    D, groups, k = TINY["hidden_size"], 4, TINY["num_conv_pos_embeddings"]
    v = rng.normal(size=(D, D // groups, k)).astype(np.float32)
    g = rng.normal(size=(1, 1, k)).astype(np.float32)
    base = "encoder.pos_conv_embed.conv"
    keys = ((f"{base}.parametrizations.weight.original0",
             f"{base}.parametrizations.weight.original1")
            if spelling == "parametrizations"
            else (f"{base}.weight_g", f"{base}.weight_v"))
    sd = {keys[0]: g, keys[1]: v}
    (loaded, unmapped, got), (jloaded, junmapped, want) = _load_both(
        sd, _jax_template())
    assert unmapped == junmapped == [] and loaded == jloaded == [
        f"{base}.weight"]
    np.testing.assert_array_equal(got["params/encoder/pos_conv_kernel"],
                                  want["params/encoder/pos_conv_kernel"])
    torch_sd = {key: torch.from_numpy(val) for key, val in sd.items()}
    model = ab.AudioboxAesthetics(CFG)
    ab.load_state_dict(model, torch_sd)
    np.testing.assert_array_equal(
        model.state_dict()["wavlm." + base + ".weight"].numpy(),
        want["params/encoder/pos_conv_kernel"])


@pytest.mark.parametrize("stable", [False, True], ids=["group", "layer"])
def test_config_from_state_dict_equals_jax(stable):
    """The geometry read from a checkpoint (HF's layout, group and layer
    norm; and the port's own full-predictor dict) equals JAX's reading."""
    kw = dict(TINY, do_stable_layer_norm=stable,
              feat_extract_norm="layer" if stable else "group")
    model = ab.AudioboxAesthetics(ab.AudioboxConfig(wavlm=WavLMConfig(**kw)))
    sd = model.state_dict()
    got = ab.config_from_state_dict(sd)
    want = jax_ab.config_from_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    for field in ("hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "conv_dim", "conv_kernel",
                  "conv_stride", "conv_bias", "feat_extract_norm",
                  "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
                  "num_buckets", "max_distance", "do_stable_layer_norm"):
        assert getattr(got.wavlm, field) == getattr(want.wavlm, field), field
    assert got.wavlm.feat_extract_norm == kw["feat_extract_norm"]
    assert got.head_hidden == want.head_hidden and got.axes == want.axes
    # pre- and post-norm share every parameter: the reading is post-norm
    assert got.wavlm == WavLMConfig(**dict(kw, do_stable_layer_norm=False,
                                           max_distance=800))


def test_load_torch_checkpoint_unwraps_containers(tmp_path):
    sd = ab.AudioboxAesthetics(CFG).state_dict()
    for wrap in ("state_dict", "model", "model_state_dict", None):
        path = str(tmp_path / f"{wrap}.pt")
        torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)
        got = ab.load_torch_checkpoint(path)
        want = jax_ab.load_torch_checkpoint(path)
        assert sorted(got) == sorted(want) == sorted(sd)
        assert all(torch.is_tensor(v) for v in got.values())
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("rate,shape", [
    (16_000, (20_000,)), (44_100, (44_100,)), (22_050, (30_001, 2)),
    (8_000, (2, 12_000)), (48_000, (0,)), (16_000, (5, 3))],
    ids=["16k", "44k1", "22k05-stereo", "8k-channels-first", "empty",
         "short-channels-last"])
def test_to_mono_16k_equals_jax(rate, shape):
    wave = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    got, want = ab._to_mono_16k(wave, rate), jax_ab._to_mono_16k(wave, rate)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_forward_keeps_the_process_tf32_settings():
    """The predictor's forward pins IEEE fp32 inside and leaves the
    process's settings as they were."""
    pred = ab.AesPredictor(CFG, batch=1, chunk_seconds=CHUNK, device="cpu")
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    try:
        seen = []
        hook = pred.model.register_forward_hook(lambda *a: seen.append(
            (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)))
        pred.score_wave(np.zeros(8000, np.float32))
        hook.remove()
        assert seen == [("highest", False)]
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 == before[1]
    finally:
        torch.set_float32_matmul_precision(before[0])


def test_predictor_on_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab.AesPredictor(CFG, chunk_seconds=CHUNK)


def _stub(calls, engine):
    class Stub:
        def __init__(self, config=None, weights=None, batch=8, **kw):
            calls.append((engine, weights, batch, kw.get("device")))

        def score_jsonl(self, inp, out):
            with open(out, "w") as f:
                f.write(json.dumps({a: 5.0 for a in AXES}) + "\n")
    return Stub


def test_run_aesthetics_precedence(tmp_path, monkeypatch):
    """audio-aes on PATH > the predictor over an existing checkpoint (on
    the caller's device) > the proxy; ``force_proxy`` wins over the
    weights and a name that is no file leaves the proxy, as in JAX."""
    calls = []
    monkeypatch.setattr(ab, "AesPredictor", _stub(calls, "port"))
    monkeypatch.setattr(jax_ab, "AesPredictor", _stub(calls, "jax"))
    ckpt = tmp_path / "w.pt"
    ckpt.write_bytes(b"stub")
    inp = tmp_path / "in.jsonl"
    inp.write_text(json.dumps({"path": "x.wav"}) + "\n")
    out = str(tmp_path / "out.jsonl")
    for mod in (aesthetics, jax_aes):
        monkeypatch.setattr(mod.shutil, "which", lambda _: None)
    monkeypatch.setenv("AUDIOBOX_WEIGHTS", str(ckpt))
    assert aesthetics.run_aesthetics(str(inp), out, 3, device="cpu") is True
    assert jax_aes.run_aesthetics(str(inp), out, 3) is True
    assert calls == [("port", str(ckpt), 3, "cpu"), ("jax", str(ckpt), 3,
                                                     None)]
    assert aesthetics.run_aesthetics(str(inp), out, force_proxy=True) is False
    assert _rows(out)[0]["proxy"] is True
    monkeypatch.delenv("AUDIOBOX_WEIGHTS")
    assert aesthetics.run_aesthetics(
        str(inp), out, weights=str(tmp_path / "missing")) is False
    # an audio-aes on PATH comes first
    binary = tmp_path / "audio-aes"
    binary.write_text("#!/bin/sh\necho '{\"CE\": 1}'\n")
    binary.chmod(0o755)
    monkeypatch.setattr(aesthetics.shutil, "which", lambda _: str(binary))
    assert aesthetics.run_aesthetics(str(inp), out, weights=str(ckpt),
                                     device="cpu") is True
    assert _rows(out) == [{"CE": 1}] and len(calls) == 2


def _tiny_checkpoint(path):
    model = ab.AudioboxAesthetics(CFG)
    ab.init_audiobox_weights(model, torch.Generator().manual_seed(1))
    torch.save({"state_dict": model.state_dict()}, path)
    return path


def _tiny_predictors(monkeypatch):
    """Both packages' predictors cut to 0.5-s chunks (their CLIs and
    ``run_aesthetics`` build them with the default 10 s)."""
    for mod in (ab, jax_ab):
        real = mod.AesPredictor

        def tiny(*args, _real=real, **kwargs):
            return _real(*args, **dict(kwargs, chunk_seconds=CHUNK))
        monkeypatch.setattr(mod, "AesPredictor", tiny)


def test_run_aesthetics_scores_with_the_predictor(tmp_path, monkeypatch,
                                                  wavs):
    """With ``$AUDIOBOX_WEIGHTS`` naming a checkpoint, ``run_aesthetics``
    no longer raises: it scores with the port's predictor (True), rows
    within 2e-4 of the JAX package's over the same file."""
    inp, _ = wavs
    _tiny_predictors(monkeypatch)
    for mod in (aesthetics, jax_aes):
        monkeypatch.setattr(mod.shutil, "which", lambda _: None)
    monkeypatch.setenv("AUDIOBOX_WEIGHTS",
                       _tiny_checkpoint(str(tmp_path / "w.pt")))
    got, want = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert aesthetics.run_aesthetics(inp, got, 2, device="cpu") is True
    assert jax_aes.run_aesthetics(inp, want, 2) is True
    _assert_rows_close(_rows(got)[:2], _rows(want)[:2])
    assert all(np.isnan(v) for v in _rows(got)[2].values())


def test_audio_aes_cli_exit_codes_and_rows(tmp_path, monkeypatch, capsys,
                                           wavs):
    """cli/audio_aes.py: JAX's exit codes (2 without weights unless
    --allow-random, 2 on a missing checkpoint, 2 on --batch-size < 1), one
    row per input line on stdout or --output, NaN for the missing file;
    over one checkpoint its rows within 2e-4 of the JAX CLI's; the default
    device is the card."""
    inp, _ = wavs
    _tiny_predictors(monkeypatch)
    monkeypatch.delenv("AUDIOBOX_WEIGHTS", raising=False)
    for argv in ([inp], [inp, "--ckpt", str(tmp_path / "none.pt")],
                 [inp, "--allow-random", "--batch-size", "0"]):
        assert audio_aes.main(argv + ["--device", "cpu"]) == 2
        assert jax_cli.main(argv) == 2
    capsys.readouterr()
    assert audio_aes.main([inp, "--batch-size", "2", "--allow-random",
                           "--device", "cpu"]) == 0
    rows = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 3 and set(rows[0]) == set(AXES)
    assert all(np.isfinite(v) for r in rows[:2] for v in r.values())
    assert all(np.isnan(v) for v in rows[2].values())

    ckpt = _tiny_checkpoint(str(tmp_path / "w.pt"))
    got, want = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert audio_aes.main([inp, "--ckpt", ckpt, "--batch-size", "2",
                           "--output", got, "--device", "cpu"]) == 0
    assert jax_cli.main([inp, "--ckpt", ckpt, "--batch-size", "2",
                         "--output", want]) == 0
    _assert_rows_close(_rows(got)[:2], _rows(want)[:2])
    assert all(np.isnan(v) for v in _rows(got)[2].values())
    assert os.path.getsize(got) > 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio_aes.main([inp, "--ckpt", ckpt])
