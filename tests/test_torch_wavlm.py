"""The port's WavLM encoder (``eval/wavlm.py``) against the JAX package's
and against ``transformers.WavLMModel``, on the CPU.

Weights cross from JAX as numpy through ``models/convert.py::
audiobox_state_dict_from_jax``, and from HF through the port's checkpoint
loader (``eval/audiobox.py::load_state_dict``). Every hidden state is held
within rtol 2e-4 and atol 2e-5, the bounds the JAX package holds its own
encoder to against HF (tests/test_audiobox.py); the bucket table bit for
bit. The geometry is tests/test_audiobox.py's TINY.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.eval import wavlm as jax_wavlm
from ai_music_generation_tpu_torch.eval import wavlm
from ai_music_generation_tpu_torch.eval.audiobox import load_state_dict
from ai_music_generation_tpu_torch.models.convert import (
    audiobox_state_dict_from_jax,
)

torch.set_num_threads(1)

TINY = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
    conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=32, max_distance=80,
)
VARIANTS = {"base-postnorm": False, "large-prenorm": True}
T = 2400  # samples: 119 frames
VALID = (T, 1400)  # the ragged row's valid samples


def _kw(stable):
    return dict(TINY, do_stable_layer_norm=stable,
                feat_extract_norm="layer" if stable else "group")


def _wave(seed=1, B=2):
    return np.random.default_rng(seed).normal(size=(B, T)).astype(np.float32)


def _frame_mask(cfg, valid=VALID):
    frames = cfg.frames_for_samples(T)
    nf = np.array([cfg.frames_for_samples(v) for v in valid])
    return (np.arange(frames)[None, :] < nf[:, None]).astype(np.float32), nf


@pytest.fixture(scope="module", params=list(VARIANTS), ids=list(VARIANTS))
def pair(request):
    """A JAX encoder with its params (numpy) and the port's on the same
    weights."""
    stable = VARIANTS[request.param]
    jcfg = jax_wavlm.WavLMConfig(**_kw(stable))
    enc = jax_wavlm.WavLMEncoder(jcfg)
    params = jax.tree_util.tree_map(np.asarray, enc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 400), jnp.float32)))
    cfg = wavlm.WavLMConfig(**_kw(stable))
    model = wavlm.WavLMEncoder(cfg).eval()
    model.load_state_dict(audiobox_state_dict_from_jax(params, cfg))
    return enc, params, model, cfg


@pytest.mark.parametrize("masked", [False, True], ids=["full", "ragged"])
def test_encoder_matches_jax(pair, masked):
    """Every hidden state of the port within rtol 2e-4, atol 2e-5 of JAX's,
    with and without a ragged frame mask."""
    enc, params, model, cfg = pair
    wave = _wave()
    wave[1, VALID[1]:] = 0.0
    mask = _frame_mask(cfg)[0] if masked else None
    j_last, j_hid = enc.apply(params, jnp.asarray(wave),
                              None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        last, hid = model(torch.from_numpy(wave),
                          None if mask is None else torch.from_numpy(mask))
    assert hid.shape == (cfg.num_layers + 1, 2, cfg.frames_for_samples(T),
                         cfg.hidden_size)
    for i in range(hid.shape[0]):
        np.testing.assert_allclose(hid[i].numpy(), np.asarray(j_hid[i]),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"hidden state {i}")
    np.testing.assert_allclose(last.numpy(), np.asarray(j_last),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("q_len,k_len,buckets,distance", [
    (499, 499, 320, 800), (2000, 2000, 320, 800), (7, 7, 320, 800),
    (119, 119, 32, 80), (160, 160, 32, 80), (1500, 1500, 32, 80),
    (5, 9, 32, 80),
], ids=["base-10s", "base-2000", "base-7", "tiny-119", "tiny-160",
        "tiny-1500", "tiny-rect"])
def test_bucket_table_equals_jax(q_len, k_len, buckets, distance):
    """The relative-position buckets equal JAX's bit for bit, at WavLM
    base's 10-s chunk (499 frames) and TINY's geometry."""
    got = wavlm.relative_position_buckets(q_len, k_len, buckets, distance)
    want = np.asarray(jax_wavlm.relative_position_buckets(
        q_len, k_len, buckets, distance))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_attention_caches_one_table_per_length():
    cfg = wavlm.WavLMConfig(**_kw(False))
    attn = wavlm.GatedRelPosAttention(cfg, has_relative_position_bias=True)
    first = attn.buckets(119)
    assert attn.buckets(119) is first
    assert attn.buckets(60).shape == (60, 60)
    assert torch.equal(first, wavlm.relative_position_buckets(
        119, 119, cfg.num_buckets, cfg.max_distance))


def test_frames_for_samples_equals_jax():
    for kw in (TINY, {}):
        got, want = wavlm.WavLMConfig(**kw), jax_wavlm.WavLMConfig(**kw)
        for n in (0, 160, 399, 400, 401, 8000, 59_200, 160_000):
            assert got.frames_for_samples(n) == want.frames_for_samples(n)
    assert wavlm.WavLMConfig().frames_for_samples(160_000) == 499


def test_init_follows_the_jax_distributions():
    """The seeded init draws JAX's distributions: truncated he/lecun
    normals within two of their std (Flax's fan-in rule), N(0, 0.02)
    buckets, the positional conv's std, norms 1 / 0, the gate constant 1;
    a seed repeats its weights."""
    cfg = wavlm.WavLMConfig(**dict(TINY, conv_dim=(64, 64, 64),
                                   hidden_size=128, intermediate_size=256))
    models = [wavlm.init_wavlm_weights(wavlm.WavLMEncoder(cfg),
                                       torch.Generator().manual_seed(s))
              for s in (0, 0, 1)]
    a, b, c = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layers.0.attention.q_proj.weight"],
                           c["encoder.layers.0.attention.q_proj.weight"])

    def std_of(fan_in, scale):
        return math.sqrt(scale / fan_in) / .87962566103423978

    checks = {
        "feature_extractor.conv_layers.1.conv.weight": std_of(64 * 64, 2.0),
        "feature_extractor.conv_layers.0.conv.weight": std_of(64, 2.0),
        "encoder.layers.1.feed_forward.intermediate_dense.weight":
            std_of(128, 1.0),
        "encoder.layers.0.attention.gru_rel_pos_linear.weight":
            std_of(cfg.head_dim, 1.0),
    }
    for key, std in checks.items():
        w = a[key]
        assert float(w.abs().max()) <= 2 * std
        # a normal truncated at 2 sigma has std 0.8796 sigma
        assert abs(float(w.std()) / (0.87962566 * std) - 1) < 0.15, key
    assert abs(float(a["encoder.layers.0.attention.rel_attn_embed.weight"]
                     .std()) / 0.02 - 1) < 0.25
    pos = a["encoder.pos_conv_embed.conv.weight"]
    assert abs(float(pos.std()) / (2 * math.sqrt(
        1 / (cfg.num_conv_pos_embeddings * cfg.hidden_size))) - 1) < 0.1
    for key, val in a.items():
        if key.endswith(("layer_norm.weight", "gru_rel_pos_const")):
            assert torch.equal(val, torch.ones_like(val)), key
        elif key.endswith("bias"):
            assert torch.equal(val, torch.zeros_like(val)), key


def test_bridge_takes_bare_and_full_trees_and_places_every_leaf(pair):
    """The bridge accepts a bare encoder tree (WavLMConfig) and the same
    tree under a full predictor's ``encoder/`` (keys under ``wavlm.``);
    a leaf it cannot place raises."""
    from ai_music_generation_tpu_torch.eval.audiobox import AudioboxConfig

    _, params, model, cfg = pair
    bare = audiobox_state_dict_from_jax(params, cfg)
    assert sorted(bare) == sorted(model.state_dict())
    stray = {"params": dict(params["params"], extra={"kernel": np.zeros(2)})}
    with pytest.raises(ValueError, match="extra/kernel"):
        audiobox_state_dict_from_jax(stray, cfg)
    full_cfg = AudioboxConfig(wavlm=cfg, axes=())
    full = audiobox_state_dict_from_jax({"params": {"encoder":
                                                    params["params"]}},
                                        full_cfg)
    assert sorted(full) == sorted("wavlm." + k for k in bare)


def _hf_model(stable):
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
        do_stable_layer_norm=stable,
        feat_extract_norm="layer" if stable else "group",
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0,
        mask_feature_prob=0.0, apply_spec_augment=False,
    )
    torch.manual_seed(0)
    return transformers.WavLMModel(cfg).eval()


def _port_from_hf(hf, stable):
    model = wavlm.WavLMEncoder(wavlm.WavLMConfig(**_kw(stable))).eval()
    loaded, unmapped = load_state_dict(model, hf.state_dict())
    assert unmapped == [], unmapped
    assert len(loaded) == len(model.state_dict())
    return model


@pytest.mark.parametrize("stable", list(VARIANTS.values()),
                         ids=list(VARIANTS))
def test_encoder_matches_hf(stable):
    """A random-init ``transformers.WavLMModel`` loaded through the port's
    checkpoint loader (its weight-norm positional conv composed): every
    hidden state within rtol 2e-4, atol 2e-5 of HF's."""
    hf = _hf_model(stable)
    model = _port_from_hf(hf, stable)
    wave = _wave(seed=4)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wave), output_hidden_states=True)
        last, hid = model(torch.from_numpy(wave))
    assert hid.shape[0] == len(ref.hidden_states)
    for i, h in enumerate(ref.hidden_states):
        np.testing.assert_allclose(hid[i].numpy(), h.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=f"hidden state {i}")
    np.testing.assert_allclose(last.numpy(), ref.last_hidden_state.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_encoder_matches_hf_with_padding_mask():
    """A ragged batch: the port zeroes padded frames and masks attention as
    HF's ``attention_mask`` does (valid frames compared; HF leaves padded
    frames unspecified), and the mask changes the masked row."""
    hf = _hf_model(False)
    model = _port_from_hf(hf, False)
    wave = _wave(seed=3)
    wave[1, VALID[1]:] = 0.0
    am = (np.arange(T)[None, :] < np.array(VALID)[:, None]).astype(np.int64)
    mask, nf = _frame_mask(model.config)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wave), attention_mask=torch.from_numpy(am),
                 output_hidden_states=True)
        last, _ = model(torch.from_numpy(wave), torch.from_numpy(mask))
        unmasked, _ = model(torch.from_numpy(wave))
    for b in range(2):
        np.testing.assert_allclose(
            last[b, :nf[b]].numpy(), ref.last_hidden_state[b, :nf[b]].numpy(),
            rtol=2e-4, atol=2e-5, err_msg=f"row {b}")
    assert not np.allclose(unmasked[1, :nf[1]].numpy(),
                           last[1, :nf[1]].numpy(), atol=1e-4)


def test_config_is_frozen_with_jax_defaults():
    got, want = wavlm.WavLMConfig(), jax_wavlm.WavLMConfig()
    fields = {f.name for f in dataclasses.fields(got)}
    assert fields == {f.name for f in dataclasses.fields(want)} - {"dtype"}
    assert all(getattr(got, f) == getattr(want, f) for f in fields)
    assert got.head_dim == 64
