"""The port's TunesFormer (models/tunesformer.py, tunesformer_import.py,
tunesformer_export.py, convert.py) against the JAX package's, on the same
weights.

Config: the JAX tests' ``TINY_CFG`` (patch_length 16, patch_size 16, 2+2
layers, 32 wide, 2 heads), with and without ``share_weights``. JAX init
weights cross through ``tunesformer_state_dict_from_jax``; inputs come from
a numpy seed. Tolerances: fp32 forwards within 1e-5 of the output's range
(XLA and torch's CPU kernels sum in other orders); bf16 within 2^-6 (both
round every op to bf16, in other orders). Checkpoints round trip bit for
bit: ``weights.pth`` files hold the fp32 parameters.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import KVCache as JaxKVCache
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormer as JaxTunesFormer,
)
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormerConfig as JaxConfig,
)
from ai_music_generation_tpu.models import tunesformer_export as jax_export
from ai_music_generation_tpu.models import tunesformer_import as jax_import
from ai_music_generation_tpu_torch.models.convert import (
    init_tunesformer_weights,
    tunesformer_state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.gpt import KVCache
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
    load_tunesformer,
)
from ai_music_generation_tpu_torch.models.tunesformer_export import (
    save_reference_checkpoint,
    tunesformer_state_from_port,
)
from ai_music_generation_tpu_torch.models.tunesformer_import import (
    config_from_reference_state,
    load_reference_checkpoint,
    port_state_from_reference,
)

torch.set_num_threads(1)

TINY = dict(patch_length=16, patch_size=16, patch_layers=2, char_layers=2,
            n_embd=32, n_head=2, dropout=0.0)
FP32_FRAC, BF16_FRAC = 1e-5, 2.0 ** -6


def _pair(share=False, dtype="float32"):
    """(JAX model, params (numpy), port model) at ``dtype``."""
    jcfg = JaxConfig(**TINY, share_weights=share, dtype=getattr(jnp, dtype))
    jmodel = JaxTunesFormer(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16, 16), jnp.int32)))
    cfg = TunesFormerConfig(**TINY, share_weights=share,
                            dtype=getattr(torch, dtype))
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(params, cfg))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["split", "shared"])
def pair(request):
    return _pair(request.param)


def _patches(B=2, P=16, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (B, P, S)).astype(
        np.int32)


def _close(got, want, frac):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got.astype(np.float32) - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


@torch.inference_mode()
def test_encode_patches_equals_jax(pair):
    jmodel, params, model = pair
    x = _patches()
    want = jmodel.apply(params, jnp.asarray(x), method=jmodel.encode_patches)
    _close(model.encode_patches(torch.from_numpy(x)), want, FP32_FRAC)


@torch.inference_mode()
def test_patch_steps_after_a_cached_prefill_equal_jax(pair):
    """``encode_patches_cached`` over 5 patches, then 6 ``patch_step`` s:
    every step's hidden state equals JAX's and the full forward's."""
    jmodel, params, model = pair
    x = _patches(seed=1)
    jcache = JaxKVCache.create(jmodel.config.patch_core_config(), 2,
                               max_len=16, quantized=False)
    _, jcache = jmodel.apply(params, jnp.asarray(x[:, :5]), jcache,
                             method=jmodel.encode_patches_cached)
    cache = KVCache.create(model.config.patch_core_config(), 2, max_len=16,
                           device="cpu")
    hidden, _ = model.encode_patches_cached(torch.from_numpy(x[:, :5]), cache)
    full = model.encode_patches(torch.from_numpy(x))
    _close(hidden, full[:, :5], FP32_FRAC)
    for i in range(5, 11):
        want, jcache = jmodel.apply(params, jnp.asarray(x[:, i]), jcache,
                                    method=jmodel.patch_step)
        got, _ = model.patch_step(torch.from_numpy(x[:, i]), cache)
        _close(got, want, FP32_FRAC)
        _close(got, full[:, i], FP32_FRAC)
    assert int(cache.length) == 11


@torch.inference_mode()
def test_char_logits_and_char_steps_equal_jax(pair):
    """``char_logits`` (the encoded patch at position 0, the tied head) and
    a 16-position ``char_step`` sequence equal JAX's; each step equals the
    full forward's position."""
    jmodel, params, model = pair
    x = _patches(seed=2)
    enc = np.array(jmodel.apply(params, jnp.asarray(x),
                                method=jmodel.encode_patches))[:, 3]
    toks = x[:, 4]
    want = jmodel.apply(params, jnp.asarray(enc), jnp.asarray(toks),
                        method=jmodel.char_logits)
    full = model.char_logits(torch.from_numpy(enc), torch.from_numpy(toks))
    _close(full, want, FP32_FRAC)
    jcache = JaxKVCache.create(jmodel.config.char_core_config(), 2,
                               max_len=16, quantized=False)
    cache = KVCache.create(model.config.char_core_config(), 2, max_len=16,
                           device="cpu")
    for j in range(16):
        jl, jcache = jmodel.apply(params, jnp.asarray(enc),
                                  jnp.asarray(toks[:, j]), jcache,
                                  method=jmodel.char_step)
        got, _ = model.char_step(torch.from_numpy(enc),
                                 torch.from_numpy(toks[:, j]), cache)
        _close(got, jl, FP32_FRAC)
        _close(got, full[:, j], FP32_FRAC)


@pytest.mark.parametrize("subset", [False, True], ids=["all", "indices"])
@torch.inference_mode()
def test_loss_equals_jax(pair, subset):
    """The eval-mode loss (pad chars ignored; ``patch_indices`` selecting
    the conditioning rows) equals JAX's."""
    jmodel, params, model = pair
    x = _patches(seed=3)
    x[:, :, 10:] = 0  # pads: ignored labels
    x[1, 12:] = 0  # whole padded patches
    idx = np.asarray([[0, 3, 7], [1, 2, 13]], np.int32) if subset else None
    want = float(jmodel.apply(params, jnp.asarray(x), True,
                              None if idx is None else jnp.asarray(idx)))
    got = float(model(torch.from_numpy(x),
                      None if idx is None else torch.from_numpy(idx)))
    assert abs(got - want) <= FP32_FRAC * abs(want)


@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
@torch.inference_mode()
def test_bf16_forwards_within_the_bf16_yardstick(share):
    """At bf16 compute (fp32 parameters) the encoder, a cached patch step
    and the char logits stay within 2^-6 of the range of JAX's."""
    jmodel, params, model = _pair(share, "bfloat16")
    x = _patches(seed=4)
    want = jmodel.apply(params, jnp.asarray(x), method=jmodel.encode_patches)
    got = model.encode_patches(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_FRAC)
    jcache = JaxKVCache.create(jmodel.config.patch_core_config(), 2,
                               max_len=16, quantized=False)
    _, jcache = jmodel.apply(params, jnp.asarray(x[:, :6]), jcache,
                             method=jmodel.encode_patches_cached)
    cache = KVCache.create(model.config.patch_core_config(), 2, max_len=16,
                           device="cpu")
    model.encode_patches_cached(torch.from_numpy(x[:, :6]), cache)
    jh, _ = jmodel.apply(params, jnp.asarray(x[:, 6]), jcache,
                         method=jmodel.patch_step)
    h, _ = model.patch_step(torch.from_numpy(x[:, 6]), cache)
    _close(h, np.asarray(jh, np.float32), BF16_FRAC)
    enc = np.asarray(want, np.float32)[:, 2]
    jl = jmodel.apply(params, jnp.asarray(enc, jnp.bfloat16),
                      jnp.asarray(x[:, 3]), method=jmodel.char_logits)
    got = model.char_logits(torch.from_numpy(enc).to(torch.bfloat16),
                            torch.from_numpy(x[:, 3]))
    _close(got, np.asarray(jl, np.float32), BF16_FRAC)


@torch.inference_mode()
def test_patch_embedding_is_the_gather_sum_at_fp32():
    """The gather-sum (32 rows per patch, the reference widths'
    patch_size) equals JAX's at fp32 to its last bits: within 1e-6 of the
    range, a few ulps (XLA's CPU code fuses the gather into the reduction
    and adds 8 interleaved partial sums, torch another order, so the bits
    are not equal); and it equals the reference's one-hot product within
    fp32 rounding."""
    cfg = dict(TINY, patch_size=32, n_embd=64)
    jmodel = JaxTunesFormer(JaxConfig(**cfg, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 16, 32), jnp.int32)))
    tcfg = TunesFormerConfig(**cfg, dtype=torch.float32)
    model = TunesFormer(tcfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(params, tcfg))
    x = _patches(2, 5, 32, seed=5)
    want = jmodel.apply(
        params, jnp.asarray(x),
        method=lambda m, p: m.patch_embedding(p))
    got = model.patch_embedding(torch.from_numpy(x))
    _close(got, want, 1e-6)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(x).long(), 128)
    ref = onehot.reshape(2, 5, -1).float() @ model.patch_embedding.weight \
        + model.patch_embedding.bias
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_share_weights_registers_one_core():
    model = TunesFormer(TunesFormerConfig(**TINY, share_weights=True),
                        device="cpu")
    assert model.patch_core is model.char_core is model.core
    keys = model.state_dict().keys()
    assert any(k.startswith("core.") for k in keys)
    assert not any(k.startswith(("patch_core.", "char_core.")) for k in keys)


def test_tunesformer_without_a_card_raises_naming_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TunesFormer(TunesFormerConfig(**TINY))


@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_init_weights_follow_the_jax_scheme(share):
    """``init_tunesformer_weights``: the same statistics as the JAX init
    (N(0, 0.02) tables and projections, residual projections at
    0.02/sqrt(2 n_layer) of their core, zero biases, unit LayerNorms)."""
    cfg = TunesFormerConfig(**dict(TINY, n_embd=256, n_head=4),
                            share_weights=share)
    model = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                     torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert float(sd["patch_embedding.weight"].std()) == pytest.approx(
        0.02, rel=0.02)
    assert not sd["patch_embedding.bias"].any()
    for prefix, n_layer in (("core.", 2),) if share else (
            ("patch_core.", 2), ("char_core.", 2)):
        proj = sd[prefix + "h.0.mlp.c_proj.weight"]
        assert float(proj.std()) == pytest.approx(
            0.02 / (2 * n_layer) ** 0.5, rel=0.05)
        assert torch.equal(sd[prefix + "h.1.ln_2.weight"],
                           torch.ones(256))
        assert not sd[prefix + "h.1.attn.c_attn.bias"].any()


# -- weights.pth: the reference format, both directions -----------------------

@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_jax_weights_pth_loads_into_the_port(share, tmp_path):
    """A weights.pth written by the JAX package's save_reference_checkpoint
    loads into the port (load_reference_checkpoint) with the JAX params bit
    for bit and JAX's encodings."""
    jmodel, params, model = _pair(share)
    path = str(tmp_path / "weights.pth")
    jax_export.save_reference_checkpoint(path, params, jmodel.config)
    sd = load_reference_checkpoint(path, model.config)
    want = tunesformer_state_dict_from_jax(params, model.config)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    loaded = TunesFormer(model.config, device="cpu")
    loaded.load_state_dict(sd)
    x = _patches(seed=6)
    enc = jmodel.apply(params, jnp.asarray(x), method=jmodel.encode_patches)
    with torch.inference_mode():
        _close(loaded.encode_patches(torch.from_numpy(x)), enc, FP32_FRAC)


@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_port_weights_pth_loads_into_jax_bit_equal(share, tmp_path):
    """The port's save_reference_checkpoint writes a weights.pth that the
    JAX package's load_reference_checkpoint reads back to the original
    params bit for bit, with the JAX export's keys and arrays (the tied
    head, the aliased shared core, the zero patch wte) and the reference's
    training-state keys; the port reads its own file back bit for bit."""
    jmodel, params, model = _pair(share)
    path = str(tmp_path / "weights.pth")
    save_reference_checkpoint(path, model, epoch=3, min_eval_loss=1.5)
    back = jax.device_get(jax_import.load_reference_checkpoint(
        path, jmodel.config))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for keypath, value in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[keypath]),
                                      np.asarray(value))
    ckpt = torch.load(path, weights_only=False)
    assert {"model", "optimizer", "lr_sched", "epoch", "best_epoch",
            "min_eval_loss"} <= set(ckpt)
    assert ckpt["epoch"] == 3 and ckpt["min_eval_loss"] == 1.5
    sd = ckpt["model"]
    assert sd["char_level_decoder.base.lm_head.weight"] is \
        sd["char_level_decoder.base.transformer.wte.weight"]
    want = jax_export.tunesformer_state_from_params(params, jmodel.config)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    mine = load_reference_checkpoint(path, model.config)
    for k, v in model.state_dict().items():
        assert torch.equal(mine[k], v), k


def test_load_tunesformer_reads_a_reference_directory(tmp_path):
    """``load_tunesformer(dir)`` builds the model from ``dir/weights.pth``
    alone (the architecture from the shapes; patch_length and n_head at the
    reference's 128 and 12), as the JAX package's auto-import does, with
    every parameter bit for bit and the checkpoint's meta."""
    cfg = dict(patch_length=128, patch_size=8, patch_layers=1,
               char_layers=1, n_embd=48, n_head=12, dropout=0.0)
    jcfg = JaxConfig(**cfg, dtype=jnp.float32)
    params = jax.device_get(JaxTunesFormer(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 128, 8), jnp.int32)))
    jax_export.save_reference_checkpoint(str(tmp_path / "weights.pth"),
                                         params, jcfg, epoch=7)
    model, meta = load_tunesformer(str(tmp_path), dtype=torch.float32,
                                   device="cpu")
    assert model.config == TunesFormerConfig(**cfg, dtype=torch.float32)
    assert meta["iter_num"] == 7 and meta["model_args"]["n_head"] == 12
    want = tunesformer_state_dict_from_jax(params, model.config)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_reference_hf_forward_equals_the_port():
    """The reference architecture built from transformers' GPT2 modules
    (tests/test_tunesformer_import.py's replica): its state dict imported
    into the port gives the replica's char logits."""
    import test_tunesformer_import as ref_mod

    torch.manual_seed(0)
    ref = ref_mod.TorchTunesFormer().eval()
    rng = np.random.default_rng(0)
    P, S = ref_mod.P_LEN, ref_mod.P_SIZE
    patches = rng.integers(3, 120, size=(1, P, S)).astype(np.int64)
    patches[0, :, 0] = 1
    with torch.no_grad():
        enc = ref.patch_level_decoder(
            torch.tensor(patches)).last_hidden_state.squeeze(0)
        want = ref.char_level_decoder(enc[:-1],
                                      torch.tensor(patches[0, 1:]))
    state = dict(ref.state_dict())
    cfg = dataclasses.replace(
        config_from_reference_state(state, patch_length=P,
                                    n_head=ref_mod.N_HEAD,
                                    dtype=torch.float32), dropout=0.0)
    assert (cfg.patch_size, cfg.patch_layers, cfg.char_layers, cfg.n_embd,
            cfg.share_weights) == (S, ref_mod.PATCH_LAYERS,
                                   ref_mod.CHAR_LAYERS, ref_mod.N_EMBD, False)
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(port_state_from_reference(state, cfg))
    with torch.inference_mode():
        x = torch.from_numpy(patches.astype(np.int32))
        got = model.char_logits(model.encode_patches(x)[0, :-1], x[0, 1:])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_export_import_round_trip_and_config_inference():
    """The port's state out to the reference layout and back is the
    identity, and the reference state's shapes give back the config."""
    for share in (False, True):
        cfg = TunesFormerConfig(**dict(TINY, patch_layers=3),
                                share_weights=share, dtype=torch.float32)
        model = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                         torch.Generator().manual_seed(2))
        state = tunesformer_state_from_port(model)
        inferred = config_from_reference_state(state, patch_length=16,
                                               n_head=2,
                                               dtype=torch.float32)
        want = dataclasses.replace(cfg, dropout=inferred.dropout)
        if share:  # a shared state carries max(layers) under both prefixes
            want = dataclasses.replace(want, char_layers=3)
        assert inferred == want
        back = port_state_from_reference(state, cfg)
        for k, v in model.state_dict().items():
            assert torch.equal(back[k], v), k


def test_mismatched_and_orbax_checkpoints_raise(tmp_path):
    _, _, model = _pair()
    save_reference_checkpoint(str(tmp_path / "weights.pth"), model)
    deeper = dataclasses.replace(model.config, patch_layers=3)
    with pytest.raises(ValueError, match="patch_layers: configured 3"):
        load_reference_checkpoint(str(tmp_path / "weights.pth"), deeper)
    orbax = tmp_path / "orbax"
    os.makedirs(orbax / "weights")
    with pytest.raises(FileNotFoundError,
                       match="convert_ckpt tunesformer to-torch"):
        load_tunesformer(str(orbax), device="cpu")
    with pytest.raises(FileNotFoundError, match="no TunesFormer checkpoint"):
        load_tunesformer(str(tmp_path / "missing"), device="cpu")
