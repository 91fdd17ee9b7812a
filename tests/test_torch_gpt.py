"""The port's GPT (ai_music_generation_tpu_torch/models/gpt.py) against the
JAX package's, on the same weights.

Config: the tests/test_gqa_flat.py model (block 32, vocab 96, 2 layers,
6 heads, 384 wide) with KH=2, plus MHA (KH=6, so KH*D = 384 is a multiple
of 128 and the JAX flat cache accepts it). JAX params go through
``state_dict_from_jax``; token ids are made with numpy from a seed.

Tolerances: fp32 differs only by accumulation order (XLA vs torch CPU
kernels), so logits agree to 1e-4. bf16 rounds at other places in the two
frameworks (inside the tanh GELU, the matmul accumulators), so each logit
may differ by a few bf16 ulps: allowed 2^-5 of the largest logit, i.e.
4 ulps of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.gpt import KVCache as JaxKVCache
from ai_music_generation_tpu.models.gpt import num_params as jax_num_params
from ai_music_generation_tpu.models.nanogpt_ckpt import (
    nanogpt_state_from_params,
)
from ai_music_generation_tpu_torch.models.convert import (
    init_weights,
    state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig, KVCache

torch.set_num_threads(1)

KV_HEADS = {"kh2": 2, "mha": None}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(kh, dtype="bf16", **kw):
    jd, td = DTYPES[dtype]
    common = dict(block_size=32, vocab_size=96, n_layer=2, n_head=6,
                  n_embd=384, n_kv_head=KV_HEADS[kh], dropout=0.0)
    return (JaxGPTConfig(**common, dtype=jd, **kw),
            GPTConfig(**common, dtype=td, **kw))


@pytest.fixture(scope="module", params=list(KV_HEADS))
def jax_params(request):
    jcfg, _ = _configs(request.param)
    params = JaxGPT(jcfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((2, 8), jnp.int32))
    return request.param, jax.device_get(params)


def _port(kh, params, dtype="bf16"):
    _, cfg = _configs(kh, dtype)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model.eval()


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 96, shape).astype(np.int32)


def _assert_logits_close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-4 if dtype == "fp32" else 2.0 ** -5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def test_state_dict_matches_nanogpt_export(jax_params):
    kh, params = jax_params
    jcfg, cfg = _configs(kh)
    want = nanogpt_state_from_params(params, jcfg)
    got = state_dict_from_jax(params, cfg)
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    assert got["lm_head.weight"] is got["transformer.wte.weight"]
    # the names are the port's own module names (strict load)
    GPT(cfg, device="cpu").load_state_dict(got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_full_forward_matches_jax(jax_params, dtype):
    kh, params = jax_params
    jcfg, _ = _configs(kh, dtype)
    idx = _ids((3, 32))
    want, _, _ = jax.jit(lambda p, x: JaxGPT(jcfg).apply(
        p, x, return_all_logits=True))(params, idx)
    with torch.no_grad():
        got, _ = _port(kh, params, dtype)(torch.from_numpy(idx),
                                          return_all_logits=True)
    _assert_logits_close(got, want, dtype)
    # inference fast path: the last position only
    with torch.no_grad():
        last, _ = _port(kh, params, dtype)(torch.from_numpy(idx))
    _assert_logits_close(last, want[:, -1:], dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
def test_cached_decode_matches_jax(jax_params, quant):
    """Prefill 8 tokens, then 8 cached T=1 steps (the decode op): bf16
    logits match the JAX flat-cache model step by step."""
    kh, params = jax_params
    jcfg, cfg = _configs(kh, kv_quantized=quant, flat_kv=True)
    jmodel = JaxGPT(jcfg)
    step = jax.jit(lambda p, x, c: jmodel.apply(p, x, cache=c))
    model = _port(kh, params)
    idx = _ids((3, 16), seed=1)
    jcache = JaxKVCache.create(jcfg, 3)
    cache = KVCache.create(cfg, 3, device="cpu")
    for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 16)]:
        want, _, jcache = step(params, idx[:, lo:hi], jcache)
        with torch.no_grad():
            got, cache = model(torch.from_numpy(idx[:, lo:hi]), cache=cache)
        _assert_logits_close(got, want, "bf16")
    assert int(cache.length) == 16
    assert cache.k[0].dtype == (torch.int8 if quant else torch.bfloat16)


def test_cached_decode_matches_own_full_forward(jax_params):
    """Incremental decode reproduces full-context logits (mirror of
    tests/test_gpt.py::test_kv_cache_matches_full_forward, fp32)."""
    kh, params = jax_params
    model = _port(kh, params, "fp32")
    idx = torch.from_numpy(_ids((2, 10), seed=2))
    with torch.no_grad():
        full, _ = model(idx)
        cache = KVCache.create(model.config, 2, device="cpu")
        assert cache.k[0].dtype == torch.float32
        logits, cache = model(idx[:, :6], cache=cache)
        for t in range(6, 10):
            logits, cache = model(idx[:, t:t + 1], cache=cache)
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
    assert int(cache.length) == 10


def test_kv_cache_defaults_to_the_card(monkeypatch):
    """With no device, KVCache.create allocates on the card (the JAX cache
    lands on the accelerator); with no card it raises, never falling back
    to the CPU."""
    _, cfg = _configs("kh2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(dataclasses.replace(cfg, n_kv_head=None), 2, spec=True)
    cache = KVCache.create(cfg, 2, device="cpu")
    assert all(t.device.type == "cpu" for t in cache.k + cache.v)
    assert cache.length.device.type == "cpu"


def test_num_params_matches_jax(jax_params):
    kh, params = jax_params
    model = _port(kh, params)
    for non_embedding in (True, False):
        assert model.num_params(non_embedding) == jax_num_params(
            params, non_embedding)


def test_crop_block_size_and_length_check():
    _, cfg = _configs("kh2")
    model = init_weights(GPT(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="exceeds block_size"):
        model(torch.zeros((1, 33), dtype=torch.int32))
    model.crop_block_size(16)
    assert model.config.block_size == 16
    assert model.transformer.wpe.weight.shape == (16, 384)
    with torch.no_grad():
        logits, _ = model(torch.zeros((1, 16), dtype=torch.int32))
    assert logits.shape == (1, 1, 96)
    with pytest.raises(ValueError, match="exceeds block_size"):
        model(torch.zeros((1, 17), dtype=torch.int32))


def test_init_weights_follows_jax_scheme():
    _, cfg = _configs("kh2", bias=True)
    model = GPT(cfg, device="cpu")
    a = init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in a.state_dict().items()}
    b = init_weights(GPT(cfg, device="cpu"),
                     torch.Generator().manual_seed(0))
    for k, v in b.state_dict().items():  # seeded: reproducible
        assert torch.equal(v, sd[k]), k
    h0 = model.transformer.h[0]
    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    assert abs(h0.attn.c_attn.weight.std().item() - 0.02) < 2e-3
    assert abs(h0.attn.c_proj.weight.std().item() - proj_std) < 2e-3
    assert abs(h0.mlp.c_proj.weight.std().item() - proj_std) < 2e-3
    assert torch.equal(h0.ln_1.weight, torch.ones(384))
    assert torch.equal(h0.attn.c_attn.bias, torch.zeros(384 + 2 * 128))
    assert model.lm_head.weight is model.transformer.wte.weight


def test_refuses_unported_features():
    for kw in ({"n_expert": 4}, {"seq_axis": "seq"}):
        with pytest.raises(NotImplementedError):
            GPT(dataclasses.replace(_configs("kh2")[1], **kw), device="cpu")
