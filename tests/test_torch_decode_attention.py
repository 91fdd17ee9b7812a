"""The port's valid-prefix decode attention (ai_music_generation_tpu_torch/
ops/decode_attention.py, K4) and the model's ``attn_impl="pallas"`` decode
path against the JAX package.

The same inputs, made with numpy from a seed, go through the port's plain
twin and the JAX ``decode_attention_reference`` and, at a small shape, the
Pallas kernel in interpret mode (as tests/test_decode_attention.py runs it).
Columns at and past ``length`` are poisoned with NaN: they must never reach
the output. The model tests put the JAX params into the port
(``state_dict_from_jax``) and compare logits and greedy tokens with the JAX
model and Generator at ``attn_impl="pallas"``, which reach the same kernel.
The CUDA kernel is held against the twin in tests/test_torch_cuda_kernels.py
(no JAX there: the machine with the card has none).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.decode.generate import Generator as JaxGenerator
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.gpt import KVCache as JaxKVCache
from ai_music_generation_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
)
from ai_music_generation_tpu.ops.decode_attention import (
    decode_attention_reference as jax_decode_attention_reference,
)
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.models import gpt as gpt_module
from ai_music_generation_tpu_torch.models.convert import (
    init_weights,
    state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig, KVCache
from ai_music_generation_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)

torch.set_num_threads(1)


def _inputs(B, H, S, D, length, seed=0, bf16=False):
    """q [B, HD], k/v [B, S, HD] in fp32 (values exact in bf16 with bf16),
    the columns from ``length`` on poisoned with NaN."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, H * D), (B, S, H * D), (B, S, H * D)))
    if bf16:
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in (q, k, v))
    k[:, length:] = np.nan
    v[:, length:] = np.nan
    return q, k, v


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("length", [1, 63, 64, 100, 256])
def test_twin_matches_jax_reference_fp32(length):
    """The JAX test's own shape and tolerance (tests/test_decode_attention.py
    :17-31): fp32 differs only by summation order."""
    B, H, S, D = 4, 2, 256, 64
    q, k, v = _inputs(B, H, S, D, length)
    want = jax_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        n_head=H)
    before = decode_attention.launches
    got = decode_attention(*_torch((q, k, v)),
                           torch.tensor(length, dtype=torch.int32), n_head=H)
    assert decode_attention.launches == before  # no kernel on the CPU
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("length", [1, 77, 128])
def test_twin_matches_jax_reference_bf16(length):
    """bf16: both sides run the same op chain and round at the same places
    (the scores einsum's output, the scaled scores, the probabilities, the
    PV einsum's output), but XLA's and torch's CPU dots accumulate in other
    orders, so a rounded bf16 score or probability may land one ulp (2^-8
    relative) apart; through softmax and PV that stays within a few bf16
    ulps of the output: 2^-6 of its range."""
    B, H, S, D = 2, 6, 128, 64
    q, k, v = _inputs(B, H, S, D, length, seed=1, bf16=True)
    want = np.asarray(jax_decode_attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.int32(length), n_head=H).astype(jnp.float32))
    got = decode_attention_reference(*_torch((q, k, v), torch.bfloat16),
                                     length, n_head=H)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert np.isfinite(want).all() and err <= 2.0 ** -6 * np.abs(want).max()


@pytest.mark.parametrize("length", [1, 64, 100, 128, 300])
def test_twin_matches_pallas_interpret(length):
    """Against the Pallas kernel itself (interpret mode): the kernel skips
    whole 64-column chunks past ``length``; a length past S reads all S."""
    B, H, S, D = 3, 2, 128, 64
    q, k, v = _inputs(B, H, S, D, min(length, S), seed=2)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.int32(length), n_head=H,
                                interpret=True)
    got = decode_attention(*_torch((q, k, v)), length, n_head=H)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_length_zero_reads_column_zero():
    """``max(length, 1)``: a zero or negative length still reads column 0,
    as the JAX reference and kernel clamp it."""
    q, k, v = _torch(_inputs(2, 2, 16, 16, 1, seed=3))
    want = decode_attention_reference(q, k, v, 1, n_head=2)
    for length in (0, -3):
        torch.testing.assert_close(
            decode_attention(q, k, v, torch.tensor(length, dtype=torch.int32),
                             n_head=2), want, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    q, k, v = (t.to("meta") for t in _torch(_inputs(2, 2, 16, 16, 4)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(q, k, v, torch.zeros((), dtype=torch.int32,
                                               device="meta"), n_head=2)


# ---- the model's attn_impl="pallas" decode path against the JAX model

COMMON = dict(block_size=32, vocab_size=96, n_layer=2, n_head=6, n_embd=384,
              dropout=0.0, attn_impl="pallas")


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig(**COMMON, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((2, 8), jnp.int32)))
    cfg = GPTConfig(**COMMON, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, params, model.eval()


def test_pallas_model_matches_jax(models):
    """Prefill 8 tokens, then 8 T=1 steps (K4 on both sides; JAX's kernel in
    interpret mode): fp32 logits agree to 1e-4 (accumulation order only),
    and the port's cache holds JAX's [B, S, H, D] cache in its flat
    layout."""
    jmodel, params, model = models
    step = jax.jit(lambda p, x, c: jmodel.apply(p, x, cache=c))
    idx = np.random.default_rng(4).integers(0, 96, (3, 16)).astype(np.int32)
    jcache = JaxKVCache.create(jmodel.config, 3)
    cache = KVCache.create(model.config, 3, device="cpu")
    for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 16)]:
        want, _, jcache = step(params, idx[:, lo:hi], jcache)
        with torch.no_grad():
            got, cache = model(torch.from_numpy(idx[:, lo:hi]), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    assert int(cache.length) == int(jcache.length) == 16
    np.testing.assert_allclose(
        cache.k[1].numpy(), np.asarray(jcache.k[1]).reshape(3, 32, 384),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("window", [None, 16])
def test_pallas_greedy_tokens_equal_jax(models, window):
    """Greedy fp32 decoding with attn_impl="pallas" emits the JAX
    Generator's tokens, across windowed refreshes."""
    jmodel, params, model = models
    prompts = np.random.default_rng(5).integers(0, 96, (4, 8)).astype(
        np.int32)
    kw = dict(max_new_tokens=40, temperature=0.0, top_k=None, window=window)
    want = np.asarray(JaxGenerator(jmodel, **kw).generate(params, prompts))
    got = Generator(model, **kw).generate(prompts)
    np.testing.assert_array_equal(got.numpy(), want)


DISPATCH = {
    # (config overrides, T=1 op the JAX model runs: "k4" or "k1")
    "pallas-mha-bf16": (dict(), "k4"),
    "pallas-flat": (dict(flat_kv=True), "k1"),
    "pallas-int8": (dict(kv_quantized=True), "k1"),
    "pallas-gqa": (dict(n_kv_head=2), "k1"),
    "xla-mha-bf16": (dict(attn_impl="xla"), "k1"),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_decode_dispatch_follows_jax(monkeypatch, name):
    """A spy on both ops: each T=1 step runs K4 or K1 once per layer, as the
    JAX model's branches would (gpt.py:590 flat first, then :724 K4 for
    attn_impl="pallas" with MHA and no scales), and the prefill neither.
    The K4 step's column write leaves the cache K1's twin leaves."""
    overrides, op = DISPATCH[name]
    calls = {"k4": 0, "k1": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    cfg = GPTConfig(**{**COMMON, "block_size": 16, "n_layer": 3, **overrides})
    model = init_weights(GPT(cfg, device="cpu"),
                         torch.Generator().manual_seed(0)).eval()
    monkeypatch.setattr(gpt_module, "decode_attention",
                        spy("k4", gpt_module.decode_attention))
    monkeypatch.setattr(gpt_module, "gqa_decode_update",
                        spy("k1", gpt_module.gqa_decode_update))
    idx = torch.randint(0, 96, (2, 8), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    cache = KVCache.create(cfg, 2, device="cpu")
    with torch.no_grad():
        model(idx[:, :4], cache=cache)
        assert calls == {"k4": 0, "k1": 0}
        for t in range(4, 8):
            model(idx[:, t:t + 1], cache=cache)
    assert calls[op] == cfg.n_layer * 4
    assert calls["k4" if op == "k1" else "k1"] == 0
    if name == "pallas-mha-bf16":
        # the same weights through K1's twin: the same cache bits
        xla = GPT(dataclasses.replace(cfg, attn_impl="xla"), device="cpu")
        xla.load_state_dict(model.state_dict())
        ref = KVCache.create(cfg, 2, device="cpu")
        with torch.no_grad():
            xla(idx[:, :4], cache=ref)
            for t in range(4, 8):
                xla(idx[:, t:t + 1], cache=ref)
        for a, b in zip(cache.k + cache.v, ref.k + ref.v):
            assert torch.equal(a, b)
