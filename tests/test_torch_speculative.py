"""The port's speculative decoding (ai_music_generation_tpu_torch/decode/
speculative.py and the spec mode of models/gpt.py) against the JAX package.

On a tiny MHA model (block 64, vocab 32, 2 layers, 2 heads, 32 wide) with
the JAX params carried over by ``state_dict_from_jax``:

- the spec-mode model, step by step (prefill, verify steps with scripted
  rejections, a refresh): logits within the model tests' tolerances
  (fp32 1e-4, bf16 2^-5 of the range), the cache bookkeeping (``col_pos``, ``length``,
  ``cursor``) equal, int8 caches and scales bit-exact in fp32 and float
  caches within fp32 accumulation-order noise;
- ``prompt_lookup_drafts`` bit-exact on random buffers;
- greedy fp32 ``SpecGenerator``: tokens and ``n_steps`` identical to the
  JAX ``SpecGenerator`` (ragged prompts, inside one window and across
  refreshes, ``n_draft`` 1 and 4, int8 and float caches), and equal to the
  port's own ``Generator`` inside one window;
- sampled decoding holds the port's own contract: the committed token's
  marginal is the temperature/top-k distribution (TV < 0.06 at B=4096),
  the same seed gives the same tokens, prompts are kept.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.decode.speculative import (
    SpecGenerator as JaxSpecGenerator,
)
from ai_music_generation_tpu.decode.speculative import (
    prompt_lookup_drafts as jax_prompt_lookup_drafts,
)
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.gpt import KVCache as JaxKVCache
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.decode.speculative import (
    SpecGenerator,
    keep_committed,
    prompt_lookup_drafts,
    reset_spec_cache,
)
from ai_music_generation_tpu_torch.models.convert import state_dict_from_jax
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig, KVCache

torch.set_num_threads(1)

COMMON = dict(block_size=64, vocab_size=32, n_layer=2, n_head=2, n_embd=32,
              dropout=0.0, bias=False)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
INVALID = KVCache.INVALID_POS


@pytest.fixture(scope="module")
def params():
    jmodel = JaxGPT(JaxGPTConfig(**COMMON, dtype=jnp.float32))
    return jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


def _models(params, dtype="fp32", **kw):
    jd, td = DTYPES[dtype]
    jmodel = JaxGPT(JaxGPTConfig(**COMMON, dtype=jd, **kw))
    cfg = GPTConfig(**COMMON, dtype=td, **kw)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, model.eval()


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.is_floating_point() else a).numpy()
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(
        a.dtype, jnp.floating) else a)


def _jax_keep_committed(cache, cursor0, length0, commits, T):
    """The JAX SpecGenerator's bookkeeping after a verify step
    (speculative.py:316-324), written out for a JAX cache."""
    rel = jnp.arange(cache.col_pos.shape[1])[None, :] - cursor0
    col_pos = jnp.where((rel >= 0) & (rel < T),
                        jnp.where(rel < commits[:, None],
                                  length0[:, None] + rel, INVALID),
                        cache.col_pos)
    return dataclasses.replace(cache, col_pos=col_pos.astype(jnp.int32),
                               length=(length0 + commits).astype(jnp.int32))


def _jax_reset(cache):
    """The JAX refresh's reset (speculative.py:337-341)."""
    B, S = cache.col_pos.shape
    return dataclasses.replace(
        cache, length=jnp.zeros((B,), jnp.int32),
        cursor=jnp.zeros((), jnp.int32),
        col_pos=jnp.full((B, S), INVALID, jnp.int32))


def _layer_cache(cache, layer):
    """One layer's cache as numpy: k, v and (int8) scales; in bf16 mode
    int8 K/V are compared dequantized by the caller."""
    out = {n: _np(getattr(cache, n)[layer]) for n in ("k", "v")}
    if cache.k_scale is not None:
        for n in ("k", "v"):
            s = _np(getattr(cache, n + "_scale")[layer])  # [B, H, S]
            out[n + "_scale"] = s
            B, S, HD = out[n].shape
            out[n + "_deq"] = (out[n].reshape(B, S, s.shape[1], -1)
                               * s.transpose(0, 2, 1)[..., None]).reshape(
                B, S, HD)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant", [False, True], ids=["floatcache", "int8"])
def test_spec_model_matches_jax(params, quant, dtype):
    jmodel, model = _models(params, dtype, kv_quantized=quant)
    step = jax.jit(lambda p, x, c: jmodel.apply(p, x, cache=c,
                                                return_all_logits=True))
    B, T = 3, 5
    rng = np.random.default_rng(7)
    jcache = JaxKVCache.create(jmodel.config, B, spec=True)
    cache = KVCache.create(model.config, B, device="cpu", spec=True)
    commits_script = [np.array([1, 5, 3]), np.array([5, 2, 1]),
                      np.array([2, 1, 4])]
    calls = [rng.integers(0, 32, (B, 7))]  # prefill (T = F - 1 = 7)
    calls += [rng.integers(0, 32, (B, T)) for _ in commits_script]
    calls += ["refresh", rng.integers(0, 32, (B, 32))]  # T = C = 32
    for i, idx in enumerate(calls):
        if isinstance(idx, str):
            jcache = _jax_reset(jcache)
            reset_spec_cache(cache)
            continue
        idx = idx.astype(np.int32)
        cursor0, length0 = cache.cursor.clone(), cache.length.clone()
        jcursor0, jlength0 = jcache.cursor, jcache.length
        want, _, jcache = step(params, idx, jcache)
        with torch.no_grad():
            got, _ = model(torch.from_numpy(idx), cache=cache,
                           return_all_logits=True)
        want = np.asarray(want, np.float32)
        err = np.abs(_np(got) - want).max()
        tol = 1e-4 if dtype == "fp32" else 2.0 ** -5 * np.abs(want).max()
        assert err <= tol, (i, err, tol)
        if 1 <= i <= len(commits_script):
            c = commits_script[i - 1].astype(np.int32)
            jcache = _jax_keep_committed(jcache, jcursor0, jlength0,
                                         jnp.asarray(c), T)
            keep_committed(cache, cursor0, length0, torch.from_numpy(c), T)
        for name in ("col_pos", "length", "cursor"):
            np.testing.assert_array_equal(_np(getattr(cache, name)),
                                          _np(getattr(jcache, name)), name)
        for layer in range(model.config.n_layer):
            got_c, want_c = _layer_cache(cache, layer), _layer_cache(
                jcache, layer)
            for name, a in got_c.items():
                b = want_c[name]
                if dtype == "fp32" and quant:
                    np.testing.assert_array_equal(a, b, f"{name}[{layer}]")
                elif dtype == "fp32":
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
                elif not (quant and name in ("k", "v")):
                    # bf16 projections round a few ulps apart (int8 values
                    # are compared dequantized)
                    assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(
                        b).max(), (name, layer, i)
    assert int(cache.cursor) == 32  # the refresh wrote 32 columns
    assert cache.k[0].shape == (B, 64, 32)
    if quant:
        assert cache.k[0].dtype == torch.int8
        assert cache.k_scale[0].shape == (B, 2, 64)


def test_spec_cache_refuses_gqa_and_unaligned_length():
    """Mirror of tests/test_decode_matrix.py::test_speculative_rejects_gqa:
    the verify attention assumes full multi-head K/V."""
    cfg = GPTConfig(**{**COMMON, "n_kv_head": 1})
    with pytest.raises(ValueError, match="multi-head"):
        KVCache.create(cfg, 2, device="cpu", spec=True)
    with pytest.raises(ValueError, match="multi-head"):
        SpecGenerator(GPT(cfg, device="cpu"), max_new_tokens=4).generate(
            np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="8-aligned"):
        KVCache.create(GPTConfig(**COMMON), 2, max_len=60, device="cpu",
                       spec=True)
    with pytest.raises(ValueError, match="no room"):
        SpecGenerator(GPT(GPTConfig(**COMMON), device="cpu"), n_draft=4,
                      refresh=4)


def test_prompt_lookup_drafts_bit_exact_vs_jax():
    rng = np.random.default_rng(0)
    B, total, K = 64, 40, 4
    tokens = rng.integers(0, 4, (B, total)).astype(np.int32)  # many bigrams
    tokens[:8] = np.tile(np.arange(5), 8)[:total]  # periodic rows
    lens = rng.integers(0, total + 1, (B,)).astype(np.int32)
    lens[:4] = [0, 1, 2, 3]  # lens < 3: no lookup
    lens[4:8] = [total - 1, total, total - 2, total]  # wrap at the end
    prompt_lens = rng.integers(0, total + 1, (B,)).astype(np.int32)
    for k in (1, K):
        jd, jf = jax_prompt_lookup_drafts(tokens, lens, prompt_lens, k)
        d, f = prompt_lookup_drafts(*map(torch.from_numpy,
                                         (tokens, lens, prompt_lens)), k)
        assert d.dtype == torch.int32
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert f.any() and not f.all()  # forced and free positions both met


def test_draft_lookup_on_periodic_sequence():
    """Mirror of tests/test_speculative.py: the last bigram (5, 6)
    previously continued with 7 8 5."""
    row = torch.tensor([1, 5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 0, 0, 0],
                       dtype=torch.int32)
    tokens = torch.stack([row, torch.zeros_like(row)])
    drafts, forced = prompt_lookup_drafts(
        tokens, torch.tensor([11, 3], dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), 3)
    assert drafts[0].tolist() == [7, 8, 5] and not forced.any()
    assert drafts[1].tolist() == [0, 0, 0]


def test_draft_lookup_teacher_forces_prompt():
    row = torch.arange(14, dtype=torch.int32) % 9
    drafts, forced = prompt_lookup_drafts(
        row[None], torch.tensor([4], dtype=torch.int32),
        torch.tensor([7], dtype=torch.int32), 4)
    assert forced[0].tolist() == [True, True, True, False]
    assert drafts[0, :3].tolist() == row[4:7].tolist()


def _count_calls(model):
    """Record the T of every model call (a forward pre-hook)."""
    seen = []
    handle = model.register_forward_pre_hook(
        lambda _, args: seen.append(args[0].shape[1]))
    return seen, handle


@pytest.mark.parametrize("quant", [False, True], ids=["floatcache", "int8"])
@pytest.mark.parametrize("n_draft", [1, 4])
@pytest.mark.parametrize("new", [20, 60], ids=["one_window", "refreshes"])
def test_greedy_tokens_and_steps_equal_jax(params, new, n_draft, quant):
    jmodel, model = _models(params, kv_quantized=quant)
    prompts = np.random.default_rng(1).integers(0, 32, (4, 10)).astype(
        np.int32)
    plens = np.array([10, 7, 9, 5], np.int32)
    kw = dict(max_new_tokens=new, temperature=0.0, top_k=None,
              n_draft=n_draft)
    want, want_steps = JaxSpecGenerator(jmodel, **kw).generate_with_stats(
        params, prompts, plens, seed=7)
    seen, handle = _count_calls(model)
    got, steps = SpecGenerator(model, **kw).generate_with_stats(
        prompts, plens, seed=7)
    handle.remove()
    assert got.dtype == torch.int32 and got.shape == (4, 10 + new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    # one prefill of F - 1 = 3 tokens, the verify steps, and the refreshes,
    # which re-prefill min(C, P + new) tokens (C = 32). Every 7 steps (8
    # columns each past the prefill) the cache is full: 20 new tokens stay
    # inside one context window but refresh too, 60 new tokens truncate.
    refreshes = seen.count(min(32, 10 + new))
    assert seen[0] == 3 and seen.count(n_draft + 1) == steps
    assert len(seen) == 1 + steps + refreshes
    assert refreshes >= (2 if new == 60 else 0)


@pytest.mark.parametrize("quant", [False, True], ids=["floatcache", "int8"])
def test_greedy_matches_generator(params, quant):
    """Mirror of tests/test_speculative.py::test_greedy_matches_generator:
    inside one context window greedy speculative output is the plain
    Generator's, token for token."""
    _, model = _models(params, kv_quantized=quant)
    prompts = np.random.default_rng(1).integers(0, 32, (4, 10))
    plens = np.array([10, 7, 9, 5])
    kw = dict(max_new_tokens=20, temperature=0.0, top_k=None)
    plain = Generator(model, **kw).generate(prompts, plens, seed=7)
    for n_draft in (1, 3):
        spec = SpecGenerator(model, n_draft=n_draft, **kw).generate(
            prompts, plens, seed=7)
        assert torch.equal(plain, spec)


def test_one_step_marginal_is_exact(params):
    """Mirror of tests/test_speculative.py::test_one_step_marginal_is_exact:
    the committed token's marginal equals the temperature/top-k sampling
    distribution of the model's own logits."""
    _, model = _models(params)
    B, P, top_k = 4096, 6, 5
    prompt = np.random.default_rng(3).integers(0, 32, (1, P))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(prompt))
    lg = logits[0, -1].double().numpy()
    lg = np.where(lg < np.sort(lg)[-top_k], -np.inf, lg)
    p_exact = np.exp(lg - lg.max())
    p_exact /= p_exact.sum()
    out = SpecGenerator(model, max_new_tokens=1, temperature=1.0,
                        top_k=top_k, n_draft=3).generate(
        np.repeat(prompt, B, axis=0), seed=11)
    emp = np.bincount(out[:, P].numpy(), minlength=32) / B
    tv = 0.5 * np.abs(emp - p_exact).sum()
    assert tv < 0.06, (tv, emp, p_exact)  # binomial noise ~0.02 at B=4096
    assert set(np.nonzero(emp)[0]) <= set(np.nonzero(p_exact > 0)[0])


def test_refreshes_are_deterministic_and_keep_prompts(params):
    _, model = _models(params, kv_quantized=True)
    B, P, new = 6, 12, 150  # far past block_size 64: several refreshes
    prompts = np.random.default_rng(5).integers(0, 32, (B, P))
    plens = np.array([12, 9, 12, 4, 7, 12])
    sg = SpecGenerator(model, max_new_tokens=new, temperature=0.8, top_k=8,
                       n_draft=4)
    seen, handle = _count_calls(model)
    a = sg.generate(prompts, plens, seed=13)
    handle.remove()
    assert seen.count(32) >= 2  # refreshes re-prefill C = 32 tokens
    assert torch.equal(a, sg.generate(prompts, plens, seed=13))
    assert not torch.equal(a, sg.generate(prompts, plens, seed=14))
    assert a.shape == (B, P + new) and a.min() >= 0 and a.max() < 32
    for i, n in enumerate(plens):
        np.testing.assert_array_equal(a[i, :n].numpy(), prompts[i, :n])


def test_generate_with_stats_counts_steps(params):
    """ceil(committed/(K+1)) <= n_steps <= committed, and in-prompt drafts
    are force-accepted: a long ragged prompt commits several tokens per
    step even on random weights."""
    _, model = _models(params)
    K, new = 3, 24
    sg = SpecGenerator(model, max_new_tokens=new, temperature=0.0,
                       top_k=None, n_draft=K)
    prompts = np.random.default_rng(2).integers(0, 32, (2, 24))
    toks, n_steps = sg.generate_with_stats(prompts, [24, 20], seed=5)
    assert torch.equal(toks, sg.generate(prompts, [24, 20], seed=5))
    committed = toks.shape[1] - 16  # prefill bucket 16; rows fill the buffer
    assert -(-committed // (K + 1)) <= n_steps < committed
    np.testing.assert_array_equal(toks[0, :24].numpy(), prompts[0])
