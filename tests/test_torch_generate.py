"""The port's Generator (ai_music_generation_tpu_torch/decode/generate.py)
against the JAX package's.

Greedy decoding draws no random numbers, so with fp32 compute and an
unquantized cache the two frameworks must emit the same tokens: 40 new
tokens at block 32 run a windowed-refresh phase (re-prefill, then more
decode steps), once at the default window and once at window 16. Sampled
decoding cannot match JAX (threefry streams are not reproducible in torch);
there the port holds its own contract: the same seed gives the same tokens,
prompts are preserved, and top-k / top-p restrict the support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.decode.generate import Generator as JaxGenerator
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu_torch.decode.generate import (
    Generator,
    apply_top_p,
    sample_logits,
)
from ai_music_generation_tpu_torch.models.convert import state_dict_from_jax
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig

torch.set_num_threads(1)

COMMON = dict(block_size=32, vocab_size=96, n_layer=2, n_head=6, n_embd=384,
              n_kv_head=2, dropout=0.0, flat_kv=True)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig(**COMMON, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    cfg = GPTConfig(**COMMON, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), cfg))
    return jmodel, params, model.eval()


@pytest.mark.parametrize("window", [None, 16])
def test_greedy_tokens_equal_jax(models, window):
    jmodel, params, model = models
    prompts = np.random.default_rng(1).integers(0, 96, (4, 8)).astype(
        np.int32)
    kw = dict(max_new_tokens=40, temperature=0.0, top_k=None, window=window)
    want = np.asarray(JaxGenerator(jmodel, **kw).generate(params, prompts))
    got = Generator(model, **kw).generate(prompts)
    assert got.dtype == torch.int32 and got.shape == (4, 48)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt_without_a_card_raises_naming_device_cpu(monkeypatch):
    """GPT(cfg) with no ``device`` builds on the card; without one it
    raises and names the CPU argument, as KVCache.create does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPT(GPTConfig(**COMMON))


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")],
                         ids=["str", "torch.device"])
def test_cpu_model_generates_on_the_cpu(models, device):
    """GPT(cfg, device="cpu") holds every parameter on the CPU, and its
    Generator decodes there with the JAX greedy tokens."""
    jmodel, params, model = models
    cpu = GPT(model.config, device=device)
    assert all(p.device.type == "cpu" for p in cpu.parameters())
    cpu.load_state_dict(model.state_dict())
    prompts = np.random.default_rng(6).integers(0, 96, (3, 8)).astype(
        np.int32)
    kw = dict(max_new_tokens=12, temperature=0.0, top_k=None)
    got = Generator(cpu.eval(), **kw).generate(prompts)
    assert got.device.type == "cpu"
    want = np.asarray(JaxGenerator(jmodel, **kw).generate(params, prompts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_prompts_preserved(models):
    model = models[2]
    prompts = np.zeros((3, 6), np.int32)
    prompts[0, :6] = [9, 8, 7, 6, 5, 4]
    prompts[1, :3] = [11, 12, 13]
    prompts[2, :1] = [20]
    lens = np.array([6, 3, 1], np.int32)
    out = Generator(model, max_new_tokens=5, temperature=1.0,
                    top_k=None).generate(prompts, lens, seed=0).numpy()
    assert out.shape == (3, 11)
    for row, n in enumerate(lens):
        np.testing.assert_array_equal(out[row, :n], prompts[row, :n])
    assert ((out >= 0) & (out < 96)).all()


def test_same_seed_same_tokens(models):
    model = models[2]
    gen = Generator(model, max_new_tokens=40, temperature=0.8, top_k=20)
    prompts = np.random.default_rng(2).integers(0, 96, (4, 8))
    a = gen.generate(prompts, seed=7)
    np.testing.assert_array_equal(a.numpy(), gen.generate(prompts, seed=7))
    assert not torch.equal(a, gen.generate(prompts, seed=8))


def test_top_k_restricts_support():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((64, 96)).astype(
        np.float32))
    allowed = torch.topk(logits, 5, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        tok = sample_logits(logits, g, temperature=1.3, top_k=5)
        assert (allowed == tok[:, None].long()).any(dim=-1).all()
        seen.update(tok.tolist())
    assert len(seen) > 5  # it samples, not argmax
    # top_k=1 is greedy whatever the temperature; greedy draws nothing
    greedy = logits.argmax(-1).to(torch.int32)
    assert torch.equal(sample_logits(logits, g, 2.0, top_k=1), greedy)
    assert torch.equal(sample_logits(logits, None, 0.0), greedy)


def test_generate_top_k_one_is_greedy(models):
    model = models[2]
    prompts = np.random.default_rng(4).integers(0, 96, (2, 8))
    greedy = Generator(model, max_new_tokens=20, temperature=0.0,
                       top_k=None).generate(prompts)
    topk1 = Generator(model, max_new_tokens=20, temperature=1.5,
                      top_k=1).generate(prompts, seed=3)
    assert torch.equal(greedy, topk1)


def test_top_p_matches_jax():
    """apply_top_p keeps the same tokens as the JAX version (mirror of
    tests/test_decode.py::test_sample_logits_top_p)."""
    from ai_music_generation_tpu.decode.generate import (
        apply_top_p as jax_apply_top_p,
    )

    rng = np.random.default_rng(5)
    logits = np.concatenate([
        np.array([[3.0, 2.0, 1.0, 0.0] * 4]),
        rng.standard_normal((7, 16)) * 3,
    ]).astype(np.float32)
    for top_p in (0.5, 0.7, 0.9, 1.0):
        want = np.isfinite(np.asarray(jax_apply_top_p(logits, top_p)))
        got = torch.isfinite(apply_top_p(torch.from_numpy(logits), top_p))
        np.testing.assert_array_equal(got.numpy(), want)
    # logits [3, 2, 1, 0]: probs ~ [.64, .24, .09, .03]; top_p 0.7 keeps 2
    small = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
    kept = torch.isfinite(apply_top_p(small, 0.7))[0].tolist()
    assert kept == [True, True, False, False]
