"""The port's MoE GPT through its decode, serving and training paths, held
to the JAX package's on the same weights:

- greedy fp32 tokens (top_k=1) of the port's ``Generator`` equal JAX's in
  lockstep (an MHA model, 40 new tokens at block 32: refreshes), and at the
  flat GQA x window=16 corner of tests/test_decode_matrix.py:80-89 with 4
  experts, over a float and an int8 cache;
- the port's ``SpecGenerator``: greedy tokens and ``n_steps`` equal JAX's
  (its verify steps route B x (n_draft + 1) tokens a call);
- the MoE ``GenerationServer`` against JAX's on the same submissions (more
  requests than slots, window refreshes): greedy tokens equal. Every slot
  ticks, idle ones too, and routing couples the slots of a tick, so the
  port's alone-versus-crowd checks do not apply to MoE; the JAX server is
  the reference here;
- ``Trainer`` with ``n_expert > 0`` trains (the val loss falls), writes
  ``MOE_KEYS`` into ``model_args``, a dense-config resume restores the MoE
  architecture (the mirror of tests/test_trainer.py:209), and
  ``cli/sample.py`` samples the MoE ``ckpt.pt``.

Weights are numpy draws from a seed (the router at std 0.5, ``wte`` at 0.5
so greedy picks are no near-ties), carried to the port by
``state_dict_from_jax``; prompts are numpy draws.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.decode.generate import Generator as JaxGenerator
from ai_music_generation_tpu.decode.speculative import (
    SpecGenerator as JaxSpecGenerator,
)
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.serve.engine import (
    GenerationServer as JaxServer,
)
from ai_music_generation_tpu_torch.cli import sample as sample_cli
from ai_music_generation_tpu_torch.data.memmap import write_bin, write_meta
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.decode.speculative import SpecGenerator
from ai_music_generation_tpu_torch.models.convert import state_dict_from_jax
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import (
    MOE_KEYS,
    load_ckpt,
)
from ai_music_generation_tpu_torch.serve.engine import GenerationServer
from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib
from ai_music_generation_tpu_torch.train.trainer import DEFAULTS, Trainer

torch.set_num_threads(1)

MOE = dict(n_expert=4, expert_top_k=2, capacity_factor=1.25, dropout=0.0)
SMALL = dict(MOE, block_size=32, vocab_size=64, n_layer=2, n_head=4,
             n_embd=64)
# tests/test_decode_matrix.py's BASE with GQA, the flat cache and 4 experts
MATRIX = dict(MOE, block_size=32, vocab_size=96, n_layer=2, n_head=6,
              n_embd=384, n_kv_head=2, flat_kv=True)
SPEC = dict(SMALL, block_size=64, bias=False)
SERVING = dict(SMALL, block_size=64, vocab_size=50)


def _numpy_params(params, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        std = (0.5 if "router" in names or "wte" in names else 0.05)
        mean = 1.0 if names[-1] == "scale" else 0.0
        return (mean + std * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def _models(common, seed=0, **kw):
    """(JAX model, params, port model) in fp32 on the same numpy weights."""
    common = dict(common, **kw)
    jmodel = JaxGPT(JaxGPTConfig(**common, dtype=jnp.float32))
    params = _numpy_params(jmodel.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 8), jnp.int32)), seed)
    cfg = GPTConfig(**common, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, params, model.eval()


GREEDY = dict(max_new_tokens=40, temperature=0.8, top_k=1)


def test_generator_lockstep_greedy_equals_jax():
    """An MHA MoE model over the lockstep cache: a power-of-two prefill of
    the ragged prompts, T=1 steps and the refreshes past block 32."""
    jmodel, params, model = _models(SMALL)
    prompts = np.random.default_rng(1).integers(0, 64, (4, 8)).astype(
        np.int32)
    lens = np.array([8, 5, 7, 3], np.int32)
    want = JaxGenerator(jmodel, **GREEDY).generate(params, prompts, lens,
                                                   seed=7)
    got = Generator(model, **GREEDY).generate(prompts, lens, seed=7)
    assert got.shape == (4, 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_generator_flat_gqa_window_greedy_equals_jax(quant):
    """The decode matrix's MoE x flat x window=16 corner with 4 experts:
    windowed re-prefills of 8 tokens, each T=1 step through the flat GQA
    op; int8 quantizes the cache."""
    jmodel, params, model = _models(MATRIX, kv_quantized=quant)
    prompts = np.array([[1, 2, 3, 0, 0], [5, 6, 7, 8, 9], [10, 11, 0, 0, 0],
                        [20, 21, 22, 23, 0]], np.int32)
    lens = np.array([3, 5, 2, 4], np.int32)
    want = JaxGenerator(jmodel, window=16, **GREEDY).generate(
        params, prompts, lens, seed=7)
    got = Generator(model, window=16, **GREEDY).generate(prompts, lens,
                                                         seed=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_spec_generator_greedy_equals_jax(quant):
    jmodel, params, model = _models(SPEC, kv_quantized=quant)
    prompts = np.random.default_rng(2).integers(0, 64, (4, 10)).astype(
        np.int32)
    plens = np.array([10, 7, 9, 5], np.int32)
    kw = dict(max_new_tokens=60, temperature=0.0, top_k=None, n_draft=4)
    want, want_steps = JaxSpecGenerator(jmodel, **kw).generate_with_stats(
        params, prompts, plens, seed=7)
    got, steps = SpecGenerator(model, **kw).generate_with_stats(
        prompts, plens, seed=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)


def _serve_greedy(srv, reqs):
    rids = [srv.submit(p, max_new_tokens=b, temperature=0.0, seed=i)
            for i, (p, b) in enumerate(reqs)]
    done = {r.id: r for r in srv.run_until_idle()}
    return [done[r].generated for r in rids]


def test_server_greedy_equals_jax():
    """14 requests for 12 slots (a first wave above 8, later ones below),
    prompts of 1-20 tokens, budgets up to 45 past the 32-column ring: the
    admission prefills (padding rows included), every tick of every slot
    and the window refreshes route the same tokens in both engines."""
    jmodel, params, model = _models(SERVING)
    rng = np.random.default_rng(5)
    lens = [3, 1, 20, 7, 12, 2, 16, 5, 9, 4, 18, 6, 11, 8]
    budgets = [30, 12, 45, 5, 40, 25, 9, 33, 17, 44, 6, 21, 38, 14]
    reqs = [(rng.integers(0, 50, n).tolist(), b)
            for n, b in zip(lens, budgets)]
    kw = dict(n_slots=12, ticks_per_call=8, cache_len=32, admit_group=16)
    want = _serve_greedy(JaxServer(jmodel, params, **kw), reqs)
    got = _serve_greedy(GenerationServer(model, **kw), reqs)
    assert [len(g) for g in got] == budgets
    assert got == [list(w) for w in want]


def _write_corpus(d, text):
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.array([stoi[c] for c in text], np.uint16)
    split = int(0.9 * len(ids))
    d.mkdir(parents=True)
    write_bin(ids[:split], str(d / "train.bin"))
    write_bin(ids[split:], str(d / "val.bin"))
    write_meta({"vocab_size": len(chars), "stoi": stoi,
                "itos": dict(enumerate(chars))}, str(d / "meta.pkl"))


def _config(root, out, **kw):
    c = dict(DEFAULTS)
    c.update(dataset="tinymusic", data_root=root, out_dir=out, n_layer=2,
             n_head=2, n_embd=32, block_size=32, batch_size=4,
             gradient_accumulation_steps=2, max_iters=20, eval_interval=10,
             eval_iters=4, log_interval=10, warmup_iters=2,
             lr_decay_iters=20, learning_rate=1e-2, min_lr=1e-3,
             dtype="float32", dropout=0.0, device="cpu")
    c.update(kw)
    return c


def test_moe_trainer_trains_resumes_the_arch_and_samples(tmp_path):
    root = tmp_path / "data"
    _write_corpus(root / "tinymusic",
                  "$abcdefg|ABCDEFG|" * 2000 + "$gfedcba|GFEDCBA|" * 2000)
    out = str(tmp_path / "out")
    t1 = Trainer(_config(str(root), out, n_expert=2, expert_top_k=1))
    assert all(hasattr(b, "moe") for b in t1.model.transformer.h)
    t1.run()
    with open(os.path.join(out, "losses.jsonl")) as f:
        losses = [json.loads(line)["val/loss"] for line in f]
    assert losses[-1] < losses[0]
    ckpt = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    assert {k: ckpt["model_args"][k] for k in MOE_KEYS} == dict(
        n_expert=2, expert_top_k=1, capacity_factor=1.25, moe_aux_coef=0.01)
    assert "transformer.h.0.moe.w_fc" in ckpt["model"]

    # a dense resume config: the checkpoint's MoE architecture wins
    t2 = Trainer(_config(str(root), out, max_iters=22, init_from="resume"))
    assert t2.gpt_config.n_expert == 2 and t2.gpt_config.expert_top_k == 1
    assert t2.iter_num == 20
    t2.run()
    assert t2.iter_num == 23

    model, meta = load_ckpt(os.path.join(out, ckpt_lib.BEST), device="cpu")
    assert model.config.n_expert == 2 and meta["model_args"]["n_expert"] == 2
    results = sample_cli.main([
        f"--out_dir={out}", f"--data_root={root}", "--dataset=tinymusic",
        "--tokens_format=char", "--use_validation_prefixes=False",
        "--start=$abc", "--num_samples=3", "--max_new_tokens=8",
        "--temperature=0.8", "--top_k=1", "--dtype=float32", "--device=cpu"])
    assert [i for i, _ in results] == [0, 1, 2]
    assert all(text.startswith("$abc") for _, text in results)


@pytest.mark.parametrize("n_expert", [0, 4], ids=["dense", "moe"])
def test_probe_step_flops_equal_flop_counter(n_expert):
    """experiments/moe_probe.py's FLOP formula (experts at their capacity
    rows) is what FlopCounterMode counts for a forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from ai_music_generation_tpu_torch.experiments.moe_probe import (
        step_flops,
    )
    from ai_music_generation_tpu_torch.models.convert import init_weights

    cfg = GPTConfig(**dict(SMALL, n_expert=n_expert, bias=False),
                    dtype=torch.float32)
    model = init_weights(GPT(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    x = torch.randint(0, 64, (4, 32), generator=torch.Generator())
    with FlopCounterMode(display=False) as counter:
        model(x, x)[1].backward()
    assert counter.get_total_flops() == step_flops(cfg, 4)


def test_moe_probe_runs_at_a_small_size(tmp_path, monkeypatch):
    """The probe's protocol cut to 2 layers, 64 wide, block 64, batch 8 on
    the CPU: both runs' val loss falls, the step ratio and the FLOP ratio
    are reported, MoE decode is deterministic; the corpus is the JAX
    experiment's char layout (sorted characters, padded to 128)."""
    from ai_music_generation_tpu_torch.data.memmap import load_meta
    from ai_music_generation_tpu_torch.experiments import moe_probe

    for k, v in dict(n_layer=2, n_head=2, n_embd=64, block_size=64,
                     batch_size=8, dtype="float32").items():
        monkeypatch.setitem(moe_probe.PROTOCOL, k, v)
    monkeypatch.setattr(moe_probe, "DECODE_B", 8)
    monkeypatch.setattr(moe_probe, "DECODE_NEW", 16)
    res = moe_probe.run(str(tmp_path), iters=20, device="cpu", steps=2)
    for name in ("dense", "moe"):
        assert res[name]["val"][-1] < res[name]["val"][0]
    assert 1.5 < res["flop_ratio"] < 2.5 and res["ms_ratio"] > 0
    assert res["decode"]["shape"] == [8, 8 + 16]
    meta = load_meta(str(tmp_path / "data" / "moe_ds" / "meta.pkl"))
    assert meta["vocab_size"] == 128
    ids = np.fromfile(tmp_path / "data" / "moe_ds" / "train.bin", np.uint16)
    text = "".join(meta["itos"][int(i)] for i in ids[:5000])
    assert text.startswith("X:0\nL:1/8\nM:")
    # the corpus's characters first, in sorted order, then the padding,
    # "$" (the sampling CLI's marker, never in the tunes) first
    n = meta["stoi"]["$"]
    real = [meta["itos"][i] for i in range(n)]
    assert real == sorted(real) and "$" not in text
    assert all(ord(meta["itos"][i]) >= 0x2500 for i in range(n + 1, 128))


def test_train_bench_times_an_moe_model():
    """cli/train_bench.py's MoE flags reach the model it times."""
    from ai_music_generation_tpu_torch.cli import train_bench

    flags = ["--n_layer=2", "--n_head=2", "--n_embd=32", "--block_size=32",
             "--batch_size=4", "--vocab_size=64", "--burn_in=1",
             "--num_steps=2", "--n_expert=4", "--expert_top_k=1",
             "--capacity_factor=2.0", "--moe_aux_coef=0.1",
             "--dtype=float32", "--device=cpu"]
    c = train_bench.apply_overrides(dict(train_bench.DEFAULTS), flags)
    cfg = train_bench.setup(c)["config"]
    assert (cfg.n_expert, cfg.expert_top_k, cfg.capacity_factor,
            cfg.moe_aux_coef) == (4, 1, 2.0, 0.1)
    res = train_bench.main(flags)
    assert res["ms"] > 0 and np.isfinite(res["loss"])
