"""The port's HF GPT-2 import (``models/hf_import.py``) and its two users,
``init_from=gpt2*`` in ``cli/sample.py`` and in the trainer, against
transformers and the JAX package; the port's ``utils/sizing.py`` and
``utils/scaling_laws.py`` against the originals.

The model is the tiny random ``GPT2LMHeadModel`` of
tests/test_hf_import_and_sizing.py (2 layers, 2 heads, 32 wide, 32
positions, vocab 96) with its ``wte`` scaled by 10, so greedy choices are
not near-ties; ``save_pretrained`` writes it into ``<tmp>/gpt2-tiny``
(``model.safetensors``) and ``<tmp>/gpt2-tinybin`` (``pytorch_model.bin``),
and both packages load it by that relative name (the ``gpt2`` prefix
routes ``init_from``), from the same working directory.
"""

import dataclasses
import json
import os
import string
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import sample as jax_sample
from ai_music_generation_tpu.decode.generate import Generator as JaxGenerator
from ai_music_generation_tpu.models import hf_import as jax_hf
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.train.trainer import DEFAULTS as JAX_DEFAULTS
from ai_music_generation_tpu.train.trainer import Trainer as JaxTrainer
from ai_music_generation_tpu.utils import scaling_laws as jax_laws
from ai_music_generation_tpu.utils import sizing as jax_sizing
from ai_music_generation_tpu_torch.cli import sample
from ai_music_generation_tpu_torch.data.memmap import write_bin
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.models import hf_import
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.train.trainer import DEFAULTS, Trainer
from ai_music_generation_tpu_torch.utils import scaling_laws as laws
from ai_music_generation_tpu_torch.utils import sizing

torch.set_num_threads(1)

IDS = np.array([[5, 17, 42, 3, 8, 61], [90, 1, 0, 33, 33, 7]], np.int32)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """(the directory holding gpt2-tiny and gpt2-tinybin, the HF model)."""
    from transformers import GPT2Config, GPT2LMHeadModel

    hf_cfg = GPT2Config(
        n_positions=32, vocab_size=96, n_layer=2, n_head=2, n_embd=32,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    hf = GPT2LMHeadModel(hf_cfg).eval()
    with torch.no_grad():
        hf.transformer.wte.weight.mul_(10.0)
    root = tmp_path_factory.mktemp("hf")
    hf.save_pretrained(str(root / "gpt2-tiny"))
    hf.save_pretrained(str(root / "gpt2-tinybin"), safe_serialization=False)
    return root, hf


def _port_model(name, dtype=torch.float32):
    config, state = hf_import.from_pretrained(name)
    model = GPT(dataclasses.replace(config, dtype=dtype), device="cpu")
    model.load_state_dict(state)
    return model.eval()


def _jax_model(name):
    config, params = jax_hf.from_pretrained(name)
    return JaxGPT(dataclasses.replace(config, dtype=jnp.float32)), params


@pytest.mark.parametrize("name", ["gpt2-tiny", "gpt2-tinybin"],
                         ids=["safetensors", "pytorch_model.bin"])
def test_logits_equal_hf_and_jax(hf_dir, monkeypatch, name):
    """All positions' fp32 logits within 2e-3 of HF's and of JAX's."""
    root, hf = hf_dir
    monkeypatch.chdir(root)
    assert os.path.exists(os.path.join(
        name, "model.safetensors" if name == "gpt2-tiny"
        else "pytorch_model.bin"))
    model = _port_model(name)
    assert model.lm_head.weight is model.transformer.wte.weight
    ids = torch.from_numpy(IDS)
    with torch.no_grad():
        got = model(ids, ids)[0].numpy()
        want_hf = hf(ids.long()).logits.numpy()
    jmodel, params = _jax_model(name)
    want_jax = np.asarray(jmodel.apply(params, jnp.asarray(IDS),
                                       jnp.asarray(IDS))[0])
    np.testing.assert_allclose(got, want_hf, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got, want_jax, atol=2e-3, rtol=2e-3)


def test_state_equals_jax_params(hf_dir, monkeypatch):
    """Every tensor is the JAX package's parameter (its Dense kernels are
    [in, out], the HF Conv1D layout; the port's Linear weights transposed),
    so an untransposed square c_proj cannot pass."""
    root, _ = hf_dir
    monkeypatch.chdir(root)
    config, state = hf_import.from_pretrained("gpt2-tiny")
    _, params = jax_hf.from_pretrained("gpt2-tiny")
    p = params["params"]
    pairs = [("transformer.wte.weight", p["wte"]["embedding"], False),
             ("transformer.wpe.weight", p["wpe"]["embedding"], False),
             ("transformer.ln_f.weight", p["ln_f"]["scale"], False)]
    for i in range(config.n_layer):
        h = p[f"h_{i}"]
        for mod, sub in (("attn", "c_attn"), ("attn", "c_proj"),
                         ("mlp", "c_fc"), ("mlp", "c_proj")):
            pairs.append((f"transformer.h.{i}.{mod}.{sub}.weight",
                          h[mod][sub]["kernel"], True))
            pairs.append((f"transformer.h.{i}.{mod}.{sub}.bias",
                          h[mod][sub]["bias"], False))
    for key, want, transposed in pairs:
        got = state[key].numpy()
        np.testing.assert_array_equal(got.T if transposed else got,
                                      np.asarray(want), err_msg=key)


def test_greedy_tokens_equal_jax(hf_dir, monkeypatch):
    root, _ = hf_dir
    monkeypatch.chdir(root)
    model = _port_model("gpt2-tiny")
    jmodel, params = _jax_model("gpt2-tiny")
    prompts = np.random.default_rng(1).integers(0, 96, (3, 6)).astype(
        np.int32)
    kw = dict(max_new_tokens=30, temperature=0.0, top_k=None)
    want = np.asarray(JaxGenerator(jmodel, **kw).generate(params, prompts))
    got = Generator(model, **kw).generate(prompts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_name_with_no_directory_raises_as_jax(tmp_path, monkeypatch):
    """A name that is no local directory goes through transformers, as in
    JAX; where it finds no weights (no cache, no network) both raise the
    same RuntimeError. transformers is a stand-in whose loader raises as
    the real one then does: nothing reaches for the network."""
    def offline(name, *args, **kwargs):
        raise OSError(f"we could not connect to fetch {name!r}")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2LMHeadModel=types.SimpleNamespace(from_pretrained=offline)))
    errors = []
    for load in (hf_import.from_pretrained, jax_hf.from_pretrained):
        with pytest.raises(RuntimeError) as info:
            load("gpt2-nowhere")
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "could not load 'gpt2-nowhere'" in errors[0]
    # without transformers at all: both raise the same error again
    monkeypatch.setitem(sys.modules, "transformers", None)
    for load in (hf_import.from_pretrained, jax_hf.from_pretrained):
        with pytest.raises(RuntimeError, match="transformers is required"):
            load("gpt2-nowhere")


def test_zoo_shape_mismatch_raises(hf_dir, monkeypatch, tmp_path):
    """A local directory named like a zoo model with other shapes fails
    loudly, as in JAX; other names are not checked."""
    root, _ = hf_dir
    os.symlink(root / "gpt2-tiny", tmp_path / "gpt2")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="'gpt2' loaded with shapes"):
        hf_import.from_pretrained("gpt2")
    with pytest.raises(ValueError, match="'gpt2' loaded with shapes"):
        jax_hf.from_pretrained("gpt2")


def test_load_model_takes_dtype_and_flat_kv(hf_dir, monkeypatch):
    root, _ = hf_dir
    monkeypatch.chdir(root)
    model, meta = sample.load_model("out", dtype="float32",
                                    init_from="gpt2-tiny", flat_kv=True,
                                    device="cpu")
    assert meta == {"model_args": {}, "config": {}}
    assert model.config.flat_kv and model.config.dtype == torch.float32
    assert model.config.block_size == 32 and not model.training
    bf16, _ = sample.load_model("out", init_from="gpt2-tiny", device="cpu")
    assert bf16.config.dtype == torch.bfloat16


class _FakeEncoding:
    """tiktoken's ``gpt2`` encoding stand-in: 96 printable characters, one
    id each ('$' is 65)."""

    TABLE = string.printable[:96]

    def encode(self, s, allowed_special=()):
        assert allowed_special == {"<|endoftext|>"}
        return [self.TABLE.index(c) for c in s]

    def decode(self, ids):
        return "".join(self.TABLE[i] for i in ids)


def test_sample_cli_texts_equal_jax(hf_dir, monkeypatch, tmp_path):
    """Both CLIs' run_sampling under init_from=gpt2-tiny, top_k=1, fp32,
    with tiktoken's encoding faked (its table cannot be fetched here),
    write the same texts."""
    import tiktoken

    root, _ = hf_dir
    monkeypatch.chdir(root)
    monkeypatch.setattr(tiktoken, "get_encoding",
                        lambda name: _FakeEncoding())
    c = dict(init_from="gpt2-tiny", use_validation_prefixes=False,
             start="$ ab|cd", num_samples=5, batch_size=2,
             max_new_tokens=20, top_k=1, dtype="float32", seed=3)
    texts = {}
    for name, mod, extra in (("port", sample, dict(device="cpu")),
                             ("jax", jax_sample, {})):
        cfg = dict(mod.DEFAULTS, out_dir=str(tmp_path / name), **c, **extra)
        texts[name] = mod.run_sampling(cfg)
        files = sorted(os.listdir(tmp_path / name / "samples"))
        assert files == [f"sample_{i}.txt" for i in range(5)]
    assert texts["port"] == texts["jax"]


def _fixture_data(root, T=16, n=4000):
    d = root / "data" / "rand"
    d.mkdir(parents=True, exist_ok=True)
    ids = np.random.default_rng(0).integers(0, 96, n).astype(np.uint16)
    write_bin(ids[:3600], str(d / "train.bin"), np.uint16)
    write_bin(ids[3600:], str(d / "val.bin"), np.uint16)
    return str(root / "data")


def test_trainer_iter0_loss_equals_jax(hf_dir, monkeypatch, tmp_path):
    """Both Trainers from init_from=gpt2-tiny (dropout 0, fp32): the HF
    architecture (block_size n_positions, uncropped; bias; vocab 96), and
    the first train step's loss on one fixture batch within 1e-5 relative."""
    root, _ = hf_dir
    monkeypatch.chdir(root)
    data_root = _fixture_data(tmp_path)
    common = dict(init_from="gpt2-tiny", dataset="rand", data_root=data_root,
                  block_size=16, batch_size=2, gradient_accumulation_steps=1,
                  dtype="float32", dropout=0.0, learning_rate=1e-3,
                  warmup_iters=0, max_iters=1, n_layer=6, n_embd=48)
    port = Trainer(dict(DEFAULTS, out_dir=str(tmp_path / "port"),
                        device="cpu", **common))
    jax_t = JaxTrainer(dict(JAX_DEFAULTS, out_dir=str(tmp_path / "jax"),
                            **common))
    want_args = dict(n_layer=2, n_head=2, n_embd=32, block_size=32,
                     bias=True, vocab_size=96)
    assert {k: port.model_args[k] for k in want_args} == want_args
    assert {k: jax_t.model_args[k] for k in want_args} == want_args
    assert port.iter_num == jax_t.iter_num == 0
    rows = jax_t.micro_batch
    x = np.random.default_rng(5).integers(0, 96, (1, rows, 17)).astype(
        np.int32)
    x, y = x[..., :-1], x[..., 1:]
    import jax

    _, metrics = jax_t._train_step(jax_t.state, x, y,
                                   jax.random.PRNGKey(0))
    got = port._train_step(torch.from_numpy(x), torch.from_numpy(y), 0,
                           port.c["seed"])
    want = float(metrics["loss"])
    assert abs(float(got["loss"]) - want) <= 1e-5 * abs(want)


# ---- sizing and scaling laws ------------------------------------------------

SIZING_CONFIGS = [
    dict(block_size=64, vocab_size=96, n_layer=3, n_head=2, n_embd=32,
         bias=True),
    dict(block_size=64, vocab_size=96, n_layer=3, n_head=2, n_embd=32,
         bias=False),
    dict(block_size=256, vocab_size=128, n_layer=6, n_head=6, n_embd=384),
    dict(block_size=256, vocab_size=128, n_layer=6, n_head=6, n_embd=384,
         n_kv_head=2, kv_quantized=True),
    dict(block_size=1024, vocab_size=50257, n_layer=12, n_head=12,
         n_embd=768),
]


@pytest.mark.parametrize("kw", SIZING_CONFIGS,
                         ids=["bias", "no-bias", "music", "gqa-int8",
                              "gpt2"])
def test_sizing_equals_jax(kw):
    cfg, jcfg = GPTConfig(**kw), JaxGPTConfig(**kw)
    assert sizing.params_breakdown(cfg) == jax_sizing.params_breakdown(jcfg)
    n = sizing.params_breakdown(cfg)["non_embedding"]
    assert sizing.flops_per_token(cfg, n) == jax_sizing.flops_per_token(
        jcfg, n)
    assert dataclasses.asdict(sizing.sizing_report(cfg)) == \
        dataclasses.asdict(jax_sizing.sizing_report(jcfg))
    for mfu in (0.4, 0.55):
        assert sizing.projected_tokens_per_sec(cfg, mfu, peak=989e12) == \
            jax_sizing.projected_tokens_per_sec(jcfg, mfu, peak=989e12)


@pytest.mark.parametrize("bias", [True, False])
def test_sizing_counts_the_port_gpt(bias):
    cfg = GPTConfig(block_size=64, vocab_size=96, n_layer=3, n_head=2,
                    n_embd=32, bias=bias, dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    bd = sizing.params_breakdown(cfg)
    assert bd["total"] == model.num_params(non_embedding=False)
    assert bd["non_embedding"] == model.num_params(non_embedding=True)


def test_print_report_equals_jax(capsys):
    kw = SIZING_CONFIGS[-1]
    sizing.print_report(GPTConfig(**kw))
    ours = capsys.readouterr().out
    jax_sizing.print_report(JaxGPTConfig(**kw))
    assert ours == capsys.readouterr().out and "flops/token" in ours
    # the CPU's peak without a card
    assert sizing.projected_tokens_per_sec(GPTConfig(**kw)) > 0


@pytest.mark.parametrize("fn, args", [
    ("gpt_params", dict(seq_len=1024, vocab_size=50257, d_model=768,
                        num_heads=12, num_layers=12)),
    ("chinchilla_params", dict(seq_len=2048, vocab_size=32000, d_model=8192,
                               num_heads=64, num_layers=80,
                               ffw_size=4 * 8192)),
    ("chinchilla_flops", dict(seq_len=2048, vocab_size=32000, d_model=4096,
                              num_heads=32, num_layers=40,
                              ffw_size=4 * 4096)),
    ("chinchilla_loss", dict(n_params=1e9, n_tokens=1e11)),
    ("compute_optimal", dict(flop_budget=5.76e23)),
    ("optimal_for_params", dict(n_params=124e6)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_scaling_laws_equal_jax(fn, args):
    got, want = getattr(laws, fn)(**args), getattr(jax_laws, fn)(**args)
    if dataclasses.is_dataclass(got):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got == want
    assert (laws.E, laws.A, laws.B, laws.ALPHA, laws.BETA) == (
        jax_laws.E, jax_laws.A, jax_laws.B, jax_laws.ALPHA, jax_laws.BETA)


def test_hf_config_dict_and_object_agree(hf_dir):
    root, hf = hf_dir
    with open(root / "gpt2-tiny" / "config.json") as f:
        as_dict = json.load(f)
    assert hf_import.config_from_hf(as_dict, 0.1) == \
        hf_import.config_from_hf(hf.config, 0.1)
