"""The port's sampling CLI (ai_music_generation_tpu_torch/cli/sample.py)
against the JAX package's ``cli/sample.py``.

A char corpus of random ABC tunes (the port's copies of the JAX corpus
helpers) gives the meta.pkl; checkpoints are ``ckpt.pt`` files of JAX init
weights (``wte`` scaled by 10, so greedy choices are not near-ties): the
tests' ``tiny`` MHA model written by JAX ``save_reference_ckpt``, and a
``flat_kv`` GQA int8 model (2 layers, 4 heads, 256 wide, KH=2) written by
the port's ``save_ckpt`` and read back by JAX ``load_reference_ckpt``.
At ``dtype=float32, top_k=1`` every draw is the argmax, so both CLIs must
write the same texts, with and without ``--speculative``.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import sample as jax_sample
from ai_music_generation_tpu.models import nanogpt_ckpt as jax_ckpt
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu_torch.cli import sample
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.data.prepare import prepare_char
from ai_music_generation_tpu_torch.models.convert import state_dict_from_jax
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import (
    load_ckpt,
    save_ckpt,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(data_root, validation JSON path, midi-text dir, vocab size)."""
    root = tmp_path_factory.mktemp("corpus")
    tunes = random_tunes(40, seed=3)
    entries = [{"abc notation": t} for t in tunes]
    vocab, _, _ = prepare_char(entries[:34], entries[34:],
                               str(root / "data" / "irishman"))
    val = root / "validation.json"
    val.write_text(json.dumps([{"id": 100 + i, "abc notation": t}
                               for i, t in enumerate(tunes[34:39])]))
    midi = root / "midi_texts"
    midi.mkdir()
    (midi / "piece_a.txt").write_text("k5 | p60 d4 | p62 d4 | p64 d4 |")
    (midi / "piece_b.txt").write_text("k2 | p50 d2 p52 d2 | p55 d8")
    (midi / "notes.md").write_text("not a prompt")
    return str(root / "data"), str(val), str(midi), vocab


MODELS = {
    "mha": dict(n_layer=2, n_head=2, n_embd=32),
    "gqa-flat-int8": dict(n_layer=2, n_head=4, n_embd=256, n_kv_head=2),
}
RUNTIME = {"mha": {}, "gqa-flat-int8": dict(kv_quantized=True,
                                             flat_kv=True)}


def _write_ckpt(out_dir, name, vocab):
    """A ckpt.pt of JAX init weights in ``out_dir``."""
    kw = dict(MODELS[name], block_size=64, vocab_size=vocab, dropout=0.0)
    jcfg = JaxGPTConfig(**kw, dtype=jnp.float32)
    params = jax.device_get(JaxGPT(jcfg).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8), jnp.int32)))
    p = params["params"]
    p["wte"]["embedding"] = np.asarray(p["wte"]["embedding"]) * 10.0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ckpt.pt")
    train_config = {"dataset": "irishman", "learning_rate": 1e-3}
    if name == "mha":
        jax_ckpt.save_reference_ckpt(path, params, jcfg,
                                     train_config=train_config)
    else:
        cfg = GPTConfig(**kw, dtype=torch.float32)
        model = GPT(cfg, device="cpu")
        model.load_state_dict(state_dict_from_jax(params, cfg))
        save_ckpt(path, model, iter_num=7, train_config=train_config)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, corpus):
    vocab = corpus[3]
    root = tmp_path_factory.mktemp("ckpts")
    return {name: os.path.dirname(_write_ckpt(str(root / name), name, vocab))
            for name in MODELS}


def _config(corpus, out_dir, **kw):
    data_root, val, _, _ = corpus
    c = dict(sample.DEFAULTS)
    c.update(out_dir=out_dir, data_root=data_root, dataset="irishman",
             tokens_format="char", validation_path=val,
             n_conditional_measures=2, max_new_tokens=24, batch_size=3,
             dtype="float32", device="cpu")
    c.update(kw)
    return c


@pytest.fixture
def jax_reads_gqa(monkeypatch):
    """JAX ``load_model`` reads a ckpt.pt through ``load_reference_ckpt``,
    whose config takes only the nanoGPT model_args; a GQA file's
    ``n_kv_head`` goes in as the config override that function takes."""
    original = jax_ckpt.load_reference_ckpt

    def load(path, **overrides):
        args = torch.load(path, map_location="cpu",
                          weights_only=False)["model_args"]
        if args.get("n_kv_head"):
            overrides["n_kv_head"] = args["n_kv_head"]
        return original(path, **overrides)

    monkeypatch.setattr(jax_ckpt, "load_reference_ckpt", load)


@pytest.mark.parametrize("mode", ["fixed", "char", "midi"])
def test_prompt_iter_equals_jax(corpus, mode):
    data_root, val, midi, _ = corpus
    c = dict(sample.DEFAULTS, num_samples=4, start="$X")
    if mode == "fixed":
        c.update(use_validation_prefixes=False)
    elif mode == "char":
        c.update(dataset="irishman", tokens_format="char",
                 validation_path=val, n_conditional_measures=3)
    else:
        c.update(tokens_format="midi", validation_path=midi,
                 n_conditional_measures=2, start="$")
    got = list(sample.prompt_iter(c))
    assert got == list(jax_sample.prompt_iter(c)) and got


def test_prompt_iter_errors_equal_jax(corpus, tmp_path):
    start = tmp_path / "start.txt"
    start.write_text("$ from a file")
    c = dict(sample.DEFAULTS, use_validation_prefixes=False, num_samples=2,
             start=f"FILE:{start}")
    assert list(sample.prompt_iter(c)) == list(jax_sample.prompt_iter(c))
    for bad in (dict(validation_path=""),
                dict(validation_path="x", tokens_format="char",
                     dataset="bach")):
        c = dict(sample.DEFAULTS, **bad)
        with pytest.raises(Exception) as ours:
            list(sample.prompt_iter(c))
        with pytest.raises(Exception) as theirs:
            list(jax_sample.prompt_iter(c))
        assert type(ours.value) is type(theirs.value)


@pytest.mark.parametrize("res,sid,dataset,fmt", [
    ("$X:0\nabc|def|", 5, "irishman", "char"),
    ("$ a b | c d", 3, "bach", "midi"),
    ("$ a b | c d |", 4, "bach", "midi"),
    ("$ p60 d4 | p62 $ d4", "piece", "irishman", "midi"),
])
def test_normalize_output_equals_jax(res, sid, dataset, fmt):
    assert sample.normalize_output(res, sid, dataset, fmt) == \
        jax_sample.normalize_output(res, sid, dataset, fmt)


@pytest.mark.parametrize("fmt", ["char", "midi"])
def test_build_codec_equals_jax(corpus, tmp_path, fmt):
    data_root = corpus[0]
    if fmt == "midi":  # a whitespace vocabulary
        from ai_music_generation_tpu_torch.data.memmap import write_meta

        words = ["$", "k5", "p60", "d4", "|"]
        os.makedirs(tmp_path / "bach")
        write_meta({"stoi": {w: i for i, w in enumerate(words)},
                    "itos": dict(enumerate(words))},
                   str(tmp_path / "bach" / "meta.pkl"))
        data_root, dataset, text = str(tmp_path), "bach", "$ k5 | p60 d4 |"
    else:
        dataset, text = "irishman", "X:1\nL:1/8\nK:C\nab c|"
    meta = {"config": {"dataset": dataset}}
    enc, dec = sample.build_codec(meta, data_root, fmt)
    jenc, jdec = jax_sample.build_codec(meta, data_root, fmt)
    ids = enc(text)
    assert ids == jenc(text) and dec(ids) == jdec(ids)
    assert dec(np.asarray(ids[::-1])) == jdec(np.asarray(ids[::-1]))
    with pytest.raises(FileNotFoundError):
        sample.build_codec({"config": {"dataset": "nope"}}, data_root, fmt)


@pytest.mark.parametrize("name,spec", [("mha", False), ("mha", True),
                                       ("gqa-flat-int8", False)],
                         ids=["mha", "mha-speculative", "gqa-flat-int8"])
def test_run_sampling_texts_equal_jax(corpus, ckpts, jax_reads_gqa, name,
                                      spec):
    """fp32, top_k=1: the port's texts equal JAX's, file for file (5
    validation prompts in batches of 3); the speculative cache needs MHA."""
    c = _config(corpus, ckpts[name], top_k=1, speculative=spec, n_draft=3,
                **RUNTIME[name])
    want = jax_sample.run_sampling(dict(c), write=False)
    got = sample.run_sampling(dict(c), write=False)
    assert [i for i, _ in got] == [100 + i for i in range(5)]
    assert got == want
    assert all(text.startswith(f"X:{i}\n") for i, text in got)


def test_same_seed_and_batch_size_give_identical_files(corpus, ckpts,
                                                       tmp_path):
    c = _config(corpus, ckpts["mha"], temperature=0.9, top_k=8)
    first = sample.run_sampling(dict(c), write=False)
    assert sample.run_sampling(dict(c), write=False) == first
    assert sample.run_sampling(dict(c, seed=c["seed"] + 1),
                               write=False) != first


def test_main_writes_the_samples(corpus, ckpts):
    data_root, val, _, _ = corpus
    out = ckpts["gqa-flat-int8"]
    results = sample.main([
        f"--out_dir={out}", f"--data_root={data_root}", "--dataset=irishman",
        "--tokens_format=char", f"--validation_path={val}",
        "--n_conditional_measures=1", "--max_new_tokens=10",
        "--batch_size=5", "--kv_quantized=True",
        "--flat_kv=True", "--device=cpu", "--dtype=float32"])
    files = sorted(os.listdir(os.path.join(out, "samples")))
    assert files == [f"sample_{100 + i}.abc" for i in range(5)]
    for sid, text in results:
        with open(os.path.join(out, "samples", f"sample_{sid}.abc")) as f:
            assert f.read() == text and text.startswith(f"X:{sid}\n")


def test_ckpt_round_trip_and_jax_reads_the_port_save(corpus, ckpts,
                                                     tmp_path):
    """The port's save writes what its load and JAX's load read: the same
    weights, model_args with n_kv_head, iter_num, config; a tied head."""
    model, meta = load_ckpt(os.path.join(ckpts["gqa-flat-int8"], "ckpt.pt"),
                            device="cpu")
    assert model.config.n_kv_head == 2 and meta["iter_num"] == 7
    assert meta["config"]["dataset"] == "irishman"
    assert model.lm_head.weight is model.transformer.wte.weight
    path = str(tmp_path / "again.pt")
    save_ckpt(path, model)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert ckpt["model"]["lm_head.weight"].data_ptr() == \
        ckpt["model"]["transformer.wte.weight"].data_ptr()
    assert len(ckpt["optimizer"]["param_groups"]) == 2
    cfg, params, jmeta = jax_ckpt.load_reference_ckpt(path, n_kv_head=2)
    again = GPT(dataclasses.replace(model.config), device="cpu")
    again.load_state_dict(state_dict_from_jax(params, model.config))
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    # a reference checkpoint's torch.compile prefix and mask buffers
    sd = {f"_orig_mod.{k}": v for k, v in ckpt["model"].items()
          if k != "lm_head.weight"}
    sd["_orig_mod.transformer.h.0.attn.bias"] = torch.ones(1, 1, 64, 64)
    torch.save(dict(ckpt, model=sd), path)
    m2, _ = load_ckpt(path, device="cpu")
    assert torch.equal(m2.lm_head.weight, model.lm_head.weight)


def test_orbax_only_gpt2_and_no_card_raise(tmp_path, monkeypatch):
    """An orbax-only out_dir and a missing one raise; a GPT-2 zoo name with
    no local directory goes through transformers and, with no cached
    weights, raises the JAX CLI's RuntimeError (transformers is a stand-in
    whose loader raises as the real one then does: nothing reaches for the
    network)."""
    def offline(name, *args, **kwargs):
        raise OSError(f"we could not connect to fetch {name!r}")

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2LMHeadModel=types.SimpleNamespace(from_pretrained=offline)))
    monkeypatch.chdir(tmp_path)
    os.makedirs(tmp_path / "ckpt")
    (tmp_path / "ckpt" / "meta.json").write_text("{}")
    with pytest.raises(FileNotFoundError,
                       match="convert_ckpt gpt to-torch"):
        sample.load_model(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        sample.load_model(str(tmp_path / "empty"), device="cpu")
    with pytest.raises(RuntimeError, match="could not load 'gpt2-medium'"):
        sample.load_model(str(tmp_path), init_from="gpt2-medium",
                          device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        sample.resolve_device(sample.DEFAULTS["device"])


def test_serve_cli_builds_a_working_server(corpus, ckpts):
    """cli/serve.py's server over a ckpt.pt and its corpus's codec answers a
    text prompt with tokens and their text; ``--mesh`` without torchrun is
    refused."""
    import threading
    import urllib.request

    from ai_music_generation_tpu_torch.cli import serve as serve_cli

    c = dict(serve_cli.DEFAULTS, out_dir=ckpts["gqa-flat-int8"],
             data_root=corpus[0], tokens_format="char", port=0, n_slots=4,
             ticks_per_call=8, cache_len=32, kv_quantized=True, flat_kv=True,
             dtype="float32", device="cpu", prewarm=True)
    runner, httpd = serve_cli.build_server(c)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps({"prompt": "X:1\nK:G\n", "max_new_tokens": 12,
                             "temperature": 0.0}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert len(out["tokens"]) == 12 and len(out["text"]) == 12
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()
    # --mesh without torchrun (the mesh itself: tests/test_torch_serve_mesh)
    with pytest.raises(RuntimeError, match="torchrun"):
        serve_cli.build_server(dict(c, mesh="2x1", prewarm=False))
