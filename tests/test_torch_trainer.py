"""The port's Trainer, cli/train.py and cli/train_bench.py on the CPU, on a
tiny learnable corpus (the tests/test_trainer.py corpus with a "$" tune
marker, and its config: 2 layers, 2 heads, 32 wide, block 32, fp32): the
loss falls; resume continues where the run stopped, bit for bit, with the
architecture of the checkpoint; ``init_from=<path>.pt`` fine-tunes; a
uint32 corpus trains; the refused options raise; the sampling CLI reads
what the trainer writes.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.cli import sample as sample_cli
from ai_music_generation_tpu_torch.cli import train as train_cli
from ai_music_generation_tpu_torch.cli import train_bench
from ai_music_generation_tpu_torch.data.memmap import write_bin, write_meta
from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import (
    read_ckpt,
    save_ckpt,
)
from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib
from ai_music_generation_tpu_torch.train.trainer import DEFAULTS, Trainer

torch.set_num_threads(1)


def _write_corpus(d, text, dtype=np.uint16):
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.array([stoi[c] for c in text], dtype)
    split = int(0.9 * len(ids))
    d.mkdir(parents=True)
    write_bin(ids[:split], str(d / "train.bin"), dtype)
    write_bin(ids[split:], str(d / "val.bin"), dtype)
    write_meta({"vocab_size": len(chars), "stoi": stoi,
                "itos": dict(enumerate(chars)),
                "bin_dtype": np.dtype(dtype).name}, str(d / "meta.pkl"))
    return len(chars)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    text = ("$abcdefg|ABCDEFG|" * 2000) + ("$gfedcba|GFEDCBA|" * 2000)
    vocab = _write_corpus(root / "tinymusic", text)
    return str(root), vocab


def make_config(root, out_dir, **kw):
    c = dict(DEFAULTS)
    c.update(
        dataset="tinymusic", data_root=root, out_dir=out_dir,
        n_layer=2, n_head=2, n_embd=32, block_size=32, batch_size=4,
        gradient_accumulation_steps=8, max_iters=20, eval_interval=10,
        eval_iters=4, log_interval=10, warmup_iters=2, lr_decay_iters=20,
        learning_rate=1e-2, min_lr=1e-3, dtype="float32", dropout=0.0,
        device="cpu",
    )
    c.update(kw)
    return c


def _losses(out):
    with open(os.path.join(out, "losses.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_train_loss_decreases(corpus, tmp_path, dropout):
    root, vocab = corpus
    out = str(tmp_path / "out")
    trainer = Trainer(make_config(root, out, dropout=dropout))
    assert trainer.model_args["vocab_size"] == vocab
    assert trainer.tokens_per_iter == 8 * 4 * 32
    best = trainer.run()
    losses = _losses(out)
    assert [r["iter"] for r in losses] == [0, 10, 20]
    assert set(losses[0]) == {"iter", "train/loss", "val/loss", "lr", "mfu"}
    assert losses[0]["val/loss"] > best and best < 2.0
    assert losses[-1]["mfu"] > 0  # the EMA starts after 5 iterations
    for name in (ckpt_lib.BEST, ckpt_lib.LAST):
        assert ckpt_lib.checkpoint_exists(out, name)
    ckpt = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    assert set(ckpt) == {"model", "optimizer", "model_args", "iter_num",
                         "best_val_loss", "config"}
    assert ckpt["iter_num"] == 20 and ckpt["best_val_loss"] == best
    assert len(ckpt["optimizer"]["state"]) == len(
        list(trainer.model.parameters()))
    assert ckpt["config"]["dataset"] == "tinymusic"


def test_resume_continues_bit_for_bit(corpus, tmp_path):
    """10 iterations, then a resume to 15, ends where one run to 15 ends:
    the same weights and optimizer state (the batches and dropout masks are
    functions of the iteration)."""
    root, _ = corpus
    kw = dict(dropout=0.2, eval_interval=5, log_interval=1)
    whole = Trainer(make_config(root, str(tmp_path / "whole"), max_iters=14,
                                **kw))
    whole.run()
    out = str(tmp_path / "split")
    Trainer(make_config(root, out, max_iters=10, **kw)).run()
    t2 = Trainer(make_config(root, out, max_iters=14, init_from="resume",
                             **kw))
    assert t2.iter_num == 10 and t2.best_val_loss < 1e9
    t2.run()
    assert t2.iter_num == 15
    for a, b in zip(whole.model.parameters(), t2.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(whole.optimizer.state.values(),
                    t2.optimizer.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_resume_forces_arch_from_checkpoint(corpus, tmp_path):
    root, _ = corpus
    out = str(tmp_path / "out")
    Trainer(make_config(root, out, max_iters=10, n_kv_head=1)).run()
    t2 = Trainer(make_config(root, out, max_iters=12, init_from="resume",
                             n_embd=64, n_layer=3))
    assert t2.model_args["n_embd"] == 32 and t2.model_args["n_layer"] == 2
    assert t2.gpt_config.kv_heads == 1
    t2.run()
    assert t2.iter_num == 13


def test_resume_without_a_checkpoint_raises_with_hints(corpus, tmp_path):
    root, _ = corpus
    out = tmp_path / "out"
    with pytest.raises(FileNotFoundError, match="no last_iter_ckpt.pt"):
        Trainer(make_config(root, str(out), init_from="resume"))
    model = GPT(GPTConfig(block_size=32, vocab_size=16, n_layer=1, n_head=2,
                          n_embd=32), device="cpu")
    save_ckpt(str(out / "ckpt.pt"), model)
    with pytest.raises(FileNotFoundError, match="--init_from=.*ckpt.pt"):
        Trainer(make_config(root, str(out), init_from="resume"))
    jax_dir = tmp_path / "jax_out" / "last_iter_ckpt"
    jax_dir.mkdir(parents=True)
    (jax_dir / "meta.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="orbax"):
        Trainer(make_config(root, str(tmp_path / "jax_out"),
                            init_from="resume"))


def test_init_from_a_ckpt_pt_fine_tunes(corpus, tmp_path):
    """Architecture and weights from the file, optimizer and iteration
    fresh."""
    root, vocab = corpus
    cfg = GPTConfig(block_size=32, vocab_size=vocab, n_layer=2, n_head=2,
                    n_embd=48, bias=False)
    src = init_weights(GPT(cfg, device="cpu"),
                       torch.Generator().manual_seed(9))
    pt = str(tmp_path / "ref_ckpt.pt")
    save_ckpt(pt, src, iter_num=500)
    t = Trainer(make_config(root, str(tmp_path / "out"), max_iters=2,
                            init_from=pt, n_embd=32))
    assert t.model_args["n_embd"] == 48 and t.iter_num == 0
    assert torch.equal(t.model.transformer.wte.weight,
                       src.transformer.wte.weight)
    assert not t.optimizer.state
    t.run()


def test_train_on_uint32_corpus(tmp_path):
    words = [f"<{i}>" for i in range(200)]
    text = "".join(words) * 20
    _write_corpus(tmp_path / "data" / "bigvocab", text, np.uint32)
    t = Trainer(make_config(str(tmp_path / "data"), str(tmp_path / "out"),
                            dataset="bigvocab", max_iters=3, eval_interval=3,
                            eval_iters=1))
    assert t.train_data.dtype == np.uint32
    t.run()
    assert t.iter_num == 4


def test_vocab_falls_back_to_50304_without_meta(corpus, tmp_path):
    root, _ = corpus
    d = tmp_path / "data" / "nometa"
    d.mkdir(parents=True)
    for name in ("train.bin", "val.bin"):
        write_bin(np.arange(400) % 50, str(d / name))
    t = Trainer(make_config(str(tmp_path / "data"), str(tmp_path / "out"),
                            dataset="nometa", eval_only=True, eval_iters=1))
    assert t.meta_vocab_size is None and t.gpt_config.vocab_size == 50304
    t.run()
    assert t.iter_num == 0 and len(_losses(str(tmp_path / "out"))) == 1


@pytest.mark.parametrize("kw,error,match", [
    # a zoo name without a local directory or cached weights (transformers
    # a stand-in whose loader raises as the real one does offline): the JAX
    # trainer's error
    (dict(init_from="gpt2"), RuntimeError, "could not load 'gpt2'"),
    (dict(init_from="gpt2-xl"), RuntimeError, "could not load 'gpt2-xl'"),
    # the mesh knobs need a process group (torchrun); under one they train
    # (tests/test_torch_parallel_steps.py)
    (dict(fsdp=True), RuntimeError, "torchrun"),
    (dict(n_expert=2, n_model=2), RuntimeError, "torchrun"),
    (dict(n_model=2), RuntimeError, "torchrun"),
    (dict(init_from="nothing"), ValueError, "unknown init_from"),
], ids=["gpt2", "gpt2-xl", "fsdp", "n_expert", "n_model", "unknown"])
def test_refused_options_raise(corpus, tmp_path, monkeypatch, kw, error,
                               match):
    def offline(name, *args, **kwargs):
        raise OSError(f"we could not connect to fetch {name!r}")

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2LMHeadModel=types.SimpleNamespace(from_pretrained=offline)))
    monkeypatch.chdir(tmp_path)
    root, _ = corpus
    with pytest.raises(error, match=match):
        Trainer(make_config(root, str(tmp_path / "out"), **kw))


def test_the_card_is_the_default_device(corpus, tmp_path, monkeypatch):
    root, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = make_config(root, str(tmp_path / "out"))
    c["device"] = DEFAULTS["device"]
    assert c["device"] == "cuda"
    with pytest.raises(RuntimeError, match="--device=cpu"):
        Trainer(c)


def test_train_cli_then_sample_cli(corpus, tmp_path, capsys):
    """cli/train.py with a config file and flags writes a ckpt.pt that
    cli/sample.py samples from (a fixed start prompt, 8 new tokens)."""
    root, _ = corpus
    out = str(tmp_path / "out")
    cfg = tmp_path / "exp.py"
    cfg.write_text("n_layer = 2\nn_head = 2\nn_embd = 32\nblock_size = 32\n"
                   "dataset = 'tinymusic'\nalways_save_checkpoint = False\n")
    best = train_cli.main([
        str(cfg), f"--data_root={root}", f"--out_dir={out}",
        "--batch_size=4", "--gradient_accumulation_steps=2",
        "--max_iters=20", "--eval_interval=10", "--eval_iters=2",
        "--log_interval=5", "--warmup_iters=2", "--lr_decay_iters=20",
        "--learning_rate=0.01", "--dtype=float32", "--device=cpu"])
    text = capsys.readouterr().out
    assert "tokens per iteration will be: 256" in text
    assert f"best val loss: {best:.4f}" in text
    assert "iter 15: loss" in text
    results = sample_cli.main([
        f"--out_dir={out}", f"--data_root={root}", "--dataset=tinymusic",
        "--tokens_format=char", "--use_validation_prefixes=False",
        "--start=$abc", "--num_samples=3", "--max_new_tokens=8",
        "--batch_size=3", "--device=cpu"])
    assert len(results) == 3
    assert read_ckpt(os.path.join(out, "ckpt.pt"))["iter_num"] in (10, 20)


def test_config_copies_drive_the_cli_flags(tmp_path):
    """The port's copies of the training configs apply to the trainer's
    defaults: every key they set is a trainer key."""
    from ai_music_generation_tpu_torch.utils.configurator import (
        apply_overrides,
    )

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, want in (("irishman_char.py", dict(batch_size=64, n_layer=6,
                                                 dropout=0.2, block_size=256)),
                       ("train_gpt2.py", dict(batch_size=12, block_size=1024,
                                              gradient_accumulation_steps=40))):
        path = os.path.join(here, "ai_music_generation_tpu_torch", "configs",
                            name)
        c = apply_overrides(DEFAULTS, [path])
        assert {k: c[k] for k in want} == want


def test_train_bench_on_the_cpu():
    res = train_bench.main([
        "--device=cpu", "--n_layer=2", "--n_head=2", "--n_embd=32",
        "--block_size=32", "--batch_size=2", "--vocab_size=64",
        "--burn_in=1", "--num_steps=2", "--dtype=float32", "--remat=True"])
    assert res["ms"] > 0 and res["mfu"] > 0 and np.isfinite(res["loss"])
    assert res["peak_bytes"] is None
