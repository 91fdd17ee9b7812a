"""The port's TunesFormer trainer (cli/tunesformer_train.py) and its
checkpoint (``save_reference_checkpoint`` with the optimizer,
``optimizer_state_from_reference``) against the JAX package's CLI.

The corpus: 24 of the port's ``random_tunes`` curated by the port's
``cli/add_control_codes.py``. Runs use reference-compatible small widths
(patch_length 128 and 12 heads, which JAX's weights.pth import assumes;
patch_size 16, 2+2 layers, 48 wide), fp32, batch 4, lr 1e-3, on the CPU.
The JAX CLI is driven with its steps replaced by recorders (and ``jax.jit``
by the identity, so the recorders see arrays): the batches, their order and
the patch indices it would train on are compared with the port CLI's, run
the same way. Tolerance: the eval loss at one set of weights within 1e-5 of
its value (fp32, accumulation order); everything else is exact.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import tunesformer_train as jax_cli
from ai_music_generation_tpu.decode import tunes_generate as jax_tg
from ai_music_generation_tpu.models import tunesformer as jax_tf
from ai_music_generation_tpu.train import checkpoint as jax_ckpt
from ai_music_generation_tpu.train import tunes_step as jax_ts
from ai_music_generation_tpu_torch.cli import add_control_codes
from ai_music_generation_tpu_torch.cli import tunesformer_train as cli
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.decode.tunes_generate import (
    TunesGenerator,
)
from ai_music_generation_tpu_torch.models import tunesformer_export
from ai_music_generation_tpu_torch.models.convert import (
    init_tunesformer_weights,
    tunesformer_state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
    load_tunesformer,
)
from ai_music_generation_tpu_torch.models.tunesformer_export import (
    save_reference_checkpoint,
)
from ai_music_generation_tpu_torch.models.tunesformer_import import (
    LM_HEAD,
    optimizer_state_from_reference,
    read_reference,
    reference_key,
    unique_keys,
)
from ai_music_generation_tpu_torch.train import tunes_step
from ai_music_generation_tpu_torch.train.optimizer import (
    adamw_count,
    hf_cosine_schedule,
    optax_adamw,
)
from ai_music_generation_tpu_torch.train.tunes_step import (
    make_tunesformer_train_step,
)

torch.set_num_threads(1)

ARCH = dict(patch_length=128, patch_size=16, patch_layers=2, char_layers=2,
            n_embd=48, n_head=12)
RUN = dict(ARCH, batch_size=4, dtype="float32", learning_rate=1e-3)


def _flags(c):
    return [f"--{k}={v}" for k, v in c.items()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "abc")
    for i, tune in enumerate(random_tunes(24, seed=2)):
        (root / "abc" / f"{i:03d}.abc").write_text(tune)
    path = str(root / "data.json")
    assert add_control_codes.main([str(root / "abc"),
                                   f"--output={path}"]) == 24
    return path


def _train(corpus, out, **kw):
    return cli.main(_flags(dict(RUN, data_path=corpus, out_dir=str(out),
                                device="cpu", **kw)))


def test_defaults_and_encode_dataset_equal_jax(corpus):
    """The port's DEFAULTS are the JAX CLI's plus ``device``;
    encode_dataset gives JAX's arrays for every item."""
    extra = {k: cli.DEFAULTS[k] for k in set(cli.DEFAULTS)
             - set(jax_cli.DEFAULTS)}
    assert extra == {"device": "cuda"}
    assert {k: cli.DEFAULTS[k] for k in jax_cli.DEFAULTS} == jax_cli.DEFAULTS
    with open(corpus) as f:
        items = json.load(f)
    items.append({"control code": "S:1\n", "abc notation": "L:1/8"})
    for P, S in ((128, 16), (16, 8)):
        got = cli.encode_dataset(items, P, S)
        want = jax_cli.encode_dataset(items, P, S)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _record_port(monkeypatch, seen):
    def train_step(model, optimizer, schedule):
        def step(batch, step_count, seed=0, patch_indices=None):
            seen["train"].append(batch.numpy().copy())
            seen["idx"].append(None if patch_indices is None
                               else patch_indices.numpy().copy())
            return torch.tensor(1.0)
        return step

    def eval_step(model):
        def step(batch):
            seen["eval"].append(batch.numpy().copy())
            return torch.tensor(1.0)
        return step

    monkeypatch.setattr(tunes_step, "make_tunesformer_train_step", train_step)
    monkeypatch.setattr(tunes_step, "make_tunesformer_eval_step", eval_step)
    monkeypatch.setattr(tunesformer_export, "save_reference_checkpoint",
                        lambda *a, **k: None)


def _record_jax(monkeypatch, seen):
    def train_step(model, tx):
        def step(params, opt_state, batch, rng, patch_indices=None):
            seen["train"].append(np.asarray(batch).copy())
            seen["idx"].append(None if patch_indices is None
                               else np.asarray(patch_indices).copy())
            return params, opt_state, jnp.float32(1.0)
        return step

    def eval_step(model):
        def step(params, batch):
            seen["eval"].append(np.asarray(batch).copy())
            return jnp.float32(1.0)
        return step

    monkeypatch.setattr(jax_ts, "make_tunesformer_train_step", train_step)
    monkeypatch.setattr(jax_ts, "make_tunesformer_eval_step", eval_step)
    monkeypatch.setattr(jax_ckpt, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)


@pytest.mark.parametrize("psbs", [0, 5], ids=["full", "sampled"])
def test_split_batch_order_and_patch_indices_equal_jax(corpus, tmp_path,
                                                       monkeypatch, psbs):
    """Three epochs at batch 3 (the JAX CLI then takes its one-device path
    on the tests' 8 virtual devices): the same train batches in the same
    order, the same eval batches (the tail wrapped), the same patch
    indices."""
    c = dict(ARCH, patch_length=16, batch_size=3, num_epochs=3,
             patch_sampling_batch_size=psbs, data_path=corpus, n_embd=24)
    runs = []
    for record, main, extra in ((_record_jax, jax_cli.main, {}),
                                (_record_port, cli.main,
                                 {"device": "cpu"})):
        seen = {"train": [], "eval": [], "idx": []}
        with monkeypatch.context() as m:
            record(m, seen)
            main(_flags(dict(c, out_dir=str(tmp_path / main.__module__),
                             **extra)))
        runs.append(seen)
    jax_run, port_run = runs
    assert len(port_run["train"]) == 3 * (22 // 3)
    assert len(port_run["eval"]) == 3
    for key in ("train", "eval", "idx"):
        assert len(port_run[key]) == len(jax_run[key])
        for a, b in zip(port_run[key], jax_run[key]):
            assert (a is None and b is None) or np.array_equal(a, b)
    assert (port_run["idx"][0] is None) == (psbs == 0)


def test_eval_loss_at_one_set_of_weights_equals_jax(corpus):
    """JAX init weights in both: the port's eval step over a batch of the
    corpus equals JAX's ``make_tunesformer_eval_step`` within 1e-5."""
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_eval_step,
    )

    with open(corpus) as f:
        items = json.load(f)
    arrs = cli.encode_dataset(items, 128, 16)
    batch = np.stack(arrs[:4])
    jcfg = jax_tf.TunesFormerConfig(**ARCH, dtype=jnp.float32)
    jmodel = jax_tf.TunesFormer(jcfg)
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 16), jnp.int32), False))
    want = float(jax.jit(jax_ts.make_tunesformer_eval_step(jmodel))(
        params, jnp.asarray(batch)))
    cfg = TunesFormerConfig(**ARCH, dtype=torch.float32)
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(params, cfg))
    got = float(make_tunesformer_eval_step(model.train())(
        torch.from_numpy(batch)))
    assert abs(got - want) <= 1e-5 * abs(want)


LOG = re.compile(r"Epoch (\d+)\ntrain_loss: ([-\d.e]+)\neval_loss: "
                 r"([-\d.e]+)\ntime: \w{3} \w{3} [ \d]\d \d\d:\d\d:\d\d "
                 r"\d{4}\n\n")


def _logs(out):
    with open(os.path.join(out, "logs.txt")) as f:
        text = f.read()
    entries = LOG.findall(text)
    assert "".join(m.group(0) for m in LOG.finditer(text)) == text
    return [(int(e), float(t), float(v)) for e, t, v in entries]


@pytest.fixture(scope="module")
def two_epochs(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    return str(out), _train(corpus, out, num_epochs=2)


def test_two_epoch_run_writes_the_reference_files(two_epochs):
    """logs.txt holds an entry per epoch in the JAX CLI's format; the eval
    loss falls; weights.pth has the reference trainer's keys, the model in
    the export layout, the AdamW state over the distinct tensors (the
    unused patch wte has none) with the run's update count, the schedule
    state at that count, and the model args."""
    out, result = two_epochs
    logs = _logs(out)
    assert [e for e, _, _ in logs] == [1, 2]
    assert logs[1][2] < logs[0][2]
    assert [r["eval_loss"] for r in result["epochs"]] == [v for _, _, v
                                                          in logs]
    ckpt, state = read_reference(os.path.join(out, "weights.pth"))
    assert {"model", "optimizer", "lr_sched", "epoch", "best_epoch",
            "min_eval_loss", "model_args", "update_count"} <= set(ckpt)
    assert ckpt["epoch"] == ckpt["best_epoch"] == result["best_epoch"] == 2
    assert ckpt["min_eval_loss"] == result["min_eval_loss"] == logs[1][2]
    assert ckpt["model_args"] == dict(ARCH, share_weights=False)
    steps = sum(r["steps"] for r in result["epochs"])
    assert ckpt["update_count"] == steps == 2 * (22 // 4)
    keys = unique_keys(state, False)
    opt = ckpt["optimizer"]
    assert opt["param_groups"][0]["params"] == list(range(len(keys)))
    g = opt["param_groups"][0]
    assert (tuple(g["betas"]), g["eps"], g["weight_decay"]) == \
        ((0.9, 0.999), 1e-8, 1e-4)
    missing = [k for i, k in enumerate(keys) if i not in opt["state"]]
    assert missing == ["patch_level_decoder.base.wte.weight"]
    for i, s in opt["state"].items():
        assert float(s["step"]) == steps
        assert s["exp_avg"].shape == s["exp_avg_sq"].shape == \
            state[keys[i]].shape
    assert ckpt["lr_sched"]["last_epoch"] == steps
    assert g["lr"] == float(hf_cosine_schedule(1e-3, steps / 10, steps)(
        torch.tensor(steps)))


def test_jax_reads_the_trained_weights_and_generates_the_same_text(
        two_epochs):
    """JAX's load_tunesformer (the weights.pth import) reads the trained
    file to the port's parameters bit for bit, and JAX's generator gives
    the port generator's tunes at top_k=1."""
    out, _ = two_epochs
    jmodel, params, meta = jax_tf.load_tunesformer(out, dtype=jnp.float32)
    model, port_meta = load_tunesformer(out, dtype=torch.float32,
                                        device="cpu")
    assert meta["iter_num"] == port_meta["iter_num"] == 2
    assert port_meta["model_args"] == dict(ARCH, share_weights=False)
    want = tunesformer_state_dict_from_jax(jax.device_get(params),
                                           model.config)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    greedy = dict(top_p=0.9, top_k=1, temperature=1.0)
    prompt = "S:1\nB:8\nL:1/8\nM:3/4\nK:D\n de|"
    jtext = jax_tg.TunesGenerator(jmodel, **greedy).generate_tunes(
        params, prompt, num_tunes=2, max_patch=16, seed=3)
    text = TunesGenerator(model, **greedy).generate_tunes(
        prompt, num_tunes=2, max_patch=16, seed=3)
    assert text == jtext and len(text[0]) > len(prompt)


class _Killed(Exception):
    pass


def test_resume_is_bit_equal_to_the_straight_run(corpus, tmp_path,
                                                 two_epochs, monkeypatch):
    """The two-epoch run killed once it wrote its epoch-1 weights.pth, then
    --load_from_checkpoint (the same flags: the schedule spans the run's
    num_epochs): the same logs (but the times) and a weights.pth with the
    same tensors, moments and counts as the straight run's."""
    straight, _ = two_epochs
    out = tmp_path / "resumed"
    real = tunesformer_export.save_reference_checkpoint

    def save_then_die(*args, **kw):
        real(*args, **kw)
        raise _Killed

    with monkeypatch.context() as m:
        m.setattr(tunesformer_export, "save_reference_checkpoint",
                  save_then_die)
        with pytest.raises(_Killed):
            _train(corpus, out, num_epochs=2)
    result = _train(corpus, out, num_epochs=2, load_from_checkpoint=True)
    assert [r["epoch"] for r in result["epochs"]] == [2]
    assert _logs(str(out)) == _logs(straight)
    a, _ = read_reference(os.path.join(straight, "weights.pth"))
    b, _ = read_reference(str(out / "weights.pth"))
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for i, s in a["optimizer"]["state"].items():
        for m, v in s.items():
            assert torch.equal(b["optimizer"]["state"][i][m], v), (i, m)
    for key in ("epoch", "best_epoch", "min_eval_loss", "update_count",
                "lr_sched"):
        assert a[key] == b[key], key


def test_torch_init_fine_tunes_from_an_exported_weights_pth(corpus,
                                                            tmp_path):
    """--torch_init loads a weights.pth's weights (with a fresh optimizer):
    at lr 0 one epoch leaves them bit-equal, at lr 1e-3 it moves them."""
    cfg = TunesFormerConfig(**ARCH, dtype=torch.float32)
    src = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                   torch.Generator().manual_seed(9))
    path = str(tmp_path / "init.pth")
    save_reference_checkpoint(path, src, epoch=5)
    for lr, same in ((0.0, True), (1e-3, False)):
        out = tmp_path / f"lr{lr}"
        _train(corpus, out, num_epochs=1, torch_init=path, learning_rate=lr)
        model, meta = load_tunesformer(str(out), dtype=torch.float32,
                                       device="cpu")
        assert meta["iter_num"] == 1
        equal = [torch.equal(v, src.state_dict()[k])
                 for k, v in model.state_dict().items()]
        assert all(equal) if same else not any(equal)


def test_nan_losses_are_left_out_of_the_epoch_means(corpus, tmp_path,
                                                    monkeypatch):
    """A step whose loss is NaN counts in neither the sum nor the count."""
    real = tunes_step.make_tunesformer_train_step
    losses = []

    def every_other_nan(model, optimizer, schedule):
        step = real(model, optimizer, schedule)

        def wrapped(*args, **kw):
            loss = step(*args, **kw)
            if len(losses) % 2:
                loss = torch.tensor(float("nan"))
            losses.append(float(loss))
            return loss
        return wrapped

    monkeypatch.setattr(tunes_step, "make_tunesformer_train_step",
                        every_other_nan)
    result = _train(corpus, tmp_path / "nan", num_epochs=1)
    finite = [v for v in losses if v == v]
    assert len(finite) == (len(losses) + 1) // 2 > 1
    assert result["epochs"][0]["train_loss"] == sum(finite) / len(finite)


def test_n_model_above_one_raises(corpus, tmp_path):
    """Without a process group ``--n_model 2`` raises naming torchrun, as
    the GPT ``Trainer`` does (the mesh runs:
    tests/test_torch_parallel_tunes.py)."""
    with pytest.raises(RuntimeError, match="torchrun"):
        _train(corpus, tmp_path, n_model=2)


@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_checkpoint_optimizer_state_round_trips(share, tmp_path):
    """save_reference_checkpoint with the port's AdamW after two steps,
    read back by optimizer_state_from_reference into a fresh optimizer:
    every moment and count bit-equal; the moments of a Conv1D weight are
    stored transposed, as the weight is; the tied head has no entry of its
    own."""
    cfg = TunesFormerConfig(**dict(ARCH, patch_length=16),
                            share_weights=share, dropout=0.0,
                            dtype=torch.float32)
    model = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                     torch.Generator().manual_seed(1))
    opt = optax_adamw(model.parameters())
    step = make_tunesformer_train_step(model, opt,
                                       hf_cosine_schedule(1e-3, 1.0, 10))
    rng = np.random.default_rng(0)
    for i in range(2):
        step(torch.from_numpy(rng.integers(0, 128, (2, 16, 16)).astype(
            np.int32)), i)
    path = str(tmp_path / "weights.pth")
    save_reference_checkpoint(path, model, optimizer=opt, base_lr=1e-3)
    ckpt, state = read_reference(path)
    keys = unique_keys(state, share)
    assert LM_HEAD not in keys and len(keys) == len(
        set(map(id, state.values())))
    fresh = optax_adamw(model.parameters())
    fresh.load_state_dict(optimizer_state_from_reference(ckpt, model, fresh))
    assert float(adamw_count(fresh)) == 2 == ckpt["update_count"]
    for p in model.parameters():
        for m in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.state[p][m], opt.state[p][m])
    name = "core.h.1.mlp.c_fc.weight" if share else \
        "char_core.h.1.mlp.c_fc.weight"
    key, transposed = reference_key(name, share)
    p = dict(model.named_parameters())[name]
    saved = ckpt["optimizer"]["state"][keys.index(key)]["exp_avg"]
    assert transposed and torch.equal(saved, opt.state[p]["exp_avg"].T)
