"""The port's train step (ai_music_generation_tpu_torch/train/) against the
JAX package's ``make_train_step`` on the same weights and batches.

Tiny models (2 layers, 4 heads, 64 wide, block 32, vocab 64), MHA and GQA
(KH=2), bias on and off, accum 1 and 2, the clip triggered (limit 0.01,
below every grad norm here) and not (limit 1000); x and y from numpy with
a seed, the last 3 targets of each row ignored (-1). JAX params go through
``state_dict_from_jax``. Each case takes 3 steps of both and compares after
each.

Tolerances: fp32 differs by accumulation order only; the loss and
``grad_norm`` agree to 1e-5 of their value and every parameter to 1e-5 of
the largest parameter magnitude (the range; observed up to 4.7e-6: Adam's
first steps are nearly lr * sign(g), which amplifies the rounding of a
gradient near eps). bf16 computes the products and the logits in bf16 in
both, rounded at other places: the loss and ``grad_norm`` agree to 2^-8 of
their value and the parameters to 2^-8 of the range (observed 1.4e-3, about
one lr-sized update of a near-tie gradient sign).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.train import optimizer as jax_opt
from ai_music_generation_tpu.train.step import TrainState
from ai_music_generation_tpu.train.step import make_train_step as jax_step
from ai_music_generation_tpu_torch.models.convert import state_dict_from_jax
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.train.optimizer import (
    cosine_warmup_schedule,
    make_optimizer,
)
from ai_music_generation_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

V = 64
LR = dict(learning_rate=1e-3, warmup_iters=2, lr_decay_iters=10, min_lr=1e-4)
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)}


def _models(kh, bias, dtype, clip):
    jd, td, _ = DTYPES[dtype]
    common = dict(block_size=32, vocab_size=V, n_layer=2, n_head=4,
                  n_embd=64, n_kv_head=kh, bias=bias, dropout=0.0)
    jmodel = JaxGPT(JaxGPTConfig(**common, dtype=jd))
    cfg = GPTConfig(**common, dtype=td)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))
    schedule = jax_opt.cosine_warmup_schedule(*LR.values())
    tx = jax_opt.make_optimizer(schedule, 0.1, 0.9, 0.95, clip)
    state = TrainState.create(params, tx)
    jstep = jax.jit(jax_step(jmodel, tx, schedule))
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params), cfg))
    step = make_train_step(
        model, make_optimizer(model, LR["learning_rate"], 0.1, 0.9, 0.95),
        cosine_warmup_schedule(*LR.values()), clip)
    return cfg, state, jstep, model, step


def _batches(accum, steps=3, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x = rng.integers(0, V, (accum, 3, 32)).astype(np.int32)
        y = rng.integers(0, V, (accum, 3, 32)).astype(np.int32)
        y[..., -3:] = -1
        yield x, y


def _check(cfg, jstate, jmetrics, model, metrics, tol):
    for key in ("loss", "grad_norm"):
        want = float(jmetrics[key])
        assert abs(float(metrics[key]) - want) <= tol * abs(want), key
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), abs=1e-9)
    want = state_dict_from_jax(jax.device_get(jstate.params), cfg)
    got = model.state_dict()
    span = max(float(v.abs().max()) for v in want.values())
    for name, value in want.items():
        err = float((got[name] - value).abs().max())
        assert err <= tol * span, (name, err / span)


CASES = list(itertools.product([None, 2], [True, False], [1, 2],
                               [1e-2, 1e3]))


@pytest.mark.parametrize(
    "kh,bias,accum,clip", CASES,
    ids=[f"{'gqa' if kh else 'mha'}-{'bias' if b else 'nobias'}-accum{a}-"
         f"{'clipped' if c < 1 else 'unclipped'}" for kh, b, a, c in CASES])
def test_fp32_train_steps_match_jax(kh, bias, accum, clip):
    cfg, jstate, jstep, model, step = _models(kh, bias, "fp32", clip)
    for i, (x, y) in enumerate(_batches(accum)):
        jstate, jmetrics = jstep(jstate, x, y, jax.random.PRNGKey(0))
        metrics = step(torch.from_numpy(x), torch.from_numpy(y), i)
        # the case's premise: the clip triggered, or not
        assert (float(jmetrics["grad_norm"]) > clip) == (clip < 1)
        _check(cfg, jstate, jmetrics, model, metrics, DTYPES["fp32"][2])


@pytest.mark.parametrize("kh", [None, 2], ids=["mha", "gqa"])
def test_bf16_train_steps_match_jax(kh):
    cfg, jstate, jstep, model, step = _models(kh, False, "bf16", 1.0)
    for i, (x, y) in enumerate(_batches(2)):
        jstate, jmetrics = jstep(jstate, x, y, jax.random.PRNGKey(0))
        metrics = step(torch.from_numpy(x), torch.from_numpy(y), i)
        _check(cfg, jstate, jmetrics, model, metrics, DTYPES["bf16"][2])
