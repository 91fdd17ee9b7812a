"""The port's TunesFormer train step (train/tunes_step.py, optax_adamw and
hf_cosine_schedule in train/optimizer.py) against the JAX package's
``make_tunesformer_train_step`` under ``optax.adamw(hf_cosine_schedule)``,
and the port's TunesFormer dropout.

Config: 2+2 layers, 32 wide, 2 heads, a 16x16 patch grid, batch 2, dropout
0 for the comparisons; with and without ``share_weights`` and
``patch_indices``. JAX init weights cross through
``tunesformer_state_dict_from_jax``; batches (bos-framed ASCII bars with
padding) and patch indices come from numpy seeds. The schedule: lr 1e-3,
30 steps, 3.0 warmup steps (lr 0 at step 0, so the first update moves the
moments only).

Tolerances: fp32 differs by accumulation order only; after each of 3 steps
the loss agrees to 1e-5 of its value and every parameter (and Adam moment)
to 1e-5 of the range (the largest magnitude of its kind). bf16 rounds every
product and the logits in bf16 in both, at other places: 2^-8 of the
value and of the range. The NaN guard is held bit for bit.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ai_music_generation_tpu.cli.tunesformer_train import (
    hf_cosine_schedule as jax_schedule,
)
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormer as JaxTunesFormer,
)
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormerConfig as JaxConfig,
)
from ai_music_generation_tpu.train.tunes_step import (
    make_tunesformer_train_step as jax_train_step,
)
from ai_music_generation_tpu_torch.cli.tunesformer_train import (
    patch_indices_for,
)
from ai_music_generation_tpu_torch.experiments import tunes_mfu
from ai_music_generation_tpu_torch.models import gpt
from ai_music_generation_tpu_torch.models import tunesformer as tf_module
from ai_music_generation_tpu_torch.models.convert import (
    init_tunesformer_weights,
    tunes_optimizer_state_from_jax,
    tunesformer_state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.tunesformer import (
    CHAR_CORE,
    PATCH_CORE,
    TunesFormer,
    TunesFormerConfig,
    core_dropout_key,
)
from ai_music_generation_tpu_torch.train.optimizer import (
    ADAMW_WEIGHT_DECAY,
    adamw_count,
    hf_cosine_schedule,
    optax_adamw,
)
from ai_music_generation_tpu_torch.train.tunes_step import (
    make_tunesformer_eval_step,
    make_tunesformer_train_step,
)

torch.set_num_threads(1)

TINY = dict(patch_length=16, patch_size=16, patch_layers=2, char_layers=2,
            n_embd=32, n_head=2)
LR, TOTAL = 1e-3, 30
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)}
B, K = 2, 5


def _setup(share, dtype="fp32", weight_decay=ADAMW_WEIGHT_DECAY):
    """(JAX model, params, opt_state, jitted step, port model, optimizer,
    port step)."""
    jd, td, _ = DTYPES[dtype]
    jmodel = JaxTunesFormer(JaxConfig(**TINY, dropout=0.0,
                                      share_weights=share, dtype=jd))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 16, 16), jnp.int32))
    tx = optax.adamw(jax_schedule(LR, TOTAL / 10, TOTAL),
                     weight_decay=weight_decay)
    opt_state = tx.init(params["params"])
    jstep = jax.jit(jax_train_step(jmodel, tx))
    cfg = TunesFormerConfig(**TINY, dropout=0.0, share_weights=share,
                            dtype=td)
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(
        jax.device_get(params), cfg))
    opt = optax_adamw(model.parameters(), weight_decay)
    step = make_tunesformer_train_step(
        model, opt, hf_cosine_schedule(LR, TOTAL / 10, TOTAL))
    return jmodel, params, opt_state, jstep, model, opt, step


def _batch(seed):
    """[B, 16, 16] patch stacks: bos-framed bars of ASCII chars with a
    random length, then fully padded patches."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, 16, 16), np.int32)
    for b in range(B):
        n = int(rng.integers(8, 16))
        for p in range(n):
            m = int(rng.integers(3, 16))
            x[b, p, 0] = 1
            x[b, p, 1:m] = rng.integers(3, 128, m - 1)
            x[b, p, m] = 2 if m < 16 else x[b, p, m - 1]
    return x


def _span(tensors):
    return max(float(v.abs().max()) for v in tensors.values())


def _check_params(jparams, model, tol):
    want = tunesformer_state_dict_from_jax(jax.device_get(jparams),
                                           model.config)
    got = model.state_dict()
    span = _span(want)
    for name, value in want.items():
        err = float((got[name].float() - value).abs().max())
        assert err <= tol * span, (name, err / span)


def _check_moments(jopt, model, opt, tol):
    want = tunes_optimizer_state_from_jax(jax.device_get(jopt), model, opt)
    got = opt.state_dict()["state"]
    for m in ("exp_avg", "exp_avg_sq"):
        span = max(float(s[m].abs().max()) for s in want["state"].values())
        for i, s in want["state"].items():
            err = float((got[i][m] - s[m]).abs().max())
            assert err <= tol * span, (m, i, err / span)
    assert all(float(s["step"]) == float(adamw_count(opt))
               for s in want["state"].values())


CASES = [(s, k, ADAMW_WEIGHT_DECAY)
         for s, k in itertools.product([False, True], [False, True])]
# optax's decay reaches every parameter, biases and LayerNorms included,
# the tied char_wte (and, shared, the one core) once: at 0.5 the decay term
# moves a parameter by 5e-4 of its value a step, so a masked parameter or
# a decay applied twice misses the 1e-5 yardstick by far
DECAY_CASES = [(False, False, 0.5), (True, False, 0.5)]


def _case_id(share, subset, weight_decay):
    name = f"{'shared' if share else 'split'}-{'indices' if subset else 'full'}"
    return name if weight_decay == ADAMW_WEIGHT_DECAY \
        else f"{name}-decay{weight_decay}"


@pytest.mark.parametrize("share,subset,weight_decay", CASES + DECAY_CASES,
                         ids=[_case_id(*c) for c in CASES + DECAY_CASES])
def test_fp32_train_steps_match_jax(share, subset, weight_decay):
    """3 steps of both from the same params (optax.adamw's decay, and 0.5
    against ``optax.adamw(weight_decay=0.5)``): the loss, the parameters
    and the Adam moments after each; the count of updates is JAX's."""
    jmodel, params, jopt, jstep, model, opt, step = _setup(
        share, weight_decay=weight_decay)
    tol = DTYPES["fp32"][2]
    for i in range(3):
        x = _batch(i)
        idx = patch_indices_for(0, i, B, K, 16) if subset else None
        params, jopt, jloss = jstep(
            params, jopt, jnp.asarray(x), jax.random.PRNGKey(0),
            None if idx is None else jnp.asarray(idx))
        loss = step(torch.from_numpy(x), i, 0,
                    None if idx is None else torch.from_numpy(idx))
        assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
        _check_params(params, model, tol)
        _check_moments(jopt, model, opt, tol)
    assert float(adamw_count(opt)) == 3



@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_bf16_train_steps_match_jax(share):
    jmodel, params, jopt, jstep, model, opt, step = _setup(share, "bf16")
    tol = DTYPES["bf16"][2]
    for i in range(3):
        x = _batch(10 + i)
        idx = patch_indices_for(1, i, B, K, 16)
        params, jopt, jloss = jstep(params, jopt, jnp.asarray(x),
                                    jax.random.PRNGKey(0), jnp.asarray(idx))
        loss = step(torch.from_numpy(x), i, 0, torch.from_numpy(idx))
        assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
        _check_params(params, model, tol)


def test_step_k_plus_one_from_a_converted_optax_state():
    """Two JAX steps, then the JAX params and optax state converted into a
    fresh port model and optimizer (``tunes_optimizer_state_from_jax``):
    the third step agrees with JAX's."""
    jmodel, params, jopt, jstep, _, _, _ = _setup(False)
    for i in range(2):
        params, jopt, _ = jstep(params, jopt, jnp.asarray(_batch(i)),
                                jax.random.PRNGKey(0), None)
    cfg = TunesFormerConfig(**TINY, dropout=0.0, dtype=torch.float32)
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(
        jax.device_get(params), cfg))
    opt = optax_adamw(model.parameters())
    opt.load_state_dict(tunes_optimizer_state_from_jax(
        jax.device_get(jopt), model, opt))
    assert float(adamw_count(opt)) == 2
    step = make_tunesformer_train_step(
        model, opt, hf_cosine_schedule(LR, TOTAL / 10, TOTAL))
    x = _batch(2)
    params, jopt, jloss = jstep(params, jopt, jnp.asarray(x),
                                jax.random.PRNGKey(0), None)
    loss = step(torch.from_numpy(x), 2)
    tol = DTYPES["fp32"][2]
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    _check_params(params, model, tol)
    _check_moments(jopt, model, opt, tol)


def _bits(t):
    return t.detach().clone().view(torch.int32)


def test_nan_guard_leaves_every_bit_and_the_count():
    """A NaN parameter makes both losses non-finite: the port's parameters,
    moments and count stay bit-equal (JAX's params stay too); with the
    parameter restored, the next step's lr is the schedule at optax's
    count and the step agrees with JAX's."""
    jmodel, params, jopt, jstep, model, opt, step = _setup(False)
    x = _batch(0)
    params, jopt, _ = jstep(params, jopt, jnp.asarray(x),
                            jax.random.PRNGKey(0), None)
    step(torch.from_numpy(x), 0)
    good_bias = np.array(params["params"]["patch_embedding"]["bias"])
    poisoned = jax.tree_util.tree_map(lambda a: a, params)
    poisoned["params"]["patch_embedding"]["bias"] = jnp.asarray(
        good_bias).at[0].set(jnp.nan)
    good = float(model.patch_embedding.bias[0].detach())
    with torch.no_grad():
        model.patch_embedding.bias[0] = float("nan")
    before = {n: _bits(p) for n, p in model.named_parameters()}
    moments = [(_bits(s["exp_avg"]), _bits(s["exp_avg_sq"]),
                float(s["step"])) for s in opt.state.values()]
    jparams, jopt2, jloss = jstep(poisoned, jopt, jnp.asarray(_batch(1)),
                                  jax.random.PRNGKey(0), None)
    loss = step(torch.from_numpy(_batch(1)), 1)
    assert not np.isfinite(float(jloss)) and not torch.isfinite(loss)
    for n, p in model.named_parameters():
        assert torch.equal(_bits(p), before[n]), n
    for (m, v, c), s in zip(moments, opt.state.values()):
        assert torch.equal(_bits(s["exp_avg"]), m)
        assert torch.equal(_bits(s["exp_avg_sq"]), v)
        assert float(s["step"]) == c == 1
    counts = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jopt2)
              if np.asarray(leaf).dtype == np.int32]
    assert counts and all(int(c) == 1 for c in counts)
    # restored: the next finite step reads the schedule at count 1
    with torch.no_grad():
        model.patch_embedding.bias[0] = good
    sched = hf_cosine_schedule(LR, TOTAL / 10, TOTAL)
    assert float(sched(adamw_count(opt))) == pytest.approx(
        float(jax_schedule(LR, TOTAL / 10, TOTAL)(1)), rel=1e-6)
    x = _batch(2)
    params, jopt2, jloss = jstep(params, jopt2, jnp.asarray(x),
                                 jax.random.PRNGKey(0), None)
    loss = step(torch.from_numpy(x), 2)
    tol = DTYPES["fp32"][2]
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    _check_params(params, model, tol)
    assert float(adamw_count(opt)) == 2


def test_hf_cosine_schedule_equals_jax_at_every_step():
    for total in (30, 7, 113):
        want = jax_schedule(LR, total / 10, total)
        got = hf_cosine_schedule(LR, total / 10, total)
        steps = np.arange(total + 2)
        w = np.asarray(jax.vmap(want)(jnp.asarray(steps)))
        g = got(torch.from_numpy(steps)).numpy()
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)


# -- dropout ------------------------------------------------------------------

P = 0.25


def _tiny(share=False, p=P, dtype=torch.float32, seed=0):
    cfg = TunesFormerConfig(**TINY, dropout=p, share_weights=share,
                            dtype=dtype)
    return init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                    torch.Generator().manual_seed(seed))


def test_keep_rate_is_one_minus_p():
    """Each core's masks keep 1 - p of the elements: over 2^17 elements a
    site, within 5 standard deviations (0.006)."""
    key = gpt.dropout_key(3, 11)
    for core in (PATCH_CORE, CHAR_CORE):
        for site in range(4):
            keep = gpt.dropout_keep((1 << 17,), P, core_dropout_key(key, core),
                                    1, site)
            assert abs(float(keep.float().mean()) - (1 - P)) < 0.006


class _Sites:
    """Records every dropout call of the model's forward: (shape, p, key,
    layer, site) and its mask."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tf_module.dropout

        def record(x, p, key, layer, site, *mesh):
            self.calls.append((tuple(x.shape), p, key, layer, site))
            return real(x, p, key, layer, site, *mesh)

        monkeypatch.setattr(tf_module, "dropout", record)
        monkeypatch.setattr(gpt, "dropout", record)


@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_dropout_sites_and_keys_per_core(share, monkeypatch):
    """The train-mode loss drops at each core's embedding sum and at three
    sites in every layer, the patch core under core_dropout_key(key,
    PATCH_CORE) and the char core under CHAR_CORE (also with one shared
    core); the two cores' masks at a same-shaped site differ."""
    model = _tiny(share).train()
    sites = _Sites(monkeypatch)
    key = gpt.dropout_key(5, 2)
    model(torch.from_numpy(_batch(0)), dropout_key=key)
    layers = 2
    pkey, ckey = (core_dropout_key(key, c) for c in (PATCH_CORE, CHAR_CORE))
    assert pkey != ckey
    want = ([(pkey, 0, gpt.SITE_EMBED)]
            + [(pkey, i, s) for i in range(layers)
               for s in (gpt.SITE_ATTN_PROBS, gpt.SITE_ATTN_OUT,
                         gpt.SITE_MLP_OUT)]
            + [(ckey, 0, gpt.SITE_EMBED)]
            + [(ckey, i, s) for i in range(layers)
               for s in (gpt.SITE_ATTN_PROBS, gpt.SITE_ATTN_OUT,
                         gpt.SITE_MLP_OUT)])
    got = [(k, layer, site) for _, p, k, layer, site in sites.calls]
    assert sorted(got) == sorted(want) and all(
        p == P for _, p, *_ in sites.calls)
    shape = (4096,)
    masks = {(k, layer, site): gpt.dropout_keep(shape, P, k, layer, site)
             for k, layer, site in want}
    # distinct (core, layer, site) give distinct masks, agreeing about as
    # often as independent ones would (p^2 + (1-p)^2 = 0.625)
    for a, b in itertools.combinations(masks, 2):
        agree = float((masks[a] == masks[b]).float().mean())
        assert 0.58 < agree < 0.67, (a, b, agree)


def test_masks_are_a_function_of_the_key():
    model = _tiny().train()
    x = torch.from_numpy(_batch(1))
    a = model(x, dropout_key=gpt.dropout_key(1, 7))
    b = model(x, dropout_key=gpt.dropout_key(1, 7))
    c = model(x, dropout_key=gpt.dropout_key(1, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_eval_and_p0_equal_the_deterministic_forward():
    x = torch.from_numpy(_batch(2))
    dropped = _tiny(p=P)
    plain = _tiny(p=0.0)
    want = plain.eval()(x)
    assert torch.equal(dropped.eval()(x), want)
    assert torch.equal(plain.train()(x), want)
    assert torch.equal(plain.train()(x, dropout_key=9), want)
    assert not torch.equal(dropped.train()(x, dropout_key=9), want)
    with pytest.raises(ValueError, match="dropout_key"):
        dropped.train()(x)


def test_train_step_with_dropout_is_deterministic_and_evals_in_eval_mode():
    """Two models from one init take the same dropout step bit for bit;
    the eval step is the eval-mode loss and leaves the model in eval
    mode."""
    runs = []
    for _ in range(2):
        model = _tiny()
        opt = optax_adamw(model.parameters())
        step = make_tunesformer_train_step(
            model, opt, hf_cosine_schedule(LR, TOTAL / 10, TOTAL))
        for i in range(2):
            step(torch.from_numpy(_batch(i)), i, seed=4)
        runs.append(model)
    for (n, a), b in zip(runs[0].state_dict().items(),
                         runs[1].state_dict().values()):
        assert torch.equal(a, b), n
    x = torch.from_numpy(_batch(5))
    loss = make_tunesformer_eval_step(runs[0])(x)
    assert not runs[0].training and not loss.requires_grad
    assert torch.equal(loss, runs[1].eval()(x))


@pytest.mark.parametrize("share", [False, True], ids=["split", "shared"])
def test_flop_counter_equals_the_analytic_count(share):
    """FlopCounterMode's count of one train step (forward, backward,
    optimizer) equals ``tunes_mfu.analytic_flops`` exactly: both are
    integer counts of the same products. At the reference widths the
    formula gives 4.592 TFLOP a step at batch 8 and 18.369 at 32."""
    cfg = TunesFormerConfig(patch_length=16, patch_size=8, patch_layers=2,
                            char_layers=1, n_embd=32, n_head=2, dropout=0.1,
                            share_weights=share)
    model = init_tunesformer_weights(TunesFormer(cfg, device="cpu"),
                                     torch.Generator().manual_seed(0))
    step = make_tunesformer_train_step(
        model, optax_adamw(model.parameters()),
        hf_cosine_schedule(LR, 1.0, 10))
    x = tunes_mfu.ascii_batch(torch.Generator().manual_seed(1), 3, cfg,
                              "cpu")
    assert tunes_mfu.count_flops(lambda: step(x, 0)) == \
        tunes_mfu.analytic_flops(cfg, 3)
    ref = TunesFormerConfig(dropout=0.0)
    assert round(tunes_mfu.analytic_flops(ref, 8) / 1e9) == 4592
    assert round(tunes_mfu.analytic_flops(ref, 32) / 1e9) == 18369
