"""The pieces of the port's training path against the JAX package: the
batch sampler, the LR schedule, the decay groups, the loss, the clip, MFU,
the optimizer-state converter, the forward with targets; and the port's own
contracts: dropout masks and remat.

Tiny models (2 layers, 4 heads, 64 wide, block 32, vocab 64). Tolerances:
the sampler, the decay groups and the loss's ignore handling are exact;
the schedule within 1e-7 (JAX computes it in fp32, the port in Python
floats); fp32 losses, logits and norms within 1e-5 of their magnitude
(accumulation order only); the converted step k+1 as the fp32 train steps
of tests/test_torch_train_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ai_music_generation_tpu.data import memmap as jax_memmap
from ai_music_generation_tpu.models import gpt as jax_gpt
from ai_music_generation_tpu.train import optimizer as jax_opt
from ai_music_generation_tpu.train.step import TrainState
from ai_music_generation_tpu.train.step import make_train_step as jax_step
from ai_music_generation_tpu_torch.data import memmap
from ai_music_generation_tpu_torch.models import gpt
from ai_music_generation_tpu_torch.models.convert import (
    init_weights,
    optimizer_state_from_jax,
    state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import (
    read_ckpt,
    save_ckpt,
)
from ai_music_generation_tpu_torch.train import optimizer as opt
from ai_music_generation_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
)

torch.set_num_threads(1)

V = 64
COMMON = dict(block_size=32, vocab_size=V, n_layer=2, n_head=4, n_embd=64,
              n_kv_head=2, bias=True)


def _jax_model(**kw):
    cfg = jax_gpt.GPTConfig(**dict(COMMON, dtype=jnp.float32, **kw))
    model = jax_gpt.GPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))
    return model, jax.device_get(params)


def _port_model(params=None, seed=0, **kw):
    cfg = gpt.GPTConfig(**dict(COMMON, dtype=torch.float32, **kw))
    model = gpt.GPT(cfg, device="cpu")
    if params is None:
        return init_weights(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_bin_dataset_batches_equal_jax(tmp_path, dtype):
    tokens = np.random.default_rng(3).integers(0, 60000, 5000)
    path = str(tmp_path / "train.bin")
    memmap.write_bin(tokens, path, dtype)
    memmap.write_meta({"bin_dtype": np.dtype(dtype).name},
                      str(tmp_path / "meta.pkl"))
    ours, theirs = memmap.BinDataset(path), jax_memmap.BinDataset(path)
    assert ours.dtype == theirs.dtype == dtype
    assert len(ours) == len(theirs) == 5000
    for seed, it, shape, block in [(1337, 0, (2, 4), 32), (1438, 7, (5,), 64),
                                   (0, 10_000_003, (3, 1), 256)]:
        got, want = ours.sample(seed, it, shape, block), \
            theirs.sample(seed, it, shape, block)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    # the exclusive high: every window start is below len - block_size
    ix = ours.global_indices(5, 1, 20_000, 4990)
    assert ix.min() >= 0 and ix.max() == 9


def test_bin_dataset_defaults_to_uint16_without_meta(tmp_path):
    path = str(tmp_path / "val.bin")
    memmap.write_bin(np.arange(100), path)
    assert memmap.BinDataset(path).dtype == np.uint16


# -- optimizer -----------------------------------------------------------------

@pytest.mark.parametrize("args", [(6e-4, 10, 40, 6e-5), (1e-3, 100, 50000, 1e-4),
                                  (1e-2, 0, 30, 1e-3), (1e-3, 5, 5, 1e-4)],
                         ids=["gpt2-like", "music", "no-warmup", "degenerate"])
def test_schedule_equals_jax(args):
    ours = opt.cosine_warmup_schedule(*args)
    theirs = jax_opt.cosine_warmup_schedule(*args)
    for it in range(60):
        assert abs(ours(it) - float(theirs(it))) <= 1e-7, it
        assert ours(it) == pytest.approx(float(theirs(it)), rel=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(bias=False, n_kv_head=None)],
                         ids=["gqa-bias", "mha-nobias"])
def test_decay_groups_equal_the_jax_mask(kw):
    """JAX's optimizer decays exactly the parameters that one update with
    zero gradients moves (ones everywhere: decay is the only update); the
    port's decayed group holds the same names, the tied head once."""
    jmodel, params = _jax_model(**kw)
    tx = jax_opt.make_optimizer(1.0, weight_decay=0.5, grad_clip=None)
    ones = jax.tree_util.tree_map(jnp.ones_like, params["params"])
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params["params"])
    updates, _ = tx.update(zeros, tx.init(ones), ones)
    moved = jax.tree_util.tree_map(lambda u: np.full(1, bool(jnp.any(u != 0))),
                                   jax.device_get(updates))
    model = _port_model(params, **kw)
    flags = state_dict_from_jax({"params": moved}, model.config)
    want = {n for n, f in flags.items() if f.item() and n != "lm_head.weight"}
    names = {id(p): n for n, p in model.named_parameters()}
    decay, nodecay = opt.decay_groups(model)
    assert {names[id(p)] for p in decay} == want
    assert len(decay) + len(nodecay) == len(list(model.parameters()))
    assert sum(p is model.lm_head.weight for p in decay) == 1
    groups = opt.make_optimizer(model, weight_decay=0.5).param_groups
    assert [g["weight_decay"] for g in groups] == [0.5, 0.0]
    assert groups[0]["params"] == decay and groups[1]["eps"] == 1e-8


@pytest.mark.parametrize("scale", [0.01, 1.0, 1e3])
def test_global_norm_and_clip_equal_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in [(8, 3), (5,), (2, 2, 2)]]
    want_norm = float(optax.global_norm(grads))
    want, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = opt.global_norm(got)
    assert float(norm) == pytest.approx(want_norm, rel=1e-6)
    opt.clip_by_global_norm_(got, 1.0, norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
    if want_norm < 1.0:  # below the limit: untouched, bit for bit
        for g, w in zip(got, grads):
            np.testing.assert_array_equal(g.numpy(), w)


# -- loss, forward, MFU --------------------------------------------------------

@pytest.mark.parametrize("ignored", ["none", "some", "all"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_entropy_ignore_index_equals_jax(ignored, dtype):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, V)) * 4).astype(np.float32)
    targets = rng.integers(0, V, (3, 7)).astype(np.int32)
    if ignored == "some":
        targets[rng.random((3, 7)) < 0.3] = -1
    elif ignored == "all":
        targets[:] = -1
    jl = jnp.asarray(logits, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tl = torch.from_numpy(logits).to(torch.bfloat16 if dtype == "bf16"
                                     else torch.float32)
    want = float(jax_gpt.cross_entropy_ignore_index(jl, jnp.asarray(targets)))
    got = gpt.cross_entropy_ignore_index(tl, torch.from_numpy(targets))
    assert got.dtype == torch.float32
    if ignored == "all":
        assert want == 0.0 and float(got) == 0.0  # not nan
    else:
        assert float(got) == pytest.approx(want, rel=1e-6)


def test_forward_with_targets_equals_jax():
    """(logits of every position, loss), nanoGPT's return convention."""
    jmodel, params = _jax_model()
    idx, tgt = _tokens((3, 32)), _tokens((3, 32), seed=1)
    tgt[0, :5] = -1
    want_logits, want_loss, _ = jmodel.apply(params, idx, tgt)
    model = _port_model(params).eval()
    with torch.no_grad():
        logits, loss = model(torch.from_numpy(idx), torch.from_numpy(tgt))
    assert logits.shape == (3, 32, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5 * float(np.abs(want_logits).max()))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    with pytest.raises(ValueError, match="no-cache"):
        from ai_music_generation_tpu_torch.models.gpt import KVCache

        model(torch.from_numpy(idx[:, :4]), torch.from_numpy(tgt[:, :4]),
              cache=KVCache.create(model.config, 3, device="cpu"))


def test_flash_attention_matches_the_einsum_chain():
    """attn_impl="flash" (scaled_dot_product_attention) computes the
    no-cache forward of the einsum chain, GQA included; with active dropout
    it takes the einsum chain, whose masks it then shares."""
    x, y = torch.from_numpy(_tokens((2, 32))), torch.from_numpy(
        _tokens((2, 32), seed=1))
    xla = _port_model(seed=3).eval()
    flash = _port_model(seed=3, attn_impl="flash").eval()
    with torch.no_grad():
        a, b = xla(x, y), flash(x, y)
    torch.testing.assert_close(b[0], a[0], atol=1e-5, rtol=0)
    xla = _port_model(seed=3, dropout=0.2).train()
    flash = _port_model(seed=3, dropout=0.2, attn_impl="flash").train()
    key = gpt.dropout_key(1, 2, 0)
    assert torch.equal(xla(x, y, dropout_key=key)[1],
                       flash(x, y, dropout_key=key)[1])


def test_mfu_equals_jax():
    jcfg = jax_gpt.GPTConfig(**dict(COMMON, dtype=jnp.float32))
    model = _port_model()
    _, params = _jax_model()
    assert model.num_params() == jax_gpt.num_params(params)
    for peak in (989e12, None):
        want = jax_gpt.estimate_mfu(jcfg, model.num_params(), 12, 0.25,
                                    peak or 1e12)
        assert gpt.estimate_mfu(model.config, model.num_params(), 12, 0.25,
                                peak or gpt.peak_flops_for("cpu")) == want


def test_peak_flops_by_card_name(monkeypatch):
    assert gpt.peak_flops_for("cpu") == 1e12
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                  "Some Other Card"])
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: next(names))
    assert gpt.peak_flops_for("cuda") == 989e12
    assert gpt.peak_flops_for("cuda") == 989e12
    with pytest.raises(ValueError, match="Some Other Card"):
        gpt.peak_flops_for("cuda")


# -- the optimizer state from JAX ----------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_step_after_k_jax_steps_from_a_converted_state(k):
    """k JAX steps, then both frameworks start from JAX's params and
    optimizer state: step k+1 agrees (the bias corrections past step 1,
    the schedule at step k)."""
    jmodel, params = _jax_model()
    sched = dict(learning_rate=1e-3, warmup_iters=1, lr_decay_iters=6,
                 min_lr=1e-4)
    schedule = jax_opt.cosine_warmup_schedule(*sched.values())
    tx = jax_opt.make_optimizer(schedule, 0.1, 0.9, 0.95, 1.0)
    jstep = jax.jit(jax_step(jmodel, tx, schedule))
    state = TrainState.create(params, tx)
    batches = [(_tokens((2, 3, 32), seed=10 + i), _tokens((2, 3, 32),
                                                          seed=20 + i))
               for i in range(k + 1)]
    for x, y in batches[:k]:
        state, _ = jstep(state, x, y, jax.random.PRNGKey(0))
    host = jax.device_get(state)
    model = _port_model(host.params)
    optimizer = opt.make_optimizer(model, 1e-3, 0.1, 0.9, 0.95)
    converted = optimizer_state_from_jax(host.opt_state, model, optimizer)
    optimizer.load_state_dict(converted)
    assert all(float(s["step"]) == k for s in optimizer.state.values())
    mu = state_dict_from_jax(host.opt_state[1][0].mu, model.config)
    wte = model.transformer.wte.weight
    assert torch.equal(optimizer.state[wte]["exp_avg"],
                       mu["transformer.wte.weight"])
    step = make_train_step(model, optimizer,
                           opt.cosine_warmup_schedule(*sched.values()), 1.0)
    x, y = batches[k]
    state, jmetrics = jstep(state, x, y, jax.random.PRNGKey(0))
    metrics = step(torch.from_numpy(x), torch.from_numpy(y), k)
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), abs=1e-9)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=1e-5)
    want = state_dict_from_jax(jax.device_get(state.params), model.config)
    span = max(float(v.abs().max()) for v in want.values())
    for name, value in model.state_dict().items():
        assert float((value - want[name]).abs().max()) <= 1e-5 * span, name


def test_no_adam_state_raises():
    model = _port_model()
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        optimizer_state_from_jax((optax.EmptyState(),), model,
                                 opt.make_optimizer(model))


def test_save_ckpt_keeps_the_optimizer_state(tmp_path):
    model = _port_model()
    optimizer = opt.make_optimizer(model)
    step = make_train_step(model, optimizer)
    step(torch.from_numpy(_tokens((1, 2, 32))),
         torch.from_numpy(_tokens((1, 2, 32), seed=1)), 0)
    path = str(tmp_path / "ckpt.pt")
    save_ckpt(path, model, iter_num=1, optimizer=optimizer)
    ckpt = read_ckpt(path)
    fresh = opt.make_optimizer(_port_model(seed=1))
    fresh.load_state_dict(ckpt["optimizer"])
    for a, b in zip(optimizer.state.values(), fresh.state.values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key])


# -- dropout and remat ---------------------------------------------------------

def test_dropout_masks_are_a_function_of_seed_iter_micro_layer_site():
    key = gpt.dropout_key(1337, 5, 1)
    assert key == gpt.dropout_key(1337, 5, 1)
    assert len({key, gpt.dropout_key(1338, 5, 1), gpt.dropout_key(1337, 6, 1),
                gpt.dropout_key(1337, 5, 0)}) == 4
    shape = (4, 6, 32, 32)
    mask = gpt.dropout_keep(shape, 0.2, key, 3, gpt.SITE_ATTN_PROBS)
    assert mask.shape == shape and mask.dtype == torch.bool
    assert torch.equal(mask, gpt.dropout_keep(shape, 0.2, key, 3,
                                              gpt.SITE_ATTN_PROBS))
    for other in (gpt.dropout_keep(shape, 0.2, key, 2, gpt.SITE_ATTN_PROBS),
                  gpt.dropout_keep(shape, 0.2, key, 3, gpt.SITE_MLP_OUT),
                  gpt.dropout_keep(shape, 0.2, gpt.dropout_key(1337, 5, 0), 3,
                                   gpt.SITE_ATTN_PROBS)):
        agree = (other == mask).float().mean().item()
        assert 0.64 < agree < 0.70  # independent: 0.8^2 + 0.2^2 = 0.68


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
def test_dropout_keeps_about_1_minus_p_and_preserves_the_mean(p):
    x = torch.ones(200_000)
    y = gpt.dropout(x, p, gpt.dropout_key(0, 0, 0), 0, gpt.SITE_EMBED)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 0.005
    assert abs(y.mean().item() - 1.0) < 0.01
    assert torch.all((y == 0) | (y == torch.tensor(1 / (1 - p))))
    # the mask of 2^32 elements or more would wrap the counter
    with pytest.raises(ValueError, match="2\\^32"):
        gpt.dropout_keep((1 << 16, 1 << 16), p, 0, 0, 0)


def test_dropout_acts_only_in_train_mode_without_a_cache():
    model = _port_model(dropout=0.2)
    x, y = torch.from_numpy(_tokens((2, 32))), torch.from_numpy(
        _tokens((2, 32), seed=1))
    with pytest.raises(ValueError, match="dropout_key"):
        model(x, y)
    a = model(x, y, dropout_key=gpt.dropout_key(0, 0, 0))[1]
    b = model(x, y, dropout_key=gpt.dropout_key(0, 1, 0))[1]
    assert a != b
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x, y)[1], model(x, y)[1])
    eval_loss = make_eval_step(model)(x, y)
    assert not model.training and eval_loss.requires_grad is False


@pytest.mark.parametrize("kh", [2, None], ids=["gqa", "mha"])
def test_remat_is_bit_equal_to_no_remat(kh):
    """remat recomputes each block in the backward pass; with dropout 0.2
    its masks are recomputed from the same counters: the loss, every
    gradient and the parameters after a step are bit-equal."""
    results = []
    for remat in (False, True):
        model = _port_model(seed=4, dropout=0.2, remat=remat, n_kv_head=kh)
        step = make_train_step(model, opt.make_optimizer(model))
        x, y = _tokens((2, 3, 32)), _tokens((2, 3, 32), seed=1)
        model.train()
        _, loss = model(torch.from_numpy(x[0]), torch.from_numpy(y[0]),
                        dropout_key=gpt.dropout_key(7, 0, 0))
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        metrics = step(torch.from_numpy(x), torch.from_numpy(y), 0, seed=7)
        results.append((loss.detach(), grads, metrics,
                        [p.detach().clone() for p in model.parameters()]))
    (l0, g0, m0, p0), (l1, g1, m1, p1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_remat_checkpoints_each_block(monkeypatch):
    calls = []
    real = gpt.checkpoint
    monkeypatch.setattr(gpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = _port_model(remat=True)
    x = torch.from_numpy(_tokens((1, 32)))
    model(x, x)
    assert len(calls) == model.config.n_layer
    with torch.no_grad():  # nothing to recompute without gradients
        model(x, x)
    assert len(calls) == model.config.n_layer

