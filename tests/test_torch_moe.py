"""The port's MoE layer and MoE GPT (ai_music_generation_tpu_torch/models/
moe.py, models/gpt.py) against the JAX package's (models/moe.py), on the
same weights.

Sizes: the tests/test_moe.py layer (32 wide, 4 experts, top 2, tokens
[2, 16]) and a 2-layer, 64-wide MoE GPT (block 32, vocab 64). Weights and
inputs are numpy draws from a seed (the router at std 0.5, so its
probabilities are well apart); JAX params reach the port through
``state_dict_from_jax`` / ``moe_state_dict_from_jax``. JAX's routing
(``expert_idx``, ``keep``, ``slot``) is read from its own calls of
``jax.lax.top_k``, ``jax.nn.one_hot`` and ``jnp.einsum`` while it runs
eagerly.

Tolerances: the routing is equal; in fp32 the layer's output agrees within
1e-5 of its range and the aux within 1e-6 (summation order only), each
gradient within 1e-4 of its range; the GPT's logits within 1e-5 of their
range and the loss within 1e-5 of its value in fp32, 2^-4 of the range and
2^-6 of the value in bf16 (products rounded at other places, over two
layers); one fp32 train step's parameters within 1e-4 of their range, as
tests/test_torch_train_step.py holds the dense step.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.moe import MoEMLP as JaxMoEMLP
from ai_music_generation_tpu.train import optimizer as jax_opt
from ai_music_generation_tpu.train.step import TrainState
from ai_music_generation_tpu.train.step import make_train_step as jax_step
from ai_music_generation_tpu_torch.models.convert import (
    init_weights,
    moe_state_dict_from_jax,
    optimizer_state_from_jax,
    state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.gpt import MLP, GPT, GPTConfig
from ai_music_generation_tpu_torch.models.moe import (
    MoEMLP,
    capacity_of,
    route,
)
from ai_music_generation_tpu_torch.train.optimizer import (
    cosine_warmup_schedule,
    decay_groups,
    make_optimizer,
)
from ai_music_generation_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

LAYER = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32,
             dropout=0.0, bias=True, n_expert=4, expert_top_k=2)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _numpy_leaves(tree, seed, router_std=0.5):
    """Every leaf redrawn from a numpy seed: N(0, 0.05), LayerNorm scales
    near 1, the router kernels at ``router_std``."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        if "router" in names:
            std, mean = router_std, 0.0
        elif names[-1] == "scale":
            std, mean = 0.05, 1.0
        else:
            std, mean = 0.05, 0.0
        return (mean + std * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def _layer_pair(cf=2.0, top_k=2, seed=0, **kw):
    common = dict(LAYER, capacity_factor=cf, expert_top_k=top_k, **kw)
    jcfg = JaxGPTConfig(**common, dtype=jnp.float32)
    jlayer = JaxMoEMLP(jcfg)
    x = np.random.default_rng(seed + 100).standard_normal(
        (2, 16, 32)).astype(np.float32)
    params = _numpy_leaves(jlayer.init(jax.random.PRNGKey(0), x)["params"],
                           seed)
    layer = MoEMLP(GPTConfig(**common, dtype=torch.float32))
    layer.load_state_dict(moe_state_dict_from_jax(params))
    return jlayer, params, layer, x


def _jax_routing(jlayer, params, x, monkeypatch):
    """(y, aux, expert_idx, keep, slot) of the JAX layer, the routing read
    from its calls."""
    rec = {"one_hot": [], "keep": []}
    top_k, one_hot, einsum = jax.lax.top_k, jax.nn.one_hot, jnp.einsum

    def rec_top_k(a, k):
        out = top_k(a, k)
        rec["expert_idx"] = np.asarray(out[1])
        return out

    def rec_one_hot(a, n, **kw):
        rec["one_hot"].append(np.asarray(a))
        return one_hot(a, n, **kw)

    def rec_einsum(spec, *ops, **kw):
        if spec == "nke,nkc->nec":
            rec["keep"].append(np.asarray(ops[0]).any(-1))
        return einsum(spec, *ops, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    monkeypatch.setattr(jnp, "einsum", rec_einsum)
    y, aux = jlayer.apply({"params": params}, jnp.asarray(x))
    monkeypatch.undo()
    # one_hot: the selections, then the slots; einsum: dispatch (the kept
    # mask), then combine
    return (np.asarray(y), float(aux), rec["expert_idx"], rec["keep"][0],
            rec["one_hot"][1])


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["no_drops", "drops"])
def test_layer_matches_jax_routing_output_and_aux(cf, monkeypatch):
    jlayer, params, layer, x = _layer_pair(cf)
    want_y, want_aux, want_idx, want_keep, want_slot = _jax_routing(
        jlayer, params, x, monkeypatch)
    xt = torch.from_numpy(x)
    capacity = capacity_of(32, 4, 2, cf)
    _, idx, keep, slot = route(layer.probs(xt), 2, capacity)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    assert (cf < 1) == (not want_keep.all())  # 0.5 drops, 2.0 does not
    with torch.no_grad():
        y, aux = layer(xt)
    err = np.abs(y.numpy() - want_y).max()
    assert err <= 1e-5 * np.abs(want_y).max(), err
    assert abs(float(aux) - want_aux) <= 1e-6


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["no_drops", "drops"])
def test_layer_gradients_match_jax(cf):
    """Gradients to x, the experts and (through the gates and the aux) the
    router, of sum(y * r) + 3 * aux."""
    jlayer, params, layer, x = _layer_pair(cf, seed=1)
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jlayer.apply({"params": p}, x)
        return jnp.sum(y * r) + 3.0 * aux

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = layer(xt)
    ((y * torch.from_numpy(r)).sum() + 3.0 * aux).backward()
    want = {"x": gx, "w_fc": gp["w_fc"], "w_proj": gp["w_proj"],
            "b_fc": gp["b_fc"], "b_proj": gp["b_proj"],
            "router": np.asarray(gp["router"]["kernel"]).T}
    got = {"x": xt.grad, "w_fc": layer.w_fc.grad,
           "w_proj": layer.w_proj.grad, "b_fc": layer.b_fc.grad,
           "b_proj": layer.b_proj.grad, "router": layer.router.weight.grad}
    for name, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[name].numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)
    assert np.abs(want["router"]).max() > 0


def _tiled_moe(mlp: MLP, config) -> MoEMLP:
    """An MoE layer whose every expert is ``mlp``."""
    layer = MoEMLP(config)
    E = config.n_expert
    with torch.no_grad():
        layer.w_fc.copy_(mlp.c_fc.weight.t()[None].expand(E, -1, -1))
        layer.w_proj.copy_(mlp.c_proj.weight.t()[None].expand(E, -1, -1))
        layer.b_fc.copy_(mlp.c_fc.bias[None].expand(E, -1))
        layer.b_proj.copy_(mlp.c_proj.bias[None].expand(E, -1))
        layer.router.weight.normal_(0.0, 0.5,
                                    generator=torch.Generator().manual_seed(3))
    return layer


def test_identical_experts_equal_dense_mlp():
    """tests/test_moe.py:50: every expert the same MLP and room for every
    token, the renormalised gates sum to 1, so the layer is the MLP (and
    the router gets no gradient through the outputs beyond fp32 noise)."""
    cfg = GPTConfig(**LAYER, capacity_factor=2.0, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    mlp = MLP(cfg)
    with torch.no_grad():
        for p in mlp.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    layer = _tiled_moe(mlp, cfg)
    x = torch.randn(2, 16, 32, generator=gen)
    y_moe, aux = layer(x)
    torch.testing.assert_close(y_moe, mlp(x), rtol=2e-5, atol=2e-6)
    assert torch.isfinite(aux)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    (layer(xa)[0] ** 2).sum().backward()
    (mlp(xb) ** 2).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-3, atol=1e-5)


def test_capacity_overflow_drops_to_exactly_zero():
    """tests/test_moe.py:74: capacity ceil(0.01 * 16 / 4) = 1 row an expert
    at top 1, so at most n_expert tokens get an output and the rest are
    exactly 0 (they ride the residual)."""
    cfg = GPTConfig(**dict(LAYER, capacity_factor=0.01, expert_top_k=1),
                    dtype=torch.float32)
    layer = MoEMLP(cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    x = torch.randn(1, 16, 32, generator=gen)
    with torch.no_grad():
        y, _ = layer(x)
    nonzero = (y[0].abs().sum(-1) > 0).sum().item()
    assert 1 <= nonzero <= cfg.n_expert
    assert int((y[0] == 0).all(-1).sum()) == 16 - nonzero


def test_aux_loss_oracle():
    """tests/test_moe.py:90: aux = E * sum_e f_e p_e from the router's own
    probabilities (top 1), and >= 1, its value under uniform routing."""
    cfg = GPTConfig(**dict(LAYER, expert_top_k=1), dtype=torch.float32)
    layer = MoEMLP(cfg)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    x = torch.randn(2, 8, 32, generator=gen)
    with torch.no_grad():
        _, aux = layer(x)
    logits = x.reshape(-1, 32).double().numpy() @ \
        layer.router.weight.detach().double().numpy().T
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = probs.argmax(-1)
    f = np.array([(top == e).mean() for e in range(cfg.n_expert)])
    want = cfg.n_expert * float((f * probs.mean(0)).sum())
    np.testing.assert_allclose(float(aux), want, rtol=1e-5)
    assert float(aux) >= 1.0 - 1e-5


@pytest.mark.parametrize("top_k", [2, 3])
def test_tied_router_picks_the_lowest_experts(top_k, monkeypatch):
    """A zero router ties every probability: each token picks experts
    0..K-1, as jax.lax.top_k breaks ties; slots and keep equal JAX's."""
    jlayer, params, layer, x = _layer_pair(2.0, top_k=top_k)
    params = dict(params, router={"kernel": np.zeros_like(
        params["router"]["kernel"])})
    with torch.no_grad():
        layer.router.weight.zero_()
    _, want_idx, want_keep, want_slot = _jax_routing(
        jlayer, params, x, monkeypatch)[1:]
    probs = layer.probs(torch.from_numpy(x))
    assert torch.equal(probs, torch.full_like(probs, 0.25))
    _, idx, keep, slot = route(probs, top_k, capacity_of(32, 4, top_k, 2.0))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.tile(np.arange(top_k), (32, 1)))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)


GPT_COMMON = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4,
                  n_embd=64, dropout=0.0, bias=True, n_expert=4,
                  expert_top_k=2, capacity_factor=1.25)


def _gpt_pair(dtype="fp32", seed=0, **kw):
    jd, td = DTYPES[dtype]
    common = dict(GPT_COMMON, **kw)
    jmodel = JaxGPT(JaxGPTConfig(**common, dtype=jd))
    params = {"params": _numpy_leaves(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"],
        seed)}
    cfg = GPTConfig(**common, dtype=td)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return jmodel, params, model


def _batch(B=4, T=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 64, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def test_state_dict_names_and_init():
    """The converted state dict is the port's key set (moe.* in place of
    mlp.*), and init_weights draws the JAX scheme: experts 0.02 and
    0.02/sqrt(2L), zero biases, router 0.02."""
    _, params, model = _gpt_pair()
    sd = state_dict_from_jax(params, model.config)
    assert set(sd) == set(model.state_dict())
    assert "transformer.h.0.moe.router.weight" in sd
    assert not any(".mlp." in k for k in sd)
    big = GPTConfig(**dict(GPT_COMMON, n_embd=256, n_head=4))
    m = init_weights(GPT(big, device="cpu"),
                     torch.Generator().manual_seed(0))
    moe = m.transformer.h[0].moe
    assert abs(moe.w_fc.std().item() - 0.02) < 1e-3
    assert abs(moe.w_proj.std().item() - 0.02 / 2.0) < 1e-3
    assert abs(moe.router.weight.std().item() - 0.02) < 2e-3
    assert not moe.b_fc.any() and not moe.b_proj.any()


def _routing_margin(model, x, y):
    """The smallest gap, over the layers and tokens of ``model(x, y)``,
    between the log-probabilities of a token's j-th and (j+1)-th expert,
    j <= K: the choice and the order of the choices (which decides the
    drops under the capacity)."""
    gaps = []
    K = model.config.expert_top_k

    def hook(moe, args, out):
        logp = torch.sort(moe.probs(args[0]).log(), -1, descending=True)[0]
        gaps.append(float((logp[:, :K] - logp[:, 1:K + 1]).min()))

    hooks = [b.moe.register_forward_hook(hook) for b in model.transformer.h]
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(y))
    for h in hooks:
        h.remove()
    return min(gaps)


# (dtype, batch, seed, least routing margin): bf16 rounds the router's
# input at other places than JAX does (a few 2^-8 of it), which moves a
# router logit by ~0.02 here; a token whose experts lie closer may take
# another expert, or rank its two in the other order (which decides the
# drops), and then its logits are another function's. So the bf16 case
# runs on inputs whose every routing decision clears 0.05 in
# log-probability (asserted); fp32 rounds ~1e-7
GPT_CASES = {"fp32": ((4, 32), 0, 1e-5), "bf16": ((2, 16), 8, 0.05)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gpt_logits_and_loss_match_jax(dtype):
    """Training forward (all positions) with the aux term in the loss, at a
    capacity that drops tokens (0.5) and the protocol's 1.25."""
    (B, T), seed, margin = GPT_CASES[dtype]
    for cf in (1.25, 0.5):
        jmodel, params, model = _gpt_pair(dtype, seed=seed,
                                          capacity_factor=cf,
                                          moe_aux_coef=0.5)
        x, y = _batch(B, T, seed=seed)
        assert _routing_margin(model, x, y) >= margin
        want_logits, want_loss, _ = jmodel.apply(params, jnp.asarray(x),
                                                 jnp.asarray(y))
        with torch.no_grad():
            logits, loss = model(torch.from_numpy(x), torch.from_numpy(y))
        want_logits = np.asarray(want_logits, np.float32)
        rng = np.abs(want_logits).max()
        frac, lfrac = (1e-5, 1e-5) if dtype == "fp32" else (2.0 ** -4,
                                                          2.0 ** -6)
        err = np.abs(logits.float().numpy() - want_logits).max()
        assert err <= frac * rng, (cf, err, rng)
        assert abs(float(loss) - float(want_loss)) <= lfrac * abs(
            float(want_loss)), (cf, float(loss), float(want_loss))


def test_loss_carries_the_aux_term():
    """loss = cross-entropy + moe_aux_coef * (sum of the layers' aux) /
    n_layer, the aux of each layer that of its MoE on its input."""
    _, _, model = _gpt_pair(moe_aux_coef=0.5)
    x, y = (torch.from_numpy(a) for a in _batch())
    auxes = []
    hooks = [b.moe.register_forward_hook(
        lambda m, i, out: auxes.append(out[1])) for b in model.transformer.h]
    with torch.no_grad():
        logits, loss = model(x, y)
    for h in hooks:
        h.remove()
    from ai_music_generation_tpu_torch.models.gpt import (
        cross_entropy_ignore_index,
    )
    ce = cross_entropy_ignore_index(logits, y)
    torch.testing.assert_close(loss, ce + 0.5 * sum(auxes) / 2, rtol=1e-6,
                               atol=0)
    assert len(auxes) == 2 and all(a >= 1.0 - 1e-5 for a in auxes)


def test_aux_only_where_the_loss_reads_it():
    """The load-balance aux is computed with targets and skipped on the
    forwards whose loss does not read it (logits only, cached prefill and
    T=1 steps); skipping it leaves the layer's output and the logits
    unchanged."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache

    _, _, model = _gpt_pair()
    x, y = (torch.from_numpy(a) for a in _batch())
    auxes = []
    hooks = [b.moe.register_forward_hook(
        lambda m, i, out: auxes.append(out[1])) for b in model.transformer.h]
    with torch.no_grad():
        full, _ = model(x, y)
        assert len(auxes) == 2 and all(a is not None for a in auxes)
        auxes.clear()
        logits, _ = model(x, return_all_logits=True)
        cache = KVCache.create(model.config, x.shape[0], device="cpu")
        model(x[:, :-1], cache=cache)
        model(x[:, -1:], cache=cache)
    for h in hooks:
        h.remove()
    assert len(auxes) == 6 and all(a is None for a in auxes)
    torch.testing.assert_close(logits, full, rtol=0, atol=0)
    layer = model.transformer.h[0].moe
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 64)).astype(np.float32))
    with torch.no_grad():
        (y_aux, aux), (y_no, none) = layer(h), layer(h, aux=False)
    assert torch.isfinite(aux) and none is None
    torch.testing.assert_close(y_no, y_aux, rtol=0, atol=0)


def _jax_train(jmodel, params, x, y, steps, clip=1.0):
    schedule = jax_opt.cosine_warmup_schedule(1e-3, 2, 10, 1e-4)
    tx = jax_opt.make_optimizer(schedule, 0.1, 0.9, 0.95, clip)
    state = TrainState.create(params, tx)
    step = jax.jit(jax_step(jmodel, tx, schedule))
    states = []
    for i in range(steps):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(i))
        states.append((jax.device_get(state), float(metrics["loss"])))
    return states


def test_train_step_matches_jax_and_optimizer_state_converts():
    """Three steps of make_train_step (accum 2, AdamW with JAX's ndim >= 2
    decay mask, the clip) from the same weights and batches: loss and
    parameters after each step; then the JAX optimizer state converted
    (optimizer_state_from_jax) equals the port's moments."""
    jmodel, params, model = _gpt_pair(seed=3)
    x, y = _batch(B=8, seed=4)
    x, y = x.reshape(2, 4, 32), y.reshape(2, 4, 32)
    want = _jax_train(jmodel, params, x, y, 3)
    opt = make_optimizer(model, 1e-3, 0.1, 0.9, 0.95)
    step = make_train_step(model, opt,
                           cosine_warmup_schedule(1e-3, 2, 10, 1e-4), 1.0)
    for i, (state, jloss) in enumerate(want):
        metrics = step(torch.from_numpy(x), torch.from_numpy(y), i)
        assert abs(float(metrics["loss"]) - jloss) <= 1e-5 * abs(jloss)
        ref = state_dict_from_jax(state.params, model.config)
        span = max(float(v.abs().max()) for v in ref.values())
        got = model.state_dict()
        err = max(float((got[k] - v).abs().max()) for k, v in ref.items())
        assert err <= 1e-4 * span, (i, err, span)
    converted = optimizer_state_from_jax(want[-1][0].opt_state, model, opt)
    mine = opt.state_dict()["state"]
    assert set(converted["state"]) == set(mine)
    for i, s in converted["state"].items():
        assert float(s["step"]) == float(mine[i]["step"]) == 3.0
        for key in ("exp_avg", "exp_avg_sq"):
            scale = float(s[key].abs().max())
            err = float((mine[i][key] - s[key]).abs().max())
            assert err <= 1e-4 * scale + 1e-12, (i, key, err, scale)
    # the loaded conversion is a state the optimizer takes
    opt.load_state_dict(converted)


def test_decay_groups_follow_the_jax_mask():
    """JAX decays every parameter of ndim >= 2: the 3-D experts, the
    router and the [E, .] expert biases; the LayerNorms do not decay."""
    _, params, model = _gpt_pair()
    decay, nodecay = decay_groups(model)
    name = {id(p): n for n, p in model.named_parameters()}
    decayed = {name[id(p)] for p in decay}
    flat = jax.tree_util.tree_leaves_with_path(params)
    jax_decayed = sum(leaf.ndim >= 2 for _, leaf in flat)
    assert len(decay) == jax_decayed
    moe = "transformer.h.0.moe."
    assert {moe + n for n in ("w_fc", "w_proj", "b_fc", "b_proj",
                              "router.weight")} <= decayed
    assert all(p.dim() == 1 for p in nodecay)


def test_remat_routes_as_without_it():
    """remat recomputes each block in the backward pass; the MoE block
    routes as it did, so the gradients equal those without remat."""
    grads = []
    for remat in (False, True):
        _, _, model = _gpt_pair(remat=remat)
        x, y = (torch.from_numpy(a) for a in _batch(seed=6))
        model.train()
        _, loss = model(x, y)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n

