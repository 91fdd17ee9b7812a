"""The MFU decomposition of the port (ai_music_generation_tpu_torch/
experiments/mfu_sweep.py) against docs/experiments/mfu_sweep.py.

- on weights bridged through ``models/nanogpt_ckpt.py`` and the same numpy
  batch, in fp32: the ``fwd`` loss equals JAX's ``loss_fn`` within 1e-5
  absolute and the ``fwdbwd`` gradients equal ``jax.value_and_grad``'s
  within 1e-5 of each gradient's largest value; ``remat`` and ``flash``
  (SDPA) give the plain loss;
- the MFU table is JAX's ``estimate_mfu`` for the same arguments and peak
  (to 1e-12 relative: the same float arithmetic);
- the big-batch loop moves on after ``torch.cuda.OutOfMemoryError`` and
  re-raises any other error;
- ``main`` on the CPU at a tiny size prints the table, the breakdown line
  and its JSON line, and launches no kernel; without a card it raises.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.gpt import estimate_mfu as jax_mfu
from ai_music_generation_tpu.models.gpt import num_params as jax_num_params
from ai_music_generation_tpu.models.nanogpt_ckpt import (
    nanogpt_state_from_params,
)
from ai_music_generation_tpu_torch.experiments import mfu_sweep
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import model_state

torch.set_num_threads(1)

WIDTHS = dict(block_size=64, vocab_size=50, n_layer=2, n_head=4, n_embd=64)
LOSS_ATOL = 1e-5  # fp32, absolute
GRAD_RTOL = 1e-5  # fp32, of each gradient's largest absolute value


@pytest.fixture(scope="module")
def bridged():
    """(JAX model, its fp32 params, the port's fp32 state on them, the
    port's config) at the test widths."""
    jmodel = JaxGPT(JaxGPTConfig(**WIDTHS, dropout=0.0, bias=False,
                                 dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    state = model_state({"model": {
        k: torch.from_numpy(np.array(v)) for k, v in
        nanogpt_state_from_params(params, jmodel.config).items()}})
    cfg = mfu_sweep.make_config(WIDTHS, dtype=torch.float32)
    return jmodel, params, state, cfg


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    return tuple(rng.integers(0, 50, (4, 64)).astype(np.int32)
                 for _ in range(2))


def _jax_loss_fn(jmodel):
    def loss_fn(p, xb, yb):  # mfu_sweep.py:139-141
        _, loss, _ = jmodel.apply(p, xb, yb, deterministic=True)
        return loss
    return loss_fn


def _t(a):
    return torch.from_numpy(a).long()


def test_fwd_loss_equals_jax(bridged, batch):
    jmodel, params, state, cfg = bridged
    want = float(jax.jit(_jax_loss_fn(jmodel))(params, *batch))
    model = mfu_sweep.build(cfg, state, "cpu").eval()
    got = float(mfu_sweep.loss_only(model, *map(_t, batch)))
    assert abs(got - want) <= LOSS_ATOL, (got, want)
    assert all(p.grad is None for p in model.parameters())


def test_fwdbwd_gradients_equal_jax(bridged, batch):
    jmodel, params, state, cfg = bridged
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel)))(
        params, *batch)
    want = model_state({"model": nanogpt_state_from_params(
        jax.device_get(grads), jmodel.config)})
    model = mfu_sweep.build(cfg, state, "cpu").eval()
    for _ in range(2):  # the gradients are set anew, not summed
        got_loss = mfu_sweep.loss_and_grads(model, *map(_t, batch))
    assert abs(float(got_loss) - float(loss)) <= LOSS_ATOL
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        w = torch.from_numpy(np.array(want[name]))
        scale = float(w.abs().max())
        err = float((p.grad - w).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("overrides", [dict(remat=True),
                                       dict(attn_impl="flash")],
                         ids=["remat", "flash"])
def test_remat_and_flash_give_the_plain_loss(bridged, batch, overrides):
    _, _, state, cfg = bridged
    x, y = map(_t, batch)
    plain = mfu_sweep.build(cfg, state, "cpu")
    other = mfu_sweep.build(mfu_sweep.dataclasses.replace(cfg, **overrides),
                            state, "cpu")
    want = float(mfu_sweep.loss_and_grads(plain, x, y))
    got = float(mfu_sweep.loss_and_grads(other, x, y))
    assert abs(got - want) <= LOSS_ATOL, (got, want)
    # the full step runs on both and moves the loss the same way
    a = float(mfu_sweep.full_step(plain)(x, y, 0))
    b = float(mfu_sweep.full_step(other)(x, y, 0))
    assert abs(a - b) <= LOSS_ATOL


@pytest.mark.parametrize("model", sorted(mfu_sweep.MODELS))
def test_mfu_table_is_jax_estimate_mfu(bridged, model):
    """Each row's MFU is JAX's ``estimate_mfu`` of the same config,
    parameter count, batch, step time and peak; the port's non-embedding
    parameter count is JAX's ``num_params``."""
    jmodel, params, state, cfg = bridged
    port = mfu_sweep.build(cfg, state, "cpu")
    assert port.num_params() == jax_num_params(params)
    B, widths, bigs = mfu_sweep.MODELS[model]
    jcfg = JaxGPTConfig(**widths, dropout=0.0, bias=False)
    pcfg = mfu_sweep.make_config(widths)
    n, peak = 85_000_000, 989e12
    results = {"fwd": dict(s=0.0371, batch=B),
               "full": dict(s=0.1129, batch=B),
               f"full{bigs[0]}": dict(s=0.2213, batch=bigs[0])}
    got = mfu_sweep.mfu_table(pcfg, n, results, peak)
    for key, r in results.items():
        want = jax_mfu(jcfg, n, r["batch"], r["s"], peak)
        assert math.isclose(got[key], want, rel_tol=1e-12), (key, got, want)


def test_breakdown_is_the_scripts_differences():
    r = {"fwd": dict(s=0.010, batch=12), "fwdbwd": dict(s=0.030, batch=12),
         "full": dict(s=0.035, batch=12)}
    split = mfu_sweep.breakdown(r)
    assert split["batch"] == 12
    assert [round(split[k], 9) for k in ("fwd_ms", "bwd_ms",
                                         "optimizer_ms")] == [10, 20, 5]
    assert mfu_sweep.breakdown({"fwd": r["fwd"]}) is None


def test_big_batches_move_on_only_after_out_of_memory(capsys):
    tried = []

    def run_at(b):
        tried.append(b)
        if b > 16:
            raise torch.cuda.OutOfMemoryError(f"CUDA out of memory at {b}")
        return (0.5, 3.0)

    b, out, failures = mfu_sweep.first_big(run_at, (512, 256, 16, 8))
    assert (b, out, tried) == (16, (0.5, 3.0), [512, 256, 16])
    assert len(failures) == 2 and "batch 512" in failures[0]
    assert "batch 256 failed: OutOfMemoryError" in capsys.readouterr().out
    assert mfu_sweep.first_big(
        lambda b: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("x")),
        (4, 2))[:2] == (None, None)

    def broken(b):
        raise ValueError("not a memory error")

    with pytest.raises(ValueError, match="not a memory error"):
        mfu_sweep.first_big(broken, (512, 256))


TINY = ["--device=cpu", "--n_layer=2", "--n_head=4", "--n_embd=64",
        "--block_size=64", "--batch=4", "--big_batches=8,6", "--burn=1",
        "--steps=2"]


@pytest.mark.parametrize("model", sorted(mfu_sweep.MODELS))
def test_main_runs_on_the_cpu(model, capsys):
    from ai_music_generation_tpu_torch.experiments.decode_studies import (
        StepCount,
    )

    with StepCount() as counts:
        result = mfu_sweep.main([f"--model={model}", *TINY])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(result))
    assert out[-2].startswith("breakdown @ B=4: fwd ")
    assert result["model"] == model and result["device"] == "cpu"
    assert list(result["variants"]) == ["fwd", "fwdbwd", "full", "flash",
                                        "remat", "full8"]
    for v in result["variants"].values():
        assert math.isfinite(v["loss"]) and 0 < v["mfu"] < 1
    assert result["variants"]["full8"]["batch"] == 8
    assert counts.k1 == counts.k2 == 0 and counts.t1 == 0


def test_unknown_variant_is_refused():
    with pytest.raises(SystemExit):
        mfu_sweep.main(["--device=cpu", "--variants=fwd,bogus"])


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        mfu_sweep.main(["--model=music"])
