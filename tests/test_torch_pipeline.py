"""Pipeline parallelism (parallel/pipeline.py: the staged layout and JAX's
GPipe schedule) over gloo worker processes against the JAX package's plain
GPT step, as tests/test_pipeline.py holds JAX's pipelined program to it.

The workers are this file run as a script (``launch_workers``), a group of
2 ranks and one of 4 started together, each running every case of its
group once:

- the pipelined loss and every parameter gradient (the stages' blocks
  gathered back to the plain layout) at (data, pipe) (1, 2), (2, 2) and
  (1, 4), 4 microbatches, against JAX's plain loss and gradients: the loss
  at rtol 1e-6, the gradients at rtol 5e-5 / atol 1e-6 (JAX's tolerances);
  each stage holds n_layer / S blocks;
- ``load_plain`` then ``plain`` gives the plain ``state_dict`` back bit for
  bit, at (1, 4);
- ``make_pipeline_train_step`` with ``optax_adamw`` at (2, 2): the first
  step's parameters against JAX's plain step with ``optax.adamw(1e-3)``
  within 2e-5 of the largest parameter magnitude (fp32 gradients differ by
  their summation order, Adam's first step is ~lr * sign(g)), and the loss
  falls at the second step;
- the guards (n_layer % S, dropout, MoE) with JAX's messages.

Weights: the JAX model's init through ``state_dict_from_jax`` (JAX's test
config: 4 layers, 2 heads, 32 wide, block 16, vocab 64, fp32, batch 8).
"""

import argparse
import concurrent.futures
import datetime
import os
import sys

import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.models.gpt import GPTConfig
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.worker_smoke import (
    launch_workers,
)

torch.set_num_threads(1)

ARCH = dict(block_size=16, vocab_size=64, n_layer=4, n_head=2, n_embd=32,
            dropout=0.0, bias=True)
N_MICRO, LR = 4, 1e-3
GROUPS = {"pair": 2, "quad": 4}
# name: (group, n_data, n_pipe)
CASES = {"1x2": ("pair", 1, 2), "2x2": ("quad", 2, 2), "1x4": ("quad", 1, 4)}
STEP_TOL = 2e-5


def _config(**kw):
    return GPTConfig(**{**ARCH, **kw}, dtype=torch.float32)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, ARCH["vocab_size"], (8, 16))
    return torch.from_numpy(x), torch.from_numpy(np.roll(x, -1, axis=1))


# -- the workers ---------------------------------------------------------------
def _stage(state, n_data, n_pipe):
    from ai_music_generation_tpu_torch.parallel.pipeline import (
        PipelineGPT,
        make_pipe_mesh,
    )

    mesh = make_pipe_mesh(n_data, n_pipe, "cpu")
    model = PipelineGPT(_config(), mesh, device="cpu")
    model.load_plain(state)
    return model, mesh


def _loss_case(state, n_data, n_pipe):
    from ai_music_generation_tpu_torch.parallel.pipeline import (
        make_pipeline_loss,
    )

    model, _ = _stage(state, n_data, n_pipe)
    share, loss = make_pipeline_loss(model, N_MICRO)(*_batch())
    share.backward()
    model.sync_grads()
    grads = model.plain({n: p.grad for n, p in model.named_parameters()})
    out = dict(loss=float(loss), grads=grads, blocks=len(model.transformer.h))
    if (n_data, n_pipe) == (1, 4):
        out["round_trip"] = model.plain(dict(model.named_parameters()))
    return out


def _train_case(state):
    from ai_music_generation_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )
    from ai_music_generation_tpu_torch.train.optimizer import optax_adamw

    model, mesh = _stage(state, 2, 2)
    step = make_pipeline_train_step(model, optax_adamw(model.parameters()),
                                    mesh, N_MICRO, lambda it: LR)
    first = step(*_batch())
    after = model.plain({n: p.detach().clone()
                         for n, p in model.named_parameters()})
    second = step(*_batch())
    return dict(loss=[float(first["loss"]), float(second["loss"])],
                lr=first["lr"], after=after)


def _guards():
    from ai_music_generation_tpu_torch.parallel.pipeline import (
        PipelineGPT,
        make_pipe_mesh,
    )

    mesh = make_pipe_mesh(1, 2, "cpu")
    out = {}
    for name, kw in (("layers", dict(n_layer=3)), ("dropout",
                                                   dict(dropout=0.1)),
                     ("moe", dict(n_expert=4))):
        try:
            PipelineGPT(_config(**kw), mesh, device="cpu")
        except ValueError as e:
            out[name] = str(e)
    return out


def _worker(argv):
    ap = argparse.ArgumentParser()
    for flag in ("--port", "--process-id", "--num-processes"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--group", required=True)
    args = ap.parse_args(argv)
    distributed.initialize_distributed(
        "cpu", rank=args.process_id, world_size=args.num_processes,
        master_addr="localhost", master_port=args.port,
        timeout=datetime.timedelta(seconds=120))
    try:
        state = torch.load(os.path.join(args.out_dir, "state.pt"))
        results = {name: _loss_case(state, n_data, n_pipe)
                   for name, (group, n_data, n_pipe) in CASES.items()
                   if group == args.group}
        if args.group == "quad":
            results["train"] = _train_case(state)
        else:
            results["guards"] = _guards()
        torch.save(results, os.path.join(
            args.out_dir, f"{args.group}_{args.process_id}.pt"))
    finally:
        distributed.shutdown()


# -- the references and the tests ----------------------------------------------
def _jax_reference():
    """JAX's plain loss and gradients, and its plain step with
    ``optax.adamw(1e-3)``, in the port's names."""
    import jax
    import jax.numpy as jnp
    import optax

    from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
    from ai_music_generation_tpu.models.gpt import GPTConfig as JaxConfig
    from ai_music_generation_tpu_torch.models.convert import (
        state_dict_from_jax,
    )

    model = JaxGPT(JaxConfig(**ARCH, dtype=jnp.float32))
    x, y = (jnp.asarray(t.numpy(), jnp.int32) for t in _batch())
    params = model.init(jax.random.PRNGKey(0), x)
    loss, grads = jax.value_and_grad(
        lambda p: model.apply(p, x, y)[1])(params)
    tx = optax.adamw(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    after = optax.apply_updates(params, updates)
    cfg = _config()

    def port(tree):
        return state_dict_from_jax(jax.device_get(tree), cfg)

    return dict(state=port(params), loss=float(loss), grads=port(grads),
                after=port(after))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    ref = _jax_reference()
    torch.save(ref["state"], os.path.join(root, "state.pt"))
    with concurrent.futures.ThreadPoolExecutor(len(GROUPS)) as pool:
        for launch in [pool.submit(launch_workers, [
                os.path.abspath(__file__), "--out-dir", root, "--group",
                group], n, 300) for group, n in GROUPS.items()]:
            launch.result()
    results = {group: [torch.load(os.path.join(root, f"{group}_{r}.pt"))
                       for r in range(n)] for group, n in GROUPS.items()}
    return dict(ref=ref, results=results)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_plain(run, name):
    group, _, n_pipe = CASES[name]
    ref = run["ref"]
    for r in run["results"][group]:
        got = r[name]
        assert got["blocks"] == ARCH["n_layer"] // n_pipe
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        assert set(got["grads"]) == set(ref["grads"])
        for key, want in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][key].numpy(),
                                       want.numpy(), rtol=5e-5, atol=1e-6,
                                       err_msg=key)


def test_staged_layout_round_trips():
    """stack/unstack of a plain state_dict, and a stage's load_plain then
    plain gathered over the pipe axis, give it back bit for bit."""
    from ai_music_generation_tpu_torch.models.gpt import GPT
    from ai_music_generation_tpu_torch.parallel.pipeline import (
        stack_block_params,
        unstack_block_params,
    )

    state = GPT(_config(), device="cpu").state_dict()
    stacked, shared = stack_block_params(state, ARCH["n_layer"])
    assert stacked["attn.c_attn.weight"].shape[0] == ARCH["n_layer"]
    assert "transformer.wte.weight" in shared
    back = unstack_block_params(stacked, shared)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], v) for k, v in state.items())


def test_stages_load_and_gather_the_plain_state(run):
    state = run["ref"]["state"]
    for r in run["results"]["quad"]:
        got = r["1x4"]["round_trip"]
        assert set(got) == set(state)
        assert all(torch.equal(got[k], v) for k, v in state.items())


def test_train_step_matches_jax_plain_step_and_learns(run):
    want = run["ref"]["after"]
    span = max(float(v.abs().max()) for v in want.values())
    for r in run["results"]["quad"]:
        got = r["train"]
        assert got["lr"] == LR and got["loss"][1] < got["loss"][0]
        np.testing.assert_allclose(got["loss"][0], run["ref"]["loss"],
                                   rtol=1e-6)
        for key, value in want.items():
            err = float((got["after"][key] - value).abs().max())
            assert err <= STEP_TOL * span, (key, err / span)


def test_guards(run):
    for r in run["results"]["pair"]:
        g = r["guards"]
        assert g["layers"] == "n_layer 3 not divisible by 2 pipeline stages"
        assert g["dropout"] == "pipeline training path requires dropout=0"
        assert g["moe"].startswith("MoE blocks return a third (aux-loss) "
                                   "element the GPipe schedule does not "
                                   "thread")


if __name__ == "__main__":
    _worker(sys.argv[1:])
