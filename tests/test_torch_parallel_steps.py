"""Sharded GPT training over 4 gloo worker processes (ai_music_generation_
tpu_torch/parallel/, the mesh paths of models/ and train/) against the
port's single-process step over the same global batch and the JAX
package's replicated step, as tests/test_mesh.py:102, test_gqa.py:160 and
test_moe.py:160 hold JAX's sharded steps to its replicated ones.

The workers are this file run as a script (``launch_workers``: one free
port, a 120 s process-group timeout, a 300 s limit on the launch). One
launch runs every case and writes its results; the tests compare.

Step cases (2 steps each, 2 layers, 4 heads, width 64, vocab 64, block 16,
fp32, a global batch of 8 rows whose row r ignores its last r % 4 targets,
so the data ranks count different targets; the clip at 1.0): (4,1) DDP
and (4,1) FSDP with 2 micro-steps, (2,2) TP+DP, (1,4) TP, GQA (2 K/V heads)
on (2,2) and (1,4), GQA on (2,2) with FSDP, MoE (4 experts, capacity factor
1.0, so pairs are dropped) on (2,2) with expert parallelism, and dropout 0.1
on (2,2) and (1,4) (2 heads there: each rank runs every head). Weights come
from the JAX model's init through ``state_dict_from_jax``.

Trainer case: ``Trainer(n_model=2, fsdp=True, dropout=0.1)`` on (2,2) runs
3 iterations and saves; ``Trainer(init_from="resume")`` on (4,1) restores
the file, then runs 2 more; the plain single-process trainer does the same
at the same global batch and, resumed from that file, on (1,1).

Tolerances (fp32, accumulation order only): against the single-process
port the loss and grad norm within 1e-5 of their value and every
parameter within 1e-5 of the largest parameter magnitude (Adam's first
steps amplify gradient roundings near eps, tests/test_torch_train_step.py);
against JAX twice that, the sum of the two comparisons' bounds. A restored
checkpoint is bit-equal.
"""

import argparse
import concurrent.futures
import copy
import datetime
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from ai_music_generation_tpu_torch.data.memmap import write_bin, write_meta
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.mesh import Layout, make_mesh
from ai_music_generation_tpu_torch.parallel.sharding import parallelize
from ai_music_generation_tpu_torch.parallel.worker_smoke import (
    launch_workers,
)
from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib
from ai_music_generation_tpu_torch.train.optimizer import (
    cosine_warmup_schedule,
    make_optimizer,
)
from ai_music_generation_tpu_torch.train.step import make_train_step
from ai_music_generation_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

WORLD, STEPS, B, T, V, SEED = 4, 2, 8, 16, 64, 5
ARCH = dict(block_size=T, vocab_size=V, n_layer=2, n_head=4, n_embd=64,
            bias=True)
LR = (1e-3, 2, 10, 1e-4)  # lr, warmup, decay iters, min lr
TOL, JAX_TOL = 1e-5, 2e-5
# name: (n_data, n_model, fsdp, config, accum)
CASES = {
    "ddp-4x1": (4, 1, False, {}, 2),
    "fsdp-4x1": (4, 1, True, {}, 2),
    "tp-dp-2x2": (2, 2, False, {}, 1),
    "tp-1x4": (1, 4, False, {}, 1),
    "gqa-2x2": (2, 2, False, dict(n_kv_head=2), 1),
    "gqa-1x4": (1, 4, False, dict(n_kv_head=2), 1),
    "gqa-fsdp-2x2": (2, 2, True, dict(n_kv_head=2), 1),
    "moe-ep-2x2": (2, 2, False, dict(n_expert=4, capacity_factor=1.0), 1),
    "dropout-2x2": (2, 2, False, dict(dropout=0.1), 1),
    "dropout-1x4": (1, 4, False, dict(dropout=0.1, n_head=2), 1),
}
TRAINER = dict(dataset="tiny", n_layer=2, n_head=4, n_embd=64, block_size=T,
               bias=True, dropout=0.1, dtype="float32", device="cpu",
               warmup_iters=1, lr_decay_iters=8, learning_rate=1e-3,
               min_lr=1e-4, eval_iters=2, log_interval=1)


def _batches(accum):
    """[STEPS, accum, B, T] inputs and targets; row r of every micro-step
    ignores its last r % 4 targets."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, V, (STEPS, accum, B, T))
    y = rng.integers(0, V, (STEPS, accum, B, T))
    for r in range(B):
        if r % 4:
            y[:, :, r, -(r % 4):] = -1
    return torch.from_numpy(x), torch.from_numpy(y)


def _step_fn(model, plan=None):
    optimizer = make_optimizer(model, LR[0], 0.1, 0.9, 0.95)
    return make_train_step(model, optimizer, cosine_warmup_schedule(*LR),
                           1.0, plan)


# -- the worker ---------------------------------------------------------------
def _local_shape(p):
    return tuple((p.to_local() if isinstance(p, DTensor) else p).shape)


def _sharded_steps(case, state):
    n_data, n_model, fsdp, extra, accum = case
    model = GPT(GPTConfig(**{**ARCH, **extra}, dtype=torch.float32),
                device="cpu")
    model.load_state_dict(state)
    layout = Layout(make_mesh(n_data, n_model, "cpu"))
    _, plan = parallelize(model, layout, fsdp)
    step = _step_fn(model, plan)
    x, y = _batches(accum)
    rows = B // n_data
    mine = slice(layout.data_rank * rows, (layout.data_rank + 1) * rows)
    out = []
    for s in range(STEPS):
        metrics = step(x[s][:, mine], y[s][:, mine], s, SEED)
        out.append(dict(loss=float(metrics["loss"]),
                        grad_norm=float(metrics["grad_norm"]),
                        state=plan.gather_state(model)[0]))
    return dict(steps=out, local=[
        {n: _local_shape(p) for n, p in model.named_parameters()}])


def _recorded(trainer):
    """The trainer's step, recording each iteration's loss."""
    losses, step = [], trainer._train_step

    def recorded(*args):
        metrics = step(*args)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer._train_step = recorded
    return losses


def _trainer_case(root):
    import torch.distributed as dist

    out = os.path.join(root, "mesh")
    base = dict(TRAINER, data_root=os.path.join(root, "data"), out_dir=out)
    first = Trainer(dict(base, n_model=2, fsdp=True, batch_size=2,
                         gradient_accumulation_steps=4, max_iters=3,
                         eval_interval=3))
    losses = _recorded(first)
    first.run()
    shapes = {n: _local_shape(p) for n, p in first.model.named_parameters()}
    del first
    resumed = Trainer(dict(base, init_from="resume", batch_size=2,
                           gradient_accumulation_steps=4, max_iters=5,
                           eval_interval=100))
    state, opt = resumed.plan.gather_state(resumed.model, resumed.optimizer)
    saved = ckpt_lib.load_checkpoint(out, ckpt_lib.LAST)
    equal = (all(torch.equal(saved["model"][k], state[k])
                 for k in saved["model"])
             and all(torch.equal(v, opt["state"][i][k])
                     for i, e in saved["optimizer"]["state"].items()
                     for k, v in e.items()))
    after = _recorded(resumed)
    resumed.run()
    try:
        Trainer(dict(base, batch_size=2, gradient_accumulation_steps=3))
        accum_refused = False
    except ValueError:
        accum_refused = True
    dist.barrier()
    return dict(losses=losses, iter=resumed.iter_num, equal=equal,
                after=after, shapes=shapes, accum_refused=accum_refused,
                mesh=(resumed.n_data, resumed.layout.n_model),
                micro=(resumed.micro_batch, resumed.grad_accum))


def _worker(argv):
    ap = argparse.ArgumentParser()
    for flag in ("--port", "--process-id", "--num-processes"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    distributed.initialize_distributed(
        "cpu", rank=args.process_id, world_size=args.num_processes,
        master_addr="localhost", master_port=args.port,
        timeout=datetime.timedelta(seconds=120))
    try:
        inputs = torch.load(os.path.join(args.out_dir, "inputs.pt"))
        results = {name: _sharded_steps(CASES[name], inputs[name])
                   for name in CASES}
        results["trainer"] = _trainer_case(args.out_dir)
        if distributed.is_main_process():
            torch.save(results, os.path.join(args.out_dir, "results.pt"))
    finally:
        distributed.shutdown()


# -- the tests ----------------------------------------------------------------
def _jax_model(extra):
    import jax
    import jax.numpy as jnp

    from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
    from ai_music_generation_tpu.models.gpt import GPTConfig as JaxConfig

    model = JaxGPT(JaxConfig(**{**ARCH, **extra}, dtype=jnp.float32))
    return model, model.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, T), jnp.int32))


def _jax_steps(model, params, accum):
    import jax

    from ai_music_generation_tpu.train import optimizer as jax_opt
    from ai_music_generation_tpu.train.step import TrainState
    from ai_music_generation_tpu.train.step import make_train_step as step

    schedule = jax_opt.cosine_warmup_schedule(*LR)
    tx = jax_opt.make_optimizer(schedule, 0.1, 0.9, 0.95, 1.0)
    state, fn = TrainState.create(params, tx), jax.jit(step(model, tx,
                                                            schedule))
    x, y = _batches(accum)
    out = []
    for s in range(STEPS):
        state, metrics = fn(state, x[s].numpy().astype(np.int32),
                            y[s].numpy().astype(np.int32),
                            jax.random.PRNGKey(0))
        out.append(dict(loss=float(metrics["loss"]),
                        grad_norm=float(metrics["grad_norm"]),
                        params=jax.device_get(state.params)))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Weights, the single-process port's and JAX's steps, the workers'
    results."""
    import jax

    from ai_music_generation_tpu_torch.models.convert import (
        state_dict_from_jax,
    )

    root = str(tmp_path_factory.mktemp("mesh"))
    data = os.path.join(root, "data", "tiny")
    os.makedirs(data)
    ids = np.random.default_rng(0).integers(0, V, 20000)
    write_bin(ids[:18000], os.path.join(data, "train.bin"))
    write_bin(ids[18000:], os.path.join(data, "val.bin"))
    write_meta({"vocab_size": V}, os.path.join(data, "meta.pkl"))
    inputs, models, configs = {}, {}, {}
    for name, (_, _, _, extra, _) in CASES.items():
        configs[name] = GPTConfig(**{**ARCH, **extra}, dtype=torch.float32)
        models[name] = _jax_model({k: v for k, v in extra.items()
                                   if k != "dropout"})
        inputs[name] = state_dict_from_jax(jax.device_get(models[name][1]),
                                           configs[name])
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    # the workers run in the background while the references are computed
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(launch_workers, [
            os.path.abspath(__file__), "--out-dir", root], WORLD, 300)
        single, jax_ref = {}, {}
        for name, (_, _, _, extra, accum) in CASES.items():
            model = GPT(configs[name], device="cpu")
            model.load_state_dict(inputs[name])
            step, (x, y) = _step_fn(model), _batches(accum)
            single[name] = []
            for s in range(STEPS):
                metrics = step(x[s], y[s], s, SEED)
                single[name].append(dict(
                    loss=float(metrics["loss"]),
                    grad_norm=float(metrics["grad_norm"]),
                    state={k: v.clone()
                           for k, v in model.state_dict().items()}))
            if not extra.get("dropout"):  # JAX draws other dropout masks
                jax_ref[name] = _jax_steps(*models[name], accum)
        workers.result()
    return dict(root=root, single=single, jax=jax_ref, configs=configs,
                results=torch.load(os.path.join(root, "results.pt")))


def _check(got, want, tol, what):
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= tol * abs(want[key]), (what, key)
    span = max(float(v.abs().max()) for v in want["state"].values())
    for name, value in want["state"].items():
        err = float((got["state"][name] - value).abs().max())
        assert err <= tol * span, (what, name, err / span)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_the_single_process_step(run, name):
    for s in range(STEPS):
        _check(run["results"][name]["steps"][s], run["single"][name][s],
               TOL, f"{name} step {s}")


JAX_CASES = [n for n, c in CASES.items() if not c[3].get("dropout")]


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_steps_match_the_jax_replicated_step(run, name):
    import jax

    from ai_music_generation_tpu_torch.models.convert import (
        state_dict_from_jax,
    )

    for s in range(STEPS):
        want = dict(run["jax"][name][s])
        want["state"] = state_dict_from_jax(want.pop("params"),
                                            run["configs"][name])
        _check(run["results"][name]["steps"][s], want, JAX_TOL,
               f"{name} step {s} vs JAX")
    assert jax.device_count() == 8  # the JAX side ran replicated


@pytest.mark.parametrize("name", ["tp-dp-2x2", "tp-1x4", "gqa-1x4",
                                  "moe-ep-2x2"])
def test_model_axis_parts_are_distributed(run, name):
    """Each rank holds its part: 1/n_model of c_attn's fused columns, of
    c_fc, of the vocab; with MoE E / n_model experts (JAX test_moe.py:160
    asserts it of its shards)."""
    n_model = CASES[name][1]
    local = run["results"][name]["local"][0]
    full = {n: tuple(p.shape) for n, p in
            GPT(run["configs"][name], device="meta").named_parameters()}
    for leaf, dim in (("attn.c_attn.weight", 0), ("attn.c_proj.weight", 1)):
        key = f"transformer.h.0.{leaf}"
        assert local[key][dim] * n_model == full[key][dim]
    assert local["transformer.wte.weight"][0] * n_model == V
    if name.startswith("moe"):
        assert local["transformer.h.0.moe.w_fc"][0] == 4 // n_model
        assert local["transformer.h.0.moe.router.weight"] == full[
            "transformer.h.0.moe.router.weight"]
    else:
        assert local["transformer.h.0.mlp.c_fc.weight"][0] * n_model == (
            full["transformer.h.0.mlp.c_fc.weight"][0])


def test_moe_case_drops_pairs(run):
    """The MoE case's premise: at capacity factor 1.0 the router overfills
    an expert, so the global priority decides which pairs are dropped."""
    from ai_music_generation_tpu_torch.models.gpt import _layer_norm
    from ai_music_generation_tpu_torch.models.moe import capacity_of, route

    cfg = run["configs"]["moe-ep-2x2"]
    model = GPT(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(run["root"], "inputs.pt"))[
        "moe-ep-2x2"])
    x, _ = _batches(1)
    h = model.transformer.wte.weight[x[0, 0]] + model.transformer.wpe.weight
    h = h + model.transformer.h[0].attn(_layer_norm(
        h, model.transformer.h[0].ln_1))
    layer = model.transformer.h[0].moe
    probs = layer.probs(_layer_norm(h, model.transformer.h[0].ln_2))
    _, _, keep, _ = route(probs, 2, capacity_of(B * T, 4, 2, 1.0))
    assert not bool(keep.all())


def test_dropout_masks_match_the_single_card_step(run):
    """With dropout on, the sharded steps (rows over data, heads over the
    model axis) drop what the single-card step drops: their updates equal
    (above, within fp32's tolerance), while the single-card step under
    another key's masks moves some parameter ten times that far (its
    update's sign flips: 2 lr)."""
    cfg = run["configs"]["dropout-2x2"]
    model = GPT(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(run["root"], "inputs.pt"))[
        "dropout-2x2"])
    x, y = _batches(1)
    _step_fn(model)(x[0], y[0], 0, SEED + 1)
    got = run["results"]["dropout-2x2"]["steps"][0]["state"]
    span = max(float(v.abs().max()) for v in got.values())
    err = max(float((model.state_dict()[k] - v).abs().max())
              for k, v in got.items())
    assert err > 10 * TOL * span


@pytest.fixture(scope="module")
def plain_trainer(run):
    """The single-process trainer at the (2,2) run's global batch (4 rows,
    2 micro-steps), then resumed from the mesh's checkpoint at the (4,1)
    run's (8 rows, 1 micro-step)."""
    base = dict(TRAINER, data_root=os.path.join(run["root"], "data"))
    first = Trainer(dict(base, out_dir=os.path.join(run["root"], "plain"),
                         batch_size=4, gradient_accumulation_steps=2,
                         max_iters=3, eval_interval=3))
    losses = _recorded(first)
    first.run()
    resumed_dir = os.path.join(run["root"], "plain-resume")
    shutil.copytree(os.path.join(run["root"], "mesh"), resumed_dir)
    resumed = Trainer(dict(base, out_dir=resumed_dir, init_from="resume",
                           batch_size=8, gradient_accumulation_steps=1,
                           max_iters=5, eval_interval=100))
    state = {k: v.clone() for k, v in resumed.model.state_dict().items()}
    opt = copy.deepcopy(resumed.optimizer.state_dict())
    after = _recorded(resumed)
    resumed.run()
    return dict(losses=losses, after=after, state=state, opt=opt,
                root=run["root"])


def test_trainer_on_a_mesh_matches_the_plain_trainer(run, plain_trainer):
    mesh = run["results"]["trainer"]
    assert len(mesh["losses"]) == 4  # iterations 0-3, saved at 3
    np.testing.assert_allclose(mesh["losses"], plain_trainer["losses"],
                               rtol=TOL)
    # TP over 2 and FSDP over 2: c_attn's columns split twice
    assert mesh["shapes"]["transformer.h.0.attn.c_attn.weight"] == (96, 32)
    assert mesh["accum_refused"]  # accum 3 over 4 data ranks (JAX's rule)
    # only the main process wrote: one eval line an eval
    with open(os.path.join(plain_trainer["root"], "mesh",
                           "losses.jsonl")) as f:
        assert len(f.read().splitlines()) == 2


def test_checkpoint_saved_on_2x2_fsdp_resumes_bit_equal(run, plain_trainer):
    """Saved on (2,2) with FSDP; restored on (4,1) bit for bit (parameters
    and AdamW moments), and on (1,1) by the plain trainer, whose next
    iterations the (4,1) run matches."""
    mesh = run["results"]["trainer"]
    assert mesh["equal"] and mesh["mesh"] == (4, 1) and mesh["micro"] == (
        8, 1)
    saved = ckpt_lib.load_checkpoint(os.path.join(run["root"], "mesh"),
                                     ckpt_lib.LAST)
    assert saved["iter_num"] == 3 and mesh["iter"] == 6
    for k, v in saved["model"].items():
        assert torch.equal(plain_trainer["state"][k], v), k
    for i, entry in saved["optimizer"]["state"].items():
        for k, v in entry.items():
            assert torch.equal(plain_trainer["opt"]["state"][i][k], v)
    np.testing.assert_allclose(mesh["after"], plain_trainer["after"],
                               rtol=TOL)
    assert len(mesh["after"]) == 3


if __name__ == "__main__":
    _worker(sys.argv[1:])
