"""Sharded TunesFormer training over 4 gloo worker processes
(``train/tunes_step.py::shard_tunesformer_step`` and
``cli/tunesformer_train.py`` under a process group) against the port's
single-process step and CLI and the JAX package's step: the counterparts
of tests/test_tunes_multichip.py:47,70 and test_tunesformer_cli.py:97.

The workers are this file run as a script (``launch_workers``: a 120 s
process-group timeout, a 300 s limit on the launch); one launch runs every
case.

Step cases: 2+2 layers, 32 wide, 2 heads, a 16x16 patch grid, a global
batch of 8 padded tunes, fp32; step 0 on the whole context, step 1 on 5
conditioning rows a tune (``patch_indices``), then an eval: (2,2) and (4,1)
with split cores, (2,2) with ``share_weights``, all against the port's
single-process step, the split ones also against JAX's
``make_tunesformer_train_step`` under ``optax.adamw(hf_cosine_schedule)``;
dropout 0.1 on (2,2) against the single-process step only (JAX draws other
masks).

CLI case: ``--n_model 2`` over 4 processes ((2,2): the JAX CLI's mesh rule)
on 24 curated random tunes, 2 epochs at the CLI's default dropout 0.1,
against the single-process CLI: every epoch's losses and the written
``weights.pth``.

Tolerances (fp32, accumulation order only): against the single-process
port the losses within 1e-5 of their value, parameters and AdamW moments
within 1e-5 of the largest magnitude of their kind; against JAX twice that
(the sum of the two comparisons' bounds).
"""

import argparse
import concurrent.futures
import datetime
import os
import sys

import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.cli import tunesformer_train as cli
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
)
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
from ai_music_generation_tpu_torch.parallel.worker_smoke import (
    launch_workers,
)
from ai_music_generation_tpu_torch.train.optimizer import (
    hf_cosine_schedule,
    optax_adamw,
)
from ai_music_generation_tpu_torch.train.tunes_step import (
    make_tunesformer_eval_step,
    make_tunesformer_train_step,
    shard_tunesformer_step,
)

torch.set_num_threads(1)

WORLD, B, K, SEED = 4, 8, 5, 3
TINY = dict(patch_length=16, patch_size=16, patch_layers=2, char_layers=2,
            n_embd=32, n_head=2)
LR, TOTAL = 1e-3, 30
TOL, JAX_TOL = 1e-5, 2e-5
# name: (n_data, n_model, share_weights, dropout)
CASES = {"split-2x2": (2, 2, False, 0.0), "split-4x1": (4, 1, False, 0.0),
         "shared-2x2": (2, 2, True, 0.0), "dropout-2x2": (2, 2, False, 0.1)}
JAX_CASES = [n for n, c in CASES.items() if not (c[2] or c[3])]
CLI_RUN = dict(patch_length=16, patch_size=16, patch_layers=2,
               char_layers=2, n_embd=48, n_head=12, batch_size=4,
               dtype="float32", learning_rate=1e-3, num_epochs=2,
               device="cpu")


def _config(share, dropout):
    return TunesFormerConfig(**TINY, share_weights=share, dropout=dropout,
                             dtype=torch.float32)


def _schedule():
    return hf_cosine_schedule(LR, TOTAL / 10, TOTAL)


def _batches():
    """(two [B, 16, 16] batches of bos-framed random bars with padded tails,
    [B, K] sorted conditioning rows)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        x = np.zeros((B, 16, 16), np.int64)
        for b in range(B):
            for p in range(int(rng.integers(6, 16))):
                m = int(rng.integers(3, 16))
                x[b, p, 0] = 1
                x[b, p, 1:m] = rng.integers(3, 128, m - 1)
                x[b, p, m] = 2 if m < 16 else x[b, p, m - 1]
        out.append(torch.from_numpy(x))
    idx = np.sort(np.stack([rng.choice(15, K, replace=False)
                            for _ in range(B)]), axis=1)
    return out, torch.from_numpy(idx)


def _run_steps(train, evaluate):
    """Step 0 (whole context), step 1 (patch_indices), then an eval."""
    (x0, x1), idx = _batches()
    losses = [float(train(x0, 0, SEED)), float(train(x1, 1, SEED, idx))]
    return losses + [float(evaluate(x0))]


# -- the worker ---------------------------------------------------------------
def _sharded_case(case, state):
    n_data, n_model, share, dropout = case
    model = TunesFormer(_config(share, dropout), device="cpu")
    model.load_state_dict(state)
    train, evaluate, model, optimizer, plan = shard_tunesformer_step(
        make_mesh(n_data, n_model, "cpu"), model, _schedule())
    losses = _run_steps(train, evaluate)
    whole, opt = plan.gather_state(model, optimizer)
    return dict(losses=losses, state=whole, opt=opt["state"],
                placements=plan.batch_placements)


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
        results = {name: _sharded_case(CASES[name], inputs[name])
                   for name in CASES}
        results["cli"] = cli.main(_flags(dict(
            CLI_RUN, data_path=os.path.join(args.out_dir, "data.json"),
            out_dir=os.path.join(args.out_dir, "cli-mesh"), n_model=2)))
        if distributed.is_main_process():
            torch.save(results, os.path.join(args.out_dir, "results.pt"))
    finally:
        distributed.shutdown()


def _flags(c):
    return [f"--{k}={v}" for k, v in c.items()]


# -- the tests ----------------------------------------------------------------
def _jax_case(share):
    import jax
    import jax.numpy as jnp
    import optax

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
        make_tunesformer_eval_step as jax_eval,
    )
    from ai_music_generation_tpu.train.tunes_step import (
        make_tunesformer_train_step as jax_train,
    )

    model = JaxTunesFormer(JaxConfig(**TINY, dropout=0.0, share_weights=share,
                                     dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 16, 16), jnp.int32))
    tx = optax.adamw(jax_schedule(LR, TOTAL / 10, TOTAL))
    step = jax.jit(jax_train(model, tx))
    (x0, x1), idx = _batches()
    p, o, l0 = step(params, tx.init(params["params"]),
                    jnp.asarray(x0.numpy(), jnp.int32),
                    jax.random.PRNGKey(0))
    p, o, l1 = step(p, o, jnp.asarray(x1.numpy(), jnp.int32),
                    jax.random.PRNGKey(0), jnp.asarray(idx.numpy(),
                                                       jnp.int32))
    l2 = jax.jit(jax_eval(model))(p, jnp.asarray(x0.numpy(), jnp.int32))
    return params, dict(losses=[float(l0), float(l1), float(l2)],
                        params=jax.device_get(p))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results, and meanwhile (the workers run in the
    background) the single-process port's and JAX's steps."""
    import jax
    import jax.numpy as jnp

    from ai_music_generation_tpu.models.tunesformer import (
        TunesFormer as JaxTunesFormer,
    )
    from ai_music_generation_tpu.models.tunesformer import (
        TunesFormerConfig as JaxConfig,
    )
    from ai_music_generation_tpu_torch.cli import add_control_codes
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.models.convert import (
        tunesformer_state_dict_from_jax,
    )

    root = tmp_path_factory.mktemp("tunes")
    os.makedirs(root / "abc")
    for i, tune in enumerate(random_tunes(24, seed=2)):
        (root / "abc" / f"{i:03d}.abc").write_text(tune)
    assert add_control_codes.main([str(root / "abc"),
                                   f"--output={root / 'data.json'}"]) == 24
    inputs = {}
    for name, (_, _, share, dropout) in CASES.items():
        params = JaxTunesFormer(JaxConfig(
            **TINY, dropout=0.0, share_weights=share,
            dtype=jnp.float32)).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 16, 16), jnp.int32))
        inputs[name] = tunesformer_state_dict_from_jax(
            jax.device_get(params), _config(share, dropout))
    torch.save(inputs, root / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(launch_workers, [
            os.path.abspath(__file__), "--out-dir", str(root)], WORLD, 300)
        single = {}
        for name, (_, _, share, dropout) in CASES.items():
            model = TunesFormer(_config(share, dropout), device="cpu")
            model.load_state_dict(inputs[name])
            optimizer = optax_adamw(model.parameters())
            losses = _run_steps(
                make_tunesformer_train_step(model, optimizer, _schedule()),
                make_tunesformer_eval_step(model))
            single[name] = dict(losses=losses, model=model, opt=optimizer)
        # the split cores against JAX, as tests/test_tunes_multichip.py
        # holds JAX's sharded step (both cases share JAX's init)
        split = _jax_case(False)[1]
        jax_ref = {name: split for name in JAX_CASES}
        workers.result()
    return dict(root=str(root), single=single, jax=jax_ref,
                results=torch.load(root / "results.pt"))


def _span(tensors):
    return max(float(v.abs().max()) for v in tensors)


def _check_state(got, model, tol, what):
    want = model.state_dict()
    span = _span(want.values())
    for name, value in want.items():
        err = float((got[name] - value).abs().max())
        assert err <= tol * span, (what, name, err / span)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_tunes_step_matches_the_single_process_step(run, name):
    got, want = run["results"][name], run["single"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    _check_state(got["state"], want["model"], TOL, name)
    opt = want["opt"].state_dict()["state"]
    for m in ("exp_avg", "exp_avg_sq"):
        span = _span(s[m] for s in opt.values())
        for i, s in opt.items():
            err = float((got["opt"][i][m] - s[m]).abs().max())
            assert err <= TOL * span, (name, m, i, err / span)
        assert all(torch.equal(got["opt"][i]["step"], s["step"])
                   for i, s in opt.items())


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_tunes_step_matches_jax(run, name):
    from ai_music_generation_tpu_torch.models.convert import (
        tunesformer_state_dict_from_jax,
    )

    got, want = run["results"][name], run["jax"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=JAX_TOL)
    cfg = run["single"][name]["model"].config
    ref = TunesFormer(cfg, device="cpu")
    ref.load_state_dict(tunesformer_state_dict_from_jax(want["params"], cfg))
    _check_state(got["state"], ref, JAX_TOL, f"{name} vs JAX")


def test_batch_placement_is_rows_over_data(run):
    from torch.distributed.tensor import Replicate, Shard

    assert run["results"]["split-2x2"]["placements"] == (Shard(0),
                                                         Replicate())


def test_cli_with_n_model_2_over_4_processes_matches_one_process(run):
    root = run["root"]
    one = cli.main(_flags(dict(CLI_RUN, data_path=os.path.join(
        root, "data.json"), out_dir=os.path.join(root, "cli-one"))))
    mesh = run["results"]["cli"]
    assert len(mesh["epochs"]) == len(one["epochs"]) == 2
    for a, b in zip(mesh["epochs"], one["epochs"]):
        for key in ("train_loss", "eval_loss"):
            assert abs(a[key] - b[key]) <= TOL * abs(b[key]), key
    assert mesh["best_epoch"] == one["best_epoch"]
    got = torch.load(os.path.join(root, "cli-mesh", cli.WEIGHTS),
                     weights_only=False)
    want = torch.load(os.path.join(root, "cli-one", cli.WEIGHTS),
                      weights_only=False)
    span = _span(want["model"].values())
    for key, value in want["model"].items():
        assert float((got["model"][key] - value).abs().max()) <= TOL * span
    assert got["epoch"] == want["epoch"]
    # only the main process wrote its log: one block an epoch
    with open(os.path.join(root, "cli-mesh", "logs.txt")) as f:
        assert f.read().count("Epoch ") == 2


if __name__ == "__main__":
    _worker(sys.argv[1:])
