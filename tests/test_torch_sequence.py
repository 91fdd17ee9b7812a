"""Sequence parallelism (parallel/sequence.py, ops/ring_attention.py, the
``seq_axis`` branch of models/gpt.py) over gloo worker processes against
the JAX package's plain attention and plain GPT loss, as
tests/test_sequence.py holds JAX's sequence-sharded programs to them.

The workers are this file run as a script (``launch_workers``), a group of
2 ranks and one of 4 started together, each running every case of its
group once:

- ring attention at n_seq 2 and 4 ([2, 16, 2, 8] fp32 q, k, v) against
  JAX's plain masked softmax attention: the output at rtol/atol 1e-5, the
  gradients of ``sum(out ** 2)`` for q, k and v at rtol 1e-4 / atol 1e-5
  (JAX's tolerances; k and v take the reverse shifts' gradients);
- the sequence loss and every parameter gradient at (data, seq) (1, 2) and
  (2, 2), and at (2, 2) with targets ignored in data shard 0's rows and seq
  shard 0's positions only, against JAX's plain GPT loss and gradients: the
  loss at rtol 1e-6, gradients at rtol 5e-5 / atol 1e-6 (JAX's);
- ``make_seq_train_step`` with ``optax_adamw`` at (2, 2): two steps, the
  first's loss and grad norm JAX's plain values, the loss falls, every
  rank's parameters equal;
- the guards that need a mesh (a global T past block_size, T not divisible
  by n_seq), with JAX's messages; the rest run here.

Weights: the JAX model's init through ``state_dict_from_jax`` (JAX's test
config: 2 layers, 2 heads, 32 wide, block 16, vocab 64, fp32, batch 8).
"""

import argparse
import concurrent.futures
import dataclasses
import datetime
import os
import sys

import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.worker_smoke import (
    launch_workers,
)

torch.set_num_threads(1)

ARCH = dict(block_size=16, vocab_size=64, n_layer=2, n_head=2, n_embd=32,
            dropout=0.0, bias=True)
RING = (2, 16, 2, 8)  # B, T, H, D
GROUPS = {"pair": 2, "quad": 4}
# name: (group, n_data, n_seq, uneven ignore)
LOSS_CASES = {"1x2": ("pair", 1, 2, False), "2x2": ("quad", 2, 2, False),
              "2x2-uneven": ("quad", 2, 2, True)}
LR = 1e-3


def _batch(uneven=False):
    rng = np.random.default_rng(0)
    x = rng.integers(0, ARCH["vocab_size"], (8, 16))
    y = np.roll(x, -1, axis=1)
    if uneven:  # data shard 0's rows, seq shard 0's positions
        y[:3, :5] = -1
    return torch.from_numpy(x), torch.from_numpy(y)


def _qkv():
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.normal(size=RING).astype(np.float32))
            for _ in range(3)]


def _model(state, **kw):
    model = GPT(GPTConfig(**{**ARCH, **kw}, dtype=torch.float32),
                device="cpu")
    model.load_state_dict(state)
    return model


# -- the workers ---------------------------------------------------------------
def _ring(n_seq):
    import torch.distributed as dist

    from ai_music_generation_tpu_torch.ops.ring_attention import (
        ring_attention,
    )
    from ai_music_generation_tpu_torch.parallel.sequence import make_seq_mesh

    mesh = make_seq_mesh(1, n_seq, "cpu")
    group, r = mesh.get_group("seq"), dist.get_rank()
    Tl = RING[1] // n_seq
    q, k, v = (t[:, r * Tl:(r + 1) * Tl].clone().requires_grad_()
               for t in _qkv())
    out = ring_attention(q, k, v, group)
    (out ** 2).sum().backward()
    return dict(out=out.detach(), grads=[t.grad for t in (q, k, v)])


def _loss_case(state, n_data, n_seq, uneven):
    from ai_music_generation_tpu_torch.parallel.sequence import (
        make_seq_loss,
        make_seq_mesh,
        sum_grads_,
    )

    model = _model(state)
    loss_fn = make_seq_loss(model, make_seq_mesh(n_data, n_seq, "cpu"))
    share, loss = loss_fn(*_batch(uneven))
    share.backward()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad for p in model.parameters()]
    sum_grads_(grads, model.layout)
    return dict(loss=float(loss), grads=dict(zip(names, grads)))


def _train_case(state):
    from ai_music_generation_tpu_torch.parallel.sequence import (
        make_seq_mesh,
        make_seq_train_step,
    )
    from ai_music_generation_tpu_torch.train.optimizer import optax_adamw

    model = _model(state)
    step = make_seq_train_step(model, optax_adamw(model.parameters()),
                               make_seq_mesh(2, 2, "cpu"), lambda it: LR)
    metrics = [step(*_batch()) for _ in range(2)]
    return dict(loss=[float(m["loss"]) for m in metrics],
                grad_norm=float(metrics[0]["grad_norm"]),
                lr=metrics[0]["lr"],
                state={k: v.clone() for k, v in model.state_dict().items()})


def _guards(state):
    from ai_music_generation_tpu_torch.parallel.sequence import (
        make_seq_loss,
        make_seq_mesh,
    )

    out = {}
    mesh = make_seq_mesh(1, 2, "cpu")
    x, y = _batch()
    for name, model, batch in (
            ("block", GPT(GPTConfig(**dict(ARCH, block_size=8)),
                          device="cpu"), (x, y)),
            ("divisible", _model(state), (x[:, :15], y[:, :15]))):
        try:  # the model's own check sees only the local chunk
            make_seq_loss(model, mesh)(*batch)
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
        results = {"ring": _ring(args.num_processes)}
        for name, (group, n_data, n_seq, uneven) in LOSS_CASES.items():
            if group == args.group:
                results[name] = _loss_case(state, n_data, n_seq, uneven)
        if args.group == "quad":
            results["train"] = _train_case(state)
        else:
            results["guards"] = _guards(state)
        torch.save(results, os.path.join(
            args.out_dir, f"{args.group}_{args.process_id}.pt"))
    finally:
        distributed.shutdown()


# -- the references and the tests ----------------------------------------------
def _jax_setup():
    import jax
    import jax.numpy as jnp

    from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
    from ai_music_generation_tpu.models.gpt import GPTConfig as JaxConfig

    model = JaxGPT(JaxConfig(**ARCH, dtype=jnp.float32))
    x = jnp.asarray(_batch()[0].numpy(), jnp.int32)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0), x))


def _jax_plain(model, params, uneven=False):
    """JAX's plain loss and gradients (tests/test_sequence.py's
    reference), the gradients in the port's names."""
    import jax
    import jax.numpy as jnp

    from ai_music_generation_tpu_torch.models.convert import (
        state_dict_from_jax,
    )

    x, y = (jnp.asarray(t.numpy(), jnp.int32) for t in _batch(uneven))
    loss, grads = jax.value_and_grad(
        lambda p: model.apply(p, x, y)[1])(params)
    cfg = GPTConfig(**ARCH, dtype=torch.float32)
    return float(loss), state_dict_from_jax(jax.device_get(grads), cfg)


def _jax_ring():
    """JAX's plain attention (tests/test_sequence.py::_plain_attention) and
    the gradients of sum(out ** 2) for q, k and v."""
    import jax
    import jax.numpy as jnp

    def plain(q, k, v):
        T, D = q.shape[1], q.shape[3]
        mask = jnp.tril(jnp.ones((T, T), bool))
        att = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(D)
        att = jnp.where(mask[None, None], att, -jnp.inf)
        att = jax.nn.softmax(att.astype(jnp.float32), axis=-1)
        return jnp.einsum("bhts,bshd->bthd", att, v.astype(jnp.float32))

    q, k, v = (jnp.asarray(t.numpy()) for t in _qkv())
    grads = jax.grad(lambda *a: jnp.sum(plain(*a) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(plain(q, k, v)), [np.asarray(g) for g in grads]


def _jax_step(model, params):
    import jax
    import jax.numpy as jnp
    import optax

    x, y = (jnp.asarray(t.numpy(), jnp.int32) for t in _batch())
    loss, grads = jax.value_and_grad(
        lambda p: model.apply(p, x, y)[1])(params)
    return float(loss), float(optax.global_norm(grads["params"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    from ai_music_generation_tpu_torch.models.convert import (
        state_dict_from_jax,
    )

    root = str(tmp_path_factory.mktemp("sequence"))
    model, params = _jax_setup()
    state = state_dict_from_jax(params, GPTConfig(**ARCH,
                                                  dtype=torch.float32))
    torch.save(state, os.path.join(root, "state.pt"))
    with concurrent.futures.ThreadPoolExecutor(len(GROUPS)) as pool:
        launches = [pool.submit(launch_workers, [
            os.path.abspath(__file__), "--out-dir", root, "--group", group],
            n, 300) for group, n in GROUPS.items()]
        ref = {"ring": _jax_ring(), "step": _jax_step(model, params),
               "plain": _jax_plain(model, params),
               "uneven": _jax_plain(model, params, uneven=True)}
        for launch in launches:
            launch.result()
    assert jax.device_count() == 8
    results = {group: [torch.load(os.path.join(root, f"{group}_{r}.pt"))
                       for r in range(n)] for group, n in GROUPS.items()}
    return dict(ref=ref, results=results, state=state)


@pytest.mark.parametrize("group", list(GROUPS))
def test_ring_attention_matches_plain(run, group):
    """The ranks' chunks, concatenated in rank order, are the plain
    attention; each rank's q, k and v gradients are its chunk of the plain
    gradients (k and v: the sum over every rank's queries)."""
    want, want_grads = run["ref"]["ring"]
    ranks = run["results"][group]
    out = torch.cat([r["ring"]["out"] for r in ranks], dim=1)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    for i, g in enumerate(want_grads):
        got = torch.cat([r["ring"]["grads"][i] for r in ranks], dim=1)
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-4, atol=1e-5,
                                   err_msg="qkv"[i])


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_seq_loss_and_grads_match_jax_plain(run, name):
    group, _, _, uneven = LOSS_CASES[name]
    want_loss, want_grads = run["ref"]["uneven" if uneven else "plain"]
    for r in run["results"][group]:
        got = r[name]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-6)
        assert set(got["grads"]) == set(want_grads) - {"lm_head.weight"}
        for key, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want_grads[key].numpy(),
                                       rtol=5e-5, atol=1e-6, err_msg=key)


def test_uneven_ignore_changes_the_loss(run):
    """The uneven case is not the even one: ignored targets moved the
    global mean the sum over the mesh reproduces."""
    assert run["ref"]["uneven"][0] != run["ref"]["plain"][0]


def test_seq_train_step_runs_learns_and_stays_replicated(run):
    want_loss, want_norm = run["ref"]["step"]
    ranks = run["results"]["quad"]
    first = ranks[0]["train"]
    np.testing.assert_allclose(first["loss"][0], want_loss, rtol=1e-6)
    np.testing.assert_allclose(first["grad_norm"], want_norm, rtol=1e-5)
    assert first["lr"] == LR and first["loss"][1] < first["loss"][0]
    moved = any(not torch.equal(first["state"][k], v)
                for k, v in run["state"].items())
    assert moved
    for r in ranks[1:]:
        assert r["train"]["loss"] == first["loss"]
        assert all(torch.equal(v, first["state"][k])
                   for k, v in r["train"]["state"].items())


def test_guards_with_a_mesh(run):
    for r in run["results"]["pair"]:
        assert r["guards"]["block"] == "global sequence 16 exceeds " \
            "block_size 8"
        assert r["guards"]["divisible"] == "T 15 not divisible by 2 seq " \
            "shards"


def test_guards_without_a_mesh(run):
    """Dropout and MoE are refused before the mesh is read (JAX's
    messages); a cache under seq_axis and dropout in train() are refused
    by the model (JAX's meaning)."""
    from ai_music_generation_tpu_torch.models.gpt import KVCache
    from ai_music_generation_tpu_torch.parallel.sequence import make_seq_loss

    state = run["state"]
    with pytest.raises(ValueError, match="requires dropout=0"):
        make_seq_loss(_model(state, dropout=0.1), None)
    with pytest.raises(ValueError, match="MoE under sequence parallelism"):
        make_seq_loss(GPT(GPTConfig(**ARCH, n_expert=4), device="cpu"), None)
    cfg = GPTConfig(**ARCH, seq_axis="seq", dtype=torch.float32)
    model = GPT(cfg, device="cpu")
    x, y = _batch()
    with pytest.raises(NotImplementedError, match="training-path knob"):
        model(x[:, :4], cache=KVCache.create(cfg, 8, device="cpu"))
    drop = GPT(dataclasses.replace(cfg, dropout=0.1), device="cpu").train()
    with pytest.raises(NotImplementedError, match="not expressible under "
                                                  "ring attention"):
        drop(x, y, dropout_key=0)
    with pytest.raises(ValueError, match="needs a layout with a seq axis"):
        model(x, y)


if __name__ == "__main__":
    _worker(sys.argv[1:])
