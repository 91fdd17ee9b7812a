"""Sharded serving and the sharded synth (serve/engine.py, serve/
tunes_engine.py, serve/mesh.py, cli/serve.py --mesh, synth/render.py and
eval/pipeline.py with a mesh) over gloo worker processes, against the
unsharded port and the JAX package's sharded engines.

The workers are this file run as a script (``launch_workers``), three
groups started together, each running every case of its group once:

- ``quad`` (4 ranks): ``GenerationServer`` on a 2x2 mesh (tensor parallel
  over 2 ranks, 2 slot rows a rank) for the tiny MHA int8 model and the
  flat GQA int8 model (KH 2: one K/V head of D 64 a rank); an MoE model (4
  experts, a capacity of 1) on 2x2 (the einsum path: a tick routes all
  slots together); ``TunesServer`` on 2x2 with 4 slots (rows over data)
  and 3 (every data rank runs them all); the "divide evenly" and the K/V
  head refusals;
- ``pair`` (2 ranks): ``GenerationServer`` on 2x1 for both models and
  for the MoE model on the flat path (each data shard routes its rows);
  ``cli/serve.py --mesh=2x1`` answering one HTTP request on rank 0 while
  rank 1 follows, both returning at shutdown; ``synthesize_midi_batch``
  over 2 ranks with 3 tunes (one padding row); ``EvalPipeline(
  shard_synth=True)``;
- ``idle`` (2 ranks, a 10 s process-group timeout): the server idles 12 s,
  then serves a request.

The references are computed in this process while the workers run: the
unsharded port engines, CLI, render and pipeline over the same inputs, and
the JAX ``GenerationServer(mesh=)`` on the conftest's virtual devices for
the greedy requests (fp32; ``wte`` x10 so that greedy picks are no
near-ties; the MoE weights drawn as tests/test_torch_moe_paths.py draws
them, the experts at std 0.2 so that a dropped pair moves the tokens).

Contract: the sharded port's bytes equal the unsharded port's (sampled and
top-p requests included: the counter noise depends on the request alone,
and on these seeds no row-parallel reordering flips a draw), the last
logits within 1e-4 of the unsharded engine's; greedy tokens
equal JAX's sharded engine's; the ring cursor is equal on every rank; the
render and the pipeline's WAVs are bit-equal to the unsharded ones.
"""

import argparse
import concurrent.futures
import datetime
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.parallel import distributed
from ai_music_generation_tpu_torch.parallel.worker_smoke import (
    launch_workers,
)

torch.set_num_threads(1)

TINY = dict(block_size=64, vocab_size=50, n_layer=2, n_head=2, n_embd=32,
            dropout=0.0)
VARIANTS = {
    "tiny-int8": dict(TINY, kv_quantized=True),
    "gqa-flat-int8": dict(TINY, n_head=4, n_embd=256, n_kv_head=2,
                          flat_kv=True, kv_quantized=True),
}
# capacity 1 a expert per call whether 2 or 4 tokens route (capacity
# factor 0.5): which pairs are dropped depends on routing over the whole
# batch or over each data shard
MOE = dict(TINY, n_head=4, n_embd=64, n_expert=4, expert_top_k=2,
           capacity_factor=0.5)
MOE_FLAT = dict(MOE, n_embd=128, flat_kv=True)
MODELS = {**VARIANTS, "moe": MOE, "moe-flat": MOE_FLAT}
SERVE = dict(n_slots=4, ticks_per_call=8, cache_len=32, admit_group=16)
REQS = [
    ([1, 2, 3], dict(max_new_tokens=24, seed=11, temperature=0.0)),
    ([5] * 9, dict(max_new_tokens=40, seed=22, temperature=1.2, top_p=0.9)),
    ([7, 8], dict(max_new_tokens=12, seed=3, temperature=0.8, top_k=20)),
    (list(range(1, 20)), dict(max_new_tokens=30, seed=4, temperature=0.0)),
    ([9, 4, 2, 8], dict(max_new_tokens=36, seed=5, temperature=0.0)),
    ([3] * 5, dict(max_new_tokens=20, seed=6, temperature=0.9, top_k=0,
                   top_p=0.8)),
]
GREEDY = [i for i, (_, kw) in enumerate(REQS) if kw["temperature"] <= 0]
MOE_REQS = [(np.random.default_rng(5).integers(0, 50, n).tolist(), b)
            for n, b in zip([3, 1, 20, 7, 12, 2], [30, 12, 45, 5, 40, 25])]
TUNES = dict(patch_length=16, patch_size=16, patch_layers=2, char_layers=2,
             n_embd=32, n_head=2, dropout=0.0)
ABC = "S:1\nB:2\nL:1/8\nM:4/4\nK:C\nCDEF GABc|cBAG FEDC|"
TUNE_REQS = [
    (ABC, dict(max_patch=8, seed=1, top_k=1)),
    ("L:1/8\nK:D\nde fg|", dict(max_patch=6, seed=22, temperature=0.9)),
    (ABC, dict(max_patch=5, seed=11, top_p=0.5)),
    ("L:1/4\nK:G\nGA|", dict(max_patch=7, seed=33, top_k=1,
                            show_control_code=False)),
    (ABC, dict(max_patch=4, seed=44, top_k=3)),
]
GROUPS = {"quad": 4, "pair": 2, "idle": 2}
IDLE_TIMEOUT, IDLE_S = 10, 12
SHORT_TUNES = [
    "X:3\nL:1/8\nM:4/4\nK:C\nCDEF GABc|c2B2 A2G2|",
    "X:7\nL:1/4\nM:3/4\nK:G\n[GBd] e f|g3|",
    "X:9\nL:1/8\nM:2/4\nK:D\ndf af|e2 d2|",
]


# -- shared by the workers and the references ---------------------------------
def _model(state, kw):
    model = GPT(GPTConfig(**kw, dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    return model.eval()


def _serve(srv, reqs=REQS):
    ids = [srv.submit(p, **kw) for p, kw in reqs]
    done = {r.id: r.generated for r in srv.run_until_idle()}
    return [done[i] for i in ids]


def _moe_reqs():
    return [(p, dict(max_new_tokens=b, temperature=0.0, seed=i))
            for i, (p, b) in enumerate(MOE_REQS)]


def _tunes_model():
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer,
        TunesFormerConfig,
    )

    model = TunesFormer(TunesFormerConfig(**TUNES, dtype=torch.float32),
                        device="cpu")
    init_tunesformer_weights(model, torch.Generator().manual_seed(3))
    return model.eval()


def _tunes(srv):
    ids = [srv.submit(p, **kw) for p, kw in TUNE_REQS]
    done = {r.id: r.text for r in srv.run_until_idle()}
    return [done[i] for i in ids]


def _midis():
    from ai_music_generation_tpu_torch.abcnotation.to_midi import (
        abc_to_midi,
    )
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )

    return [abc_to_midi(t) for t in random_tunes(3, 5)]


def _pipeline(abc_dir, out, shard):
    from ai_music_generation_tpu_torch.eval import pipeline

    return pipeline.EvalPipeline(pipeline.PipelineConfig(
        abc_input_folder=abc_dir, base_output_dir=out, shard_synth=shard,
        synth_batch=3, metrics_processes=1, device="cpu")).run()


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _cli_reply(c):
    """One HTTP request to ``cli/serve.py``'s server of config ``c``; a
    follower (``--mesh``, rank > 0) follows instead. Returns the reply
    (None on a follower)."""
    from ai_music_generation_tpu_torch.cli import serve as serve_cli

    runner, httpd = serve_cli.build_server(c)
    if httpd is None:
        runner.follow()
        return None
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        return _post(httpd.server_address[1],
                     {"prompt": "X:1\nK:G\n", "max_new_tokens": 12,
                      "temperature": 0.7, "seed": 5})
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
        thread.join(timeout=10)


def _cli_config(root):
    from ai_music_generation_tpu_torch.cli import serve as serve_cli

    return dict(serve_cli.DEFAULTS, out_dir=os.path.join(root, "ckpt"),
                data_root=os.path.join(root, "data"), tokens_format="char",
                port=0, n_slots=4, ticks_per_call=8, cache_len=32,
                kv_quantized=True, flat_kv=True, dtype="float32",
                device="cpu")


# -- the workers ---------------------------------------------------------------
def _gpt_case(inputs, name, n_data, n_model):
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    srv = GenerationServer(_model(inputs[name], MODELS[name]), **SERVE,
                           mesh=make_mesh(n_data, n_model, "cpu"))
    tokens = None
    if srv.link.controller:
        tokens = _serve(srv, _moe_reqs() if name.startswith("moe")
                        else REQS)
        srv.shutdown()
    else:
        srv.follow()
    return dict(tokens=tokens, cursor=int(srv.cache.cursor),
                cache=tuple(srv.cache.k[0].shape),
                logits=srv.last_logits.clone())


def _tunes_case(n_slots):
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer

    srv = TunesServer(_tunes_model(), n_slots=n_slots,
                      mesh=make_mesh(2, 2, "cpu"))
    texts = None
    if srv.link.controller:
        texts = _tunes(srv)
        srv.shutdown()
    else:
        srv.follow()
    return dict(texts=texts, rows=srv._patch_cache.k[0].shape[0])


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _quad(root, inputs):
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    out = {f"gpt-2x2-{name}": _gpt_case(inputs, name, 2, 2)
           for name in VARIANTS}
    out["moe-2x2"] = _gpt_case(inputs, "moe", 2, 2)
    out["tunes-4"] = _tunes_case(4)
    out["tunes-3"] = _tunes_case(3)
    out["uneven"] = _refusal(lambda: GenerationServer(
        _model(inputs["tiny-int8"], VARIANTS["tiny-int8"]), n_slots=5,
        mesh=make_mesh(2, 2, "cpu")))
    kh1 = dict(VARIANTS["gqa-flat-int8"], n_kv_head=1)
    out["kv-split"] = _refusal(lambda: GenerationServer(
        _model(inputs["kh1"], kh1), **SERVE, mesh=make_mesh(1, 4, "cpu")))
    return out


def _pair(root, inputs):
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.synth.render import (
        synthesize_midi_batch,
    )

    out = {f"gpt-2x1-{name}": _gpt_case(inputs, name, 2, 1)
           for name in VARIANTS}
    out["moe-flat-2x1"] = _gpt_case(inputs, "moe-flat", 2, 1)
    out["cli"] = _cli_reply(dict(_cli_config(root), mesh="2x1"))
    out["synth"] = synthesize_midi_batch(
        _midis(), mesh=make_mesh(2, 1, "cpu"), device="cpu")
    out["pipeline"] = _pipeline(os.path.join(root, "abc"),
                                os.path.join(root, "sharded"), True)
    return out


def _idle(root, inputs):
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    srv = GenerationServer(_model(inputs["tiny-int8"],
                                  VARIANTS["tiny-int8"]), **SERVE,
                           mesh=make_mesh(2, 1, "cpu"))
    if not srv.link.controller:
        srv.follow()
        return {}
    time.sleep(IDLE_S)  # the follower waits in the control broadcast
    tokens = _serve(srv, REQS[:2])
    srv.shutdown()
    return dict(tokens=tokens)


def _worker(argv):
    ap = argparse.ArgumentParser()
    for flag in ("--port", "--process-id", "--num-processes"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--group", required=True)
    args = ap.parse_args(argv)
    timeout = IDLE_TIMEOUT if args.group == "idle" else 120
    distributed.initialize_distributed(
        "cpu", rank=args.process_id, world_size=args.num_processes,
        master_addr="localhost", master_port=args.port,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        inputs = torch.load(os.path.join(args.out_dir, "inputs.pt"))
        run = {"quad": _quad, "pair": _pair, "idle": _idle}[args.group]
        results = run(args.out_dir, inputs)
        torch.save(results, os.path.join(
            args.out_dir, f"{args.group}_{args.process_id}.pt"))
    finally:
        distributed.shutdown()


# -- the references and the tests ----------------------------------------------
def _jax_models(kw, moe=False):
    import jax
    import jax.numpy as jnp

    from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
    from ai_music_generation_tpu.models.gpt import GPTConfig as JaxConfig
    from ai_music_generation_tpu_torch.models.convert import (
        state_dict_from_jax,
    )

    jmodel = JaxGPT(JaxConfig(**kw, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    if moe:  # tests/test_torch_moe_paths.py's draw, the experts at 0.2
        rng = np.random.default_rng(0)  # so that their output moves tokens

        def draw(path, leaf):
            names = [getattr(k, "key", "") for k in path]
            std = (0.5 if "router" in names or "wte" in names
                   else 0.2 if "moe" in names else 0.05)
            mean = 1.0 if names[-1] == "scale" else 0.0
            return (mean + std * rng.standard_normal(leaf.shape)).astype(
                np.float32)

        params = jax.tree_util.tree_map_with_path(draw, params)
    else:
        p = params["params"]
        p["wte"]["embedding"] = np.asarray(p["wte"]["embedding"]) * 10.0
    state = state_dict_from_jax(params, GPTConfig(**kw, dtype=torch.float32))
    return jmodel, params, state


def _jax_sharded(jmodel, params, n_data, n_model, reqs):
    import jax

    from ai_music_generation_tpu.parallel.mesh import make_mesh
    from ai_music_generation_tpu.serve.engine import GenerationServer

    mesh = make_mesh(n_data, n_model,
                     devices=jax.devices()[:n_data * n_model])
    return _serve(GenerationServer(jmodel, params, **SERVE, mesh=mesh), reqs)


def _write_cli_inputs(root):
    """A char corpus (its meta.pkl) and a ckpt.pt of the flat GQA model."""
    from ai_music_generation_tpu_torch.cli.random_baselines import (
        random_tunes,
    )
    from ai_music_generation_tpu_torch.data.prepare import prepare_char
    from ai_music_generation_tpu_torch.models.convert import init_weights
    from ai_music_generation_tpu_torch.models.nanogpt_ckpt import save_ckpt

    entries = [{"abc notation": t} for t in random_tunes(20, seed=3)]
    vocab, _, _ = prepare_char(entries[:16], entries[16:],
                               os.path.join(root, "data", "irishman"))
    kw = dict(VARIANTS["gqa-flat-int8"], vocab_size=vocab)
    model = GPT(GPTConfig(**kw, dtype=torch.float32), device="cpu")
    init_weights(model, torch.Generator().manual_seed(4))
    os.makedirs(os.path.join(root, "ckpt"))
    save_ckpt(os.path.join(root, "ckpt", "ckpt.pt"), model, iter_num=1,
              train_config={"dataset": "irishman"})


def _wavs(root):
    found = {}
    for d, _, files in os.walk(os.path.join(root, "wav")):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                found[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return found


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer
    from ai_music_generation_tpu_torch.serve.tunes_engine import TunesServer
    from ai_music_generation_tpu_torch.synth.render import (
        synthesize_midi_batch,
    )

    root = str(tmp_path_factory.mktemp("serve_mesh"))
    models = {name: _jax_models(kw) for name, kw in VARIANTS.items()}
    models["moe"] = _jax_models(MOE, moe=True)
    models["moe-flat"] = _jax_models(MOE_FLAT, moe=True)
    inputs = {name: m[2] for name, m in models.items()}
    inputs["kh1"] = _jax_models(dict(VARIANTS["gqa-flat-int8"],
                                     n_kv_head=1))[2]
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    _write_cli_inputs(root)
    abc = os.path.join(root, "abc")
    os.makedirs(abc)
    for i, text in enumerate(SHORT_TUNES):
        with open(os.path.join(abc, f"sample_{i}.abc"), "w") as f:
            f.write(text)
    ref = {}
    with concurrent.futures.ThreadPoolExecutor(len(GROUPS)) as pool:
        launches = [pool.submit(launch_workers, [
            os.path.abspath(__file__), "--out-dir", root, "--group", group],
            n, 300) for group, n in GROUPS.items()]
        for name, kw in VARIANTS.items():
            srv = GenerationServer(_model(inputs[name], kw), **SERVE)
            ref[name] = dict(tokens=_serve(srv), cursor=int(srv.cache.cursor),
                             logits=srv.last_logits.clone())
        srv = GenerationServer(_model(inputs["moe"], MOE), **SERVE)
        ref["moe"] = dict(tokens=_serve(srv, _moe_reqs()),
                          cursor=int(srv.cache.cursor))
        for slots in (4, 3):
            ref[f"tunes-{slots}"] = _tunes(TunesServer(_tunes_model(),
                                                       n_slots=slots))
        ref["cli"] = _cli_reply(_cli_config(root))
        ref["synth"] = synthesize_midi_batch(_midis(), device="cpu")
        # shard_synth in a plain process: the one device, unsharded
        ref["pipeline"] = _pipeline(abc, os.path.join(root, "plain"), True)
        ref["jax"] = {
            "tiny-int8": _jax_sharded(*models["tiny-int8"][:2], 2, 2, REQS),
            "gqa-flat-int8": _jax_sharded(*models["gqa-flat-int8"][:2], 2, 1,
                                          REQS),
            "moe": _jax_sharded(*models["moe"][:2], 2, 2, _moe_reqs()),
            "moe-flat": _jax_sharded(*models["moe-flat"][:2], 2, 1,
                                     _moe_reqs()),
        }
        for launch in launches:
            launch.result()
    # the synth's waves are numpy arrays
    results = {group: [torch.load(os.path.join(root, f"{group}_{r}.pt"),
                                  weights_only=False)
                       for r in range(n)] for group, n in GROUPS.items()}
    return dict(root=root, ref=ref, results=results)


CASES = [(f"gpt-{mesh}-{name}", name, group) for name in VARIANTS
         for mesh, group in (("2x1", "pair"), ("2x2", "quad"))]


@pytest.mark.parametrize("case,name,group", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_bytes_equal_the_unsharded_engine(run, case, name, group):
    """Every request's tokens (greedy, top-k, top-p) equal the unsharded
    port engine's; the ring cursor is the same on every rank and equal to
    the unsharded engine's."""
    ranks = run["results"][group]
    assert ranks[0][case]["tokens"] == run["ref"][name]["tokens"]
    assert {r[case]["cursor"] for r in ranks} == {run["ref"][name]["cursor"]}


@pytest.mark.parametrize("case,name,group", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_logits_within_fp32_tolerance(run, case, name, group):
    """Each slot's last logits, gathered over the data ranks (model rank 0
    of each; the model ranks hold the same gathered logits), within 1e-4
    of the unsharded engine's (fp32: the row-parallel sums and the vocab
    gather add in another order; the logits are O(1)-O(10))."""
    ranks = run["results"][group]
    n_model = 2 if case.startswith("gpt-2x2") else 1
    for r in range(0, len(ranks), n_model):
        for peer in range(r + 1, r + n_model):
            assert torch.equal(ranks[peer][case]["logits"],
                               ranks[r][case]["logits"])
    got = torch.cat([ranks[r][case]["logits"]
                     for r in range(0, len(ranks), n_model)])
    want = run["ref"][name]["logits"]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


# the mesh JAX runs each variant on (its flat path refuses a model axis)
JAX_CASES = [("gpt-2x2-tiny-int8", "tiny-int8", "quad"),
             ("gpt-2x1-gqa-flat-int8", "gqa-flat-int8", "pair")]


@pytest.mark.parametrize("case,name,group", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_sharded_greedy_tokens_equal_jax_sharded_engine(run, case, name,
                                                        group):
    got = run["results"][group][0][case]["tokens"]
    want = run["ref"]["jax"][name]
    assert [got[i] for i in GREEDY] == [list(want[i]) for i in GREEDY]


def test_each_rank_holds_its_rows_and_kv_heads(run):
    """2x2: 2 of the 4 slot rows a rank and half the K/V heads (one KV head
    of D 64 for the flat GQA model); 2x1: the rows alone."""
    quad, pair = run["results"]["quad"], run["results"]["pair"]
    for r in quad:
        assert r["gpt-2x2-tiny-int8"]["cache"] == (2, 32, 16)
        assert r["gpt-2x2-gqa-flat-int8"]["cache"] == (2, 32, 64)
    for r in pair:
        assert r["gpt-2x1-gqa-flat-int8"]["cache"] == (2, 32, 128)


def test_moe_sharded_routes_as_jax_and_the_unsharded_engine(run):
    """The einsum path: a tick routes all 4 slots together (the gathered
    capacity counts), as JAX's GSPMD engine and the unsharded engine do."""
    quad = run["results"]["quad"]
    got = quad[0]["moe-2x2"]["tokens"]
    assert got == [list(w) for w in run["ref"]["jax"]["moe"]]
    assert got == run["ref"]["moe"]["tokens"]
    assert {r["moe-2x2"]["cursor"] for r in quad} == {
        run["ref"]["moe"]["cursor"]}


def test_moe_flat_routes_each_data_shard_as_jax(run):
    """The flat path: JAX runs the ticks under ``shard_map`` over the data
    axis, so each data shard routes its own 2 slots; the port's sharded
    engine gives JAX's sharded engine's tokens."""
    got = run["results"]["pair"][0]["moe-flat-2x1"]["tokens"]
    assert got == [list(w) for w in run["ref"]["jax"]["moe-flat"]]


@pytest.mark.parametrize("slots", [4, 3])
def test_tunes_server_texts_equal_the_unsharded_server(run, slots):
    """4 slots ride the data axis (2 rows a rank); 3 do not divide it, and
    every data rank runs all 3 rows, as JAX replicates them."""
    quad = run["results"]["quad"]
    assert quad[0][f"tunes-{slots}"]["texts"] == run["ref"][f"tunes-{slots}"]
    assert {r[f"tunes-{slots}"]["rows"] for r in quad} == {
        2 if slots == 4 else 3}


def test_refusals(run):
    """The slot count must divide the data axis (JAX's message); K/V heads
    that a model axis cannot split are named, not guessed."""
    for r in run["results"]["quad"]:
        assert "divide evenly" in r["uneven"]
        assert "n_kv_head=1 does not split over a model axis of 4" in \
            r["kv-split"]


def test_cli_mesh_reply_equals_the_unsharded_cli(run):
    pair = run["results"]["pair"]
    assert pair[0]["cli"] == run["ref"]["cli"]
    assert pair[1]["cli"] is None  # the follower returned at shutdown
    assert len(run["ref"]["cli"]["tokens"]) == 12


def test_cli_mesh_without_torchrun_raises(run):
    from ai_music_generation_tpu_torch.cli import serve as serve_cli

    with pytest.raises(RuntimeError, match="torchrun"):
        serve_cli.build_server(dict(_cli_config(run["root"]), mesh="2x1"))


def test_sharded_synth_is_bit_equal(run):
    """3 tunes over 2 data ranks (one padding row); every rank returns the
    whole list."""
    want = run["ref"]["synth"]
    for r in run["results"]["pair"]:
        got = r["synth"]
        assert len(got) == 3 and all(w.size for w in want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_sharded_pipeline_writes_the_same_wavs(run):
    pair, root = run["results"]["pair"], run["root"]
    assert pair[1]["pipeline"] is None  # rank 1 rendered its share only
    assert pair[0]["pipeline"]["n_failed"] == run["ref"]["pipeline"][
        "n_failed"] == 0
    got, want = (_wavs(os.path.join(root, d)) for d in ("sharded", "plain"))
    assert len(want) == len(SHORT_TUNES) and got == want


def test_idle_longer_than_the_group_timeout_then_serve(run):
    """The follower waited IDLE_S in the control broadcast, past the
    process group's IDLE_TIMEOUT, and the server then served."""
    assert IDLE_S > IDLE_TIMEOUT
    got = run["results"]["idle"][0]["tokens"]
    assert got == run["ref"]["tiny-int8"]["tokens"][:2]


if __name__ == "__main__":
    _worker(sys.argv[1:])
