"""The window and refresh contracts of the port (ai_music_generation_tpu_
torch/experiments/{window_quality,refresh_quality,window_flat_probe}.py)
against the JAX scripts in docs/experiments/.

- refresh_quality's corpus: the script's recipe lines, executed with the
  JAX package's ``random_note_seq``, give the port's ``random_tunes(3000,
  7)``, and its ``prepare_char`` layout (2,700 train, 300 val) is JAX's
  byte for byte;
- on weights bridged through ``models/nanogpt_ckpt.py``, in fp32, within
  1e-5 absolute: the last-token NLL at two context lengths
  (refresh_quality.py:57-61) and window_quality's ``seq_nll``
  (window_quality.py:80-85);
- at greedy fp32 ``Generator(refresh=r)`` emits JAX's tokens for two r;
- the prompts' and windows' offsets are the scripts' numpy draws;
- each study's ``main`` end to end on the CPU at a tiny size, printing its
  JSON line; without a card their default device raises.
"""

import json
import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import random_baselines as jax_baselines
from ai_music_generation_tpu.data.prepare import prepare_char as jax_prepare
from ai_music_generation_tpu.decode.generate import Generator as JaxGenerator
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.nanogpt_ckpt import (
    nanogpt_state_from_params,
)
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.decode.generate import Generator
from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments import (
    refresh_quality,
    window_flat_probe,
    window_quality,
)
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import model_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "docs", "experiments")
COMMON = dict(block_size=64, vocab_size=40, n_layer=2, n_head=4, n_embd=64,
              dropout=0.0, bias=False)
NLL_ATOL = 1e-5  # fp32, absolute


def _script_lines(script):
    with open(os.path.join(SCRIPTS, script)) as f:
        return f.read().splitlines()


def _recipe(script, start):
    """The lines of ``docs/experiments/<script>`` from the first that starts
    with ``start`` to the next blank line, executed with the JAX package's
    helpers."""
    lines = _script_lines(script)
    i = next(n for n, ln in enumerate(lines) if ln.startswith(start))
    j = next(n for n in range(i, len(lines)) if not lines[n].strip())
    ns = dict(random=random, random_note_seq=jax_baselines.random_note_seq,
              KEY_SIGNATURES=jax_baselines.KEY_SIGNATURES,
              TIME_SIGNATURES=jax_baselines.TIME_SIGNATURES)
    exec("\n".join(lines[i:j]), ns)
    return ns


@pytest.fixture(scope="module")
def refresh_tunes():
    return _recipe("refresh_quality.py", "rng = random.Random(7)")["tunes"]


def test_refresh_corpus_is_the_jax_scripts(refresh_tunes):
    assert len(refresh_tunes) == 3000
    assert random_tunes(3000, ds.CORPUS_SEED) == refresh_tunes
    assert refresh_quality.SIZES.n_tunes == 3000


def test_refresh_layout_is_jax_prepare_char(refresh_tunes, tmp_path):
    """refresh_quality.py:30-32: 2,700 train and 300 val entries."""
    entries = [{"abc notation": t} for t in refresh_tunes]
    jax_prepare(entries[:2700], entries[2700:], str(tmp_path / "jax"))
    got = ds.prepare_measure_random(str(tmp_path / "port"), refresh_tunes)
    for name in ("meta.pkl", "train.bin", "val.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == open(
            os.path.join(got, name), "rb").read(), name


def test_refresh_schedule_is_the_scripts():
    """refresh_quality.py:35-40 at the protocol's sizes."""
    c = ds.schedule_for(refresh_quality.SIZES, refresh_quality.SCHEDULE)
    assert {k: c[k] for k in refresh_quality.SCHEDULE} == dict(
        n_layer=4, n_head=4, n_embd=256, block_size=256, batch_size=32,
        gradient_accumulation_steps=1, max_iters=1200, eval_interval=400,
        eval_iters=20, log_interval=200, warmup_iters=40,
        lr_decay_iters=1200, learning_rate=3e-3, min_lr=3e-4,
        dtype="bfloat16", dropout=0.0)


def test_offsets_are_the_scripts_draws(tmp_path):
    ids = np.random.default_rng(9).integers(0, 128, 5000).astype(np.uint16)
    ids.tofile(tmp_path / "val.bin")
    # window_quality.py:60-64
    rng = np.random.default_rng(7)
    offs = rng.integers(0, len(ids) - 48, 64)
    want = np.stack([ids[o:o + 48].astype(np.int32) for o in offs])
    np.testing.assert_array_equal(
        window_quality.val_prompts(str(tmp_path), 64, 48), want)
    # refresh_quality.py:51-55
    r = np.random.default_rng(0)
    starts = r.integers(0, len(ids) - 257, size=256)
    want = np.stack([ids[s:s + 256 + 1] for s in starts]).astype(np.int32)
    np.testing.assert_array_equal(
        refresh_quality.val_windows(str(tmp_path), 256), want)


def _bridged(seed=0):
    """(JAX model, its fp32 params, the port's fp32 model on them)."""
    jmodel = JaxGPT(JaxGPTConfig(**COMMON, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 8), jnp.int32)))
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             nanogpt_state_from_params(params, jmodel.config).items()}
    model = GPT(GPTConfig(**COMMON, dtype=torch.float32), device="cpu")
    model.load_state_dict(model_state({"model": state}))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def bridged():
    return _bridged()


def test_last_token_nll_matches_the_jax_formula(bridged):
    jmodel, params, model = bridged
    full = np.random.default_rng(4).integers(
        0, 40, (8, 65)).astype(np.int32)

    @jax.jit
    def last_token_nll(params, x, y_last):  # refresh_quality.py:57-61
        logits, _, _ = jmodel.apply(params, x)
        logp = jax.nn.log_softmax(logits[:, -1, :].astype(jnp.float32))
        return -jnp.take_along_axis(logp, y_last[:, None], axis=1)[:, 0]

    got = refresh_quality.nll_vs_context(model, full, (16, 63))
    for ctx in (16, 63):
        want = float(jnp.mean(last_token_nll(
            params, jnp.asarray(full[:, 64 - ctx:64]),
            jnp.asarray(full[:, 64]))))
        assert abs(got[str(ctx)] - want) <= NLL_ATOL, (ctx, got, want)


def test_seq_nll_matches_the_jax_formula(bridged):
    jmodel, params, model = bridged
    toks = np.random.default_rng(6).integers(0, 40, (4, 60)).astype(np.int32)
    prompt = 12

    @jax.jit
    def seq_nll(p, toks):  # window_quality.py:80-85
        logits, _, _ = jmodel.apply(p, toks[:, :-1], toks[:, 1:])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, toks[:, 1:, None], axis=2)[..., 0]
        return nll[:, prompt - 1:]

    want = float(jnp.mean(seq_nll(params, jnp.asarray(toks))))
    got = ds.teacher_nll(model, toks, prompt)
    assert abs(got - want) <= NLL_ATOL, (got, want)


@pytest.mark.parametrize("refresh", [16, 48])
def test_greedy_refresh_tokens_equal_jax(bridged, refresh):
    """40-token prompts and 60 new tokens at block 64: the window refreshes
    every ``refresh`` tokens once it is full."""
    jmodel, params, model = bridged
    prompts = np.random.default_rng(8).integers(0, 40, (3, 40)).astype(
        np.int32)
    kw = dict(max_new_tokens=60, temperature=0.0, top_k=None,
              refresh=refresh)
    want = np.asarray(JaxGenerator(jmodel, **kw).generate(params, prompts,
                                                          seed=1))
    got = Generator(model, **kw).generate(prompts, seed=1).numpy()
    np.testing.assert_array_equal(got, want)


TINY = ["--device=cpu", "--n_tunes=40", "--n_layer=2", "--n_head=4",
        "--n_embd=64", "--iters=10", "--eval_iters=2", "--n_gen=4",
        "--batch=4", "--new=40", "--reps=1"]
STUDIES = {
    "window_quality": (window_quality, [
        "--block_size=128", "--prompt=16", "--gen_new=40",
        "--windows=128,96,64"]),
    "refresh_quality": (refresh_quality, [
        "--block_size=64", "--prompt=40", "--contexts=16,32,63",
        "--refreshes=16,32,48"]),
}


@pytest.fixture(scope="module")
def work_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("window_refresh"))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_main_runs_on_the_cpu(name, work_dir, capsys):
    module, extra = STUDIES[name]
    result = module.main([f"--work_dir={work_dir}", *TINY, *extra])
    assert _last_json(capsys) == json.loads(json.dumps(result))
    assert result["study"] == name and result["device"] == "cpu"
    hist = result["train"]["history"]
    assert hist[-1][2] < hist[0][2]  # the val loss falls
    legs = result["throughput"]
    assert list(legs) == extra[-1].split("=")[1].split(",")
    for t in legs.values():
        assert t["batch"] == 4
        (c,) = t["counts"]
        assert c["t1_steps"] > 0 and c["k1"] == c["k2"] == 0
    if name == "window_quality":
        assert set(result["agreement"]) == {"96", "64"}
        assert all(math.isfinite(v) for v in result["teacher_nll"].values())
        assert set(result["structural"]) == {"128", "96", "64"}
    else:
        nll = result["nll_vs_context"]
        assert list(nll) == ["16", "32", "63"]
        assert all(math.isfinite(v) for v in nll.values())


def test_window_quality_skips_the_bench(tmp_path, capsys):
    """``--no-bench``; ``--reuse`` trains the spec checkpoint when it is
    missing."""
    module, extra = STUDIES["window_quality"]
    result = module.main([f"--work_dir={tmp_path}", *TINY, *extra,
                          "--reuse", "--no-bench"])
    assert "throughput" not in result and not result["train"]["reused"]
    assert os.path.exists(tmp_path / "ckpt_spec" / "last_iter_ckpt.pt")


def test_window_flat_probe_rows(capsys):
    """Both configurations at a 6-head 384-wide shape (2 layers): the
    flagship at each window, MHA at the full one; a row a leg, then the
    closing ``{"all": ...}`` line."""
    result = window_flat_probe.main([
        "--device=cpu", "--n_layer=2", "--n_head=6", "--n_embd=384",
        "--block_size=128", "--batch=4", "--new=40", "--reps=1",
        "--windows=128,64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(result))
    rows = result["all"]
    assert [(r["config"], r["window"]) for r in rows] == [
        ("flagship KH=2 flat", 128), ("flagship KH=2 flat", 64),
        ("MHA KH=6 einsum", 128)]
    assert [json.loads(ln) for ln in lines[-4:-1]] == json.loads(
        json.dumps(rows))
    for r in rows:
        assert r["tok_s"] > 0 and r["counts"][0]["t1_steps"] == 40


@pytest.mark.parametrize("name", sorted(STUDIES) + ["window_flat_probe"])
def test_study_defaults_to_the_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "window_flat_probe":
        module, argv = window_flat_probe, []
    else:
        module, argv = STUDIES[name][0], [f"--work_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="--device=cpu"):
        module.main(argv)
    assert not list(tmp_path.iterdir())
