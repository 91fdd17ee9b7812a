"""The trained-model decode studies of the port (ai_music_generation_tpu_
torch/experiments/{decode_studies,realpath_bench_r5,realpath_window_r5,
window64_probe,int8_quality,gqa_quality,spec_decode,spec_trace,
serve_soak}.py) against the JAX scripts in docs/experiments/.

- the corpora byte for byte: each script's recipe lines, executed with the
  JAX package's ``random_note_seq`` and ``CharTokenizer``, give the port's
  tunes, and the padded ``meta.pkl`` and the bins equal what JAX's
  ``write_meta`` / ``write_bin`` / ``prepare_char`` write;
- ``teacher_nll`` within 1e-5 of the JAX formula (int8_quality.py:105-118)
  on weights bridged through ``models/nanogpt_ckpt.py``, in fp32;
- at greedy fp32 the quality legs' generations (int8 vs bf16 cache, a
  window vs the full one) equal JAX's ``Generator`` token for token, so
  the agreement statistics are equal; ``SpecGenerator``'s verify steps (the
  committed tokens per step) equal JAX's ``generate_with_stats`` count;
- each study's ``main`` end to end on the CPU at a tiny size (2 layers, 64
  wide, 40 tunes, 10 iterations) printing its JSON line, the soak with its
  accounting asserts; without a card their default device raises.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import random_baselines as jax_baselines
from ai_music_generation_tpu.data.memmap import write_bin as jax_write_bin
from ai_music_generation_tpu.data.memmap import write_meta as jax_write_meta
from ai_music_generation_tpu.data.prepare import prepare_char as jax_prepare
from ai_music_generation_tpu.decode.generate import Generator as JaxGenerator
from ai_music_generation_tpu.decode.speculative import (
    SpecGenerator as JaxSpecGenerator,
)
from ai_music_generation_tpu.models.gpt import GPT as JaxGPT
from ai_music_generation_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ai_music_generation_tpu.models.nanogpt_ckpt import (
    nanogpt_state_from_params,
)
from ai_music_generation_tpu.tokenizers.simple import (
    CharTokenizer as JaxCharTokenizer,
)
from ai_music_generation_tpu_torch.cli.random_baselines import random_tunes
from ai_music_generation_tpu_torch.decode.speculative import SpecGenerator
from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments import (
    gqa_quality,
    int8_quality,
    realpath_bench_r5,
    realpath_window_r5,
    serve_soak,
    spec_decode,
    spec_trace,
    window64_probe,
)
from ai_music_generation_tpu_torch.models.gpt import GPT, GPTConfig
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import model_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "docs", "experiments")
COMMON = dict(block_size=64, vocab_size=40, n_layer=2, n_head=4, n_embd=64,
              dropout=0.0, bias=False)


def _recipe(script, start, stop=None):
    """The lines of ``docs/experiments/<script>`` from the first that
    starts with ``start`` up to the next blank line (or the next line that
    starts with ``stop``), executed with the JAX package's helpers."""
    with open(os.path.join(SCRIPTS, script)) as f:
        lines = f.read().splitlines()
    i = next(n for n, ln in enumerate(lines) if ln.startswith(start))
    j = next(n for n in range(i, len(lines))
             if (lines[n].startswith(stop) if stop else not lines[n].strip()))
    import random

    ns = dict(random=random, random_note_seq=jax_baselines.random_note_seq,
              KEY_SIGNATURES=jax_baselines.KEY_SIGNATURES,
              TIME_SIGNATURES=jax_baselines.TIME_SIGNATURES,
              CharTokenizer=JaxCharTokenizer)
    exec("\n".join(lines[i:j]), ns)
    return ns


@pytest.mark.parametrize("script,start", [
    ("realpath_bench_r5.py", "rng = random.Random(7)"),
    ("int8_quality.py", "rng = random.Random(7)"),
    ("gqa_quality.py", "rng = random.Random(7)"),
    ("window64_probe.py", "rng_t = random.Random(7)"),
])
def test_measure_random_corpus_is_the_jax_scripts(script, start):
    want = _recipe(script, start)["tunes"]
    assert len(want) == 3000
    assert random_tunes(3000, ds.CORPUS_SEED) == want


def test_repetitive_corpus_and_padded_meta_are_spec_decodes(tmp_path):
    ns = _recipe("spec_decode.py", "rng = random.Random(7)",
                 'ds = "/tmp/spec_ds"')
    assert ds.repetitive_tunes(3000) == ns["tunes"]
    assert ns["meta"]["vocab_size"] == ds.BENCH_VOCAB
    want = tmp_path / "jax"
    want.mkdir()
    jax_write_meta(ns["meta"], str(want / "meta.pkl"))
    ids = np.asarray(ns["tok"].encode(ns["text"]), np.uint16)
    split = int(0.9 * len(ids))
    jax_write_bin(ids[:split], str(want / "train.bin"))
    jax_write_bin(ids[split:], str(want / "val.bin"))
    got = ds.prepare_repetitive(str(tmp_path / "port"), ns["tunes"])
    for name in ("meta.pkl", "train.bin", "val.bin"):
        assert (want / name).read_bytes() == open(
            os.path.join(got, name), "rb").read(), name


def test_measure_random_layout_is_jax_prepare_char(tmp_path):
    tunes = random_tunes(40, ds.CORPUS_SEED)
    got = ds.prepare_measure_random(str(tmp_path / "port"), tunes)
    entries = [{"abc notation": t} for t in tunes]
    jax_prepare(entries[:36], entries[36:], str(tmp_path / "jax"))
    for name in ("meta.pkl", "train.bin", "val.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == open(
            os.path.join(got, name), "rb").read(), name
    assert os.path.exists(tmp_path / "port" / "validation_4.json")
    with open(ds.write_validation(str(tmp_path), tunes[36:], 6)) as f:
        val = json.load(f)
    assert [e["id"] for e in val] == ["0_0", "1_0", "2_0", "3_0", "0_1",
                                      "1_1"]
    assert [e["abc notation"] for e in val] == tunes[36:] + tunes[36:38]


def _bridged(kv_head=None, arch=(), **jax_kw):
    """(JAX model, its fp32 params, the port's fp32 model on them through
    the nanoGPT state dict)."""
    kw = dict(COMMON, n_kv_head=kv_head, **dict(arch))
    jmodel = JaxGPT(JaxGPTConfig(**kw, dtype=jnp.float32, **jax_kw))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(kv_head or 0),
                                        jnp.zeros((1, 8), jnp.int32)))
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             nanogpt_state_from_params(params, jmodel.config).items()}
    model = GPT(GPTConfig(**kw, dtype=torch.float32, **jax_kw), device="cpu")
    model.load_state_dict(model_state({"model": state}))
    return jmodel, params, model.eval()


@pytest.mark.parametrize("kv_head", [None, 2], ids=["mha", "kh2"])
def test_teacher_nll_matches_the_jax_formula(kv_head):
    jmodel, params, model = _bridged(kv_head)
    toks = np.random.default_rng(3).integers(0, 40, (4, 56)).astype(np.int32)
    prompt = 16

    def seq_nll(p, t):  # int8_quality.py:105-114
        logits, _, _ = jmodel.apply(p, t[:, :-1], t[:, 1:])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, t[:, 1:, None], axis=2)[..., 0]
        return nll[:, prompt - 1:]

    want = float(jnp.mean(jax.jit(seq_nll)(params, jnp.asarray(toks))))
    got = ds.teacher_nll(model, toks, prompt)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _greedy(jmodel, params, model, prompts, window=None):
    kw = dict(max_new_tokens=48, temperature=0.0, top_k=None, window=window)
    want = np.asarray(JaxGenerator(jmodel, **kw).generate(
        params, prompts, seed=ds.QUALITY_SEED))
    got = ds.quality_generations(model, prompts, 48, window,
                                 temperature=0.0, top_k=None)
    np.testing.assert_array_equal(got, want)
    return got, want


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(5).integers(0, 40, (4, 16)).astype(np.int32)


@pytest.mark.parametrize("study", ["int8", "window"])
def test_greedy_quality_legs_equal_jax(study, prompts):
    """int8_quality's caches (MHA, bf16 vs int8) and the window studies'
    windows (KH=2 flat int8 at the bench's head layout, which JAX's flat
    cache needs; 32 vs the full 64, where 16 + 48 tokens refresh the
    window-32 cache): each generation JAX's, and so the agreement."""
    if study == "int8":
        legs = [_bridged(None, kv_quantized=q) for q in (False, True)]
        gens = [_greedy(*leg, prompts) for leg in legs]
    else:
        leg = _bridged(2, (("n_head", 6), ("n_embd", 384)),
                       kv_quantized=True, flat_kv=True)
        gens = [_greedy(*leg, prompts, w) for w in (None, 32)]
    assert ds.agreement(gens[0][0], gens[1][0], 16) == ds.agreement(
        gens[0][1], gens[1][1], 16)


@pytest.mark.parametrize("n_draft", [4, 8])
def test_spec_committed_steps_equal_jax(n_draft):
    """spec_decode's statistic at greedy fp32 over an int8 MHA cache: the
    verify steps of each generate (60 new tokens cross a refresh) and so
    the committed tokens per step equal JAX's SpecGenerator's."""
    jmodel, params, model = _bridged(None, kv_quantized=True)
    phrase = np.asarray([3, 9, 4, 17, 3, 9, 4, 22], np.int32)
    batches = [np.stack([np.roll(phrase, r + 2 * i) for r in range(3)])
               for i in range(2)]
    kw = dict(max_new_tokens=60, temperature=0.0, top_k=None,
              n_draft=n_draft)
    gen = SpecGenerator(model, **kw)
    timed = ds.timed_generate(gen, lambda i: batches[i], 1, seed=0,
                              stats=True)
    jgen = JaxSpecGenerator(jmodel, **kw)
    want_out, want_n = jgen.generate_with_stats(params, batches[1], seed=1)
    assert timed["steps"] == [int(want_n)]
    assert spec_decode.committed_per_step(timed, gen.window) == [
        (8 + 60 - 8) / int(want_n)]
    got_out, got_n = gen.generate_with_stats(batches[1], seed=1)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))


TINY = ["--device=cpu", "--n_tunes=40", "--n_layer=2", "--n_head=4",
        "--n_embd=64", "--block_size=128", "--iters=10", "--eval_iters=2",
        "--n_gen=4", "--prompt=16", "--gen_new=40", "--batch=4", "--new=40",
        "--reps=1", "--samples=4", "--reuse"]
SOAK = ["--device=cpu", "--waves=2", "--requests=32", "--n_slots=8",
        "--max_new=16", "--block_size=64", "--n_layer=2", "--n_head=4",
        "--n_embd=64"]
STUDIES = {
    "realpath_bench_r5": (realpath_bench_r5, ["--window=64"]),
    "realpath_window_r5": (realpath_window_r5, ["--window=64"]),
    "window64_probe": (window64_probe, ["--window=32"]),
    "int8_quality": (int8_quality, []),
    "gqa_quality": (gqa_quality, []),
    "spec_decode": (spec_decode, []),
    "spec_trace": (spec_trace, []),
}


@pytest.fixture(scope="module")
def work_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("studies"))


def _walk(obj, key):
    """Every value under ``key`` anywhere in a nested result."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == key:
                yield v
            yield from _walk(v, key)
    elif isinstance(obj, list):
        for v in obj:
            yield from _walk(v, key)


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_main_runs_on_the_cpu(name, work_dir, capsys):
    module, extra = STUDIES[name]
    result = module.main([f"--work_dir={work_dir}", *TINY, *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    assert result["study"] == name and result["device"] == "cpu"
    trains = list(_walk(result, "train"))
    assert trains
    for t in trains:
        for summary in t.values() if "history" not in t else [t]:
            first, last = summary["history"][0], summary["history"][-1]
            assert last[2] < first[2]  # the val loss falls
    for nlls in _walk(result, "teacher_nll"):
        assert all(math.isfinite(v) for v in nlls.values())
    counts = [c for cs in _walk(result, "counts")
              for c in (cs if isinstance(cs, list) else [cs])]
    assert counts and all(c["k1"] == c["k2"] == 0 for c in counts)
    if name in ("spec_decode", "spec_trace"):
        assert all(c["t1_steps"] == 0 or c["calls"] == c["t1_steps"] + 1
                   for c in counts)
    else:
        assert all(c["t1_steps"] > 0 for c in counts)
    for legs in _walk(result, "cli"):
        assert [leg["cold"]["samples"] for leg in legs] == [4]
    if name == "spec_trace":
        assert {"plain", "bf16_k7", "int8dots_k7"} <= result.keys()


def test_soak_main_keeps_its_accounting(capsys):
    result = serve_soak.main(SOAK)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["study"] == "serve_soak"
    assert [w["wave"] for w in result["waves"]] == [0, 1]
    for w in result["waves"]:
        assert w["count"] == 32 and w["tokens"] >= 32
        assert w["counts"]["t1_steps"] > 0 and w["counts"]["k1"] == 0
    assert 0.0 <= result["warm_spread"] < 1.0


def test_soak_fails_a_wave_that_loses_a_request(monkeypatch):
    from ai_music_generation_tpu_torch.serve.engine import GenerationServer

    drain = GenerationServer.run_until_idle
    monkeypatch.setattr(GenerationServer, "run_until_idle",
                        lambda self: drain(self)[1:])
    with pytest.raises(AssertionError, match="31 of 32 requests"):
        serve_soak.main(SOAK)


@pytest.mark.parametrize("name", sorted(STUDIES) + ["serve_soak"])
def test_study_defaults_to_the_card(name, monkeypatch, tmp_path):
    """With no ``--device`` a study runs on the card; without one it raises
    before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = serve_soak if name == "serve_soak" else STUDIES[name][0]
    argv = [] if name == "serve_soak" else [f"--work_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="--device=cpu"):
        module.main(argv)
    assert not list(tmp_path.iterdir())


def test_sizes_default_to_the_jax_protocol():
    sizes = ds.Sizes()
    assert dataclasses.astuple(sizes)[:6] == (3000, 6, 6, 384, 256, 1500)
    assert (sizes.batch, sizes.new, sizes.n_gen, sizes.prompt,
            sizes.gen_new, sizes.samples) == (4096, 500, 64, 48, 200,
                                              (1000, 4096))
    cut = ds.schedule_for(dataclasses.replace(sizes, iters=500))
    assert (cut["max_iters"], cut["lr_decay_iters"], cut["warmup_iters"],
            cut["eval_interval"]) == (500, 500, 13, 500)
    full = ds.schedule_for(sizes, ds.SPEC_SCHEDULE)
    assert {k: full[k] for k in ds.SPEC_SCHEDULE} == ds.SPEC_SCHEDULE
