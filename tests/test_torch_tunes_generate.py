"""The port's TunesFormer generation (decode/tunes_generate.py and the
cli/tunesformer_generate.py, cli/sample_tunesformer.py entry points)
against the JAX package's, on the same weights.

Config: the JAX tests' ``TINY_CFG`` (patch_length 16, patch_size 16, 2+2
layers, 32 wide, 2 heads, fp32), JAX init weights through
``tunesformer_state_dict_from_jax``. JAX samples from threefry streams,
which torch cannot reproduce, so parity is held where it is defined: the
filtered sampling distribution (within 1e-6; the rank order exactly) and
texts at ``top_k=1``, where both frameworks are deterministic. The port's
own seed contract (same seed, same tunes) is held by a frozen golden.
"""

import argparse
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.cli import sample_tunesformer as jax_sample_cli
from ai_music_generation_tpu.decode import tunes_generate as jax_tg
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormer as JaxTunesFormer,
)
from ai_music_generation_tpu.models.tunesformer import (
    TunesFormerConfig as JaxConfig,
)
from ai_music_generation_tpu.tokenizers.patchilizer import (
    Patchilizer as JaxPatchilizer,
)
from ai_music_generation_tpu_torch.cli import sample_tunesformer
from ai_music_generation_tpu_torch.cli import tunesformer_generate
from ai_music_generation_tpu_torch.decode import tunes_generate as tg
from ai_music_generation_tpu_torch.decode.tunes_generate import (
    TunesGenerator,
    bar_scan,
    sample_top_p_top_k_temperature,
)
from ai_music_generation_tpu_torch.models.convert import (
    init_tunesformer_weights,
    tunesformer_state_dict_from_jax,
)
from ai_music_generation_tpu_torch.models.tunesformer import (
    TunesFormer,
    TunesFormerConfig,
)
from ai_music_generation_tpu_torch.models.tunesformer_export import (
    save_reference_checkpoint,
)
from ai_music_generation_tpu_torch.tokenizers.patchilizer import Patchilizer

torch.set_num_threads(1)

TINY = dict(patch_length=16, patch_size=16, patch_layers=2, char_layers=2,
            n_embd=32, n_head=2, dropout=0.0)
GREEDY = dict(top_p=0.9, top_k=1, temperature=1.0)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    jmodel = JaxTunesFormer(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16, 16), jnp.int32)))
    cfg = TunesFormerConfig(**TINY, dtype=torch.float32)
    model = TunesFormer(cfg, device="cpu")
    model.load_state_dict(tunesformer_state_dict_from_jax(params, cfg))
    return jmodel, params, model.eval()


def _probs(B=6, V=128, seed=0):
    logits = np.random.default_rng(seed).standard_normal((B, V)) * 2.0
    logits[0, 5:9] = logits[0, 3]  # ties: the lower index ranks first
    logits[1, :] = 0.0  # all tied
    return jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)


@pytest.mark.parametrize("top_p,top_k,temperature", [
    (0.8, 8, 1.2), (1.0, 0, 1.0), (0.5, 0, 0.7), (0.95, 3, 2.0),
    (0.0, 0, 1.0)])
def test_sampling_filter_equals_jax(monkeypatch, top_p, top_k, temperature):
    """The distribution the port draws from (its exponential race's
    ``filtered``, normalized) equals the one JAX's
    ``sample_top_p_top_k_temperature`` hands ``jax.random.categorical``
    (captured), within 1e-6 per token; the sorted order is JAX's
    ``lax.top_k`` order, ties toward the lower index."""
    probs = _probs()
    seen = {}
    categorical = jax.random.categorical

    def capture(key, logp, axis=-1):
        seen["jax"] = np.asarray(logp)
        return categorical(key, logp, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_tg.sample_top_p_top_k_temperature(
        probs, jax.random.PRNGKey(0), top_p, top_k, temperature)
    draw = tg.draw

    def capture_draw(filtered, sorted_idx, noise):
        seen["port"] = (filtered, sorted_idx)
        return draw(filtered, sorted_idx, noise)

    monkeypatch.setattr(tg, "draw", capture_draw)
    got = sample_top_p_top_k_temperature(
        torch.from_numpy(np.array(probs)), torch.Generator().manual_seed(0),
        top_p, top_k, temperature)
    filtered, sorted_idx = seen["port"]
    _, jidx = jax.lax.top_k(probs, probs.shape[-1])
    np.testing.assert_array_equal(sorted_idx.numpy(), np.asarray(jidx))
    want = np.asarray(jax.nn.softmax(jnp.asarray(seen["jax"]), axis=-1))
    mine = (filtered / filtered.sum(-1, keepdim=True)).numpy()
    np.testing.assert_allclose(mine, want, atol=1e-6, rtol=0)
    # the draw lies in the kept set
    kept = mine > 0
    rank = (sorted_idx == got[:, None].long()).int().argmax(-1)
    assert kept[np.arange(len(kept)), rank.numpy()].all()


def test_draws_follow_the_filtered_distribution():
    """Many draws at fresh seeds match the filtered distribution (the
    exponential race samples proportionally to ``filtered``)."""
    probs = torch.from_numpy(np.array(_probs(B=2, seed=3)))
    filtered, sorted_idx = tg.filter_sorted(probs, 0.9, 6, 1 / 1.3)
    want = torch.zeros_like(probs).scatter_(
        1, sorted_idx, filtered / filtered.sum(-1, keepdim=True))
    counts = torch.zeros_like(probs)
    gen = torch.Generator()
    n = 4000
    for i in range(n):
        gen.manual_seed(tg.fold_seed(5, 0, i))
        tok = sample_top_p_top_k_temperature(probs, gen, 0.9, 6, 1.3)
        counts[torch.arange(2), tok.long()] += 1
    assert ((counts > 0) <= (want > 0)).all()
    assert (counts / n - want).abs().max() < 0.03


def _jax_gen(jmodel, **kw):
    return jax_tg.TunesGenerator(jmodel, **kw)


@pytest.mark.parametrize("case", ["carried", "hidden", "near-capacity",
                                  "capacity"])
def test_greedy_tunes_equal_jax(models, case):
    """At top_k=1 the port's texts equal JAX's: a prompt whose tail is a
    carried partial bar, control codes hidden, a prompt one bar short of
    patch_length and one that fills it (no bar: the prompt alone)."""
    jmodel, params, model = models
    prompt, kw = {
        "carried": ("S:1\nL:1/8\nK:C\n CD", dict(max_patch=8)),
        "hidden": ("S:1\nB:2\nE:4\nK:C\n CD|EF",
                   dict(max_patch=9, show_control_code=False)),
        "near-capacity": ("K:C\n" + "ab|" * 13, dict(max_patch=16)),
        "capacity": ("K:C\n" + "ab|" * 20, dict(max_patch=16)),
    }[case]
    want = _jax_gen(jmodel, **GREEDY).generate_tunes(
        params, prompt, num_tunes=2, seed=3, **kw)
    got = TunesGenerator(model, **GREEDY).generate_tunes(
        prompt, num_tunes=2, seed=3, **kw)
    assert got == want
    if case == "hidden":
        assert not any(line[:2] in ("S:", "B:", "E:")
                       for line in got[0].splitlines())
    if case == "capacity":
        assert got == [prompt] * 2
    else:
        assert len(got[0]) > len(prompt) - (14 if case == "hidden" else 0)


class FullForwardOracle(TunesGenerator):
    """The per-bar re-encode of the whole patch stack (bar_scan), fed the
    same patches as the cached generator."""

    def _prefill(self, patches, n0):
        self._stack = patches.clone()
        self._q = n0 - 1
        return None

    def _bar_step(self, cache, new_patch, init_tokens, init_lens, sample_fn,
                  char_cache):
        self._stack[:, self._q] = new_patch
        n = torch.full((self._stack.shape[0],), self._q + 1)
        self._q += 1
        return bar_scan(self.model, self._stack, n, init_tokens, init_lens,
                        sample_fn)


def test_cached_generator_equals_the_full_forward_oracle(models):
    """Sampled (top_p 0.9, top_k 8): the cached path (one patch position
    a bar) gives the full forward's tunes byte for byte."""
    _, _, model = models
    kw = dict(top_p=0.9, top_k=8, temperature=1.0)
    prompt = "S:1\nL:1/8\nK:C\n CD"
    got = TunesGenerator(model, **kw).generate_tunes(
        prompt, num_tunes=3, max_patch=8, seed=11)
    want = FullForwardOracle(model, **kw).generate_tunes(
        prompt, num_tunes=3, max_patch=8, seed=11)
    assert got == want


# the port's seed contract: init weights from seed 0 (TINY, fp32), prompt
# "S:1\nL:1/8\nK:C\n CD" (4 patches), top_p 0.9, top_k 8, T 1.0, 2 tunes,
# 7 patches (3 bars), seed 42
GOLDEN_SEED = 42
GOLDEN = [
    'S:1\nL:1/8\nK:C\n CDQt%%%aVf\x0eDUI)Z\x0e\x0e\x10SSIB?\x15FFqA"\x03"!'
    '\'>MM\'6oR\'-V',
    'S:1\nL:1/8\nK:C\n CDQQQ<<\x06Bww\x0e_&MMq \x04h<)\x08Tw[\x1eu[6qAq!Rggg'
    'Vp\x17\x17\x1f\x1e',
]


@pytest.fixture(scope="module")
def port_model():
    return init_tunesformer_weights(
        TunesFormer(TunesFormerConfig(**TINY, dtype=torch.float32),
                    device="cpu"),
        torch.Generator().manual_seed(0)).eval()


def test_same_seed_same_tunes_and_the_frozen_golden(port_model):
    gen = TunesGenerator(port_model, top_p=0.9, top_k=8, temperature=1.0)
    prompt = "S:1\nL:1/8\nK:C\n CD"
    a = gen.generate_tunes(prompt, num_tunes=2, max_patch=7, seed=GOLDEN_SEED)
    assert a == gen.generate_tunes(prompt, num_tunes=2, max_patch=7,
                                   seed=GOLDEN_SEED)
    assert a != gen.generate_tunes(prompt, num_tunes=2, max_patch=7,
                                   seed=GOLDEN_SEED + 1)
    assert a[0] != a[1]  # rows draw independent samples
    assert a == GOLDEN


@pytest.mark.parametrize("prompt", [
    "S:1\nL:1/8\nK:C\n CD",
    "S:1\nB:2\nE:4\nK:C\nCDEF GABc|cBAG FEDC|",
    "K:C\n" + "ab|" * 20,
    "X:1\nL:1/8\nK:D\n|:de fe|dA FA:|",
    "K:C\nCafé |: x",
    "K:C\n" + "x" * 40,
])
def test_prepare_patch_state_and_filters_equal_jax(prompt):
    L, S = 16, 16
    assert tg.prepare_patch_state(Patchilizer(), prompt, L, S) == \
        jax_tg.prepare_patch_state(JaxPatchilizer(), prompt, L, S)
    for show in (False, True):
        assert tg.filter_control_codes(prompt, show) == \
            jax_tg.filter_control_codes(prompt, show)
        for bar in prompt.splitlines(keepends=True):
            assert tg.filter_generated_bar(bar, show) == \
                jax_tg.filter_generated_bar(bar, show)


# -- the CLIs ------------------------------------------------------------------

# reference-compatible small widths (the weights.pth loaders infer the
# architecture from the shapes, with patch_length 128 and 12 heads)
REF_SMALL = dict(patch_length=128, patch_size=8, patch_layers=1,
                 char_layers=1, n_embd=48, n_head=12, dropout=0.0)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tf")
    model = init_tunesformer_weights(
        TunesFormer(TunesFormerConfig(**REF_SMALL), device="cpu"),
        torch.Generator().manual_seed(1)).eval()
    save_reference_checkpoint(str(root / "weights.pth"), model)
    return str(root), model


def test_tunesformer_generate_cli(weights_dir, tmp_path):
    """The generate CLI (``-weights`` a directory with a weights.pth):
    ``<output_dir>/<timestamp>.abc`` with X:1..X:n, each tune the
    TunesGenerator's on the same weights, the prompt kept."""
    root, model = weights_dir
    prompt = "S:1\nL:1/8\nK:C\n CD"
    (tmp_path / "prompt.txt").write_text(prompt)
    args = tunesformer_generate.get_args(argparse.ArgumentParser(), [
        "-num_tunes", "3", "-max_patch", "12", "-seed", "4", "-weights",
        root, "-prompt", str(tmp_path / "prompt.txt"), "-output_dir",
        str(tmp_path / "out"), "-device", "cpu", "-show_control_code",
        "False"])
    assert args.show_control_code is False and args.top_k == 8
    path = tunesformer_generate.generate_abc(args)
    assert os.path.dirname(path) == str(tmp_path / "out")
    assert re.fullmatch(r"\w{3}_\d\d_\w{3}_\d{4}_\d\d_\d\d_\d\d\.abc",
                        os.path.basename(path))
    want = TunesGenerator(model, top_p=0.8, top_k=8,
                          temperature=1.2).generate_tunes(
        prompt, num_tunes=3, max_patch=12, seed=4, show_control_code=False)
    with open(path, newline="") as f:  # generated text may hold \r
        text = f.read()
    assert text == "".join(
        f"X:{i + 1}\n{t}\n\n" for i, t in enumerate(want))
    assert all(t.startswith("L:1/8\nK:C\n CD") for t in want)


def test_tunesformer_generate_cli_refuses_an_orbax_directory(tmp_path):
    os.makedirs(tmp_path / "weights")
    with pytest.raises(FileNotFoundError, match="convert_ckpt tunesformer"):
        tunesformer_generate.load_model(str(tmp_path), device="cpu")


def test_sample_tunesformer_cli(weights_dir, tmp_path):
    """Leadsheet prompts (control code + the first n measures) as JAX
    builds them; one ``sample_<id>.abc`` with an ``X:<id>`` header per
    leadsheet, each the generator's tune at the id's crc32 seed."""
    import zlib

    root, model = weights_dir
    sheets = [
        {"id": 7, "control code": "S:2\nB:4\nE:3",
         "abc notation": "X:7\nL:1/8\nK:G\nGA Bc|dc BA:|GA Bc|d4|]"},
        {"id": "b", "abc notation": "X:2\nL:1/4\nK:D\n|:de fe|dA FA::g2|"},
    ]
    for n in (1, 2, 4):
        assert sample_tunesformer.prefixes_from_leadsheets(sheets, n) == \
            jax_sample_cli.prefixes_from_leadsheets(sheets, n)
    for text in ("X:3\nabc|\n", "  K:C\nab|  ", ""):
        assert sample_tunesformer.normalize_abc(text, "9") == \
            jax_sample_cli.normalize_abc(text, "9")
    path = tmp_path / "val.json"
    path.write_text(json.dumps(sheets))
    n = sample_tunesformer.main([
        str(path), f"--weights={root}", f"--output_dir={tmp_path / 's'}",
        "--max_patch=12", "--n_measures=2", "--device=cpu"])
    assert n == 2
    assert sorted(os.listdir(tmp_path / "s")) == ["sample_7.abc",
                                                  "sample_b.abc"]
    gen = TunesGenerator(model, top_p=0.8, top_k=8, temperature=0.8)
    for _id, cc, prefix in sample_tunesformer.prefixes_from_leadsheets(
            sheets, 2):
        prompt = (cc + "\n" if cc and not cc.endswith("\n") else cc) + prefix
        tune = gen.generate_tunes(prompt, max_patch=12,
                                  seed=zlib.crc32(_id.encode()),
                                  show_control_code=False)[0]
        with open(tmp_path / "s" / f"sample_{_id}.abc", newline="") as f:
            text = f.read()
        assert text == sample_tunesformer.normalize_abc(tune, _id)
        assert text.startswith(f"X:{_id}\n")
