"""The int4 storage probes of the port (ai_music_generation_tpu_torch/
experiments/{int4_probe,int4_probe2,int4_cache_probe}.py) against the JAX
scripts in docs/experiments/.

The scripts run at import, so their functions are taken from the source
with ``ast`` (``int4_probe.py::make_step``, ``int4_probe2.py::unpack_nib``,
``int4_cache_probe.py::attn_step``) and executed with the shapes as
globals; the lines inside ``main`` (int4_probe2.py's packing and
``attend``) are copied below with their line numbers.

- the nibble packing and unpacking are bit-equal to JAX's on seeded int8
  over the whole int4 range;
- the attention chains on the same bf16 inputs, bit for bit (the port
  rounds where XLA rounds: bf16 constants, an fp32 softmax cast back to
  bf16): int4_probe's with scales (int8 and packed), int4_probe2's
  without, int4_cache_probe's ``attn_step``; and int4_probe's whole loop
  (``make_step``, 3 steps over 6 layers, the in-place row writes);
- the ``int4`` variant (``torch.int4``) prints ``FAILED`` on this torch and
  each probe finishes; every ``main`` prints its JSON line on the CPU and
  raises without a card by default.
"""

import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu_torch.experiments import (
    int4_cache_probe,
    int4_probe,
    int4_probe2,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "docs", "experiments")
B, S, H, D, L = 3, 8, 6, 64, 6


def _script_function(script, name, **globals_):
    """``name`` from ``docs/experiments/<script>``, defined in a namespace
    holding jax, jnp, math and ``globals_``."""
    with open(os.path.join(SCRIPTS, script)) as f:
        tree = ast.parse(f.read())
    (node,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == name]
    ns = dict(jax=jax, jnp=jnp, lax=jax.lax, math=math, **globals_)
    exec(compile(ast.Module([node], []), script, "exec"), ns)
    return ns[name]


def _jax_pack(q):  # int4_probe.py:127-133 (and int4_probe2.py:107-109)
    lo = q[..., :D // 2] & jnp.int8(0xF)
    hi = jax.lax.shift_left(q[..., D // 2:], jnp.int8(4))
    return lo | hi


@pytest.fixture(scope="module")
def nibbles():
    """Seeded int8 over the whole int4 range [-8, 7]."""
    return np.random.default_rng(0).integers(-8, 8, (B, S, H, D)).astype(
        np.int8)


def test_packing_is_bit_equal(nibbles):
    want = np.asarray(_jax_pack(jnp.asarray(nibbles)))
    got = int4_probe.pack_nibbles(torch.from_numpy(nibbles)).numpy()
    assert got.dtype == np.int8 and got.shape == (B, S, H, D // 2)
    np.testing.assert_array_equal(got, want)


def test_unpacking_is_bit_equal_and_inverts_the_packing(nibbles):
    unpack_nib = _script_function("int4_probe2.py", "unpack_nib")
    packed = int4_probe.pack_nibbles(torch.from_numpy(nibbles))
    want = np.asarray(unpack_nib(jnp.asarray(packed.numpy())).astype(
        jnp.float32))
    got = int4_probe.unpack_nibbles(packed).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, nibbles.astype(np.float32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q4 = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    c8 = rng.integers(-7, 8, (2, B, S, H, D)).astype(np.int8)
    scales = rng.uniform(0.005, 0.02, (2, B, H, S)).astype(np.float32)
    return q4, c8, scales


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _equal(got, want):
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("scheme", ["int8", "packed"])
def test_scaled_attend_chain_equals_jax(scheme):
    """int4_probe.py:94-104 (int8) and :142-152 (packed)."""
    q4, c8, scales = _inputs(1)
    unpack_nib = _script_function("int4_probe2.py", "unpack_nib")
    sm = 1.0 / math.sqrt(D)
    if scheme == "int8":
        stored, j_read = c8, (lambda x: x.astype(jnp.bfloat16))
    else:
        stored, j_read = np.array(_jax_pack(jnp.asarray(c8))), unpack_nib
    ck, cv = (jnp.asarray(stored[i]) for i in range(2))
    ks, vs = (jnp.asarray(scales[i], jnp.bfloat16) for i in range(2))
    att = jnp.einsum("bthd,bshd->bhts", jnp.asarray(q4, jnp.bfloat16),
                     j_read(ck)) * jnp.bfloat16(sm)
    att = att * ks[:, :, None, :]
    att = jax.nn.softmax(att.astype(jnp.float32),
                         axis=-1).astype(jnp.bfloat16)
    att = att * vs[:, :, None, :]
    want = jnp.einsum("bhts,bshd->bthd", att, j_read(cv))
    _, _, _, unpack = int4_probe.quantizer(scheme)
    got = int4_probe.attend(_bf16(q4), torch.from_numpy(stored[0]),
                            torch.from_numpy(stored[1]),
                            _bf16(scales[0]), _bf16(scales[1]), unpack)
    _equal(got, want)


@pytest.mark.parametrize("scheme", ["int8", "packed"])
def test_unscaled_attend_chain_equals_jax(scheme):
    """int4_probe2.py:117-121."""
    q4, c8, _ = _inputs(2)
    unpack_nib = _script_function("int4_probe2.py", "unpack_nib")
    sm = 1.0 / math.sqrt(D)
    if scheme == "int8":
        stored, j_read = c8, (lambda x: x.astype(jnp.bfloat16))
        read = int4_probe.as_bf16
    else:
        stored, j_read = np.array(_jax_pack(jnp.asarray(c8))), unpack_nib
        read = int4_probe.unpack_nibbles
    ck, cv = (jnp.asarray(stored[i]) for i in range(2))
    att = jnp.einsum("bthd,bshd->bhts", jnp.asarray(q4, jnp.bfloat16),
                     j_read(ck)) * jnp.bfloat16(sm)
    att = jax.nn.softmax(att.astype(jnp.float32),
                         axis=-1).astype(jnp.bfloat16)
    want = jnp.einsum("bhts,bshd->bthd", att, j_read(cv))
    got = int4_probe2.attend(_bf16(q4), torch.from_numpy(stored[0]),
                             torch.from_numpy(stored[1]), read)
    _equal(got, want)


def test_cache_probe_attn_step_equals_jax():
    """int4_cache_probe.py:10-15 over int8 caches and [B, S, H] scales."""
    q4, c8, scales = _inputs(3)
    attn_step = _script_function("int4_cache_probe.py", "attn_step", D=D)
    ks = np.swapaxes(scales[0], 1, 2).copy()  # [B, S, H]
    want = attn_step(jnp.asarray(q4, jnp.bfloat16), jnp.asarray(c8[0]),
                     jnp.asarray(c8[1]), jnp.asarray(ks, jnp.bfloat16),
                     None)
    got = int4_cache_probe.attn_step(_bf16(q4), torch.from_numpy(c8[0]),
                                     torch.from_numpy(c8[1]), _bf16(ks),
                                     None)
    _equal(got, want)


@pytest.mark.parametrize("scheme", ["int8", "packed"])
def test_probe_loop_equals_jax_make_step(scheme):
    """int4_probe.py's whole loop (its ``make_step``) at B=3, S=8, 3 steps:
    the caches start at zero and get a fresh row each layer-read."""
    steps = 3
    make_step = _script_function("int4_probe.py", "make_step", B=B, S=S,
                                 H=H, D=D, L=L, STEPS=steps)
    q0 = np.random.default_rng(4).standard_normal((B, H, D)).astype(
        np.float32)
    want = float(make_step(scheme)(jnp.asarray(q0, jnp.bfloat16)))
    got = float(int4_probe.make_run(scheme, B, S, steps)(_bf16(q0)))
    assert got == want


def test_int4_probe_records_the_int4_failure(capsys):
    result = int4_probe.main(["--device=cpu", "--batch=2", "--seq=8",
                              "--steps=2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(result))
    v = result["variants"]
    assert list(v) == ["int8", "packed", "int4"]
    for name in ("int8", "packed"):
        assert v[name]["ms_per_call"] > 0
        assert v[name]["ms_per_layer_read"] == pytest.approx(
            v[name]["ms_per_call"] / 2 / 6)
    assert "failed" in v["int4"]
    assert any(line.startswith("int4: FAILED ") for line in out)


def test_int4_probe2_reports_read_rates(capsys):
    result = int4_probe2.main(["--device=cpu", "--batch=2", "--seq=8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(result))
    cases = result["cases"]
    assert set(cases) == {f"{k}-{s}" for k in ("attn", "sum")
                          for s in ("int8", "int4", "packed")}
    n8 = 6 * 2 * 2 * 8 * 6 * 64
    for label, nbytes in (("sum-int8", n8), ("sum-packed", n8 // 2),
                          ("attn-int8", n8), ("attn-packed", n8 // 2)):
        c = cases[label]
        assert c["bytes"] == nbytes
        assert c["gb_s"] == pytest.approx(nbytes / (c["ms_per_call"] / 1e3)
                                          / 1e9)
    assert "failed" in cases["attn-int4"] and "failed" in cases["sum-int4"]
    assert any(line.startswith("attn-int4: FAILED ") for line in out)


def test_sum_pass_reads_every_byte():
    c8 = int4_probe2.build(2, 4, "cpu")
    assert c8.shape == (6, 2, 2, 4, 6, 64) and c8.dtype == torch.int8
    assert int(c8.min()) >= -7 and int(c8.max()) <= 7
    assert int(int4_probe2.sum_bytes(c8)) == int(c8.long().sum())


def test_int4_cache_probe_records_the_int4_failure(capsys):
    result = int4_cache_probe.main(["--device=cpu", "--batch=2", "--seq=8",
                                    "--steps=3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(result))
    v = result["variants"]
    assert v["int8"]["ms_per_step"] == pytest.approx(
        v["int8"]["ms_per_call"] / 3)
    assert v["int8"]["gb_per_step"] == 2 * 2 * 8 * 6 * 64 / 1e9
    assert "failed" in v["int4"]
    assert any(line.startswith("int4: FAILED ") for line in out)


@pytest.mark.parametrize("module", [int4_probe, int4_probe2,
                                    int4_cache_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_defaults_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        module.main([])
