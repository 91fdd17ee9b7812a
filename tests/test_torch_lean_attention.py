"""The port's lean T=1 decode attention (K7,
ai_music_generation_tpu_torch/ops/lean_attention.py) and its probe path
(ai_music_generation_tpu_torch/experiments/int4_kernel_probe.py) against
the JAX Pallas kernel of docs/experiments/int4_kernel_probe.py.

That script runs ``main()`` when it is imported, reads B, S and R from the
environment and gives ``pallas_call`` no ``interpret`` flag. So each test
shape loads it afresh without touching it: B, S and R set in the
environment, the source parsed with ``ast``, its trailing ``main()``
statement dropped, the rest executed into a new namespace, and the
namespace's ``pl`` replaced by a shim whose ``pallas_call`` runs in
interpret mode (``lean_attention`` looks ``pl`` up when it is traced).
The port is thus held against the TPU kernel itself, run on the CPU.

Inputs are made with numpy from a seed in the JAX kernel's layout (q
[B, 8, HD] and scales [B, 8, S], sublanes and rows 6-7 noise) and cut to
the port's (q [B, HD], scales [B, H, S]). Every int4 cache packs two
distinct random values per byte. The CUDA kernel is held against the twin
in tests/test_torch_cuda_kernels.py.
"""

import ast
import functools
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ai_music_generation_tpu_torch.experiments import int4_kernel_probe as probe
from ai_music_generation_tpu_torch.ops.lean_attention import (
    lean_attention,
    lean_attention_reference,
    pack_int4,
    unpack_int4,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "docs", "experiments", "int4_kernel_probe.py")
H, HD = 6, 384  # the probe's fixed head count and width


def load_jax_probe(monkeypatch, B, S, R):
    """The JAX probe's namespace at shape (B, S, R), ``pallas_call`` in
    interpret mode; nothing is written and the file is not edited."""
    for name, value in (("B", B), ("S", S), ("R", R)):
        monkeypatch.setenv(name, str(value))
    monkeypatch.setenv("SPEC_REPO", ROOT)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script inserts
    with open(PROBE) as f:
        tree = ast.parse(f.read())
    last = tree.body[-1]
    assert (isinstance(last, ast.Expr) and isinstance(last.value, ast.Call)
            and last.value.func.id == "main")
    tree.body.pop()
    ns = {"__name__": "int4_kernel_probe_under_test"}
    exec(compile(tree, PROBE, "exec"), ns)
    ns["pl"] = types.SimpleNamespace(
        GridSpec=pl.GridSpec, BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return ns


def make_inputs(B, S, packed, seed=0):
    """numpy inputs in the JAX kernel's layout: q [B, 8, HD] (sublane 0 is
    the query), k/v [B, Sp, HD] int8 (lean4: pack_int4 of two independent
    int4 draws), k/v scales [B, 8, S] in [0.5, 1.5) (rows 0..5 real)."""
    rng = np.random.default_rng(seed)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        torch.bfloat16).float().numpy()
    q = bf16(rng.normal(size=(B, 8, HD)))
    if packed:
        k, v = (pack_int4(*(torch.from_numpy(rng.integers(
            -8, 8, (B, S // 2, HD), dtype=np.int8)) for _ in range(2)))
            .numpy() for _ in range(2))
    else:
        k, v = (rng.integers(-128, 128, (B, S, HD), dtype=np.int8)
                for _ in range(2))
    ks, vs = (bf16(rng.uniform(0.5, 1.5, (B, 8, S))) for _ in range(2))
    return q, k, v, ks, vs


def port_args(q, k, v, ks, vs):
    """The JAX layout cut to the port's: q's sublane 0, scale rows 0..H-1."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(q[:, 0]).to(torch.bfloat16), t(k), t(v),
            t(ks[:, :H]).to(torch.bfloat16), t(vs[:, :H]).to(torch.bfloat16))


@pytest.mark.parametrize("B,S,R", [(4, 16, 2), (8, 32, 4)])
@pytest.mark.parametrize("packed", [False, True], ids=["lean8", "lean4"])
def test_port_matches_jax_kernel(monkeypatch, capsys, B, S, R, packed):
    """The port's lean_attention on the CPU (the twin) against the Pallas
    kernel in interpret mode. The card's yardstick is 2^-6 of the output's
    range: room for one p8 (lean8) or bf16-probability (lean4) rounding
    flip, which sums taken in another order can cause at a tie. At these
    seeds no value flips (observed: lean8 1.5e-5 of a range of ~190, one
    fp32 ulp; lean4 <= 3e-6 of ~11), so the bound here is tightened to
    2^-12 of the range, below what any flip costs (>= 2^-8)."""
    ns = load_jax_probe(monkeypatch, B, S, R)
    x = make_inputs(B, S, packed, seed=B + S)
    jq, jk, jv, jks, jvs = (jnp.asarray(a, jnp.bfloat16 if a.dtype ==
                                        np.float32 else a.dtype) for a in x)
    out = np.asarray(ns["lean_attention"](jq, jk, jv, jks, jvs,
                                          packed=packed))
    assert out.shape == (B, 8, HD)
    assert (out == out[:, :1]).all()  # every sublane carries the row
    want = out[:, 0]
    before = lean_attention.launches
    got = lean_attention(*port_args(*x), packed)
    assert lean_attention.launches == before  # no kernel on the CPU
    assert got.dtype == torch.float32 and got.shape == (B, HD)
    err = np.abs(got.numpy() - want).max()
    rng_ = np.abs(want).max()
    with capsys.disabled():
        print(f"\nlean{'4' if packed else '8'} B={B} S={S}: max abs err "
              f"{err} of range {rng_}")
    assert err <= 2.0 ** -12 * rng_


def _probe_float_unpack(x):
    """numpy transcription of the JAX probe's unpack (its lines 131-135):
    [Sp, HD] int8 -> [2 Sp, HD]."""
    xf = x.astype(np.float32)
    hi = np.floor(xf * 0.0625)
    u = xf - hi * 16.0
    lo = u - np.where(u >= 8.0, 16.0, 0.0)
    return np.concatenate([lo, hi], axis=0)


def test_unpack_int4_matches_probe_float_unpack_on_every_byte():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(256, 1)
    got = unpack_int4(torch.from_numpy(packed)[None])[0]
    assert got.dtype == torch.int8 and got.shape == (512, 1)
    np.testing.assert_array_equal(got.numpy().astype(np.float32),
                                  _probe_float_unpack(packed))


def test_pack_int4_roundtrip_on_every_pair():
    """All 256 (lo, hi) pairs: lo in the low nibble (positions 0..S/2-1),
    hi in the high nibble (S/2..S-1), and unpack inverts pack."""
    lo, hi = (torch.tensor(a, dtype=torch.int8).reshape(1, 256, 1)
              for a in np.meshgrid(np.arange(-8, 8), np.arange(-8, 8)))
    assert not torch.equal(lo, hi)
    packed = pack_int4(lo, hi)
    assert packed.dtype == torch.int8 and packed.shape == (1, 256, 1)
    b = packed.view(torch.uint8).to(torch.int32)
    assert torch.equal(b & 0xF, lo.to(torch.int32) & 0xF)
    assert torch.equal(b >> 4, hi.to(torch.int32) & 0xF)
    assert len(torch.unique(packed)) == 256
    assert torch.equal(unpack_int4(packed), torch.cat([lo, hi], dim=1))
    with pytest.raises(ValueError, match="outside"):
        pack_int4(lo, torch.full_like(hi, 8))
    with pytest.raises(ValueError, match="shape"):
        pack_int4(lo, hi[:, :3])


@pytest.mark.parametrize("name", ["lean8", "lean4"])
def test_probe_step_equals_twin_layer_by_layer(name):
    """The probe harness on the CPU (B=4, S=16): its step equals the twin
    applied layer by layer with the probe's q update, bit for bit, and
    launches nothing; lean4 caches hold distinct nibbles."""
    packed = name == "lean4"
    before = lean_attention.launches
    r = probe.run_variant(name, batch=4, seq=16, device="cpu", seed=3)
    assert lean_attention.launches == before
    assert r["steps"] == 1 and r["ms_per_layer"] is None
    assert len(r["layers"]) == probe.L
    q = r["q0"]
    for k, v, ks, vs in r["layers"]:
        o = lean_attention_reference(q, k, v, ks, vs, packed, n_head=H)
        q = q + o.to(torch.bfloat16) * probe.STEP
    assert torch.equal(r["q"], q) and torch.isfinite(q.float()).all()
    if packed:
        k = unpack_int4(r["layers"][0][0])
        assert (k[:, :8] != k[:, 8:]).float().mean() > 0.8
    record = []
    again = probe.lean_step(r["q0"], r["layers"], packed, record=record)
    assert torch.equal(again, r["q"]) and len(record) == probe.L


def test_probe_floor_and_cpu_refusal(monkeypatch):
    """The floor counts each input once and the fp32 output once (the
    probe's lean8 layer at B=4096, S=256 moves 0.84 GB); without a card the
    default device raises instead of falling back."""
    q = torch.empty((4096, HD), dtype=torch.bfloat16, device="meta")
    layer = [torch.empty((4096, 256, HD), dtype=torch.int8, device="meta")
             for _ in range(2)] + [
        torch.empty((4096, H, 256), dtype=torch.bfloat16, device="meta")
        for _ in range(2)]
    n = probe.layer_bytes(q, layer)
    assert n == 4096 * HD * (2 + 2 * 256 + 4) + 2 * 4096 * H * 256 * 2
    assert abs(n / probe.HBM_BYTES_PER_S * 1e3 - 0.2507) < 1e-3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.run_variant("lean8", batch=2, seq=4)


def test_xla8_variant_runs_on_the_cpu():
    """The plain xla8 step (the probe's baseline, no kernel): the JAX
    probe's cache layout (int8 [B, S, H, D] in [-127, 127], bf16 scales
    [B, S, H]) and a finite q of the query's shape."""
    r = probe.run_variant("xla8", batch=3, seq=8, device="cpu", seed=1)
    ck, cv, ks, vs = r["layers"][0]
    assert ck.shape == cv.shape == (3, 8, H, 64) and ck.dtype == torch.int8
    assert int(ck.min()) >= -127 and ks.shape == (3, 8, H)
    assert ks.dtype == torch.bfloat16 and 0.5 <= float(ks.min())
    assert r["q"].shape == r["q0"].shape == (3, H, 64)
    assert torch.isfinite(r["q"].float()).all()
    assert not torch.equal(r["q"], r["q0"])


def test_twin_refuses_inexact_int8_sums_and_cpu_wrapper_devices():
    q = torch.zeros((1, HD), dtype=torch.bfloat16)
    k = torch.zeros((1, 1040, HD), dtype=torch.int8)
    s = torch.ones((1, H, 1040), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exact"):
        lean_attention_reference(q, k, k, s, s, False)
    out = lean_attention_reference(q, k[:, :520], k[:, :520], s, s, True)
    assert out.shape == (1, HD) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="cuda or cpu"):
        lean_attention(*(t.to("meta") for t in (q, k, k, s, s)), False)
