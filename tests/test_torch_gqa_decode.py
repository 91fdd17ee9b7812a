"""The port's decode-step op (ai_music_generation_tpu_torch/ops/gqa_decode.py)
against the JAX package.

The same inputs, made with numpy from a seed, go through the port's plain
twin and the JAX ``gqa_decode_reference`` (what the JAX op runs off-TPU),
on the tests/test_gqa_flat.py grid: B=8, S=32, H=6, KH=2, D=64, int8 or
bf16 cache x lockstep or ring mask x pos in {0, 5, 8, S-1}. The JAX side
takes its queries folded with its own ``_placement``; the port takes them
unfolded. Cache and scale writes must be bit-exact. The CUDA kernel is held
against the twin in tests/test_torch_cuda_kernels.py (no JAX there: the
machine with the card has none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.models.gpt import _quantize_int8, _scale_write
from ai_music_generation_tpu.ops.gqa_decode import _placement
from ai_music_generation_tpu.ops.gqa_decode import (
    gqa_decode_reference as jax_gqa_decode_reference,
)
from ai_music_generation_tpu_torch.models.gpt import quantize_int8, scale_write
from ai_music_generation_tpu_torch.ops.gqa_decode import (
    gqa_decode_reference,
    gqa_decode_update,
)

torch.set_num_threads(1)

B, S, H, KH, D = 8, 32, 6, 2, 64
KHD = KH * D
POSITIONS = (0, 5, 8, S - 1)


def _bf16(a):
    """fp32 numpy values rounded to bf16 (kept as fp32: exact in both)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(quant, ring, pos, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    x = {
        "q": _bf16(rng.standard_normal((b, H, D))),
        "k_slab": _bf16(rng.standard_normal((b, KHD))),
        "v_slab": _bf16(rng.standard_normal((b, KHD))),
        "k_scale": None, "v_scale": None, "mask_rel": None,
    }
    if quant:
        x["k"] = rng.integers(-127, 128, (b, s, KHD)).astype(np.int8)
        x["v"] = rng.integers(-127, 128, (b, s, KHD)).astype(np.int8)
        x["k_scale"] = _bf16(rng.uniform(0.01, 0.11, (b, KH, s)))
        x["v_scale"] = _bf16(rng.uniform(0.01, 0.11, (b, KH, s)))
    else:
        x["k"] = _bf16(rng.standard_normal((b, s, KHD)))
        x["v"] = _bf16(rng.standard_normal((b, s, KHD)))
    if ring:
        lengths = rng.integers(0, s, (b,))
        offset = (pos - np.arange(s)) % s
        x["mask_rel"] = (lengths[:, None] - offset[None, :]).astype(np.int32)
    return x


def _torch_args(x, device="cpu"):
    def t(a):
        if a is None:
            return None
        a = torch.from_numpy(np.array(a))
        return (a.to(torch.bfloat16) if a.dtype == torch.float32 else a).to(
            device)

    return [t(x[n]) for n in ("q", "k", "v", "k_slab", "v_slab", "k_scale",
                              "v_scale", "mask_rel")]


def _jax_run(x, pos):
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa
    P = _placement(H, KH, D, jnp.bfloat16)
    q_bd = jnp.einsum("bhd,hdc->bhc", bf(x["q"]), P)
    cache = (jnp.asarray(x["k"]) if x["k"].dtype == np.int8 else bf(x["k"]),
             jnp.asarray(x["v"]) if x["v"].dtype == np.int8 else bf(x["v"]))
    res = jax_gqa_decode_reference(
        q_bd, *cache, bf(x["k_slab"])[:, None], bf(x["v_slab"])[:, None],
        bf(x["k_scale"]), bf(x["v_scale"]),
        None if x["mask_rel"] is None else jnp.asarray(x["mask_rel"]), pos,
        n_head=H, n_kv_head=KH)
    out = jnp.einsum("bhc,hdc->bhd", res[-1].astype(jnp.float32),
                     P.astype(jnp.float32))
    return [np.asarray(r.astype(jnp.float32) if r.dtype == jnp.bfloat16
                       else r) for r in res[:-1]], np.asarray(out)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("ring", [False, True], ids=["lockstep", "ring"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_twin_matches_jax_reference(quant, ring, pos):
    x = _inputs(quant, ring, pos)
    (jk, jv, *jscales), jout = _jax_run(x, pos)
    q, k, v, ks, vs, k_scale, v_scale, mask = _torch_args(x)
    out = gqa_decode_reference(q, k, v, ks, vs, k_scale, v_scale, mask,
                               torch.tensor(pos, dtype=torch.int32))
    # the cache writes (and int8 quantize + scale writes) are bit-exact
    np.testing.assert_array_equal(_np(k), jk)
    np.testing.assert_array_equal(_np(v), jv)
    if quant:
        np.testing.assert_array_equal(_np(k_scale), jscales[0])
        np.testing.assert_array_equal(_np(v_scale), jscales[1])
    # out: the same op chain in bf16 on both sides; the bf16 einsums may
    # accumulate in another order (XLA vs torch CPU kernels), which can move
    # a rounded bf16 score or probability by one ulp (2^-8 relative), so
    # allow 1% of the output's range
    err = np.abs(_np(out) - jout).max()
    assert err <= 1e-2 * np.abs(jout).max(), err


def test_quantize_int8_bit_exact():
    rng = np.random.default_rng(1)
    rows = [
        rng.standard_normal((6, 64)) * rng.uniform(1e-3, 1e3, (6, 1)),
        # exact .5 ties at scale 1 (max 127): round half to even
        np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] * 8]),
        np.zeros((1, 64)),  # all-zero row: the 1e-6 scale floor
        # saturation: the max element lands on +-127 exactly
        np.array([[-1e30, 1e29, 3.0, -7.0] * 16]),
        np.full((1, 64), 1e-40),  # subnormal input
    ]
    x = np.concatenate(rows).astype(np.float32).reshape(-1, 2, 32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dtype)
        jq, js = _quantize_int8(jnp.asarray(xt.float().numpy()).astype(jdtype))
        q, s = quantize_int8(xt)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(
            s.float().numpy(), np.asarray(js.astype(jnp.float32)))
    assert q.abs().max() == 127


@pytest.mark.parametrize("start", [0, 3, 29])
def test_scale_write_matches_jax(start):
    rng = np.random.default_rng(start)
    buf = _bf16(rng.uniform(0, 1, (B, KH, S)))
    new = _bf16(rng.uniform(0, 1, (B, 3, KH)))
    ref = _scale_write(jnp.asarray(buf, jnp.bfloat16),
                       jnp.asarray(new, jnp.bfloat16), start)
    got = scale_write(torch.from_numpy(buf).to(torch.bfloat16),
                      torch.from_numpy(new).to(torch.bfloat16),
                      torch.tensor(start, dtype=torch.int32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_wrapper_runs_twin_for_cpu_tensors():
    x = _inputs(True, False, 5)
    a, b = _torch_args(x), _torch_args(x)
    pos = torch.tensor(5, dtype=torch.int32)
    before = gqa_decode_update.launches
    out = gqa_decode_update(*a, pos)
    ref = gqa_decode_reference(*b, pos)
    assert gqa_decode_update.launches == before  # no kernel on the CPU
    for got, want in zip([out, *a], [ref, *b]):
        if got is not None:
            assert torch.equal(got, want)


def test_wrapper_refuses_other_devices():
    x = _torch_args(_inputs(False, False, 0), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gqa_decode_update(*x, torch.zeros((), dtype=torch.int32,
                                          device="meta"))
