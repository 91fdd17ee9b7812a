"""The port's int8 decode attention with per-position scales
(ai_music_generation_tpu_torch/ops/decode_attention_int8.py: K5
``decode_attention_int8``, K6 ``decode_attention_int8_multirow``) against
the JAX package.

Inputs are made with numpy from a seed, as tests/test_decode_attention_int8.py
makes them: normal K/V quantized per (row, position) to int8 with fp32
scales. The port's twins are held against the JAX
``decode_attention_int8_reference`` in fp32, and against the Pallas kernels
in interpret mode at the JAX tests' own tolerance. The CUDA kernel is held
against the twin in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_music_generation_tpu.ops.decode_attention_int8 import (
    decode_attention_int8 as jax_decode_attention_int8,
)
from ai_music_generation_tpu.ops.decode_attention_int8 import (
    decode_attention_int8_multirow as jax_decode_attention_int8_multirow,
)
from ai_music_generation_tpu.ops.decode_attention_int8 import (
    decode_attention_int8_reference as jax_decode_attention_int8_reference,
)
from ai_music_generation_tpu_torch.ops.decode_attention_int8 import (
    decode_attention_int8,
    decode_attention_int8_multirow,
    decode_attention_int8_reference,
)

torch.set_num_threads(1)


def make_inputs(B=4, H=2, S=256, D=64, seed=0):
    """q (fp32 values exact in bf16) [B, HD], int8 k/v [B, S, HD] and their
    fp32 per-position scales [B, S] (tests/test_decode_attention_int8.py
    ::make_inputs)."""
    HD = H * D
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, HD)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    kf = rng.normal(size=(B, S, HD)).astype(np.float32)
    vf = rng.normal(size=(B, S, HD)).astype(np.float32)
    ks = (np.maximum(np.abs(kf).max(-1), 1e-6) / 127.0).astype(np.float32)
    vs = (np.maximum(np.abs(vf).max(-1), 1e-6) / 127.0).astype(np.float32)
    k8 = np.clip(np.round(kf / ks[..., None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs[..., None]), -127, 127).astype(np.int8)
    return q, k8, v8, ks, vs


def _k5_args(x, q_dtype=torch.float32):
    q, k8, v8, ks, vs = x
    B, S = ks.shape
    return (torch.from_numpy(q).to(q_dtype), torch.from_numpy(k8),
            torch.from_numpy(v8), torch.from_numpy(ks).reshape(B, 1, S),
            torch.from_numpy(vs).reshape(B, 1, S))


def _jax_args(x, q_dtype=jnp.float32):
    q, k8, v8, ks, vs = x
    B, S = ks.shape
    return (jnp.asarray(q, q_dtype), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(ks.reshape(B, 1, S)), jnp.asarray(vs.reshape(B, 1, S)))


@pytest.mark.parametrize("length", [1, 127, 128, 200, 256])
def test_twins_match_jax_reference(length):
    """fp32 q: both compute in fp32 and differ only by summation order,
    so within 1e-5 of the output's range; K6 (scales [B, S]) equals K5."""
    x = make_inputs()
    want = np.asarray(jax_decode_attention_int8_reference(
        *_jax_args(x), jnp.int32(length), n_head=2))
    before = decode_attention_int8.launches
    got = decode_attention_int8(*_k5_args(x), length, n_head=2)
    assert decode_attention_int8.launches == before  # no kernel on the CPU
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    q, k8, v8, ks, vs = _k5_args(x)
    multi = decode_attention_int8_multirow(
        q, k8, v8, ks.reshape(4, 256), vs.reshape(4, 256),
        torch.tensor(length, dtype=torch.int32), n_head=2, rows_per_program=2)
    assert torch.equal(multi, got)


@pytest.mark.parametrize("length", [1, 127, 200])
def test_k5_twin_matches_pallas_interpret(length):
    """bf16 q, the JAX test's tolerance (3e-2): the Pallas kernel rounds the
    scaled probabilities to bf16 before PV; the twin keeps fp32, as the
    reference does."""
    x = make_inputs(seed=1)
    want = np.asarray(jax_decode_attention_int8(
        *_jax_args(x, jnp.bfloat16), jnp.int32(length), n_head=2,
        interpret=True).astype(jnp.float32))
    got = decode_attention_int8(*_k5_args(x, torch.bfloat16),
                                torch.tensor(length, dtype=torch.int32),
                                n_head=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("rows", [1, 4])
def test_k6_twin_matches_pallas_interpret(rows):
    """K6 at the JAX test's shape (B=16, length 100) and tolerance."""
    q, k8, v8, ks, vs = make_inputs(B=16, S=256, seed=2)
    want = np.asarray(jax_decode_attention_int8_multirow(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(100), n_head=2,
        rows_per_program=rows, interpret=True).astype(jnp.float32))
    before = decode_attention_int8_multirow.launches
    got = decode_attention_int8_multirow(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(k8),
        torch.from_numpy(v8), torch.from_numpy(ks), torch.from_numpy(vs),
        100, n_head=2, rows_per_program=rows)
    assert decode_attention_int8_multirow.launches == before
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


def test_poisoned_region_never_read():
    """Extreme values past ``length`` (int8 127, scales 1e4: scores ~1e6)
    change nothing (tests/test_decode_attention_int8.py:47-51)."""
    x = list(make_inputs(S=128, seed=3))
    clean = decode_attention_int8(*_k5_args(x, torch.bfloat16), 100,
                                  n_head=2)
    x[1][:, 100:] = 127
    x[3][:, 100:] = 1e4
    x[4][:, 100:] = 1e4
    got = decode_attention_int8(*_k5_args(x, torch.bfloat16), 100, n_head=2)
    assert torch.equal(got, clean) and torch.isfinite(got.float()).all()
    ref = np.asarray(jax_decode_attention_int8_reference(
        *_jax_args(x, jnp.bfloat16), jnp.int32(100), n_head=2).astype(
            jnp.float32))
    kern = np.asarray(jax_decode_attention_int8(
        *_jax_args(x, jnp.bfloat16), jnp.int32(100), n_head=2,
        interpret=True).astype(jnp.float32))
    for want, tol in ((ref, 2.0 ** -7), (kern, 3e-2)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


def test_multirow_refuses_rows_that_do_not_divide_the_batch():
    q, k8, v8, ks, vs = (torch.from_numpy(a) for a in make_inputs(B=6, S=16))
    with pytest.raises(ValueError, match="must divide batch"):
        decode_attention_int8_multirow(q, k8, v8, ks, vs, 4, n_head=2,
                                       rows_per_program=4)
    assert decode_attention_int8_multirow(q, k8, v8, ks, vs, 4, n_head=2,
                                          rows_per_program=3).shape == (6, 128)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention_int8(*(t.to("meta") for t in (q, k8, v8)),
                              ks.reshape(6, 1, 16).to("meta"),
                              vs.reshape(6, 1, 16).to("meta"), 4, n_head=2)
