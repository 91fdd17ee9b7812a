"""Single-query (T=1) decode attention over an int8 KV cache with one fp32
scale per (row, position), valid prefix only.

Port of ``ai_music_generation_tpu/ops/decode_attention_int8.py`` (the
Pallas kernels ``_decode_attention_int8`` and
``_decode_attention_int8_multirow``). On CUDA tensors both entry points
launch the kernel of ``csrc/decode_attention.cu`` (the one that runs
``ops.decode_attention``); on CPU tensors they run the plain twin
:func:`decode_attention_int8_reference`. Nothing falls back: a CUDA call
that the kernel cannot take raises.

Contract (B rows, H heads of size D, S cache columns, HD = H*D):

- ``q`` [B, HD] bf16.
- ``k_int8``, ``v_int8`` [B, S, HD] int8.
- ``k_scale``, ``v_scale`` fp32, one scale per (row, position): [B, 1, S]
  for :func:`decode_attention_int8`, [B, S] for
  :func:`decode_attention_int8_multirow` (the same bytes). The scales
  factor onto the scores and the probabilities:
  ``scores[h, s] = (q . k_int8[s]) * k_scale[s] / sqrt(D)`` and
  ``out[h] = sum_s probs[h, s] * v_scale[s] * v_int8[s]``.
- ``length``: as in ``ops.decode_attention``: columns ``s < max(length,
  1)`` are read, the rest never touched; on CUDA a 0-dim int32 tensor.

Returns [B, HD] in q's dtype.
"""

from __future__ import annotations

import math

import torch

from ai_music_generation_tpu_torch.ops.decode_attention import (
    launch,
    valid_prefix,
)


def decode_attention_int8_reference(q, k_int8, v_int8, k_scale, v_scale,
                                    length, n_head: int = 6):
    """Plain twin, op for op the JAX ``decode_attention_int8_reference``:
    K and V dequantized in fp32 (values x their position's scale), q in
    fp32, the scores einsum ``x 1/sqrt(D)``, the valid-prefix mask, fp32
    softmax, PV over V with the masked columns zeroed, cast to q's dtype.
    Takes scales of either layout, [B, 1, S] or [B, S]."""
    B, S, HD = k_int8.shape
    D = HD // n_head
    sm_scale = 1.0 / math.sqrt(D)
    kf = k_int8.float() * k_scale.reshape(B, S, 1).float()
    vf = v_int8.float() * v_scale.reshape(B, S, 1).float()
    q4 = q.float().reshape(B, n_head, D)
    k4 = kf.reshape(B, S, n_head, D)
    v4 = vf.reshape(B, S, n_head, D)
    live = valid_prefix(length, S, k_int8.device)
    scores = torch.einsum("bhd,bshd->bhs", q4, k4) * sm_scale
    scores = scores.masked_fill(~live, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    v_valid = torch.where(live[:, None, None], v4, v4.new_zeros(()))
    out = torch.einsum("bhs,bshd->bhd", probs, v_valid)
    return out.reshape(B, HD).to(q.dtype)


def decode_attention_int8(q, k_int8, v_int8, k_scale, v_scale, length,
                          n_head: int = 6):
    """K5 (module docstring), scales [B, 1, S]: the CUDA kernel for CUDA
    tensors (one block per (row, head)), the plain twin for CPU tensors.
    ``decode_attention_int8.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_int8_reference(
            q, k_int8, v_int8, k_scale, v_scale, length, n_head)
    B, S = k_int8.shape[:2]
    out = launch("decode_attention_int8", q, k_int8, v_int8, k_scale,
                 v_scale, length, n_head, scale_shape=(B, 1, S))
    decode_attention_int8.launches += 1
    return out


def decode_attention_int8_multirow(q, k_int8, v_int8, k_scale, v_scale,
                                   length, n_head: int = 6,
                                   rows_per_program: int = 8):
    """K6 (module docstring), scales [B, S]. ``rows_per_program`` = R was
    the rows of one TPU grid program; R must divide B, as the JAX version
    asserts, and the kernel runs one block per (row, head) whatever R is.
    The plain twin for CPU tensors.
    ``decode_attention_int8_multirow.launches`` counts kernel launches."""
    B = q.shape[0]
    R = rows_per_program
    if R < 1 or B % R:
        raise ValueError(f"rows_per_program {R} must divide batch {B}")
    if q.device.type == "cpu":
        return decode_attention_int8_reference(
            q, k_int8, v_int8, k_scale, v_scale, length, n_head)
    S = k_int8.shape[1]
    out = launch("decode_attention_int8_multirow", q, k_int8, v_int8,
                 k_scale, v_scale, length, n_head, scale_shape=(B, S))
    decode_attention_int8_multirow.launches += 1
    return out


decode_attention_int8.launches = 0
decode_attention_int8_multirow.launches = 0
