"""Single-query (T=1) multi-head decode attention over the valid prefix of a
flat KV cache.

Port of ``ai_music_generation_tpu/ops/decode_attention.py`` (the Pallas
kernel ``_decode_attention``). On CUDA tensors :func:`decode_attention`
launches the hand-written kernel in ``csrc/decode_attention.cu``; on CPU
tensors it runs the plain twin :func:`decode_attention_reference`. Nothing
falls back: a CUDA call that the kernel cannot take raises.

Contract (B rows, H heads of size D, S cache columns, HD = H*D), the JAX
layout:

- ``q`` [B, HD], the step's queries.
- ``k_cache``, ``v_cache`` [B, S, HD] in q's dtype.
- ``length``: int32 scalar, the number of valid columns. Columns
  ``s < max(length, 1)`` are read (all S if length > S); the ones past it
  are never touched and may hold anything, NaN included. On CUDA it is a
  0-dim int32 tensor on q's device, which the kernel loads itself, so a
  decode step needs no host sync.

Returns [B, HD] in q's dtype.

The CUDA kernel takes q and the cache in bf16 (or all in fp32), a head size
D in {16, 32, 64, 128}, and K/V starting on a 16-byte boundary. The
shared launcher :func:`launch` also serves the int8 variants
(``ops/decode_attention_int8.py``), which run the same kernel.
"""

from __future__ import annotations

import math

import torch

HEAD_SIZES = (16, 32, 64, 128)


def valid_prefix(length, S, device):
    """[S] bool: the columns ``s < max(length, 1)``."""
    L = torch.clamp(torch.as_tensor(length, device=device), min=1)
    return torch.arange(S, device=device) < L


def decode_attention_reference(q, k_cache, v_cache, length, n_head: int = 6):
    """Plain twin, op for op the JAX ``decode_attention_reference``: the
    scores einsum in the inputs' dtype, ``x 1/sqrt(D)`` (rounded to q's
    dtype, as JAX's weakly typed scalar is), the valid-prefix mask, fp32
    softmax, probabilities cast to v's dtype, PV over V with the masked
    columns zeroed (so a NaN there never reaches the sum), cast to q's
    dtype."""
    B, S, HD = k_cache.shape
    D = HD // n_head
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype).item()
    q4 = q.reshape(B, n_head, D)
    k4 = k_cache.reshape(B, S, n_head, D)
    v4 = v_cache.reshape(B, S, n_head, D)
    live = valid_prefix(length, S, k_cache.device)
    scores = torch.einsum("bhd,bshd->bhs", q4, k4) * scale
    scores = scores.masked_fill(~live, float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1)
    v_valid = torch.where(live[:, None, None], v4, v4.new_zeros(()))
    out = torch.einsum("bhs,bshd->bhd", probs.to(v4.dtype), v_valid)
    return out.reshape(B, HD).to(q.dtype)


def launch(name, q, k, v, k_scale, v_scale, length, n_head,
           scale_shape=None):
    """Check the operands of the op ``name`` and launch
    ``decode_attention_kernel`` on q's stream. ``k_scale``/``v_scale``
    (fp32, ``scale_shape``) select the int8 cache. One block per (row,
    head). Returns out."""
    from ai_music_generation_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device.type}")
    if q.dim() != 2:
        raise ValueError(f"q must be [B, HD], got {tuple(q.shape)}")
    B, HD = q.shape
    if n_head < 1 or HD % n_head:
        raise ValueError(f"HD={HD} is not a multiple of n_head={n_head}")
    D = HD // n_head
    if D not in HEAD_SIZES:
        raise ValueError(f"head size {D} must be one of {HEAD_SIZES}")
    if k.dim() != 3:
        raise ValueError(f"k must be [B, S, HD], got {tuple(k.shape)}")
    S = k.shape[1]
    quantized = k_scale is not None
    if quantized:
        q_dtype, cache_dtype, mode = torch.bfloat16, torch.int8, 2
    elif q.dtype in (torch.bfloat16, torch.float32):
        q_dtype = cache_dtype = q.dtype
        mode = 0 if q.dtype == torch.bfloat16 else 1
    else:
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    want = {
        "q": (q, q_dtype, (B, HD)),
        "k": (k, cache_dtype, (B, S, HD)),
        "v": (v, cache_dtype, (B, S, HD)),
        "length": (length, torch.int32, ()),
    }
    if quantized:
        want["k_scale"] = (k_scale, torch.float32, scale_shape)
        want["v_scale"] = (v_scale, torch.float32, scale_shape)
    elif v_scale is not None:
        raise ValueError("k_scale and v_scale must both be given or both None")
    for arg, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{arg} must be a tensor on {q.device}")
        if t.device != q.device:
            raise ValueError(f"{arg} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{arg} must be {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if arg in ("k", "v") and t.data_ptr() % 16:
            raise ValueError(f"{arg} must start on a 16-byte boundary")
    if 4 * S > 227 * 1024:
        raise ValueError(f"S={S} too large for one block's shared memory")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _build.load_library().decode_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale), ptr(length),
        ptr(out), B, S, n_head, D, mode,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def decode_attention(q, k_cache, v_cache, length, n_head: int = 6):
    """T=1 attention over the valid prefix (module docstring): the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors.
    ``decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, length, n_head)
    out = launch("decode_attention", q, k_cache, v_cache, None, None, length,
                 n_head)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
