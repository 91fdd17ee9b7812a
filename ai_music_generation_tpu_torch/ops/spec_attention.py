"""Speculative-verify attention over the flat spec KV cache: T query tokens
per row, each column readable under its logical position.

Port of ``ai_music_generation_tpu/ops/spec_attention.py`` (the Pallas
kernels ``_spec_attention`` and ``_spec_attention_update``). On CUDA tensors
:func:`spec_attention` and :func:`spec_attention_update` launch the
hand-written kernel in ``csrc/spec_attention.cu``; on CPU tensors they run
the plain twins below. Nothing falls back: a CUDA call that the kernel
cannot take raises.

Contract (B rows, T queries, H heads of size D, S cache columns, HD = H*D):

- ``q`` [B, T, HD], the step's queries.
- ``k``, ``v`` [B, S, HD], int8 (quantized) or the compute dtype.
- ``k_scale``, ``v_scale`` [B, H, S] bf16 in int8 mode, else None, already
  updated for the fresh columns; factored onto the scores and the
  probabilities (q.(k8*ks) == (q.k8)*ks).
- ``col_pos`` [B, S] int32, the logical position of each cache column;
  dead columns hold ``KVCache.INVALID_POS`` (1 << 30).
- ``lengths`` [B] int32: query t of row b sits at ``lengths[b] + t`` and
  reads column s iff ``col_pos[b, s] <= lengths[b] + t``.
- ``spec_attention_update`` also takes ``k_slab``, ``v_slab`` [B, Tw, HD]
  in the cache dtype (Tw = ceil(T/8)*8) and ``cursor``, an int32 scalar
  (a 0-dim tensor on the device, or an int on the CPU): the slab is written
  into columns ``cursor .. cursor+Tw-1`` of k and v IN PLACE before the
  attention reads them (the port's counterpart of the Pallas call's
  ``input_output_aliases``).
- ``int8_dots`` (int8 cache only) quantizes q per (head, query) and the
  scaled probabilities per (head, query) row to int8 and takes both
  products in integers, as the Pallas kernel's int8 x int8 MXU mode does.

Returns [B, T, HD] in q's dtype.

The CUDA kernel takes a bf16 ``q`` and an int8 or bf16 cache, a head size
D that divides 128 and is a multiple of 16, and any ``cursor`` with
``0 <= cursor <= S - Tw``.
"""

from __future__ import annotations

import math

import torch


def _query_mask(col_pos, lengths, T):
    """[B, 1, T, S] bool: query t of row b may read column s."""
    q_pos = lengths[:, None] + torch.arange(T, device=lengths.device)
    return col_pos[:, None, None, :] <= q_pos[:, None, :, None]


def spec_attention_reference(q, k, v, k_scale, v_scale, col_pos, lengths,
                             *, n_head: int):
    """Plain twin, op for op the JAX ``spec_attention_reference``: the
    model's attention chain (``models.gpt.attend``: the einsum in q's dtype,
    ``x 1/sqrt(D)``, ``x k_scale``, the mask, fp32 softmax cast back,
    ``x v_scale``, the PV einsum) under the ``col_pos`` mask."""
    from ai_music_generation_tpu_torch.models.gpt import attend

    B, T, HD = q.shape
    S, D = k.shape[1], HD // n_head
    return attend(q.reshape(B, T, n_head, D), k.view(B, S, n_head, D),
                  v.view(B, S, n_head, D), k_scale, v_scale,
                  _query_mask(col_pos, lengths, T))


def _quantize_rows(x, lo):
    """Per-row int8 quantization of the Pallas int8_dots mode: scale
    ``max(max|x|, 1e-20) / 127`` over the last axis (fp32, IEEE division),
    values ``clip(round_half_even(x / scale), lo, 127)``. Returns the
    integer values (as float64, exact) and the fp32 scales [..., 1]."""
    from ai_music_generation_tpu_torch.models.gpt import true_divide

    s = true_divide(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-20),
                    127.0)
    return torch.round(x / s).clamp(lo, 127).double(), s


def spec_attention_int8_dots_reference(q, k, v, k_scale, v_scale, col_pos,
                                       lengths, *, n_head: int):
    """Plain twin of the kernel's ``int8_dots`` mode, mirroring the Pallas
    body (``_make_attend``, int8_dots branch): q quantized per (head,
    query); scores = int dot * q scale * k_scale * 1/sqrt(D); fp32 softmax
    over the attendable columns; x v_scale; the scaled probabilities
    quantized per (head, query) row to [0, 127]; PV = int dot * that row
    scale. Both integer products are exact (taken in float64). Needs an
    int8 cache. The JAX reference ignores ``int8_dots`` off the TPU, so
    this twin is held against the Pallas kernel in interpret mode."""
    if k_scale is None:
        raise ValueError("int8_dots needs the int8 cache (quantized mode)")
    B, T, HD = q.shape
    S, H = k.shape[1], n_head
    D = HD // H
    q8, qs = _quantize_rows(q.float().reshape(B, T, H, D).transpose(1, 2),
                            -127)  # [B, H, T, D], [B, H, T, 1]
    k8 = k.view(B, S, H, D).transpose(1, 2).double()  # [B, H, S, D]
    v8 = v.view(B, S, H, D).transpose(1, 2).double()
    scores = (q8 @ k8.transpose(-1, -2)).float() * qs
    scores = scores * k_scale[:, :, None, :].float()
    scores = torch.where(_query_mask(col_pos, lengths, T),
                         scores * (1.0 / math.sqrt(D)), float("-inf"))
    probs = torch.softmax(scores, dim=-1) * v_scale[:, :, None, :].float()
    p8, ps = _quantize_rows(probs, 0)
    out = (p8 @ v8).float() * ps  # [B, H, T, D]
    return out.transpose(1, 2).reshape(B, T, HD).to(q.dtype)


def _twin(q, k, v, k_scale, v_scale, col_pos, lengths, n_head, int8_dots):
    if int8_dots:
        return spec_attention_int8_dots_reference(
            q, k, v, k_scale, v_scale, col_pos, lengths, n_head=n_head)
    return spec_attention_reference(q, k, v, k_scale, v_scale, col_pos,
                                    lengths, n_head=n_head)


def write_slab(k, v, k_slab, v_slab, cursor):
    """The plain version of the kernel's slab write: ``k[:, cursor + j] =
    k_slab[:, j]`` (and v) for j < Tw, in place. ``cursor`` may be an int
    or a device tensor (no host sync)."""
    cols = (cursor + torch.arange(k_slab.shape[1], device=k.device)).long()
    k[:, cols] = k_slab.to(k.dtype)
    v[:, cols] = v_slab.to(v.dtype)


# queries per block of the CUDA kernel (csrc/spec_attention.cu kTQ)
_QUERY_TILE = 8


def _check_cuda(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths,
                cursor, n_head, int8_dots):
    B, T, HD = q.shape
    if k.dim() != 3 or k.shape[0] != B or k.shape[2] != HD:
        raise ValueError(f"k must be [B, S, HD] = [{B}, S, {HD}], got "
                         f"{tuple(k.shape)}")
    S = k.shape[1]
    if n_head < 1 or HD % n_head:
        raise ValueError(f"HD={HD} is not a multiple of n_head={n_head}")
    D = HD // n_head
    if D % 16 or 128 % D:
        raise ValueError(f"head size {D} must be a multiple of 16 that "
                         f"divides 128")
    quantized = k_scale is not None
    if int8_dots and not quantized:
        raise ValueError("int8_dots needs the int8 cache (quantized mode)")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    want = {
        "q": (q, torch.bfloat16, (B, T, HD)),
        "k": (k, cache_dtype, (B, S, HD)),
        "v": (v, cache_dtype, (B, S, HD)),
        "col_pos": (col_pos, torch.int32, (B, S)),
        "lengths": (lengths, torch.int32, (B,)),
    }
    if k_slab is not None:
        Tw = -(-T // 8) * 8
        want["k_slab"] = (k_slab, cache_dtype, (B, Tw, HD))
        want["v_slab"] = (v_slab, cache_dtype, (B, Tw, HD))
        want["cursor"] = (cursor, torch.int32, ())
        if Tw > S:
            raise ValueError(f"write width {Tw} exceeds the cache ({S})")
    if quantized:
        want["k_scale"] = (k_scale, torch.bfloat16, (B, n_head, S))
        want["v_scale"] = (v_scale, torch.bfloat16, (B, n_head, S))
    elif v_scale is not None:
        raise ValueError("k_scale and v_scale must both be given or both None")
    for name, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor on {q.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("k", "v", "k_slab", "v_slab") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    # csrc/spec_attention.cu smem_bytes: int8 q, fp32 q, scores (or the
    # 4 warps' PV partial sums), 2 scale rows, col_pos
    tq = _QUERY_TILE
    smem = tq * D + 4 * (tq * D + max(tq * S, 4 * tq * D) + 2 * tq + S)
    if smem > 227 * 1024:
        raise ValueError(
            f"S={S} too large for one block's shared memory ({smem} B)")
    return B, T, S, D, quantized


def _launch(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths,
            cursor, n_head, int8_dots):
    from ai_music_generation_tpu_torch.ops import _build

    B, T, S, D, quantized = _check_cuda(
        q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos, lengths, cursor,
        n_head, int8_dots)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _build.load_library().spec_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(k_slab), ptr(v_slab), ptr(k_scale),
        ptr(v_scale), ptr(col_pos), ptr(lengths), ptr(cursor), ptr(out),
        B, T, S, n_head, D, int(quantized), int(int8_dots),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"spec_attention kernel launch failed: cudaError {rc}")
    return out


def _device_of(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device.type}")
    return q.device.type


def spec_attention(q, k, v, k_scale, v_scale, col_pos, lengths, *,
                   n_head: int, int8_dots: bool = False):
    """Masked multi-query attention over the spec cache (module docstring),
    without a write: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors. ``spec_attention.launches`` counts kernel launches."""
    if _device_of(q, "spec_attention") == "cpu":
        return _twin(q, k, v, k_scale, v_scale, col_pos, lengths, n_head,
                     int8_dots)
    out = _launch(q, k, v, None, None, k_scale, v_scale, col_pos, lengths,
                  None, n_head, int8_dots)
    spec_attention.launches += 1
    return out


def spec_attention_update(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos,
                          lengths, cursor, *, n_head: int,
                          int8_dots: bool = False):
    """The slab write at ``cursor`` (in place) followed by the masked
    multi-query attention (module docstring): the CUDA kernel for CUDA
    tensors, the plain twins for CPU tensors. Returns out [B, T, HD].
    ``spec_attention_update.launches`` counts kernel launches."""
    if _device_of(q, "spec_attention_update") == "cpu":
        if int8_dots and k_scale is None:  # refuse before the write
            raise ValueError("int8_dots needs the int8 cache (quantized mode)")
        write_slab(k, v, k_slab, v_slab, cursor)
        return _twin(q, k, v, k_scale, v_scale, col_pos, lengths, n_head,
                     int8_dots)
    out = _launch(q, k, v, k_slab, v_slab, k_scale, v_scale, col_pos,
                  lengths, cursor, n_head, int8_dots)
    spec_attention_update.launches += 1
    return out


spec_attention.launches = 0
spec_attention_update.launches = 0
