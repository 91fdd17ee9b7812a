"""Speculative-verify attention over the flat spec KV cache: T query tokens
per row, each column readable under its logical position.

Port of ``ai_music_generation_tpu/ops/spec_attention.py`` (the Pallas
kernels ``_spec_attention`` and ``_spec_attention_update``). On CUDA tensors
:func:`spec_attention` and :func:`spec_attention_update` launch the
hand-written kernels of ``csrc/spec_attention*``; on CPU tensors they run
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

The CUDA kernels take ``q`` (and the slabs of an unquantized cache) in one
type, bf16 or fp32 (an fp32 model: the Pallas kernel computes in q's
dtype), an int8 cache or one in that type, a head size D that divides 128
and is a multiple of 16, any ``cursor`` with ``0 <= cursor <= S - Tw``, and
an S whose block buffers fit shared memory. Every mode runs the tensor-core
kernel of ``csrc/spec_attention_mma.cuh`` in one of two regimes that its
launcher chooses from T, 16 query rows per block for T <= 16 (a verify
step), 64 for a refresh where those buffers fit (16 over a long cache); S
goes up to about 7,000 at T=5 and 2,900 at T >= 16 (6,200 and 2,500 over
an fp32 cache; mma_smem_bytes). A bf16 ``q`` enters through
``csrc/spec_attention.cu``. An fp32 ``q`` enters through
``csrc/spec_attention_f32.cu`` and keeps fp32 accuracy on the tensor cores
with split operands: over an int8 cache q and the probabilities each as two
fp16 parts, hi and lo (two passes per product), over an fp32 cache 3xTF32
(three);
:func:`spec_attention_f32_mma_model` evaluates those roundings on the CPU.
``int8_dots`` takes either type of ``q`` (instantiated in
``csrc/spec_attention_dots.cu``): q quantized in the kernel as
:func:`spec_attention_int8_dots_reference` quantizes it, the probabilities
per row as it does up to their roundings (a quantized probability may be
a neighbouring integer), both products int8 x int8 on the integer tensor
cores (mma.sync m16n8k32), exact int32 sums.
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


def spec_attention_mma_model(q, k, v, k_scale, v_scale, col_pos, lengths,
                             *, n_head: int):
    """The tensor-core kernel's roundings, evaluated on the CPU (tests
    only): scores and the softmax in fp32 from exact products (as the fp32
    twin); then the PV operands as ``csrc/spec_attention.cu`` rounds them.
    With an int8 cache, P x v_scale is scaled per (head, query) row by the
    power of two that lifts its largest value into [2^14, 2^15), rounded to
    fp16, multiplied by V (exact in fp16) and divided back. With a bf16
    cache, P is split into bf16 hi + lo and both are multiplied by V. A row
    whose every column is dead gives 0. Returns [B, T, HD] in bf16, the
    kernel's single rounding of its output."""
    B, T, HD = q.shape
    S, H = k.shape[1], n_head
    D = HD // H
    qh = q.float().reshape(B, T, H, D).transpose(1, 2)  # [B, H, T, D]
    kh = k.view(B, S, H, D).transpose(1, 2).float()
    vh = v.view(B, S, H, D).transpose(1, 2).float()
    scores = qh @ kh.transpose(-1, -2)
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :].float()
    mask = _query_mask(col_pos, lengths, T)
    scores = torch.where(mask, scores * (1.0 / math.sqrt(D)), float("-inf"))
    live = mask.any(dim=-1, keepdim=True)
    probs = torch.where(live, torch.softmax(scores, dim=-1), 0.0)
    if k_scale is not None:
        probs = probs * v_scale[:, :, None, :].float()
        _, ex = torch.frexp(probs.amax(dim=-1, keepdim=True))
        factor = torch.where(live, torch.ldexp(torch.ones_like(probs[..., :1]),
                                               15 - ex), 1.0)
        p16 = (probs * factor).half().float()
        out = (p16 @ vh) / factor
    else:
        hi = probs.bfloat16().float()
        lo = (probs - hi).bfloat16().float()
        out = hi @ vh + lo @ vh
    return out.transpose(1, 2).reshape(B, T, HD).to(torch.bfloat16)


def split_f16(x):
    """fp32 ``x`` as fp16 hi + lo (returned as fp32): hi the rounding of
    x, lo that of the exact rest x - hi. The kernel's two-pass operand for
    an fp32 q or P over an int8 cache, taken after the row's power-of-two
    scaling: within 2^-22 |x|, or 2^-25 where lo falls among fp16's
    subnormals."""
    hi = x.half().float()
    return hi, (x - hi).half().float()


def to_tf32(x):
    """fp32 ``x`` rounded to tf32 (10 fraction bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: half a tf32 ulp added to
    the magnitude's bits, the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """fp32 ``x`` as tf32 hi + lo: the kernel's 3xTF32 operand over an fp32
    cache (within 2^-22 |x|)."""
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def spec_attention_f32_mma_model(q, k, v, k_scale, v_scale, col_pos, lengths,
                                 *, n_head: int):
    """The tensor-core kernel's roundings for an fp32 q, evaluated on the
    CPU (tests only): its split operands, their products and sums exact
    (float64), the softmax in fp32. Over an int8 cache each (head, query)
    row of q is scaled by the power of two that lifts its largest |q| into
    [2^14, 2^15) and split into fp16 hi + lo (:func:`split_f16`) against K;
    P x v_scale is scaled per row the same way and split against V; both
    scalings are divided back exactly. Over an fp32 cache, 3xTF32: q, K, P
    and V split into tf32 hi + lo (:func:`split_tf32`), the products
    lo.hi + hi.lo + hi.hi. A row whose every column is dead gives 0.
    Returns [B, T, HD] fp32, the kernel's single rounding of its output."""
    B, T, HD = q.shape
    S, H = k.shape[1], n_head
    D = HD // H
    qh = q.float().reshape(B, T, H, D).transpose(1, 2)  # [B, H, T, D]
    kh = k.view(B, S, H, D).transpose(1, 2).float()
    vh = v.view(B, S, H, D).transpose(1, 2).float()

    def scaled_split(x):  # per-row power of two, fp16 hi + lo, exact sum
        _, ex = torch.frexp(x.abs().amax(dim=-1, keepdim=True))
        f = torch.ldexp(torch.ones_like(x[..., :1]), 15 - ex.clamp_min(-100))
        hi, lo = split_f16(x * f)
        return hi.double() + lo.double(), f

    def tf32_product(a, b):  # a @ b as the 3xTF32 passes
        (ah, al), (bh, bl) = (tuple(p.double() for p in split_tf32(t))
                              for t in (a, b))
        return (al @ bh + ah @ bl + ah @ bh).float()

    if k_scale is not None:
        qs, f = scaled_split(qh)
        scores = (qs @ kh.double().transpose(-1, -2)).float() / f
        scores = scores * k_scale[:, :, None, :].float()
    else:
        scores = tf32_product(qh, kh.transpose(-1, -2))
    mask = _query_mask(col_pos, lengths, T)
    scores = torch.where(mask, scores * (1.0 / math.sqrt(D)), float("-inf"))
    live = mask.any(dim=-1, keepdim=True)
    probs = torch.where(live, torch.softmax(scores, dim=-1), 0.0)
    if k_scale is not None:
        ps, f = scaled_split(probs * v_scale[:, :, None, :].float())
        out = (ps @ vh.double()).float() / f
    else:
        out = tf32_product(probs, vh)
    return out.transpose(1, 2).reshape(B, T, HD)


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
    # the compute type: the slabs' with an unquantized cache, else q's
    dtype = (k_slab.dtype if k_slab is not None and not quantized
             else q.dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be torch.bfloat16 or torch.float32, got "
                         f"{dtype}")
    cache_dtype = torch.int8 if quantized else dtype
    want = {
        "q": (q, dtype, (B, T, HD)),
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
    args = (ptr(q), ptr(k), ptr(v), ptr(k_slab), ptr(v_slab), ptr(k_scale),
            ptr(v_scale), ptr(col_pos), ptr(lengths), ptr(cursor), ptr(out),
            B, T, S, n_head, D, int(quantized))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _build.load_library()
    launch = (lib.spec_attention_f32_launch if q.dtype == torch.float32
              else lib.spec_attention_launch)
    rc = launch(*args, int(int8_dots), stream)
    if rc == _build.TOO_LARGE:
        raise ValueError(f"S={S} too large for one block's shared memory "
                         f"(csrc/spec_attention_mma.cuh mma_smem_bytes)")
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
