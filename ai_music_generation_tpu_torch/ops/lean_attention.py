"""Lean single-query (T=1) decode attention over an int8 or position-packed
int4 cache with one bf16 scale per (row, head, position).

Port of ``docs/experiments/int4_kernel_probe.py`` (the Pallas kernel
``_lean_kernel`` behind ``lean_attention``). On CUDA tensors
:func:`lean_attention` launches the hand-written kernel in
``csrc/lean_attention.cu``; on CPU tensors it runs the plain twin
:func:`lean_attention_reference`. Nothing falls back: a CUDA call that the
kernel cannot take raises.

Contract (B rows, H heads of size D, S positions, HD = H*D):

- ``q`` [B, HD] bf16, the step's query.
- ``k``, ``v`` [B, Sp, HD] int8. Unpacked (``packed=False``, "lean8"):
  Sp = S, one int8 value per (position, lane). Position-packed int4
  (``packed=True``, "lean4"): Sp = S/2, and the byte at (p, lane) holds
  position p in its low nibble and position p + S/2 in its high nibble
  (:func:`pack_int4`). Lanes are never packed.
- ``k_scale``, ``v_scale`` [B, H, S] bf16: the scores are multiplied by
  ``k_scale``, the probabilities by ``v_scale``.

Returns [B, HD] fp32. Every position is read: there is no length and no
mask.

lean8 quantizes q and the probabilities per (row, head) to int8 and does
both dots as int8 x int8 with int32 sums; lean4 unpacks the nibbles and
does both dots against bf16 q and bf16-rounded probabilities with fp32
sums. :func:`lean_attention_reference` states the order of operations.
"""

from __future__ import annotations

import math

import torch

HEAD_SIZES = (16, 32, 64, 128)
# the kernel keeps S fp32 scores in shared memory: 224 KiB of the 227 KiB a
# block may use, the rest for its static reduction buffers
MAX_S = 56 * 1024


def pack_int4(lo, hi):
    """Two int tensors [B, S/2, HD] with values in [-8, 7] -> [B, S/2, HD]
    int8: ``lo`` (positions 0..S/2-1) in the low nibble, ``hi`` (positions
    S/2..S-1) in the high nibble."""
    if lo.shape != hi.shape:
        raise ValueError(f"lo {tuple(lo.shape)} and hi {tuple(hi.shape)} "
                         f"differ in shape")
    for name, t in (("lo", lo), ("hi", hi)):
        if t.numel() and not (-8 <= int(t.min()) and int(t.max()) <= 7):
            raise ValueError(f"{name} holds a value outside [-8, 7]")
    lo32, hi32 = lo.to(torch.int32), hi.to(torch.int32)
    return ((lo32 & 0xF) | ((hi32 & 0xF) << 4)).to(torch.uint8).view(
        torch.int8)


def unpack_int4(packed):
    """[B, S/2, HD] int8 -> [B, S, HD] int8: the low nibbles (sign-extended)
    as positions 0..S/2-1, then the high nibbles as S/2..S-1."""
    x = packed.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8
    return torch.cat([lo, x >> 4], dim=1).to(torch.int8)


def _softmax(x):
    """``jax.nn.softmax`` over the last axis, as it computes it: exp(x -
    max), then a division by the sum (torch.softmax multiplies by the
    reciprocal)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def lean_attention_reference(q, k, v, k_scale, v_scale, packed: bool,
                             n_head: int = 6):
    """Plain twin, op for op the Pallas kernel body (int4_kernel_probe.py
    :137-190) for each (row, head), without its TPU shape (the 8-sublane q,
    the padded head rows, the lane-ownership mask and the ones-dot fold).

    lean8: ``qs = max(max|q_h|, 1e-20) / 127``; ``q8 = clip(round(q_h /
    qs), +-127)`` (round half to even); ``scores = float(q8 . k8) * qs *
    k_scale * (1/sqrt(D))``, left to right; fp32 softmax over all S;
    ``probs *= v_scale``; ``ps = max(max probs, 1e-20) / 127``; ``p8 =
    clip(round(probs / ps), 0, 127)``; ``out = float(p8 . v8) * ps``.

    lean4: ``scores = (q . k) * k_scale * (1/sqrt(D))`` with fp32 sums;
    softmax; ``probs *= v_scale``; probabilities rounded to bf16;
    ``out = probs . v`` with fp32 sums.

    The int8 dots are fp32 einsums here: every partial sum is an integer
    below 2^24, so they are exact; the two divisions by 127 are IEEE on
    every device (``models.gpt.true_divide``)."""
    from ai_music_generation_tpu_torch.models.gpt import true_divide

    B, _, HD = k.shape
    S = k_scale.shape[-1]
    D = HD // n_head
    sm = 1.0 / math.sqrt(D)
    if packed:
        k, v = unpack_int4(k), unpack_int4(v)
    kf = k.float().reshape(B, S, n_head, D)
    vf = v.float().reshape(B, S, n_head, D)
    qf = q.float().reshape(B, n_head, D)
    ks, vs = k_scale.float(), v_scale.float()
    if packed:
        scores = torch.einsum("bhd,bshd->bhs", qf, kf) * ks * sm
        probs = _softmax(scores) * vs
        probs = probs.to(torch.bfloat16).float()
        out = torch.einsum("bhs,bshd->bhd", probs, vf)
        return out.reshape(B, HD)
    # |q8|, p8 <= 127 and |k8|, |v8| <= 128: integer sums stay exact in fp32
    if max(D, S) * 127 * 128 >= 2 ** 24:
        raise ValueError(f"D={D} or S={S} too large for exact fp32 int8 dots")
    qs = true_divide(torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-20),
                     127.0)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127)
    scores = torch.einsum("bhd,bshd->bhs", q8, kf) * qs * ks * sm
    probs = _softmax(scores) * vs
    ps = true_divide(torch.clamp(probs.amax(-1, keepdim=True), min=1e-20),
                     127.0)
    p8 = torch.clamp(torch.round(probs / ps), 0, 127)
    out = torch.einsum("bhs,bshd->bhd", p8, vf) * ps
    return out.reshape(B, HD)


def _launch(q, k, v, k_scale, v_scale, packed, n_head):
    """Check the operands and launch ``lean_attention_kernel`` on q's
    stream: one block per (row, head). Returns out."""
    from ai_music_generation_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"lean_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    if q.dim() != 2:
        raise ValueError(f"q must be [B, HD], got {tuple(q.shape)}")
    B, HD = q.shape
    if n_head < 1 or HD % n_head:
        raise ValueError(f"HD={HD} is not a multiple of n_head={n_head}")
    D = HD // n_head
    if D not in HEAD_SIZES:
        raise ValueError(f"head size {D} must be one of {HEAD_SIZES}")
    if k_scale.dim() != 3:
        raise ValueError(f"k_scale must be [B, H, S], got "
                         f"{tuple(k_scale.shape)}")
    S = k_scale.shape[2]
    if packed and S % 2:
        raise ValueError(f"a position-packed int4 cache needs an even S, "
                         f"got {S}")
    if not 1 <= S <= MAX_S:
        raise ValueError(f"S={S} does not fit one block's shared memory "
                         f"(1 <= S <= {MAX_S})")
    Sp = S // 2 if packed else S
    want = {
        "q": (q, torch.bfloat16, (B, HD)),
        "k": (k, torch.int8, (B, Sp, HD)),
        "v": (v, torch.int8, (B, Sp, HD)),
        "k_scale": (k_scale, torch.bfloat16, (B, n_head, S)),
        "v_scale": (v_scale, torch.bfloat16, (B, n_head, S)),
    }
    for arg, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{arg} must be a tensor on {q.device}")
        if t.device != q.device:
            raise ValueError(f"{arg} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{arg} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if arg in ("k", "v") and t.data_ptr() % 16:
            raise ValueError(f"{arg} must start on a 16-byte boundary")
    out = torch.empty((B, HD), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    rc = _build.load_library().lean_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), B, S, n_head, D, int(packed),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lean_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out


def lean_attention(q, k, v, k_scale, v_scale, packed: bool,
                   n_head: int = 6):
    """K7 (module docstring): the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors. ``lean_attention.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return lean_attention_reference(q, k, v, k_scale, v_scale, packed,
                                        n_head)
    out = _launch(q, k, v, k_scale, v_scale, packed, n_head)
    lean_attention.launches += 1
    return out


lean_attention.launches = 0
