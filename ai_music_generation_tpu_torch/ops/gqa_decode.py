"""One T=1 grouped-query decode step over a flat KV cache: the fresh K/V
column is written (int8 mode: quantized first) and every query head attends.

Port of ``ai_music_generation_tpu/ops/gqa_decode.py`` (the Pallas kernel
``_gqa_decode_update``). On a CUDA tensor :func:`gqa_decode_update` launches
a hand-written kernel: at G = H // KH > 1 the one of ``csrc/gqa_decode.cuh``
(a block of 128 threads a (row, kv-head); lockstep mode built from
``csrc/gqa_decode.cu``, ring mode from ``csrc/gqa_decode_ring.cu``), at
G = 1 (multi-head attention) the one of ``csrc/gqa_decode_mha.cuh`` (a
warp a (row, head), 32-column tiles, an online softmax, a row's columns
split over up to 4 warps where the launch has few rows; lockstep mode
built from ``csrc/gqa_decode_mha.cu``, ring mode from
``csrc/gqa_decode_mha_ring.cu``); on a CPU tensor it runs
the plain twin :func:`gqa_decode_reference`. Nothing falls back: a CUDA call
that the kernel cannot take raises.

Contract (B rows, H query heads, KH kv-heads, G = H // KH, head size D):

- ``q`` [B, H, D], the step's queries, unfolded: query head h reads
  kv-head ``h // G``. (The Pallas kernel took them folded into kv-head
  lanes, an MXU trick the port drops.)
- ``k``, ``v`` [B, S, KH*D], int8 (quantized) or the compute dtype.
  Updated IN PLACE: column ``pos`` receives the fresh K/V. This is the
  port's counterpart of the Pallas call's ``input_output_aliases``.
- ``k_slab``, ``v_slab`` [B, KH*D], the step's fresh K/V projections. In
  int8 mode they are raw and are quantized per (row, kv-head) exactly as
  ``models.gpt.quantize_int8`` does.
- ``k_scale``, ``v_scale`` [B, KH, S] bf16 in int8 mode, else None.
  Updated in place at column ``pos``; factored onto scores and
  probabilities (q.(k8*ks) == (q.k8)*ks).
- ``mask_rel`` [B, S] int32 selects ring mode (column s of row b is
  attendable iff ``mask_rel[b, s] >= 0``); None selects lockstep mode
  (attendable iff ``s <= pos``). In ring mode each row's columns are summed
  in its window's order, oldest first: the ``n = mask_rel[b, pos] + 1``
  columns up to the fresh one (capped at S), from column ``pos + 1 - n``
  round, then the rest. A row's output then does not depend on where the
  shared cursor stands (a served request gives the same bits in any slot
  at any time), and a ring row that started at column 0 sums as a
  lockstep row (the Pallas kernel sums in column order).
- ``pos`` int32 scalar tensor on the same device: the column written this
  step. The kernel loads it itself, so a decode step needs no host sync.

Returns ``out`` [B, H, D] in q's dtype.

The CUDA kernel takes ``q`` and the slabs in one type, bf16 or fp32 (an
fp32 model: the Pallas kernel computes in q's dtype), and an int8 cache or
one in that type, with k and v on 16-byte boundaries, and a head size D
that is a multiple of 16 and divides 128. At G > 1, S must also let one
block's buffers fit shared memory (the kernel streams K and V through a
ring of column tiles, so what grows with S is only G+3 floats per column:
S up to about 8,000 at G=3). At G = 1 nothing in shared memory grows with
S (the softmax is online), so S has no limit of its own. It raises on
anything else; it does not fall back.
"""

from __future__ import annotations

import torch

from ai_music_generation_tpu_torch.utils import tracing


def gqa_decode_reference(q, k, v, k_slab, v_slab, k_scale, v_scale,
                         mask_rel, pos):
    """Plain PyTorch twin of the kernel, op for op the JAX
    ``gqa_decode_reference``: quantize + scale write (int8 mode), column
    write, then the model's attention chain (``models.gpt.attend``: the
    einsum in the compute dtype, ``x 1/sqrt(D)``, ``x k_scale``, the mask,
    fp32 softmax cast back, ``x v_scale``, the PV einsum), in ring mode
    over each row's columns in its window's order, as the kernel sums."""
    from ai_music_generation_tpu_torch.models.gpt import (
        attend, quantize_int8, scale_write,
    )

    B, H, D = q.shape
    S, KHD = k.shape[1], k.shape[2]
    KH = KHD // D
    col = torch.as_tensor(pos, dtype=torch.int64, device=k.device).reshape(1)
    if k_scale is not None:
        kq, ks_new = quantize_int8(k_slab.reshape(B, KH, D))
        vq, vs_new = quantize_int8(v_slab.reshape(B, KH, D))
        k_slab, v_slab = kq.reshape(B, KHD), vq.reshape(B, KHD)
        scale_write(k_scale, ks_new[:, None], col)
        scale_write(v_scale, vs_new[:, None], col)
    k[:, col] = k_slab.to(k.dtype)[:, None]
    v[:, col] = v_slab.to(v.dtype)[:, None]
    kv = k.view(B, S, KH, D), v.view(B, S, KH, D)
    scales = k_scale, v_scale
    if mask_rel is not None:
        n_win = (mask_rel[:, col] + 1).clamp(1, S)  # [B, 1]
        order = (col + 1 - n_win + torch.arange(S, device=k.device)) % S
        rows = torch.arange(B, device=k.device)[:, None]
        kv = tuple(t[rows, order] for t in kv)
        scales = tuple(None if t is None else
                       t.gather(2, order[:, None, :].expand(-1, KH, -1))
                       for t in scales)
        valid = (mask_rel.gather(1, order) >= 0)[:, None, None, :]
    else:
        valid = (torch.arange(S, device=k.device) <= col)[None, None, None, :]
    y = attend(q[:, None], *kv, *scales, valid)
    return y.reshape(B, H, D)


def _check_cuda(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos):
    B, H, D = q.shape
    if k.dim() != 3 or k.shape[0] != B or k.shape[2] % D:
        raise ValueError(f"k must be [B, S, KH*D], got {tuple(k.shape)}")
    S, KHD = k.shape[1], k.shape[2]
    KH = KHD // D
    if KH == 0 or H % KH:
        raise ValueError(f"n_head={H} is not a multiple of n_kv_head={KH}")
    if D % 16 or 128 % D:
        raise ValueError(f"head size {D} must be a multiple of 16 that "
                         f"divides 128")
    quantized = k_scale is not None
    # the compute type is the slabs': q and (unquantized) the cache follow it
    dtype = k_slab.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k_slab must be torch.bfloat16 or torch.float32, "
                         f"got {dtype}")
    want = {
        "q": (q, dtype, (B, H, D)),
        "k": (k, torch.int8 if quantized else dtype, (B, S, KHD)),
        "v": (v, torch.int8 if quantized else dtype, (B, S, KHD)),
        "k_slab": (k_slab, dtype, (B, KHD)),
        "v_slab": (v_slab, dtype, (B, KHD)),
        "pos": (pos, torch.int32, ()),
    }
    if quantized:
        want["k_scale"] = (k_scale, torch.bfloat16, (B, KH, S))
        want["v_scale"] = (v_scale, torch.bfloat16, (B, KH, S))
    elif v_scale is not None:
        raise ValueError("k_scale and v_scale must both be given or both None")
    if mask_rel is not None:
        want["mask_rel"] = (mask_rel, torch.int32, (B, S))
    for name, (t, dtype, shape) in want.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("k", "v") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return B, S, H, KH, D, quantized


def gqa_decode_update(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                      pos):
    """The decode step (module docstring): the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors. Updates k, v (and the scales)
    in place; returns out [B, H, D]. ``gqa_decode_update.launches`` counts
    kernel launches; the call is the span ``ops.gqa_decode``
    (``utils/tracing.py``) while a profiler records."""
    with tracing.span(tracing.K1_UPDATE):
        if q.device.type == "cpu":
            return gqa_decode_reference(q, k, v, k_slab, v_slab, k_scale,
                                        v_scale, mask_rel, pos)
        if q.device.type != "cuda":
            raise ValueError(f"gqa_decode_update runs on cuda or cpu, not "
                             f"{q.device.type}")
        from ai_music_generation_tpu_torch.ops import _build

        B, S, H, KH, D, quantized = _check_cuda(
            q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel, pos)
        out = torch.empty_like(q)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _build.load_library()
        rc = lib.gqa_decode_update_launch(
            ptr(q), ptr(k), ptr(v), ptr(k_slab), ptr(v_slab), ptr(k_scale),
            ptr(v_scale), ptr(mask_rel), ptr(pos), ptr(out),
            B, S, H, KH, D, int(quantized), int(q.dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream)
        if rc == _build.TOO_LARGE:
            raise ValueError(f"S={S} too large for one block's shared memory "
                             f"(csrc/gqa_decode.cuh smem_bytes)")
        if rc != 0:
            raise RuntimeError(
                f"gqa_decode kernel launch failed: cudaError {rc}")
        gqa_decode_update.launches += 1
        return out


gqa_decode_update.launches = 0
