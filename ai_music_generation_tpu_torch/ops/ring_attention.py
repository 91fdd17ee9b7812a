"""Ring attention: exact causal attention over a sequence-sharded axis, the
port of ``ai_music_generation_tpu/ops/ring_attention.py``.

The [B, T, ...] activations are split over the ranks of a ``seq`` group in
contiguous chunks (rank i holds global positions ``i*Tl .. (i+1)*Tl - 1``).
Each rank folds every K/V chunk into a flash-style online softmax while the
chunks rotate around the group with
:func:`~ai_music_generation_tpu_torch.parallel.collectives.ring_shift`, so
no rank holds a [B, H, T, T] score tensor of the global sequence. It is
plain torch ops around point-to-point sends, as the JAX op is einsums
around ``ppermute`` (no Pallas kernel); autograd through ``ring_shift``
gives the backward, as ``jax.grad`` transposes ``ppermute``.

Numerics are the JAX op's, op for op: scores in the compute dtype, then
fp32 for the mask, the running max, the normaliser and the accumulator;
masked scores are the finite ``_NEG`` (a fully masked block adds exactly
0). Every rank walks all n steps (the causal mask zeroes the blocks of
later ranks), as the SPMD program does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.parallel.collectives import ring_shift

# finite stand-in for -inf: exp(_NEG - m) underflows to exactly 0 in fp32
_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of the local chunks ``q``, ``k``, ``v`` [B, Tl, H,
    D] with K/V rotated around ``group`` (the global position of local row
    t is ``rank * Tl + t``, rank the group rank). ``scale`` defaults to
    ``1/sqrt(D)``. Returns [B, Tl, H, D] in q's dtype."""
    B, Tl, H, D = q.shape
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    local = torch.arange(Tl, device=dev)
    q_pos = idx * Tl + local
    # online-softmax state, fp32 (the plain path's softmax is fp32)
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for step in range(n):
        # after `step` rotations this rank holds rank (idx - step)'s chunk
        k_pos = ((idx - step) % n) * Tl + local
        s = torch.einsum("bthd,bshd->bhts", q, kb).float() * scale
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, vb.float())
        m = m_new
        if step < n - 1:
            kb, vb = ring_shift(kb, group), ring_shift(vb, group)
    # every query sees itself at step 0, so l >= 1
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)
