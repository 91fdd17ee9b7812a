"""32-bit counter hashing in plain integer ops: the port's stateless random
bits (the serving engine's sampling noise, the training path's dropout
masks).

Every function works on int64 tensors holding values in [0, 2^32) and on
Python ints alike; no product reaches 2^63, so a tensor gives the same bits
on the CPU and the card.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1  # odd, so ``mul32(x, GOLDEN)`` is a bijection mod 2^32


def mul32(x, c: int):
    """``x * c mod 2^32`` for ``x`` in [0, 2^32): the constant is split in
    16-bit halves so no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(h):
    """murmur3's 32-bit finalizer on values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)
