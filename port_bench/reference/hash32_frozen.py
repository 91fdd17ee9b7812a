"""A frozen copy of the counter hash that keys the training path's dropout
masks (the port's ``utils/hash32.py`` and ``models/gpt.py::dropout_key`` /
``dropout_keep``), kept here so that the reference never imports the port
and a later change to the port's masks shows as a failed comparison.

Element ``i`` (row-major over the site's full shape) of site ``site`` in
layer ``layer`` is kept iff ``mix32(mul32(i, GOLDEN) ^ k) >= p * 2^32``
with ``k = mix32(key ^ mul32(4 * layer + site + 1, GOLDEN))``. Sites: 0 the
embedding sum, 1 the attention probabilities [B, H, T, T], 2 after the
attention's output projection, 3 after the MLP's output projection.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1


def mul32(x, c: int):
    """``x * c mod 2^32`` for x in [0, 2^32), in 16-bit halves of c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(h):
    """murmur3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_key(seed: int, it: int, micro: int = 0) -> int:
    """The key of micro-step ``micro`` of optimizer step ``it``."""
    h = mix32(mix32((seed & M32) ^ 0x243F6A88) ^ (it & M32))
    return mix32(h ^ mul32(micro & M32, GOLDEN))


def keep_mask(full_shape, rows: tuple[int, int], p: float, key: int,
              layer: int, site: int, device) -> torch.Tensor:
    """The keep mask of rows ``rows[0] .. rows[1]-1`` (dim 0) of a site of
    ``full_shape``."""
    n = math.prod(full_shape)
    if n >= 1 << 32:
        raise ValueError(f"a dropout site of {n} elements passes 2^32")
    per_row = n // full_shape[0]
    k = mix32(key ^ mul32(layer * 4 + site + 1, GOLDEN))
    idx = torch.arange(rows[0] * per_row, rows[1] * per_row,
                       dtype=torch.int64, device=device)
    bits = mix32(mul32(idx, GOLDEN) ^ k)
    shape = (rows[1] - rows[0], *full_shape[1:])
    return (bits >= round(p * 2.0 ** 32)).view(shape)
