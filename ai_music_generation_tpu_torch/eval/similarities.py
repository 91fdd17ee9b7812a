"""Structural similarity functions.

The port's copy of ``ai_music_generation_tpu/eval/similarities.py`` (the
port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds the two to each other).

Scalar API parity with ref: core/metrics/similarities.py:5-67 —

- :func:`cyclic_pitch_similarity`: max over the 12 cyclic shifts of the mean
  per-bin Dice coefficient between two 12-dim pitch-class duration
  distributions (term = 1 when both bins are 0).
- :func:`rhythmic_similarity`: Dice coefficient over offset multisets
  (1.0 when both empty).

Vectorized batch builders (no reference equivalent — the reference computes
the O(N^2 * 12) matrices in pure-Python loops, SURVEY.md §3.4 "HOT (CPU)"):

- :func:`cyclic_pitch_similarity_matrix`: all-pairs matrix via a single
  broadcasted [N, M, 12shifts, 12bins] computation.
- :func:`rhythmic_similarity_matrix`: all-pairs Dice over offset histograms.

These run in numpy by default; ``xp`` takes another array module with
numpy's API (the math is identical).
"""

from __future__ import annotations

from collections import Counter
from fractions import Fraction
from typing import Sequence, Union

import numpy as np


def cyclic_pitch_similarity(v1: Sequence[float], v2: Sequence[float]) -> float:
    if len(v1) != 12 or len(v2) != 12:
        raise ValueError("Both vectors must be length 12")
    m = cyclic_pitch_similarity_matrix(
        np.asarray(v1, np.float64)[None, :], np.asarray(v2, np.float64)[None, :]
    )
    return float(m[0, 0])


def rhythmic_similarity(
    v1: Sequence[Union[float, Fraction]], v2: Sequence[Union[float, Fraction]]
) -> float:
    c1, c2 = Counter(v1), Counter(v2)
    shared = sum(min(c1[x], c2[x]) for x in c1.keys() & c2.keys())
    denom = len(v1) + len(v2)
    if denom == 0:
        return 1.0
    return 2 * shared / denom


# ---------------------------------------------------------------------------
# vectorized builders


def cyclic_pitch_similarity_matrix(a, b, xp=np):
    """All-pairs cyclic pitch similarity.

    a: [N, 12], b: [M, 12] -> [N, M] floats, where entry (i, j) equals
    ``cyclic_pitch_similarity(a[i], b[j])`` exactly.
    """
    a = xp.asarray(a, xp.float64 if xp is np else None)
    b = xp.asarray(b, xp.float64 if xp is np else None)
    # all 12 rotations of b: [M, 12shifts, 12bins]
    idx = (xp.arange(12)[:, None] + xp.arange(12)[None, :]) % 12
    b_rot = b[:, idx]  # [M, 12, 12]
    x = a[:, None, None, :]  # [N, 1, 1, 12]
    y = b_rot[None, :, :, :]  # [1, M, 12, 12]
    both_zero = (x == 0) & (y == 0)
    denom = x + y
    term = xp.where(both_zero, 1.0, 2 * xp.minimum(x, y) / xp.where(denom == 0, 1.0, denom))
    sims = term.mean(axis=-1)  # [N, M, 12]
    best = sims.max(axis=-1)  # [N, M]
    # reference returns max(sim, 0.0) implicitly via best_sim init 0.0
    return xp.maximum(best, 0.0)


def offsets_to_histogram(offsets: Sequence[Union[float, Fraction]], grid: int = 12,
                         max_quarters: int = 16) -> np.ndarray:
    """Multiset of offsets -> integer histogram on a 1/grid-quarter lattice.

    Offsets off the lattice get their own overflow bin per distinct value
    rounded to the lattice — adequate because codec offsets are already
    grid-quantized.
    """
    hist = np.zeros(grid * max_quarters + 1, np.int32)
    for off in offsets:
        i = int(round(float(off) * grid))
        i = min(max(i, 0), len(hist) - 1)
        hist[i] += 1
    return hist


def rhythmic_similarity_matrix(h1, h2, xp=np):
    """All-pairs Dice over offset histograms.

    h1: [N, B] int counts, h2: [M, B] -> [N, M]; entry (i, j) equals
    ``rhythmic_similarity`` of the underlying multisets when both were built
    on the same lattice.
    """
    h1 = xp.asarray(h1)
    h2 = xp.asarray(h2)
    shared = xp.minimum(h1[:, None, :], h2[None, :, :]).sum(-1)
    denom = h1.sum(-1)[:, None] + h2.sum(-1)[None, :]
    return xp.where(denom == 0, 1.0, 2 * shared / xp.where(denom == 0, 1, denom))
