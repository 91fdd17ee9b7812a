"""The reference's own draw of training batches from a flat token file:
step ``it`` of seed ``seed`` takes ``accum * rows`` window starts, uniform
over ``[0, n - block)``, from NumPy's generator on ``SeedSequence([seed,
it])``, in row-major order over [accum, rows]; x is the ``block`` tokens
at a start, y the ``block`` after it by one. This is the rule the
program's trainer states for its batches (nanoGPT's ``get_batch`` made a
function of the seed and the step), written again here."""

from __future__ import annotations

import numpy as np


def draw(path: str, dtype, seed: int, it: int, accum: int, rows: int,
         block: int) -> tuple[np.ndarray, np.ndarray]:
    data = np.memmap(path, dtype=dtype, mode="r")
    rng = np.random.default_rng(np.random.SeedSequence([seed, it]))
    starts = rng.integers(0, len(data) - block, size=accum * rows)
    offsets = starts[:, None] + np.arange(block)[None, :]
    x = data[offsets].astype(np.int64).reshape(accum, rows, block)
    y = data[offsets + 1].astype(np.int64).reshape(accum, rows, block)
    return x, y
