"""Memmap token datasets and batch sampling: a copy of
``ai_music_generation_tpu/data/memmap.py``. tests/test_torch_host_copies.py
holds the file helpers to the originals, tests/test_torch_train_pieces.py
the batches, tests/test_torch_parallel_rules.py ``sharded_sample``.

- The token dtype is recorded in ``meta.pkl`` (key ``bin_dtype``), uint16
  when it is not there.
- Batches are drawn for a whole optimizer iteration at once
  ([grad_accum, micro_batch, T]).
- Sampling is a deterministic function of (seed, iter): resume-stable, and
  the same batches as the JAX package's for the same arguments.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from ai_music_generation_tpu_torch.utils import tracing


class BinDataset:
    """Random-offset sampler over a flat token bin file."""

    def __init__(self, path: str, dtype: Optional[np.dtype] = None):
        if dtype is None:
            meta = load_meta(os.path.join(os.path.dirname(path), "meta.pkl"))
            dtype = (np.dtype(meta["bin_dtype"])
                     if meta and "bin_dtype" in meta else np.uint16)
        self.path = path
        self.dtype = np.dtype(dtype)
        # the memmap is re-opened per batch, so a long run does not page
        # the whole file into resident memory
        self._len = os.path.getsize(path) // self.dtype.itemsize

    def __len__(self) -> int:
        return self._len

    def global_indices(self, seed: int, it: int, n: int,
                       block_size: int) -> np.ndarray:
        """Deterministic batch offsets for (seed, it)."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, it]))
        # high is exclusive: window starts 0..len-block-1, so that
        # y = data[i+1 : i+1+block] fits
        return rng.integers(0, self._len - block_size, size=n)

    def gather(self, ix: np.ndarray, block_size: int):
        """(x, y) int32 windows at the given flat offsets."""
        data = np.memmap(self.path, dtype=self.dtype, mode="r")
        flat = np.asarray(ix).reshape(-1)
        x = np.stack([data[i: i + block_size] for i in flat]).astype(np.int32)
        y = np.stack([data[i + 1: i + 1 + block_size]
                      for i in flat]).astype(np.int32)
        shape = (*np.shape(ix), block_size)
        return x.reshape(shape), y.reshape(shape)

    def sample(self, seed: int, it: int, batch_shape: tuple[int, ...],
               block_size: int):
        """(x, y) int32 arrays of shape [*batch_shape, block_size]."""
        n = int(np.prod(batch_shape))
        ix = self.global_indices(seed, it, n, block_size).reshape(batch_shape)
        return self.gather(ix, block_size)

    def sharded_sample(self, seed: int, it: int,
                       batch_shape: tuple[int, ...], block_size: int,
                       shard: tuple[int, int] = (0, 1)):
        """This rank's rows of :meth:`sample`'s batch: every rank draws the
        same global offset grid, then gathers only its block of the last
        batch dim, the ``shard = (index, count)``-th of ``count`` equal
        blocks (the data axis: ``(data_rank, n_data)``), so the global
        batch does not depend on the mesh (JAX ``sharded_sample``, which
        gathers the rows of its addressable devices). The draw is the span
        ``data.sample`` (``utils/tracing.py``) while a profiler records."""
        index, count = shard
        rows = batch_shape[-1]
        if rows % count:
            raise ValueError(f"{rows} rows do not split over {count} ranks")
        with tracing.span(tracing.DATA_SAMPLE):
            ix = self.global_indices(
                seed, it, int(np.prod(batch_shape)), block_size
            ).reshape(batch_shape)
            per = rows // count
            return self.gather(ix[..., index * per:(index + 1) * per],
                               block_size)


def load_meta(meta_path: str) -> Optional[dict]:
    """Load the dataset meta.pkl (vocab, stoi/itos, tokens_format,
    bin_dtype); None when there is none. The file is unpickled: load only
    meta.pkl files that this program's prepare step wrote."""
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, "rb") as f:
        return pickle.load(f)


def write_bin(tokens: np.ndarray, path: str, dtype=np.uint16) -> None:
    np.asarray(tokens, dtype=dtype).tofile(path)


def write_meta(meta: dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(meta, f)
