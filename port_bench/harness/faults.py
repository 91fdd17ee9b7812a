"""Faults planted under the timed path, to see the check fail: each a
context manager that patches the port while it is open. The benchmark's
runs never open one; the tests and ``calibrate.py`` do.

- ``token_altered`` (decode): every 50th step's committed token is moved
  one id up, where the sampler produces it.
- ``state_unchanged`` (decode): the decode step leaves its cache as it
  found it (the fresh K/V column and its scales are put back).
- ``state_unchanged`` (train): the optimizer step changes nothing.
- ``half_batch`` (train): each micro-batch's first half of the rows alone
  reaches the step, whose means are then over those rows.
"""

from __future__ import annotations

import contextlib
import itertools


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def token_altered(vocab_size: int):
    from ai_music_generation_tpu_torch.decode import generate

    counter = itertools.count()

    def make(sample_logits):
        def altered(logits, *args, **kwargs):
            tok = sample_logits(logits, *args, **kwargs)
            if next(counter) % 50 == 0:
                tok = (tok + 1) % vocab_size
            return tok
        return altered

    return _patched(generate, "sample_logits", make)


def decode_state_unchanged():
    from ai_music_generation_tpu_torch.models import gpt

    def make(update):
        def unchanged(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                      pos):
            col = int(pos)
            kept = [t[:, col].clone() for t in (k, v)]
            scales = [None if t is None else t[..., col].clone()
                      for t in (k_scale, v_scale)]
            out = update(q, k, v, k_slab, v_slab, k_scale, v_scale, mask_rel,
                         pos)
            k[:, col], v[:, col] = kept
            for t, s in zip((k_scale, v_scale), scales):
                if t is not None:
                    t[..., col] = s
            return out
        return unchanged

    return _patched(gpt, "gqa_decode_update", make)


def train_state_unchanged():
    from ai_music_generation_tpu_torch.train import optimizer

    def make(make_optimizer):
        def frozen(*args, **kwargs):
            opt = make_optimizer(*args, **kwargs)
            opt.step = lambda closure=None: None
            return opt
        return frozen

    return _patched(optimizer, "make_optimizer", make)


def half_batch():
    from ai_music_generation_tpu_torch.train import step

    def make(make_train_step):
        def halved(*args, **kwargs):
            inner = make_train_step(*args, **kwargs)

            def train_step(x, y, it, seed=0):
                half = x.shape[1] // 2
                return inner(x[:, :half], y[:, :half], it, seed)
            return train_step
        return halved

    return _patched(step, "make_train_step", make)


def plant(name: str, config: dict):
    """The fault ``name``, for a cell of configuration ``config``."""
    return {
        "token_altered": lambda: token_altered(config["model"]["vocab_size"]),
        "decode_state_unchanged": decode_state_unchanged,
        "train_state_unchanged": train_state_unchanged,
        "half_batch": half_batch,
    }[name]()


FAULTS = {"decode": ("token_altered", "decode_state_unchanged"),
          "train": ("train_state_unchanged", "half_batch")}

