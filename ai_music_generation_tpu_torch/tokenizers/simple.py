"""Char- and whitespace-level tokenizers with reference-identical vocab logic.

- Char level (ref: nanoGPT/data/irishman/prepare_char.py, shakespeare_char):
  vocab = sorted set of characters; decode joins with "".
- Whitespace word level (ref: nanoGPT/data/irishman_whitespace/
  prepare_whitespace.py): vocab = sorted set of whitespace-split words;
  decode joins with " "; token ids may exceed uint16 so bins are uint32
  (ref dtype hack: nanoGPT/train.py:126-134 — here recorded in meta).

meta dict layout is pickle-compatible with the reference's ``meta.pkl``:
{"vocab_size", "itos", "stoi", "tokens_format"} plus our "bin_dtype".

The port's copy of ``ai_music_generation_tpu/tokenizers/simple.py`` (the
port imports nothing of the JAX package; tests/test_torch_data_prep.py
holds the two to each other).
"""

from __future__ import annotations

import numpy as np


class CharTokenizer:
    tokens_format = "char"

    def __init__(self, stoi: dict[str, int], itos: dict[int, str]):
        self.stoi = stoi
        self.itos = itos

    @classmethod
    def from_text(cls, text: str) -> "CharTokenizer":
        chars = sorted(set(text))
        stoi = {ch: i for i, ch in enumerate(chars)}
        itos = {i: ch for i, ch in enumerate(chars)}
        return cls(stoi, itos)

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)

    def encode(self, s: str) -> list[int]:
        return [self.stoi[c] for c in s]

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in ids)

    def meta(self) -> dict:
        return {
            "vocab_size": self.vocab_size,
            "itos": self.itos,
            "stoi": self.stoi,
            "tokens_format": self.tokens_format,
            "bin_dtype": "uint16" if self.vocab_size < 2**16 else "uint32",
        }

    @classmethod
    def from_meta(cls, meta: dict):
        return cls(meta["stoi"], meta["itos"])


class WhitespaceTokenizer:
    """Word-level tokenizer over whitespace-split tokens (ref: prepare_whitespace.py)."""

    tokens_format = "whitespace"

    def __init__(self, stoi: dict[str, int], itos: dict[int, str]):
        self.stoi = stoi
        self.itos = itos

    @classmethod
    def from_texts(cls, texts) -> "WhitespaceTokenizer":
        words = sorted({w for t in texts for w in t.split()})
        stoi = {w: i for i, w in enumerate(words)}
        itos = {i: w for i, w in enumerate(words)}
        return cls(stoi, itos)

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)

    def encode(self, s: str) -> list[int]:
        return [self.stoi[w] for w in s.split()]

    def decode(self, ids) -> str:
        return " ".join(self.itos[int(i)] for i in ids)

    def meta(self) -> dict:
        return {
            "vocab_size": self.vocab_size,
            "itos": self.itos,
            "stoi": self.stoi,
            "tokens_format": self.tokens_format,
            "bin_dtype": "uint16" if self.vocab_size < 2**16 else "uint32",
        }

    @classmethod
    def from_meta(cls, meta: dict):
        return cls(meta["stoi"], meta["itos"])


def tokenizer_from_meta(meta: dict):
    fmt = meta.get("tokens_format", "char")
    if fmt == "char":
        return CharTokenizer.from_meta(meta)
    return WhitespaceTokenizer.from_meta(meta)


def encode_to_bin(tokenizer, text: str, dtype=None) -> np.ndarray:
    dtype = dtype or np.dtype(tokenizer.meta()["bin_dtype"])
    return np.asarray(tokenizer.encode(text), dtype=dtype)
