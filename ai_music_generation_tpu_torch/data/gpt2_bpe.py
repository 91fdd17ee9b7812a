"""GPT-2 byte-level BPE: clean-room encoder + asset resolution. The port's
copy of ``ai_music_generation_tpu/data/gpt2_bpe.py`` (the port imports
nothing of the JAX package; tests/test_torch_data_prep.py holds the two to
each other): the same ids, the same resolution order and error text, with
one change that alters no output: ``Gpt2Bpe`` caches merged pieces per
instance, so the cache dies with its codec.

The reference's vendored GPT-2 data path tokenizes raw text with tiktoken's
``gpt2`` encoding into uint16 bins (ref: nanoGPT/data/shakespeare/prepare.py:20-30,
nanoGPT/data/openwebtext/prepare.py:1-81). tiktoken fetches its merge table
over the network at first use; in an air-gapped deployment that fails, so
this module implements the (published, public-domain) GPT-2 byte-level BPE
algorithm from its spec and resolves the vocab/merges assets from several
sources:

1. tiktoken's ``gpt2`` encoding, when its cache/network is available —
   byte-for-byte the reference tokenizer;
2. a HuggingFace-cached ``gpt2`` tokenizer (``local_files_only``);
3. an explicit assets directory holding the OpenAI-format ``encoder.json``
   + ``vocab.bpe`` files (the pair every public GPT-2 mirror ships).

When none resolve, :func:`load_gpt2_codec` raises
:class:`Gpt2AssetsUnavailable` with instructions — the documented SKIP for
environments with no network and no local assets (this repo's CI is one;
the tests pin the ALGORITHM against fixture vocab/merges
instead, and cli/replay_goldens.py carries the real-corpus golden counts
gated on asset presence).

Algorithm notes (all public, from the GPT-2 release):
- text is pre-split by the GPT-2 regex (contractions, letter runs, digit
  runs, punctuation runs, whitespace with lookahead) — ``regex`` module,
  ``\\p{L}``/``\\p{N}`` classes;
- each piece's UTF-8 bytes map through the reversible byte→unicode table
  (printable bytes map to themselves, the rest to 256+n) so merges operate
  on visible characters;
- merges apply lowest-rank-first until no adjacent pair has a rank.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional

__all__ = [
    "Gpt2AssetsUnavailable",
    "Gpt2Bpe",
    "bytes_to_unicode",
    "load_gpt2_codec",
]


class Gpt2AssetsUnavailable(RuntimeError):
    """No GPT-2 vocab/merges source could be resolved (no network, no
    cache, no assets dir). Callers treat this as a documented SKIP."""


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte → unicode-char table. Bytes that are printable and
    not whitespace-ish keep their own codepoint; the remaining 68 bytes map
    to 256, 257, ... so every byte is a visible character and merge rules
    never have to quote whitespace."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {}
    n = 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


# GPT-2's pre-tokenization pattern (published with the model release).
_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d"
               r"| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
               r"|\s+(?!\S)|\s+")


class Gpt2Bpe:
    """Byte-level BPE codec over an OpenAI-format vocab + merge table.

    ``encoder``: token-string → id (the ``encoder.json`` mapping).
    ``merges``: ordered list of ``(left, right)`` string pairs; earlier =
    higher priority.
    """

    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]]):
        import regex

        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self.byte_unmap = {c: b for b, c in self.byte_map.items()}
        self._pat = regex.compile(_GPT2_SPLIT)
        self.n_vocab = 1 + max(encoder.values()) if encoder else 0
        # merged pieces, cached per codec (bounded as the original's)
        self._bpe = functools.lru_cache(maxsize=65536)(self._merge)

    def _merge(self, piece: str) -> tuple[str, ...]:
        parts = list(piece)
        while len(parts) > 1:
            best = None
            best_rank = None
            for pair in zip(parts[:-1], parts[1:]):
                rank = self.ranks.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best, best_rank = pair, rank
            if best is None:
                break
            merged, i = [], 0
            while i < len(parts):
                if (i + 1 < len(parts)
                        and (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return tuple(parts)

    def encode_ordinary(self, text: str) -> list[int]:
        """Encode plain text (no special-token handling — the tiktoken
        ``encode_ordinary`` contract the reference prepare scripts use,
        ref: nanoGPT/data/shakespeare/prepare.py:21-22)."""
        ids: list[int] = []
        for m in self._pat.findall(text):
            mapped = "".join(self.byte_map[b] for b in m.encode("utf-8"))
            for token in self._bpe(mapped):
                ids.append(self.encoder[token])
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        return bytes(self.byte_unmap[c] for c in text).decode(
            "utf-8", errors="replace")


def _from_openai_files(encoder_json: str, vocab_bpe: str) -> Gpt2Bpe:
    with open(encoder_json, encoding="utf-8") as f:
        encoder = json.load(f)
    with open(vocab_bpe, encoding="utf-8") as f:
        lines = f.read().split("\n")
    # first line is the "#version" header; trailing blank lines ignored
    merges = [tuple(line.split()) for line in lines[1:]
              if line and not line.startswith("#version")]
    return Gpt2Bpe(encoder, [m for m in merges if len(m) == 2])


class _TiktokenCodec:
    """Thin adapter so callers see one interface regardless of source."""

    def __init__(self, enc):
        self._enc = enc
        self.n_vocab = enc.n_vocab

    def encode_ordinary(self, text: str) -> list[int]:
        return self._enc.encode_ordinary(text)

    def decode(self, ids) -> str:
        return self._enc.decode(list(map(int, ids)))


def load_gpt2_codec(assets_dir: Optional[str] = None):
    """Resolve a GPT-2 BPE codec: tiktoken → HF cache → local assets.

    ``assets_dir`` (or env ``GPT2_BPE_DIR``) points at a directory holding
    ``encoder.json`` + ``vocab.bpe``. Raises :class:`Gpt2AssetsUnavailable`
    when nothing resolves."""
    tried = []
    assets_dir = assets_dir or os.environ.get("GPT2_BPE_DIR")
    if assets_dir:
        ej = os.path.join(assets_dir, "encoder.json")
        vb = os.path.join(assets_dir, "vocab.bpe")
        if os.path.exists(ej) and os.path.exists(vb):
            return _from_openai_files(ej, vb)
        tried.append(f"assets_dir {assets_dir!r} (missing encoder.json/vocab.bpe)")
    try:
        import tiktoken

        return _TiktokenCodec(tiktoken.get_encoding("gpt2"))
    except Exception as e:  # network/cache failure, module absent
        tried.append(f"tiktoken ({type(e).__name__})")
    try:
        from transformers import GPT2TokenizerFast

        tok = GPT2TokenizerFast.from_pretrained("gpt2", local_files_only=True)
        vocab = tok.get_vocab()
        merges = []
        # the fast tokenizer serializes its merge table in tokenizer.json
        state = json.loads(tok.backend_tokenizer.to_str())
        for m in state["model"]["merges"]:
            pair = tuple(m.split(" ") if isinstance(m, str) else m)
            if len(pair) == 2:
                merges.append(pair)
        return Gpt2Bpe(vocab, merges)
    except Exception as e:
        tried.append(f"transformers cache ({type(e).__name__})")
    raise Gpt2AssetsUnavailable(
        "GPT-2 BPE assets unavailable: tried " + "; ".join(tried)
        + ". Provide encoder.json + vocab.bpe via --bpe_assets / GPT2_BPE_DIR, "
        "or run with network access so tiktoken can fetch its table.")
