"""Bar-patch tokenizer for ABC notation (TunesFormer's Patchilizer).

Behavior parity with ref: tunesformer/utils.py:9-82 —

- bars split on delimiters ``["|:", "::", ":|", "[|", "||", "|]", "|"]``
  with the delimiter kept attached to the END of its bar; a leading
  delimiter merges into the following bar; a trailing un-delimited fragment
  is dropped (faithful to the reference's pairwise join);
- each ABC header line (``<letter>:...`` or ``%%score...``) is its own patch
  with ``\\n`` appended; the last bar before a header also gets ``\\n``;
- a patch is ``[bos=1] + [ord(c)...] + [eos=2]`` truncated then zero-padded
  to ``patch_size`` (vocab = 128 ASCII codes; pad=0);
- optional special bos/eos patches; sequences truncate to ``patch_length``.

The port's copy of ``ai_music_generation_tpu/tokenizers/patchilizer.py``
(the port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds the two to each other). The class is pure Python (host-side
tokenization); :func:`encode_array` emits fixed-shape int32 arrays.
"""

from __future__ import annotations

import re
import unicodedata

import numpy as np

PATCH_LENGTH = 128  # ref: tunesformer/config.py:1
PATCH_SIZE = 32  # ref: tunesformer/config.py:2

DELIMITERS = ["|:", "::", ":|", "[|", "||", "|]", "|"]


def _ascii(text: str) -> str:
    """Minimal unidecode stand-in: NFKD-normalize and drop non-ASCII."""
    return unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode()


class Patchilizer:
    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self._regex = re.compile("(" + "|".join(map(re.escape, DELIMITERS)) + ")")

    def split_bars(self, body: str) -> list[str]:
        """Split a tune body into bars, delimiter attached to its bar."""
        pieces = [p for p in self._regex.split("".join(body)) if p]
        if not pieces:
            return []
        if pieces[0] in DELIMITERS:
            if len(pieces) == 1:
                return [pieces[0]]  # body IS a bare delimiter (e.g. "|")
            pieces[1] = pieces[0] + pieces[1]
            pieces = pieces[1:]
        return [pieces[2 * i] + pieces[2 * i + 1] for i in range(len(pieces) // 2)]

    def bar2patch(self, bar: str, patch_size: int = PATCH_SIZE) -> list[int]:
        patch = [self.bos_token_id] + [ord(c) for c in bar] + [self.eos_token_id]
        patch = patch[:patch_size]
        return patch + [self.pad_token_id] * (patch_size - len(patch))

    def patch2bar(self, patch) -> str:
        return "".join(
            chr(int(t)) for t in patch if int(t) > self.eos_token_id
        )

    def encode(
        self,
        abc_code: str,
        patch_length: int = PATCH_LENGTH,
        patch_size: int = PATCH_SIZE,
        add_special_patches: bool = False,
    ) -> list[list[int]]:
        lines = [ln for ln in _ascii(abc_code).split("\n") if ln]
        patches: list[list[int]] = []
        body = ""
        for line in lines:
            is_header = len(line) > 1 and (
                (line[0].isalpha() and line[1] == ":") or line.startswith("%%score")
            )
            if is_header:
                if body:
                    bars = self.split_bars(body)
                    patches.extend(
                        self.bar2patch(
                            bar + "\n" if i == len(bars) - 1 else bar, patch_size
                        )
                        for i, bar in enumerate(bars)
                    )
                    body = ""
                patches.append(self.bar2patch(line + "\n", patch_size))
            else:
                body += line + "\n"
        if body:
            patches.extend(self.bar2patch(bar, patch_size) for bar in self.split_bars(body))

        if add_special_patches:
            bos_patch = [self.bos_token_id] * (patch_size - 1) + [self.eos_token_id]
            eos_patch = [self.bos_token_id] + [self.eos_token_id] * (patch_size - 1)
            patches = [bos_patch] + patches + [eos_patch]
        return patches[:patch_length]

    def decode(self, patches) -> str:
        return "".join(self.patch2bar(p) for p in patches)

    # -- array interface -----------------------------------------------------

    def encode_array(
        self,
        abc_code: str,
        patch_length: int = PATCH_LENGTH,
        patch_size: int = PATCH_SIZE,
        add_special_patches: bool = False,
    ) -> tuple[np.ndarray, int]:
        """(int32 [patch_length, patch_size] zero-padded, n_valid_patches)."""
        patches = self.encode(abc_code, patch_length, patch_size, add_special_patches)
        arr = np.zeros((patch_length, patch_size), np.int32)
        if patches:
            arr[: len(patches)] = np.asarray(patches, np.int32)
        return arr, len(patches)
