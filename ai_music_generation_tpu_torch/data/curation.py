"""Corpus curation, the port's copy of
``ai_music_generation_tpu/data/curation.py`` (the port imports nothing of
the JAX package; tests/test_torch_host_copies.py holds the two to each
other bit for bit): IrishMAN preprocessing and TunesFormer control codes.

Covers:
- id extraction (``X:<id>`` header stripped into an ``id`` field) over the
  IrishMAN JSON splits (ref: scripts/irishman_sripts/irishman_preprocess.py:12-43)
- leadsheet-subset filtering by id list
  (ref: irishman_to_leadsheet_subset.py:11-61)
- validation -> val/test half split preserving order
  (ref: irishman_split_validation_to_val_and_test.py:6-44)
- S:/B:/E: control-code computation for TunesFormer training data
  (ref: tunesformer/data_curation.zip::add_control_codes.py): sections split
  on ``:| || |] :: |: [|`` with continuation-line merging, S = #sections
  (<=8), B = #bars per section (<=32), E = Levenshtein similarity x10 vs
  each earlier section; single-voice filter (``V:2`` reject).

Levenshtein is implemented here (the reference uses the ``jellyfish`` C
extension).
"""

from __future__ import annotations

import json
import random
import re
from typing import Optional

# one NFKD-ascii implementation shared with the serving/training tokenizer
# (curated text and patchilized text must normalize identically)
from ai_music_generation_tpu_torch.tokenizers.patchilizer import _ascii  # noqa: F401,E501


def levenshtein(a: str, b: str) -> int:
    """Classic O(len(a)*len(b)) edit distance, row-compressed."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def ld_sim(a: str, b: str) -> float:
    """1 - lev/max(len) (ref add_control_codes.py ld_sim)."""
    if not a and not b:
        return 1.0
    return 1 - levenshtein(a, b) / max(len(a), len(b))


SECTION_DELIMITERS = (":|", "||", "|]", "::", "|:", "[|")
_SECTION_RE = re.compile("(" + "|".join(map(re.escape, SECTION_DELIMITERS)) + ")")


def _is_continuation(line: str) -> Optional[bool]:
    """A section starting with a bare number is a volta continuation of the
    previous section (ref num_alph)."""
    valid = False
    for ch in line:
        if ch.isnumeric() and not valid:
            return True
        if ch.isalpha():
            return False
        if ch in ('(', '"', '!'):
            valid = True
    return None


def split_sections(text: str) -> tuple[Optional[str], Optional[list[str]]]:
    """(meta_data, merged section list) per ref split_txt."""
    lines = text.splitlines(keepends=True)
    meta_idx = 0
    meta_flag = False
    for line in lines:
        if len(line) > 1 and line[0].isalpha() and line[1] == ":":
            meta_idx += 1
            meta_flag = True
        else:
            if meta_flag:
                break
            meta_idx += 1
    meta_data = "".join(lines[:meta_idx])
    body = text[len(meta_data):]
    if not body.strip():
        # metadata-only tune (e.g. run_filter left just K:/M: lines):
        # reject instead of IndexError-ing the whole dataset build
        return None, None

    pieces = [p for p in _SECTION_RE.split(body) if p != ""]
    if len(pieces) == 1:
        # no section delimiter: close the last bar as |]
        sections = [body[::-1].replace("|", "]|", 1)[::-1]]
    else:
        if pieces[0] in SECTION_DELIMITERS:
            pieces[1] = pieces[0] + pieces[1]
            pieces = pieces[1:]
        sections = [pieces[2 * i] + pieces[2 * i + 1] for i in range(len(pieces) // 2)]

    merged: list[str] = []
    for line in sections:
        if _is_continuation(line):
            if not merged:
                return None, None
            merged[-1] += line
        else:
            merged.append(line)
    return meta_data, merged


def _strip_delims(line: str) -> str:
    for d in SECTION_DELIMITERS:
        line = line.strip(d)
        line = line.replace(d, "|")
    return line


def add_control_codes(text: str) -> tuple[str, str]:
    """(control header, cleaned tune) or ("", "") when rejected
    (ref add_tokens: S<=8 sections, B<=32 bars)."""
    meta_data, sections = split_sections(text)
    if sections is None:
        return "", ""
    if len(sections) > 8:
        return "", ""
    bars = [(_strip_delims(s)).count("|") + 1 for s in sections]
    sims = [
        [ld_sim(sections[i], sections[j]) for j in range(i)]
        for i in range(1, len(sections))
    ]
    header = f"S:{len(sections)}\n"
    for i, b in enumerate(bars):
        if i > 0:
            for s in sims[i - 1]:
                header += f"E:{round(s * 10)}\n"
        if b > 32:
            return "", ""
        header += f"B:{b}\n"
    return _ascii(header), _ascii((meta_data or "") + "".join(sections))


def is_one_voice(text: str) -> bool:
    return "V:2" not in text


# metadata prefixes dropped before control-code computation (ref run_filter,
# add_control_codes.py:121). 'G' (no colon) is the reference's literal list
# entry — it only matches a line that IS exactly "G" (line[:2] == 'G' needs
# a 1-char line), reproduced as-is.
_FILTERED_PREFIXES = ('A:', 'B:', 'C:', 'D:', 'F:', 'G', 'H:', 'N:', 'O:',
                      'R:', 'r:', 'S:', 'T:', 'V:', 'W:', 'w:', 'X:', 'Z:')


def run_filter(text: str) -> str:
    """Strip metadata/comment lines from a tune before curation (ref
    run_filter, add_control_codes.py:116-135): drops lines whose first two
    chars are a filtered field (titles, lyrics, rhythm marks, X: ids, ...),
    blank lines, and ``%`` comment lines; a trailing ``%`` comment is cut.
    Multi-voice tunes (``V:2``) return "".

    Deliberate deviation: the reference keeps everything before the LAST
    ``%`` (split/join-[:-1]), so a line with two ``%`` leaks comment text —
    including any bar/section delimiters in it — into the training data and
    deletes literal ``%`` chars. ABC comment semantics (and this repo's
    parser, abcnotation/parser.py:282) cut at the FIRST ``%``; curation does
    the same so curated text and parsed music agree."""
    if not is_one_voice(text):
        return ""
    score = ""
    for line in text.splitlines(keepends=True):
        if (line[:2] in _FILTERED_PREFIXES or line == "\n"
                or line.startswith("%")):
            continue
        if "%" in line:
            score += line.split("%", 1)[0] + "\n"
        else:
            score += line
    return score.strip()


def build_control_code_dataset(abc_texts: list[str]) -> list[dict]:
    """[{'control code', 'abc notation'}] entries for the TunesFormer trainer.

    Each tune passes through ``run_filter`` first (so titles/lyrics/X: ids
    never reach the model's training text, matching the reference's
    data.json), then ``add_control_codes``."""
    out = []
    for text in abc_texts:
        cleaned = run_filter(text)
        if not cleaned:
            continue
        header, tune = add_control_codes(cleaned)
        if header and tune:
            out.append({"control code": header, "abc notation": tune})
    return out


# -- IrishMAN preprocessing (ref: scripts/irishman_sripts/) -------------------

_X_HEADER_RE = re.compile(r"^X:\s*(\S+)\s*\n")


def strip_x_header(entries: list[dict], key: str = "abc notation") -> list[dict]:
    """Move the X:<id> first line into an 'id' field (ref irishman_preprocess)."""
    out = []
    for entry in entries:
        entry = dict(entry)
        text = entry.get(key, "")
        m = _X_HEADER_RE.match(text)
        if m:
            entry["id"] = m.group(1)
            entry[key] = text[m.end():]
        out.append(entry)
    return out


def filter_by_ids(entries: list[dict], ids: set) -> list[dict]:
    """Keep entries whose id is in the allowed set (leadsheet subset)."""
    ids = {str(i) for i in ids}
    return [e for e in entries if str(e.get("id")) in ids]


def split_validation(entries: list[dict], seed: int = 42) -> tuple[list[dict], list[dict]]:
    """Random half split preserving original order within each half
    (ref irishman_split_validation_to_val_and_test.py:6-44)."""
    idx = list(range(len(entries)))
    rng = random.Random(seed)
    chosen = set(rng.sample(idx, len(idx) // 2))
    val = [e for i, e in enumerate(entries) if i in chosen]
    test = [e for i, e in enumerate(entries) if i not in chosen]
    return val, test
