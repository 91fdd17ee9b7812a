"""Synthetic 4-part dataset builders over codec midi-texts.

Parity with ref: scripts/music21_corpus/bach/
sample_synthetic_4_parts_from_irishman.py (resampled: pool by time
signature, melodies reusable across pieces) and
build_4part_dataset_no_resample.py (pool by (time signature, key
signature), each melody used at most once).

Mechanics (ref :37-138): melodies are the ``/0`` chunks of monophonic codec
texts; meta (clef_*/key_signature_*) is kept only in bar 0 with the
normalized ``time_signature_<tsig>``; bars joined as
``/0 ... /1 ... /2 ... /3 ... / oXX |``.

The port's copy of ``ai_music_generation_tpu/cli/build_synthetic_4parts.py``
(stdlib only).

    python -m ai_music_generation_tpu_torch.cli.build_synthetic_4parts texts/ out/
"""

from __future__ import annotations

import argparse
import pathlib
import random
import re
from typing import List, Optional, Tuple

TIME_SIG_RE = re.compile(r"time_signature_(\d+/\d+)")
KEY_SIG_RE = re.compile(r"key_signature_(-?\d+)")
BAR_SPLIT_RE = re.compile(r"\|")
OFFSET_RE = re.compile(r"/\s*(o\d+)\s*$")
MELODY_RE = re.compile(r"/0(.*?)(?=\s+/\d|\s/\s*o\d+\s*$)", re.S)
FIRST_OFFSET = re.compile(r"\bo\d+\b")


def parse_file(path: pathlib.Path) -> Tuple[str, Optional[str], str, List[str]]:
    """(time_sig, key_sig, offset_token, [/0 bar chunks]). Raises on malformed."""
    txt = path.read_text(encoding="utf-8")
    m = TIME_SIG_RE.search(txt)
    if not m:
        raise ValueError(f"{path.name}: no time-signature found")
    tsig = m.group(1)
    mk = KEY_SIG_RE.search(txt)
    ksig = mk.group(1) if mk else None
    bars = [b.strip() for b in BAR_SPLIT_RE.split(txt) if b.strip()]
    if not bars:
        raise ValueError(f"{path.name}: empty file")
    mo = OFFSET_RE.search(bars[0])
    if not mo:
        raise ValueError(f"{path.name}: no offset token in bar 1")
    offset = mo.group(1)
    melody_bars = []
    for bar in bars:
        mm = MELODY_RE.search(bar)
        if not mm:
            raise ValueError(f"{path.name}: bar lacks /0 melody")
        melody_bars.append(mm.group(0).strip())
    return tsig, ksig, offset, melody_bars


def _split_meta_and_content(bar_chunk: str) -> Tuple[str, str]:
    s = bar_chunk[2:].lstrip()  # drop '/0'
    mo = FIRST_OFFSET.search(s)
    if not mo:
        meta, content = s.strip(), ""
    else:
        meta, content = s[: mo.start()].strip(), s[mo.start():].strip()
    toks = meta.split()
    meta = " ".join(
        t for t in toks if t.startswith("clef_") or t.startswith("key_signature_")
    )
    return meta, content


def assemble_piece(parts, tsig: str, offset: str) -> str:
    """4 parsed melodies -> one 4-part codec text (ref build_one_piece)."""
    n_bars = min(len(p[3]) for p in parts)
    out_tokens = []
    for i in range(n_bars):
        chunks = []
        for voice_idx, (_, _, _, melody_bars) in enumerate(parts):
            meta, content = _split_meta_and_content(melody_bars[i])
            if i == 0:
                prefix = f"/{voice_idx} {meta} time_signature_{tsig}".replace("  ", " ")
                chunks.append(f"{prefix} {content}".strip())
            else:
                chunks.append(f"/{voice_idx} {content}".strip())
        chunks.append(f"/ {offset} |")
        out_tokens.append(" ".join(chunks))
    return " ".join(out_tokens)


def create_dataset(
    input_dir: str,
    output_dir: str,
    pieces_per_sig: int = 50,
    resample: bool = True,
    same_key_only: bool = True,
    seed: int = 0,
) -> int:
    """Build pieces; returns count written.

    resample=True : pool by time signature, melodies reusable (ref resampled)
    resample=False: pool by (tsig, ksig) when same_key_only (ref no_resample,
                    with --no_same_key pooling by tsig alone), each melody
                    used at most once.
    """
    rng = random.Random(seed)
    out = pathlib.Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    pools: dict = {}
    for path in sorted(pathlib.Path(input_dir).glob("*.txt")):
        try:
            tsig, ksig, offset, bars = parse_file(path)
        except ValueError as e:
            print(f"skip {path.name}: {e}")
            continue
        key = (tsig, ksig) if (not resample and same_key_only) else tsig
        pools.setdefault(key, []).append((tsig, ksig, offset, bars))

    piece_idx = 0
    for key, samples in sorted(pools.items(), key=lambda kv: str(kv[0])):
        tsig = key[0] if isinstance(key, tuple) else key
        if resample:
            if len(samples) < 4:
                continue
            for _ in range(pieces_per_sig):
                parts = rng.sample(samples, k=4)
                text = assemble_piece(parts, tsig, parts[0][2])
                (out / f"file_{piece_idx}.txt").write_text(text, encoding="utf-8")
                piece_idx += 1
        else:
            rng.shuffle(samples)
            while len(samples) >= 4:
                parts = [samples.pop() for _ in range(4)]
                text = assemble_piece(parts, tsig, parts[0][2])
                (out / f"file_{piece_idx}.txt").write_text(text, encoding="utf-8")
                piece_idx += 1
    print(f"wrote {piece_idx} pieces to {output_dir}")
    return piece_idx


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--pieces_per_sig", type=int, default=50)
    ap.add_argument("--no_resample", action="store_true")
    ap.add_argument("--no_same_key", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    return create_dataset(
        a.input_dir, a.output_dir, a.pieces_per_sig,
        resample=not a.no_resample, same_key_only=not a.no_same_key, seed=a.seed,
    )


if __name__ == "__main__":
    main()
