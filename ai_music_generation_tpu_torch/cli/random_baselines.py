"""Random-note lower-bound baseline generators.

Parity with ref: scripts/random_notes/{random_notes,repeated_notes,
repeated_measures,sampled_measures}.py — four known-bad ABC generators used
to calibrate the structural metrics (SURVEY.md §4):

- ``random``:   uniformly random notes/durations in random measures
- ``repeated``: ONE random note sequence repeated for every measure
- ``repeated_measures``: one real validation measure repeated 32x
- ``sampled_measures``:  32 random real validation measures

All emit 1,000 files with random M:/K: headers and ``L:1/4``
(ref random_notes.py:7-93).

The port's copy of ``ai_music_generation_tpu/cli/random_baselines.py``
(the port imports nothing of the JAX package): the four generators write
the same files byte for byte at the same seed
(tests/test_torch_corpus_pipelines.py). ``random_tunes`` is the port's
own: the corpus recipe that chip_smoke.py and the tests build their
tunes from (after docs/experiments/realpath_bench_r5.py:49-68).

    python -m ai_music_generation_tpu_torch.cli.random_baselines random out/
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re

NOTES = [
    "A", "B", "C", "D", "E", "F", "G",
    "a", "b", "c", "d", "e", "f", "g",
    "A,", "B,", "C,", "D,", "E,", "F,", "G,",
    "c'", "d'", "e'", "f'", "g'", "a'", "b'",
]
TIME_SIGNATURES = ["4/4", "3/4", "2/4", "2/2", "6/8", "7/8"]
KEY_SIGNATURES = ["C", "G", "D", "A", "F", "Bb", "Eb", "Am", "Em", "Dm"]
BAR_SPLIT = re.compile(r"(:\||::|\s\||\|\])")


def random_note_seq(rng: random.Random, n: int) -> list[str]:
    out = []
    for _ in range(n):
        note = rng.choice(NOTES)
        dur = rng.randint(1, 4)
        out.append(f"{note}{dur if dur > 1 else ''}")
    return out


def random_tunes(n: int, seed: int = 7) -> list[str]:
    """``n`` random ABC tunes of 8-24 measures of 3-6 notes, with random
    meter and key headers: the corpus recipe of
    docs/experiments/realpath_bench_r5.py:49-56 (seed 7 there)."""
    rng = random.Random(seed)
    tunes = []
    for i in range(n):
        measures = [" ".join(random_note_seq(rng, rng.randint(3, 6)))
                    for _ in range(rng.randint(8, 24))]
        tunes.append(
            f"X:{i}\nL:1/8\nM:{rng.choice(TIME_SIGNATURES)}\n"
            f"K:{rng.choice(KEY_SIGNATURES)}\n" + " | ".join(measures) + " |")
    return tunes


def abc_content(i: int, measures: list[str], time_sig: str, key_sig: str) -> str:
    body = " | ".join(measures) + " |"
    return f"X:{i}\nL:1/4\nM:{time_sig}\nK:{key_sig}\n{body}\n"


def measures_from_validation(path: str) -> list[list[str]]:
    """Real measures pool from a validation JSON ({'abc notation'} items)."""
    with open(path) as f:
        sheets = json.load(f)
    pools = []
    for sheet in sheets:
        pieces = [p.strip() for p in BAR_SPLIT.split(sheet.get("abc notation", ""))
                  if p.strip() and not BAR_SPLIT.fullmatch(p)]
        # drop header-ish pieces
        pieces = [p for p in pieces if ":" not in p[:2]]
        if pieces:
            pools.append(pieces)
    return pools


def generate(mode: str, output_dir: str, num_files: int = 1000,
             min_total_notes: int = 64, validation_json: str | None = None,
             seed: int = 0) -> int:
    rng = random.Random(seed)
    os.makedirs(output_dir, exist_ok=True)
    pools = measures_from_validation(validation_json) if validation_json else []
    n_written = 0
    for i in range(num_files):
        time_sig = rng.choice(TIME_SIGNATURES)
        key_sig = rng.choice(KEY_SIGNATURES)
        if mode == "random":
            measures, total = [], 0
            while total < min_total_notes:
                n = rng.randint(1, 4)
                measures.append(" ".join(random_note_seq(rng, n)))
                total += n
        elif mode == "repeated":
            seq = " ".join(random_note_seq(rng, rng.randint(1, 4)))
            measures = [seq] * 32
        elif mode == "repeated_measures":
            if not pools:
                raise ValueError("repeated_measures mode needs --validation_json")
            measures = [rng.choice(rng.choice(pools))] * 32
        elif mode == "sampled_measures":
            if not pools:
                raise ValueError("sampled_measures mode needs --validation_json")
            measures = [rng.choice(rng.choice(pools)) for _ in range(32)]
        else:
            raise ValueError(f"unknown mode {mode}")
        with open(os.path.join(output_dir, f"sample_{i}.abc"), "w") as f:
            f.write(abc_content(i, measures, time_sig, key_sig))
        n_written += 1
    return n_written


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["random", "repeated", "repeated_measures",
                                     "sampled_measures"])
    ap.add_argument("output_dir")
    ap.add_argument("--num_files", type=int, default=1000)
    ap.add_argument("--min_total_notes", type=int, default=64)
    ap.add_argument("--validation_json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    n = generate(a.mode, a.output_dir, a.num_files, a.min_total_notes,
                 a.validation_json, a.seed)
    print(f"wrote {n} ABC files to {a.output_dir}")
    return n


if __name__ == "__main__":
    main()
