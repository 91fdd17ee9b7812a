"""Bach chorale corpus pipeline CLI (ref: scripts/music21_corpus/bach/).

Subcommands:
- ``ground-truth``      collect chorale MIDIs minus the blacklist
                        (ref bach_ground_truth.py + chorals_to_omit.py;
                        the music21 corpus is unavailable — pass any
                        directory of chorale ``.mid`` files as the source)
- ``split``             90/10 shuffled train/validation copy, seed 42
                        (ref split_dataset.py:6-52)
- ``score-templates``   per-time-signature measure-length templates + counts
                        (ref score_templates.py:14-74)
- ``measure-templates`` chord/progression mining: >=3 simultaneous onsets =
                        chord, else passing tones; measure templates and
                        chord-progression chains (ref measure_templates.py)
- ``generate``          template-driven Markov chorale sampling — the
                        reference's generate_bach.py is unrunnable (syntax
                        error + write-mode reads, SURVEY.md §2.4); this is a
                        working implementation of its design intent
- ``synthesize-corpus`` rule-based SATB stand-in corpus (data/chorales.py)
                        for environments without the music21 Bach corpus;
                        feeds ``ground-truth`` and the rest of the pipeline

The port's copy of ``ai_music_generation_tpu/cli/bach_pipeline.py`` over
the port's ``codec/`` and ``data/chorales.py``: every subcommand writes
the same files (tests/test_torch_corpus_pipelines.py).

    python -m ai_music_generation_tpu_torch.cli.bach_pipeline synthesize-corpus --out_dir=raw
    python -m ai_music_generation_tpu_torch.cli.bach_pipeline ground-truth raw --out_dir=gt
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
from collections import Counter, defaultdict
from fractions import Fraction
from pathlib import Path

from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.codec.score import score_from_midi

# ref: chorals_to_omit.py:1-26 (corrupted/duplicate chorales)
from ai_music_generation_tpu_torch.data.chorales import (  # single source (ref
    CHORALS_TO_OMIT,  # chorals_to_omit.py:1-26); synthesize_corpus skips
)  # these so num_pieces clean chorales survive ground-truth

# ref: voices_ranges.py:1-4 (SATB midi pitch ranges) — single source of
# truth lives in data/chorales.py
from ai_music_generation_tpu_torch.data.chorales import RANGES as VOICES_RANGES


def cmd_ground_truth(a):
    os.makedirs(a.out_dir, exist_ok=True)
    n = 0
    for path in sorted(Path(a.source_dir).glob("*.mid")):
        stem = path.stem.lower()
        if not stem.startswith("bwv"):
            continue
        if any(stem.startswith(x) for x in CHORALS_TO_OMIT):
            continue
        shutil.copy(path, os.path.join(a.out_dir, path.name))
        n += 1
    print(f"collected {n} chorales -> {a.out_dir}")


def cmd_split(a):
    files = sorted(Path(a.input_dir).glob("*.mid"))
    rng = random.Random(a.seed)
    rng.shuffle(files)
    split = int(len(files) * (1 - a.val_ratio))
    for sub, chunk in (("train", files[:split]), ("validation", files[split:])):
        d = os.path.join(a.out_dir, sub)
        os.makedirs(d, exist_ok=True)
        for f in chunk:
            shutil.copy(f, os.path.join(d, f.name))
    print(f"split {len(files)} -> train {split} / validation {len(files) - split}")


def _measure_lengths(midi_path) -> tuple[str, list[float]]:
    midi = midi_io.parse_midi_file(midi_path)
    score = score_from_midi(midi)
    if not score.parts:
        return "4/4", []
    part = score.parts[0]
    ts = "4/4"
    lengths = []
    for m in part.measures:
        if m.time_sig is not None:
            ts = f"{m.time_sig.numerator}/{m.time_sig.denominator}"
        lengths.append(float(m.real_duration))
    return ts, lengths


def cmd_score_templates(a):
    os.makedirs(a.out_dir, exist_ok=True)
    templates: dict[str, list] = defaultdict(list)
    length_counts: Counter = Counter()
    measure_counts: Counter = Counter()
    for path in sorted(Path(a.input_dir).glob("*.mid")):
        try:
            ts, lengths = _measure_lengths(path)
        except Exception as e:
            print(f"skip {path.name}: {e}")
            continue
        templates[ts].append(lengths)
        length_counts.update(str(x) for x in lengths)
        measure_counts[len(lengths)] += 1
    with open(os.path.join(a.out_dir, "score_templates.json"), "w") as f:
        json.dump(templates, f)
    with open(os.path.join(a.out_dir, "measure_length_counts.json"), "w") as f:
        json.dump(dict(length_counts), f)
    with open(os.path.join(a.out_dir, "measure_counts.json"), "w") as f:
        json.dump({str(k): v for k, v in measure_counts.items()}, f)
    print(f"templates for {len(templates)} time signatures -> {a.out_dir}")


def _mine_chords(midi_path):
    """Per-measure chord stacks: onsets sounding in >=3 parts are chords
    (ref measure_templates.py:49-141)."""
    midi = midi_io.parse_midi_file(midi_path)
    score = score_from_midi(midi)
    by_measure: dict[int, dict[Fraction, list[int]]] = defaultdict(lambda: defaultdict(list))
    for part in score.parts:
        for m_idx, measure in enumerate(part.measures):
            for n in measure.notes:
                if n.is_rest:
                    continue
                by_measure[m_idx][n.offset].extend(n.pitches)
    measures = []
    n_passing = 0
    for m_idx in sorted(by_measure):
        chords = []
        for off in sorted(by_measure[m_idx]):
            pitches = sorted(by_measure[m_idx][off])
            if len(pitches) >= 3:
                chords.append({"offset": str(off), "pitches": pitches})
            else:
                n_passing += len(pitches)
        measures.append(chords)
    return measures, n_passing


def cmd_measure_templates(a):
    os.makedirs(a.out_dir, exist_ok=True)
    notes_counts = {"chord_notes": 0, "passing_notes": 0}
    bach_measures = []
    progressions: Counter = Counter()
    for path in sorted(Path(a.input_dir).glob("*.mid")):
        try:
            measures, n_passing = _mine_chords(path)
        except Exception as e:
            print(f"skip {path.name}: {e}")
            continue
        notes_counts["passing_notes"] += n_passing
        flat_chords = []
        for chords in measures:
            bach_measures.append([len(c["pitches"]) for c in chords])
            for c in chords:
                notes_counts["chord_notes"] += len(c["pitches"])
                flat_chords.append(tuple(p % 12 for p in c["pitches"]))
        for prev, nxt in zip(flat_chords, flat_chords[1:]):
            progressions[(str(sorted(set(prev))), str(sorted(set(nxt))))] += 1
    with open(os.path.join(a.out_dir, "notes_counts.json"), "w") as f:
        json.dump(notes_counts, f)
    with open(os.path.join(a.out_dir, "bach_measures.json"), "w") as f:
        json.dump(bach_measures, f)
    with open(os.path.join(a.out_dir, "bach_progression.json"), "w") as f:
        json.dump([[a_, b_, c_] for (a_, b_), c_ in progressions.items()], f)
    print(f"mined {len(bach_measures)} measures -> {a.out_dir}")


def cmd_generate(a):
    """Working Markov chorale generator from mined stats."""
    with open(os.path.join(a.stats_dir, "score_templates.json")) as f:
        templates = json.load(f)
    with open(os.path.join(a.stats_dir, "bach_progression.json")) as f:
        progression_rows = json.load(f)

    rng = random.Random(a.seed)
    rules: dict[str, list] = defaultdict(list)
    for prev, nxt, count in progression_rows:
        rules[prev].append((nxt, count))

    def sample_next(prev_key):
        options = rules.get(prev_key)
        if not options:  # mod-12 fallback: any known chord
            options = [(k, 1) for k in rules.keys()]
        total = sum(c for _, c in options)
        r = rng.uniform(0, total)
        acc = 0
        for nxt, c in options:
            acc += c
            if r <= acc:
                return nxt
        return options[-1][0]

    os.makedirs(a.out_dir, exist_ok=True)
    from ai_music_generation_tpu_torch.codec.score import (
        KeySig, Measure, NoteEl, Part, Score, TimeSig,
    )
    from ai_music_generation_tpu_torch.codec.score import score_to_midi

    for i in range(a.num_pieces):
        ts_name = rng.choice(list(templates.keys()))
        template = rng.choice(templates[ts_name])
        num, den = (int(x) for x in ts_name.split("/"))
        ts = TimeSig(num, den)
        chord_key = rng.choice(list(rules.keys())) if rules else "[0, 4, 7]"
        satb_parts = [Part(name=n) for n in ("Soprano", "Alto", "Tenor", "Bass")]
        bases = (72, 65, 57, 48)
        for m_idx, m_len in enumerate(template[: a.max_measures]):
            chords_in_measure = max(1, int(float(m_len)))
            # sample the measure's chord SEQUENCE once so all four voices
            # sound the same chord at each slot
            measure_chords = []
            for _ in range(chords_in_measure):
                measure_chords.append(chord_key)
                chord_key = sample_next(chord_key)
            for p_idx, part in enumerate(satb_parts):
                measure = Measure(
                    time_sig=ts if m_idx == 0 else None,
                    key_sig=KeySig(0) if m_idx == 0 else None,
                    bar_duration=ts.bar_duration,
                    real_duration=ts.bar_duration,
                )
                step = ts.bar_duration / chords_in_measure
                for c_idx, ck in enumerate(measure_chords):
                    pcs = json.loads(ck)
                    pc = pcs[p_idx % len(pcs)]
                    base = bases[p_idx]
                    pitch = base + ((pc - base) % 12)
                    # keep the voice inside its declared SATB range (the
                    # octave placement above base can exceed the ceiling)
                    hi = VOICES_RANGES[
                        ("Soprano", "Alto", "Tenor", "Bass")[p_idx]][1]
                    if pitch > hi:
                        pitch -= 12
                    measure.notes.append(
                        NoteEl(offset=step * c_idx, quarter_length=step, pitches=(pitch,))
                    )
                part.measures.append(measure)
        score = Score(satb_parts)
        midi = score_to_midi(score)
        midi_io.write_midi_file(midi, os.path.join(a.out_dir, f"generated_{i}.mid"))
    print(f"generated {a.num_pieces} chorales -> {a.out_dir}")


def cmd_synthesize_corpus(a):
    from ai_music_generation_tpu_torch.data.chorales import synthesize_corpus

    written = synthesize_corpus(
        a.out_dir, num_pieces=a.num_pieces, seed=a.seed,
        include_blacklisted=a.include_blacklisted,
    )
    print(f"synthesized {len(written)} chorales -> {a.out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ground-truth")
    p.add_argument("source_dir")
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_ground_truth)

    p = sub.add_parser("split")
    p.add_argument("input_dir")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--val_ratio", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_split)

    p = sub.add_parser("score-templates")
    p.add_argument("input_dir")
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_score_templates)

    p = sub.add_parser("measure-templates")
    p.add_argument("input_dir")
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_measure_templates)

    p = sub.add_parser("generate")
    p.add_argument("stats_dir")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_pieces", type=int, default=10)
    p.add_argument("--max_measures", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("synthesize-corpus")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_pieces", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--include_blacklisted", type=int, default=3)
    p.set_defaults(fn=cmd_synthesize_corpus)

    a = ap.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    main()
