"""Rule-based SATB chorale-corpus synthesizer.

The reference extracts its Bach corpus from music21's bundled corpus
(ref: scripts/music21_corpus/bach/bach_ground_truth.py:9-25,
``corpus.search(composer="bach")``). music21 — and therefore the corpus —
is not available in this environment, so this module synthesizes a
*stand-in* corpus with the same structural shape: four named SATB parts in
chorale ranges (ref: voices_ranges.py:1-4), quarter-note harmonic rhythm
with eighth-note passing tones, phrase-based functional-harmony
progressions with authentic/half cadences, 4/4 and 3/4 meters, and
``bwvNNN.mid`` file naming (so the blacklist filter in
``cli/bach_pipeline.py cmd_ground_truth`` is exercised).

DELIBERATE DEVIATION: these are freshly generated chorale-style pieces,
not Bach's chorales. They exist so the full corpus pipeline
(ground-truth -> split -> midi_to_text -> prepare -> train
``bach_512_context``) is runnable and regression-testable in an
environment with no external data. When a real chorale MIDI directory is
available, pass it to ``bach_pipeline ground-truth`` instead.

Everything is deterministic given ``seed``.

The port's copy of ``ai_music_generation_tpu/data/chorales.py`` (the port
imports nothing of the JAX package), built on the port's ``codec/``: the
same seed writes the same MIDI bytes (tests/test_torch_corpus_pipelines.py).
"""

from __future__ import annotations

import os
import random
from fractions import Fraction

from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.codec.score import (
    KeySig,
    Measure,
    NoteEl,
    Part,
    Score,
    TimeSig,
    score_to_midi,
)

# SATB ranges, ref: scripts/music21_corpus/bach/voices_ranges.py:1-4
RANGES = {
    "Soprano": (60, 81),
    "Alto": (53, 74),
    "Tenor": (48, 69),
    "Bass": (36, 64),
}
VOICES = ("Soprano", "Alto", "Tenor", "Bass")

MAJOR_SCALE = (0, 2, 4, 5, 7, 9, 11)

# Functional-harmony Markov table over scale degrees (1-indexed roman
# numerals). Weights are hand-set to classical norms: pre-dominants lead to
# V, V resolves to I (or deceptively to vi), tonic moves freely.
PROGRESSION = {
    1: [(4, 3), (5, 3), (2, 2), (6, 2), (3, 1), (1, 1)],
    2: [(5, 5), (7, 1)],
    3: [(6, 3), (4, 2)],
    4: [(5, 4), (2, 2), (1, 2), (7, 1)],
    5: [(1, 5), (6, 2)],
    6: [(2, 3), (4, 3), (5, 1)],
    7: [(1, 4), (6, 1)],
}


def _triad(degree: int, tonic_pc: int) -> tuple[int, int, int]:
    """Diatonic triad pitch classes for a 1-indexed scale degree."""
    root = MAJOR_SCALE[(degree - 1) % 7]
    third = MAJOR_SCALE[(degree + 1) % 7]
    fifth = MAJOR_SCALE[(degree + 3) % 7]
    return tuple((tonic_pc + pc) % 12 for pc in (root, third, fifth))


def _nearest_in_range(pc: int, around: int, lo: int, hi: int) -> int:
    """The pitch with class ``pc`` nearest ``around`` inside [lo, hi]."""
    candidates = [p for p in range(lo, hi + 1) if p % 12 == pc]
    return min(candidates, key=lambda p: (abs(p - around), p))


def _voice_chord(
    pcs: tuple[int, int, int],
    prev: list[int],
    rng: random.Random,
) -> list[int]:
    """Voice one chord for SATB: bass takes the root, upper voices pick the
    chord tone nearest their previous note, then crossings are repaired by
    re-snapping the offender an octave away. Returns [S, A, T, B] pitches."""
    root, third, fifth = pcs
    lo_b, hi_b = RANGES["Bass"][0], RANGES["Bass"][1]
    bass = _nearest_in_range(root, prev[3], lo_b, hi_b)

    # upper voices: ensure the complete triad is covered across S/A/T by
    # assigning the three pcs in the order that minimizes total motion
    best = None
    for perm in (
        (root, third, fifth), (root, fifth, third), (third, root, fifth),
        (third, fifth, root), (fifth, root, third), (fifth, third, root),
    ):
        pitches = []
        cost = 0
        for v, pc in zip(("Soprano", "Alto", "Tenor"), perm):
            lo, hi = RANGES[v]
            p = _nearest_in_range(pc, prev[VOICES.index(v)], lo, hi)
            pitches.append(p)
            cost += abs(p - prev[VOICES.index(v)])
        s, a, t = pitches
        # penalize crossings/overlaps hard rather than forbidding outright
        if not (s >= a >= t >= bass):
            cost += 100
        if best is None or cost < best[0]:
            best = (cost, [s, a, t])
    assert best is not None
    s, a, t = best[1]
    # repair residual crossings by octave shifts where range allows
    if a > s and a - 12 >= RANGES["Alto"][0]:
        a -= 12
    if t > a and t - 12 >= RANGES["Tenor"][0]:
        t -= 12
    if bass > t and bass - 12 >= RANGES["Bass"][0]:
        bass -= 12
    return [s, a, t, bass]


def _passing_tone(a: int, b: int, tonic_pc: int) -> int | None:
    """Diatonic passing tone between two pitches a third apart."""
    lo, hi = min(a, b), max(a, b)
    if hi - lo not in (3, 4):
        return None
    for p in range(lo + 1, hi):
        if (p - tonic_pc) % 12 in MAJOR_SCALE:
            return p
    return None


def _phrase_plan(rng: random.Random) -> list[list[int]]:
    """Degrees per phrase; each phrase cadences (V-I authentic, or half
    cadence ending on V for interior phrases)."""
    n_phrases = rng.randint(3, 5)
    phrases = []
    for i in range(n_phrases):
        length = rng.randint(6, 10)  # chords before the cadence
        degrees = [1]
        while len(degrees) < length:
            options = PROGRESSION[degrees[-1]]
            total = sum(w for _, w in options)
            r = rng.uniform(0, total)
            acc = 0.0
            for deg, w in options:
                acc += w
                if r <= acc:
                    degrees.append(deg)
                    break
        last = i == n_phrases - 1
        if last:
            degrees += [2, 5, 1]  # ii-V-I authentic cadence
        elif rng.random() < 0.4:
            degrees += [4, 5]  # half cadence
        else:
            degrees += [5, 1]
        phrases.append(degrees)
    return phrases


def synthesize_chorale(seed: int) -> Score:
    """One deterministic chorale-style Score with named SATB parts."""
    rng = random.Random(seed)
    sharps = rng.randint(-3, 3)
    tonic_pc = (7 * sharps) % 12
    ts = TimeSig(*rng.choice(((4, 4), (3, 4))))
    chords_per_bar = ts.numerator  # quarter-note harmonic rhythm
    bar_ql = ts.bar_duration

    degrees = [d for phrase in _phrase_plan(rng) for d in phrase]
    # voice every chord
    prev = [72, 65, 57, 48]
    voiced: list[list[int]] = []
    for deg in degrees:
        prev = _voice_chord(_triad(deg, tonic_pc), prev, rng)
        voiced.append(prev)

    parts = [Part(name=v) for v in VOICES]
    q = Fraction(1)
    for v_idx, part in enumerate(parts):
        i = 0
        m_idx = 0
        while i < len(voiced):
            n_in_bar = min(chords_per_bar, len(voiced) - i)
            measure = Measure(
                offset=Fraction(m_idx) * bar_ql,
                time_sig=ts if m_idx == 0 else None,
                key_sig=KeySig(sharps) if m_idx == 0 else None,
                bar_duration=bar_ql,
                real_duration=bar_ql,
            )
            for c in range(n_in_bar):
                pitch = voiced[i + c][v_idx]
                off = Fraction(c)
                nxt = voiced[i + c + 1][v_idx] if i + c + 1 < len(voiced) else None
                passing = (
                    _passing_tone(pitch, nxt, tonic_pc)
                    if (nxt is not None and v_idx > 0 and rng.random() < 0.25)
                    else None
                )
                if passing is not None:
                    half = q / 2
                    measure.notes.append(
                        NoteEl(offset=off, quarter_length=half, pitches=(pitch,))
                    )
                    measure.notes.append(
                        NoteEl(offset=off + half, quarter_length=half,
                               pitches=(passing,))
                    )
                else:
                    measure.notes.append(
                        NoteEl(offset=off, quarter_length=q, pitches=(pitch,))
                    )
            # pad the final partial measure with a held last chord so every
            # measure spans its nominal duration (chorale final fermata)
            if n_in_bar < chords_per_bar:
                held = bar_ql - Fraction(n_in_bar)
                measure.notes.append(
                    NoteEl(offset=Fraction(n_in_bar), quarter_length=held,
                           pitches=(voiced[-1][v_idx],))
                )
            part.measures.append(measure)
            i += n_in_bar
            m_idx += 1
    return Score(parts)


# music21 Bach chorales excluded by the reference (ref: chorals_to_omit.py
# :1-26) — the single source of truth; cli/bach_pipeline.py imports this
CHORALS_TO_OMIT = [
    "bwv277", "bwv324", "bwv325", "bwv326", "bwv327", "bwv328", "bwv329",
    "bwv330", "bwv331", "bwv332", "bwv333", "bwv334", "bwv335", "bwv336",
    "bwv337", "bwv338", "bwv339", "bwv340", "bwv341", "bwv342", "bwv343",
    "bwv344", "bwv345", "bwv346", "bwv347",
]


def synthesize_corpus(
    out_dir: str, num_pieces: int = 100, seed: int = 0,
    include_blacklisted: int = 3,
) -> list[str]:
    """Write ``num_pieces`` chorales as ``bwvNNN.mid`` into ``out_dir``.

    ``include_blacklisted`` extra pieces are named after blacklisted BWV
    numbers (ref: chorals_to_omit.py:1-26) so the ground-truth filter has
    something to reject."""
    os.makedirs(out_dir, exist_ok=True)
    blacklisted = CHORALS_TO_OMIT[:include_blacklisted]
    # the running numbers SKIP every CHORALS_TO_OMIT name (not only the
    # emitted blacklisted ones) so exactly num_pieces chorales survive the
    # ground-truth filter — any collision with the 25-name blacklist used
    # to shrink the clean corpus silently (review finding; the round-2 E2E
    # demo's 340 -> 315 was this)
    names: list[str] = []
    n = 250
    while len(names) < num_pieces:
        cand = f"bwv{n:03d}"
        if cand not in CHORALS_TO_OMIT:
            names.append(cand)
        n += 1
    names += blacklisted
    written = []
    for i, name in enumerate(names):
        score = synthesize_chorale(seed * 100_003 + i)
        midi = score_to_midi(score)
        path = os.path.join(out_dir, f"{name}.mid")
        midi_io.write_midi_file(midi, path)
        written.append(path)
    return written
