"""The extended fuzz campaign, the grammar fuzzer at scale: the port of
``docs/experiments/fuzz_campaign.py``.

    python -m ai_music_generation_tpu_torch.experiments.fuzz_campaign \\
        [--abc 50000] [--codec 5000]

Host only (no card, no kernel):

(a) ABC: ``--abc`` seeded random tunes over the implemented grammar
    (:func:`random_tune`) through the port's two ABC compilers, the Python
    ``abcnotation/parser.py`` and the C++ ``native/abc_compiler.cpp``
    (``abcnotation/native.py`` builds it with g++ into ``_build/`` at first
    use): their notes (pitch, start, duration, voice), meter, key and unit
    length must be equal;
(b) codec: ``--codec`` random quantized scores (:func:`_random_score`)
    through ``codec/``'s score -> text -> score round trip in each of the
    three joining/offset modes (:data:`CODEC_MODES`): the pitched notes
    (:func:`_note_set`) must come back.

Every divergence prints its case seed (a complete repro) and the tune text.
Prints one JSON line, then ``CAMPAIGN CLEAN`` or ``CAMPAIGN FAILED``, and
exits 1 on any failure.

The grammar is the port's own copy of ``tests/test_fuzz.py``'s generators
(the constants, ``_rand_note``, ``_rand_element``, ``random_tune``,
``_random_score`` and ``_note_set`` with its ``filter_allowed_parts``
rule), so the port imports nothing of the JAX package or of the tests.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from fractions import Fraction

CODEC_MODES = (("Queue parallel measures", True),
               ("Join parallel measures", True),
               ("Queue parallel measures", False))


# ----------------------------------------------------------- ABC generator

LETTERS = "CDEFGABcdefgab"
ACCIDENTALS = ["", "", "", "", "^", "_", "=", "^^", "__",
               "^^^", "^_", "=^"]  # over-long/mixed runs: regex backtracks
OCTAVES = ["", "", "", "'", ",", "''", ",,"]
LENGTHS = ["", "", "", "2", "3", "4", "/2", "/", "3/2", "//", "/4", "3/4",
           "3/", "//2"]  # stray-slash forms: length token ends at the digits
KEYS = ["C", "G", "D", "A", "E", "F", "Bb", "Eb", "Am", "Em", "Dm",
        "Ador", "Amix", "Gm", "F#m", "Hm", "B#m"]  # unknown tonics -> 0
METERS = ["4/4", "3/4", "2/4", "6/8", "C", "C|", "5/4"]
UNITS = ["1/8", "1/16", "1/4"]
DECOS = ["!trill!", "!fermata!", ".", "~", "u", "v", "H", "T"]
CHORD_SYMS = ["C", "G7", "Am", "Dm7", "F", "Bdim", "E/G#"]


def _rand_note(rng: random.Random) -> str:
    return (rng.choice(ACCIDENTALS) + rng.choice(LETTERS)
            + rng.choice(OCTAVES) + rng.choice(LENGTHS))


def _rand_element(rng: random.Random, depth: int = 0) -> str:
    r = rng.random()
    if r < 0.45:
        return _rand_note(rng)
    if r < 0.52:
        return rng.choice(["z", "z2", "z/2", "z/", "x", "Z"])
    if r < 0.60:  # chord
        k = rng.randint(2, 3)
        inner = " ".join(_rand_note(rng) for _ in range(k)).replace(" ", "")
        return f"[{inner}]" + rng.choice(["", "2", "/2"])
    if r < 0.66 and depth == 0:  # tuplet with exactly r elements following
        p = rng.choice([2, 3, 4, 6])
        forms = [f"({p}", f"({p}:{rng.randint(1, 3)}",
                 f"({p}:{rng.randint(1, 3)}:{p}"]
        head = rng.choice(forms)
        def unit():
            if rng.random() < 0.15:  # chords inside tuplets
                return ("[" + _rand_note(rng).replace(" ", "")
                        + _rand_note(rng).replace(" ", "") + "]")
            return _rand_note(rng)
        return head + "".join(unit() for _ in range(p))
    if r < 0.72:  # broken rhythm pair (sometimes onto/off a chord)
        left = (_rand_note(rng) if rng.random() < 0.8
                else "[" + _rand_note(rng) + _rand_note(rng) + "]")
        right = (_rand_note(rng) if rng.random() < 0.8
                 else "[" + _rand_note(rng) + _rand_note(rng) + "]")
        return left + rng.choice([">", "<", ">>"]) + right
    if r < 0.78:  # tie: same pitch twice
        base = rng.choice(ACCIDENTALS) + rng.choice(LETTERS)
        return f"{base}2- {base}"
    if r < 0.84:  # grace group before a principal
        g = "".join(rng.choice(LETTERS) for _ in range(rng.randint(1, 3)))
        return "{" + g + "}" + _rand_note(rng)
    if r < 0.88:
        return rng.choice(DECOS) + _rand_note(rng)
    if r < 0.92:
        return f'"{rng.choice(CHORD_SYMS)}"' + _rand_note(rng)
    if r < 0.96:  # inline field (incl. unknown/ignored and malformed ones)
        tag = rng.choice([f"[M:{rng.choice(['3/4', '4/4', '6/8'])}]",
                          f"[L:{rng.choice(UNITS)}]",
                          f"[K:{rng.choice(KEYS)}]",
                          "[r:remark eb]", "[I:linebreak]", "[M:bad]"])
        return tag + " " + _rand_note(rng)
    return "(" + _rand_note(rng) + _rand_note(rng) + ")"  # slur


def random_tune(seed: int) -> str:
    """One random tune over the implemented ABC grammar."""
    rng = random.Random(seed)
    lines = ["X:1", f"L:{rng.choice(UNITS)}", f"M:{rng.choice(METERS)}"]
    if rng.random() < 0.3:
        lines.append(rng.choice([
            f"Q:1/4={rng.randint(60, 200)}", "Q:0", "Q:90 apprx",
            f"Q:{rng.randint(60, 200)}"]))
    if rng.random() < 0.15:  # comment / directive lines are stripped
        lines.append(rng.choice(["% a comment", "%%MIDI program 0"]))
    lines.append(f"K:{rng.choice(KEYS)}")

    def body_extra() -> str:
        """Occasional mid-body field/metadata lines and malformed rests
        (both compilers must agree on all of them)."""
        roll = rng.random()
        if roll < 0.3:
            return f"K:{rng.choice(KEYS)}"
        if roll < 0.55:
            return f"M:{rng.choice(['3/4', '4/4', '6/8'])}"
        if roll < 0.75:
            return rng.choice(["T:some title", "R:reel", "N:note text"])
        return rng.choice(["Z/2 " + _rand_note(rng), "Z3/4", "Z4/2",
                           "Z3/" + rng.choice("CDE"),
                           f"Z{rng.randint(1, 2)}"])

    def measures(k: int) -> str:
        out = []
        for _ in range(k):
            n = rng.randint(1, 5)
            toks = [_rand_element(rng) for _ in range(n)]
            if rng.random() < 0.1:  # tie across the barline
                base = rng.choice(LETTERS)
                toks.append(f"{base}2-")
                out.append(" ".join(toks))
                out.append(f"{base} " + _rand_note(rng))
                continue
            out.append(" ".join(toks))
        return " | ".join(out)

    n_voices = 1 if rng.random() < 0.7 else rng.randint(2, 3)
    body = []
    for v in range(n_voices):
        if n_voices > 1:
            body.append(f"V:{v + 1}")
        shape = rng.random()
        if shape < 0.22:  # plain
            body.append(measures(rng.randint(2, 5)) + " |")
        elif shape < 0.42:  # simple repeat (sometimes [|: / ||: spelling)
            start = rng.choice(["|:", "|:", "[|:", "||:"])
            body.append(f"{start} {measures(2)} :| {measures(1)} |")
        elif shape < 0.62:  # volta endings, bracket or bar-digit spelling
            if rng.random() < 0.5:
                body.append(
                    f"|: {measures(2)} |[1 {measures(1)} :|[2 {measures(1)} |")
            else:
                body.append(
                    f"|: {measures(2)} |1 {measures(1)} :|2 {measures(1)} |")
        elif shape < 0.8:  # double repeat ::
            body.append(f"|: {measures(1)} :: {measures(1)} :| ")
        else:  # start-of-tune repeat end, no explicit |:
            body.append(f"{measures(2)} :| {measures(1)} |]")
        if rng.random() < 0.25:
            body.append(body_extra())
        if rng.random() < 0.08:
            # trailing % comment at END of a body line only — an interior
            # comment would comment out the repeat/volta closers, shrinking
            # the very structures this grammar exists to cover
            body[-1] += " % noise " + rng.choice(LETTERS)
    return "\n".join(lines + body) + "\n"


# --------------------------------------------------------- codec round trip

def _random_score(seed: int):
    from ai_music_generation_tpu_torch.codec.score import (
        Measure,
        NoteEl,
        Part,
        Score,
        TimeSig,
    )

    rng = random.Random(10_000 + seed)
    num, den = rng.choice([(4, 4), (3, 4), (6, 8), (2, 4)])
    bar_ql = Fraction(4 * num, den)
    grid = rng.choice([Fraction(1, 2), Fraction(1, 4), Fraction(1, 3)])
    n_parts = rng.randint(1, 3)
    parts = []
    for p in range(n_parts):
        measures = []
        offset = Fraction(0)
        for mi in range(rng.randint(2, 4)):
            m = Measure(offset=offset, bar_duration=bar_ql,
                        real_duration=bar_ql)
            if mi == 0:
                m.time_sig = TimeSig(num, den)
            t = Fraction(0)
            while t < bar_ql:
                steps = rng.randint(1, 4)
                ql = min(grid * steps, bar_ql - t)
                if rng.random() < 0.2:
                    m.notes.append(NoteEl(offset=t, quarter_length=ql))
                else:
                    k = 1 if rng.random() < 0.8 else 2
                    pitches = tuple(sorted(
                        {rng.randint(48, 84) for _ in range(k)}))
                    m.notes.append(NoteEl(offset=t, quarter_length=ql,
                                          pitches=pitches))
                t += ql
            measures.append(m)
            offset += bar_ql
        parts.append(Part(measures=measures, name=f"P{p}", program=0))
    return Score(parts=parts)


def _note_set(score):
    """(part, absolute offset, ql, pitches) multiset, rests dropped.

    Parts with no pitched notes are dropped BEFORE numbering — the
    converter's filter_allowed_parts does the same (ref
    quantized_converter.py:838 keeps only parts containing Note/Chord), so
    an all-rest part legitimately vanishes from the text and later parts
    shift down one index (found by the extended fuzz campaign,
    experiments/fuzz_campaign.py).

    Absolute offsets are accumulated from real_durations because
    ``text_to_score`` reconstructs measures sequentially without absolute
    offsets (parity with the reference converter)."""
    parts = [p for p in score.parts
             if any(n.pitches for m in p.measures for n in m.notes)]
    out = []
    for pi, part in enumerate(parts):
        run = Fraction(0)
        for m in part.measures:
            for n in m.notes:
                if n.pitches:
                    out.append((pi, run + n.offset, n.quarter_length,
                                tuple(sorted(n.pitches))))
            run += m.real_duration
    return sorted(out)


# --------------------------------------------------------------- campaign


def native_parser():
    """The C++ compiler's parser, built at first use; raises when it cannot
    be built (the campaign compares the two compilers)."""
    from ai_music_generation_tpu_torch.abcnotation import native

    if not native.native_available():
        raise RuntimeError(f"the native ABC compiler did not build "
                           f"({native.SOURCE})")
    return native.NativeAbcParser()


def _events(tune):
    return [(x.pitch, x.start, x.duration, x.voice) for x in tune.notes]


def run_abc(n: int) -> dict:
    """``n`` differential cases, Python parser against the C++ one."""
    from ai_music_generation_tpu_torch.abcnotation.parser import AbcParser

    py, nat = AbcParser(), native_parser()
    bad = 0
    t0 = time.perf_counter()
    for case in range(n):
        abc = random_tune(case)
        a, b = py.parse(abc), nat.parse(abc)
        if (_events(a) != _events(b) or a.meter != b.meter
                or a.sharps != b.sharps or a.unit_length != b.unit_length):
            bad += 1
            print(f"DIVERGENCE case {case}:\n{abc}\n", flush=True)
        if case and case % 10000 == 0:
            rate = case / (time.perf_counter() - t0)
            print(f"  abc {case}/{n} ({rate:.0f}/s), {bad} divergences",
                  flush=True)
    wall = time.perf_counter() - t0
    print(f"abc differential: {n} cases, {bad} divergences, {wall:.0f}s",
          flush=True)
    return dict(cases=n, divergences=bad, s=wall,
                cases_per_s=n / wall if wall else None)


def run_codec(n: int) -> dict:
    """``n`` round trips in each of :data:`CODEC_MODES`."""
    from ai_music_generation_tpu_torch.codec.encoding_settings import (
        EncodingSetting,
    )
    from ai_music_generation_tpu_torch.codec.quantized_converter import (
        MidiQuantizedConverter,
    )

    bad = 0
    t0 = time.perf_counter()
    for joining, offsets in CODEC_MODES:
        conv = MidiQuantizedConverter(EncodingSetting(
            parallel_voices_joining_method=joining,
            include_offset_in_notes=offsets,
            instruments_to_convert="All instruments",
        ))
        for case in range(n):
            score = _random_score(case)
            texts = conv.stream_to_texts(score, "fuzz")
            if not texts:
                continue
            back = conv.text_to_score(texts["fuzz"])
            if _note_set(score) != _note_set(back):
                bad += 1
                print(f"ROUND-TRIP FAIL [{joining} offsets={offsets}] "
                      f"case {case}", flush=True)
    wall = time.perf_counter() - t0
    print(f"codec round trip: {len(CODEC_MODES)}x{n} cases, {bad} failures, "
          f"{wall:.0f}s", flush=True)
    return dict(cases=len(CODEC_MODES) * n, failures=bad, s=wall,
                cases_per_s=len(CODEC_MODES) * n / wall if wall else None)


def run(abc: int = 50_000, codec: int = 5_000) -> dict:
    """Both campaigns; ``clean`` when neither found a failure."""
    a, c = run_abc(abc), run_codec(codec)
    return dict(study="fuzz_campaign", abc=a, codec=c,
                clean=a["divergences"] + c["failures"] == 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--abc", type=int, default=50_000)
    ap.add_argument("--codec", type=int, default=5_000)
    args = ap.parse_args(argv)
    result = run(args.abc, args.codec)
    print(json.dumps(result), flush=True)
    print("CAMPAIGN", "CLEAN" if result["clean"] else "FAILED", flush=True)
    return 0 if result["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
