"""ABC notation parser and note-event compiler.

The port's copy of ``ai_music_generation_tpu/abcnotation/parser.py`` (the
port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds the two to each other).

Replaces the external ``abc2midi`` C binary the reference shells out to
(ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:118,
scripts/irishman_sripts/irishman_dataset_to_midi.py:55) with an in-repo
compiler targeting the ABC subset exercised by the IrishMAN corpus and the
random-note baseline generators (scripts/random_notes/*):

headers (X T M L K Q R etc.), notes with accidentals/octave marks/duration
fractions, rests (z Z x), bars and repeats (|: :| :: |] [1 [2), ties, chords
``[CEG]``, tuplets ``(3`` / ``(p:q:r``, broken rhythm ``> <``, inline fields
``[M:6/8]``, multi-voice ``V:``, key modes (maj/min/mix/dor/phr/lyd/loc) with
per-measure accidental propagation, default-note-length-from-meter rule.

Grace notes ``{...}`` are played abc2midi-style: the group steals the first
1/4 of the following note's (or chord's) span, split equally, with the
principal scaled to 3/4 (clean-room fixed-fraction analogue of abc2midi's
gracedivider; exact fractions so the differential stays bit-identical).
Chord symbols ``"G7"`` are always parsed into ``AbcTune.chord_symbols``;
with ``AbcParser(gchord=True)`` they additionally render an abc2midi-style
accompaniment (meter-derived ``fzcz`` patterns, fundamental at octave 2,
chord tones at octave 3) on a dedicated voice (``AbcTune.accomp_voice``),
mirroring abc2midi's gchord engine
(ref: abc_to_midi_wav_and_aesthetics.py:118 renders leadsheet corpora whose
chords drive the audible accompaniment).

Deliberately skipped (no melodic effect; noted for parity review):
decorations (``!trill!``, ``+trill+``, single-char shorthands — consumed and
ignored), slurs, lyrics.

Output: per-voice note events in quarter-length ``Fraction`` time, plus
tempo/meter/key metadata — directly convertible to MIDI (``to_midi``) or to
the synth event tensors.

A C++ implementation of the same grammar lives in ``native/abc_compiler.cpp``
(differentially tested against this module); this Python version is the
semantic reference and fallback.
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction
from typing import Optional

QL = Fraction

# circle of fifths: number of sharps for major keys
_MAJOR_SHARPS = {
    "C": 0, "G": 1, "D": 2, "A": 3, "E": 4, "B": 5, "F#": 6, "C#": 7,
    "F": -1, "Bb": -2, "Eb": -3, "Ab": -4, "Db": -5, "Gb": -6, "Cb": -7,
}
# mode offsets in fifths relative to major (ionian)
_MODE_OFFSET = {
    "": 0, "maj": 0, "major": 0, "ion": 0, "ionian": 0,
    "min": -3, "minor": -3, "m": -3, "aeo": -3, "aeolian": -3,
    "mix": -1, "mixolydian": -1,
    "dor": -2, "dorian": -2,
    "phr": -4, "phrygian": -4,
    "lyd": 1, "lydian": 1,
    "loc": -5, "locrian": -5,
}
_SHARP_ORDER = ["F", "C", "G", "D", "A", "E", "B"]
_LETTER_SEMITONE = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def key_signature_sharps(key: str) -> int:
    """Sharps count for an ABC K: field value (tonic + optional mode)."""
    key = key.strip()
    if not key or key.lower() == "none":
        return 0
    m = re.match(r"^([A-Ga-g])([#b]?)\s*([A-Za-z]*)", key)
    if not m:
        return 0
    tonic = m.group(1).upper() + m.group(2)
    mode_raw = m.group(3).lower()
    mode = ""
    for known in sorted((k for k in _MODE_OFFSET if k), key=len, reverse=True):
        if mode_raw.startswith(known):
            mode = known
            break
    base = _MAJOR_SHARPS.get(tonic)
    if base is None:
        return 0
    return base + _MODE_OFFSET[mode] if mode else base


def sharps_to_accidentals(sharps: int) -> dict[str, int]:
    """{'F': +1, ...} letter -> semitone alteration for a key signature."""
    acc: dict[str, int] = {}
    if sharps > 0:
        for letter in _SHARP_ORDER[:sharps]:
            acc[letter] = 1
    elif sharps < 0:
        for letter in reversed(_SHARP_ORDER[len(_SHARP_ORDER) + sharps:]):
            acc[letter] = -1
    return acc


# gchord chord-type table (abc2midi's built-in chord names, semitone
# intervals above the root). Unknown types fall back to a major triad, as
# abc2midi does (with a warning) for unrecognized chord names.
_CHORD_TYPES: dict[str, tuple[int, ...]] = {
    "": (0, 4, 7), "maj": (0, 4, 7), "M": (0, 4, 7),
    "6": (0, 4, 7, 9), "m6": (0, 3, 7, 9),
    "7": (0, 4, 7, 10), "maj7": (0, 4, 7, 11), "M7": (0, 4, 7, 11),
    "9": (0, 4, 7, 10, 14), "maj9": (0, 4, 7, 11, 14), "M9": (0, 4, 7, 11, 14),
    "11": (0, 4, 7, 10, 14, 17),
    "m": (0, 3, 7), "min": (0, 3, 7), "-": (0, 3, 7),
    "m7": (0, 3, 7, 10), "min7": (0, 3, 7, 10), "-7": (0, 3, 7, 10),
    "m9": (0, 3, 7, 10, 14),
    "dim": (0, 3, 6), "dim7": (0, 3, 6, 9), "m7b5": (0, 3, 6, 10),
    "aug": (0, 4, 8), "+": (0, 4, 8), "aug7": (0, 4, 8, 10), "+7": (0, 4, 8, 10),
    "sus": (0, 5, 7), "sus4": (0, 5, 7), "sus2": (0, 2, 7),
    "7sus4": (0, 5, 7, 10), "7sus2": (0, 2, 7, 10),
}
_CHORD_SYMBOL_RE = re.compile(
    r"^([A-G])([#b]?)([A-Za-z0-9+\-]*)(?:/([A-G])([#b]?))?$"
)
_ACCIDENTAL_PC = {"": 0, "#": 1, "b": -1}

GRACE_NUM, GRACE_DEN = 1, 4  # graces steal the first 1/4 of the principal
FUNDAMENTAL_BASE = 36  # gchord 'f' octave (C2)
CHORD_BASE = 48  # gchord 'c' octave (C3)
GCHORD_SLOT = Fraction(1, 2)  # one pattern char = one eighth note


def parse_chord_symbol(sym: str) -> Optional[tuple[int, tuple[int, ...], Optional[int]]]:
    """``"G7"`` / ``"Dm/F#"`` -> (root_pc, intervals, bass_pc) or None for
    non-chord annotations (``"Intro"``, ``"^text"``, ...)."""
    m = _CHORD_SYMBOL_RE.match(sym.strip())
    if not m:
        return None
    root_pc = (_LETTER_SEMITONE[m.group(1)] + _ACCIDENTAL_PC[m.group(2)]) % 12
    intervals = _CHORD_TYPES.get(m.group(3), _CHORD_TYPES[""])
    bass_pc = None
    if m.group(4):
        bass_pc = (_LETTER_SEMITONE[m.group(4)] + _ACCIDENTAL_PC[m.group(5) or ""]) % 12
    return root_pc, intervals, bass_pc


def gchord_pattern(meter: tuple[int, int]) -> str:
    """abc2midi's meter-derived default accompaniment patterns: one char per
    eighth note; f=fundamental c=chord z=rest b=both."""
    num, den = meter
    eighths = Fraction(8 * num, den)
    if eighths.denominator != 1:
        return ""
    slots = int(eighths)
    if den == 8 and num % 3 == 0:
        return "fzc" * (num // 3)
    if (num, den) == (3, 4):
        return "fzczcz"
    if slots % 4 == 0:
        return "fzcz" * (slots // 4)
    if slots % 2 == 0:
        return "fz" * (slots // 2)
    return ""


@dataclasses.dataclass
class AbcNote:
    pitch: int  # MIDI number; -1 for rest
    start: QL  # quarter lengths from tune start
    duration: QL
    voice: int = 0

    @property
    def is_rest(self) -> bool:
        return self.pitch < 0


@dataclasses.dataclass
class AbcTune:
    reference: str = ""  # X: field
    title: str = ""
    meter: tuple[int, int] = (4, 4)
    unit_length: QL = Fraction(1, 8)  # L: as fraction of whole note
    tempo_bpm: float = 120.0  # quarter-note bpm
    key: str = "C"
    sharps: int = 0
    notes: list[AbcNote] = dataclasses.field(default_factory=list)
    n_voices: int = 1
    # chord symbols as (time_ql, text), repeat-expanded; always collected
    chord_symbols: list[tuple[QL, str]] = dataclasses.field(default_factory=list)
    # voice index of generated gchord accompaniment (None unless gchord=True)
    accomp_voice: Optional[int] = None

    def duration(self) -> QL:
        if not self.notes:
            return Fraction(0)
        return max(n.start + n.duration for n in self.notes)


_NOTE_RE = re.compile(
    r"(?P<acc>\^{1,2}|_{1,2}|=)?"
    r"(?P<letter>[A-Ga-g])"
    r"(?P<oct>[,']*)"
    r"(?P<len>\d+/\d+|/\d+|\d+|/+)?"
)
_REST_RE = re.compile(r"(?P<kind>[zZxX])(?P<len>\d+/\d+|/\d+|\d+|/+)?")
_TUPLET_RE = re.compile(r"\((?P<p>[2-9])(?::(?P<q>\d*))?(?::(?P<r>\d*))?")
_INLINE_FIELD_RE = re.compile(r"\[(?P<tag>[A-Za-z]):(?P<val>[^\]]*)\]")
_VOLTA_RE = re.compile(r"\[(?P<num>[0-9])")


def _parse_len(token: Optional[str]) -> Fraction:
    if not token:
        return Fraction(1)
    if set(token) == {"/"}:
        # capped at 30 to match the C++ compiler (1<<n UB past 62 there);
        # sub-sample durations either way
        return Fraction(1, 2 ** min(len(token), 30))
    if token.startswith("/"):
        return Fraction(1, int(token[1:]))
    if "/" in token:
        num, den = token.split("/")
        return Fraction(int(num), int(den))
    return Fraction(int(token))


def _parse_meter(value: str) -> tuple[int, int]:
    value = value.strip()
    if value == "C":
        return (4, 4)
    if value == "C|":
        return (2, 2)
    m = re.match(r"(\d+)(?:\+\d+)*/(\d+)", value)
    if m:
        nums = re.match(r"([\d+]+)/", value).group(1)
        total = sum(int(x) for x in nums.split("+"))
        return (total, int(m.group(2)))
    return (4, 4)


def _parse_tempo(value: str) -> Optional[float]:
    value = value.strip()
    m = re.match(r"(\d+)/(\d+)\s*=\s*(\d+)", value)
    if m:
        beat = Fraction(int(m.group(1)), int(m.group(2)))  # fraction of whole
        bpm = int(m.group(3))
        return bpm * float(beat * 4)  # convert to quarter bpm
    m = re.match(r"^(\d+)$", value)
    if m:
        return float(m.group(1))
    return None


class _VoiceState:
    def __init__(self) -> None:
        self.time = Fraction(0)
        self.measure_accidentals: dict[tuple[str, int], int] = {}
        self.pending_broken: Optional[str] = None  # '>' or '<' chains
        self.broken_count = 0
        self.tuplet_remaining = 0
        self.tuplet_factor = Fraction(1)
        self.tie_pending: Optional[AbcNote] = None
        # the last emitted note(s) OF THIS VOICE sharing one start time —
        # broken rhythm and ties must resolve against the current voice,
        # not tune.notes[-1] (another voice's note when V: sections
        # interleave)
        self.last_group: list = []
        self.pending_graces: list[int] = []  # pitches awaiting a principal
        # repeat handling
        self.repeat_start_time: Fraction = Fraction(0)
        self.repeat_start_idx: int = 0
        self.in_second_ending = False
        self.first_ending_start: Optional[int] = None
        self.first_ending_time: Optional[Fraction] = None


class AbcParser:
    """Parse one ABC tune into an :class:`AbcTune` with expanded repeats.

    ``gchord=True`` additionally renders chord-symbol accompaniment on a
    dedicated voice (abc2midi's gchord engine, see module docstring)."""

    def __init__(self, gchord: bool = False):
        self.gchord = gchord

    def parse(self, abc_text: str) -> AbcTune:
        tune = AbcTune()
        lines = abc_text.split("\n")
        body_lines: list[str] = []
        in_body = False
        explicit_L = False
        for raw in lines:
            line = raw.split("%")[0].rstrip() if not raw.startswith("%%") else ""
            if not line:
                continue
            header = re.match(r"^([A-Za-z]):(.*)$", line)
            if not in_body and header and header.group(1) in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
                tag, val = header.group(1), header.group(2).strip()
                if tag == "X":
                    tune.reference = val
                elif tag == "T" and not tune.title:
                    tune.title = val
                elif tag == "M":
                    tune.meter = _parse_meter(val)
                elif tag == "L":
                    try:
                        num, den = val.split("/")
                        tune.unit_length = Fraction(int(num), int(den))
                        explicit_L = True
                    except ValueError:
                        pass
                elif tag == "Q":
                    bpm = _parse_tempo(val)
                    if bpm:
                        tune.tempo_bpm = bpm
                elif tag == "K":
                    tune.key = val
                    tune.sharps = key_signature_sharps(val)
                    in_body = True  # K: ends the header
                continue
            if in_body:
                if header and len(header.group(1)) == 1:
                    # mid-body field LINES (abc2midi honors these): K:/M:/
                    # L:/Q: become inline fields so they apply in sequence;
                    # V: passes through to the body's voice switch; other
                    # fields (T:, S:, B:, E:, R:, N:, w:, ...) are metadata
                    # — previously they were scanned as MUSIC, emitting
                    # spurious notes and ignoring key/meter changes
                    tag = header.group(1)
                    if tag in "MLKQ":
                        body_lines.append(f"[{tag}:{header.group(2).strip()}]")
                    elif tag in "Vv":
                        body_lines.append(line)
                    continue
                body_lines.append(line)
            elif header is None:
                # body before K:? treat as body with default key
                in_body = True
                body_lines.append(line)

        if not explicit_L:
            # default L from meter: < 0.75 -> 1/16, else 1/8 (ABC standard)
            num, den = tune.meter
            if Fraction(num, den) < Fraction(3, 4):
                tune.unit_length = Fraction(1, 16)

        self._parse_body(tune, "\n".join(body_lines))
        if self.gchord:
            self._generate_gchord(tune)
            tune.notes.sort(key=lambda x: (x.voice, x.start, x.pitch))
        return tune

    # ------------------------------------------------------------------

    def _parse_body(self, tune: AbcTune, body: str) -> None:
        unit_ql = tune.unit_length * 4  # quarters per unit note
        key_acc = sharps_to_accidentals(tune.sharps)
        voices: dict[str, _VoiceState] = {}
        voice_ids: list[str] = []
        cur_voice_id = "1"

        def voice(vid: str) -> _VoiceState:
            if vid not in voices:
                voices[vid] = _VoiceState()
                voice_ids.append(vid)
            return voices[vid]

        st = voice(cur_voice_id)
        i = 0
        text = body
        n = len(text)

        def emit(pitch: int, dur: QL, st: _VoiceState, vidx: int) -> None:
            dur = dur
            if st.tuplet_remaining > 0:
                dur = dur * st.tuplet_factor
                st.tuplet_remaining -= 1
            # broken rhythm
            if st.pending_broken:
                k = st.broken_count
                factor_long = Fraction(2 ** (k + 1) - 1, 2 ** k)
                factor_short = Fraction(1, 2 ** k)
                prev_factor = (factor_long if st.pending_broken == ">"
                               else factor_short)
                this_factor = (factor_short if st.pending_broken == ">"
                               else factor_long)
                if st.last_group:
                    delta = max(nt.duration for nt in st.last_group) * (
                        prev_factor - 1)
                    for nt in st.last_group:
                        nt.duration = nt.duration * prev_factor
                    st.time += delta
                dur = dur * this_factor
                st.pending_broken = None
                st.broken_count = 0
            if pitch >= 0 and st.tie_pending is not None and st.tie_pending.pitch == pitch:
                st.tie_pending.duration += dur
                st.pending_graces.clear()  # graces can't split a tied note
                st.tie_pending = None
                st.time += dur
                return
            if pitch < 0:
                st.pending_graces.clear()  # graces never attach to a rest
            elif st.pending_graces:
                # graces steal the first GRACE_NUM/GRACE_DEN of the span,
                # split equally; the principal scales to the remainder
                steal = dur * GRACE_NUM / GRACE_DEN
                per = steal / len(st.pending_graces)
                for gp in st.pending_graces:
                    tune.notes.append(AbcNote(gp, st.time, per, vidx))
                    st.time += per
                st.pending_graces.clear()
                dur = dur - steal
            note = AbcNote(pitch, st.time, dur, vidx)
            tune.notes.append(note)
            st.last_group = [note]
            # a tie binds only the immediately-following note; clear it either
            # way so a mismatched tie can't capture a later same-pitch note
            st.tie_pending = None
            st.time += dur

        while i < n:
            ch = text[i]
            vidx = voice_ids.index(cur_voice_id)

            if ch in " \t\n\\":
                i += 1
                continue
            if ch == '"':  # chord symbol: record (time, text)
                j = text.find('"', i + 1)
                sym = text[i + 1 : j] if j != -1 else text[i + 1 :]
                if sym and sym[0] not in "^_<>@":  # not a placement annotation
                    tune.chord_symbols.append((st.time, sym))
                i = (j + 1) if j != -1 else n
                continue
            if ch == "{":  # grace group: collect pitches (lengths ignored)
                j = text.find("}", i + 1)
                inner = text[i + 1 : j] if j != -1 else text[i + 1 :]
                for gm in _NOTE_RE.finditer(inner):
                    if gm.group("letter"):
                        st.pending_graces.append(self._note_pitch(gm, key_acc, st))
                i = (j + 1) if j != -1 else n
                continue
            if ch == "!":  # decoration
                j = text.find("!", i + 1)
                i = (j + 1) if j != -1 else i + 1
                continue
            if ch == "+":  # old-style +...+ decoration
                j = text.find("+", i + 1)
                i = (j + 1) if j != -1 else i + 1
                continue
            if ch in "~.HLMNOPRSTuv":  # single-char decorations
                i += 1
                continue
            if ch == "V" and i + 1 < n and text[i + 1] == ":":
                m = re.match(r"V:\s*(\S+)", text[i:])
                cur_voice_id = m.group(1)
                st = voice(cur_voice_id)
                i += m.end()
                continue
            # inline fields [M:...] [K:...] [L:...]; any OTHER single-letter
            # field (e.g. [r:remark], [I:instruction]) is consumed and
            # ignored — scanning its interior as music emitted phantom notes
            m = _INLINE_FIELD_RE.match(text, i)
            if m and len(m.group("tag")) == 1:
                tag, val = m.group("tag"), m.group("val")
                if tag not in "MLKQV":
                    i = m.end()
                    continue
                if tag == "V":
                    cur_voice_id = val.strip()
                    st = voice(cur_voice_id)
                    i = m.end()
                    continue
                if tag == "M":
                    tune.meter = _parse_meter(val)
                elif tag == "L":
                    try:
                        a, b = val.split("/")
                        tune.unit_length = Fraction(int(a), int(b))
                        unit_ql = tune.unit_length * 4
                    except ValueError:
                        pass
                elif tag == "K":
                    tune.key = val.strip()
                    tune.sharps = key_signature_sharps(val)
                    key_acc = sharps_to_accidentals(tune.sharps)
                elif tag == "Q":
                    bpm = _parse_tempo(val)
                    if bpm:
                        tune.tempo_bpm = bpm
                i = m.end()
                continue
            # volta [1 / [2
            m = _VOLTA_RE.match(text, i)
            if m:
                num = int(m.group("num"))
                if num == 1:
                    st.first_ending_start = len(tune.notes)
                    st.first_ending_time = st.time
                i = m.end()
                continue
            # bars and repeats
            if ch == "|" or ch == ":" or ch == "[":
                m = re.match(
                    r"(\[\|:|\|\|:|\|\]|\|\||::|\|:|:\|\]?|\[\||\|)",
                    text[i:])
                if m:
                    bar = m.group(1)
                    st.measure_accidentals.clear()
                    st.pending_graces.clear()  # graces don't cross barlines
                    if bar in ("|:", "[|:", "||:"):
                        st.repeat_start_idx = len(tune.notes)
                        st.repeat_start_time = st.time
                    elif bar.startswith(":|") or bar == "::":
                        self._expand_repeat(tune, st, vidx)
                        if bar == "::":
                            st.repeat_start_idx = len(tune.notes)
                            st.repeat_start_time = st.time
                    i += m.end()
                    # '|1' / ':|2' volta spelling: an ending number directly
                    # after the barline (equivalent to '[1' / '[2')
                    em = re.match(r"[0-9]", text[i:i + 1])
                    if em:
                        if em.group(0) == "1":
                            st.first_ending_start = len(tune.notes)
                            st.first_ending_time = st.time
                        i += 1
                    continue
            # tuplet
            m = _TUPLET_RE.match(text, i)
            if m:
                p = int(m.group("p"))
                q = m.group("q")
                r = m.group("r")
                default_q = {2: 3, 3: 2, 4: 3, 6: 2, 8: 3}.get(p, 2)
                qv = int(q) if q else default_q
                rv = int(r) if r else p
                st.tuplet_remaining = rv
                st.tuplet_factor = Fraction(qv, p)
                i = m.end()
                continue
            if ch == "(" or ch == ")":
                i += 1  # slur
                continue
            if ch in "><":
                run = re.match(r"([><])\1*", text[i:]).group(0)
                st.pending_broken = run[0]
                # '>'=3/2+1/2, '>>'=7/4+1/4, ...; capped at 30 (the C++
                # compiler's 1<<(k+1) would be UB past 62; both clamp)
                st.broken_count = min(len(run), 30)
                i += len(run)
                continue
            if ch == "-":
                if st.last_group:
                    st.tie_pending = st.last_group[-1]
                i += 1
                continue
            # chord [CEG]
            if ch == "[":
                j = text.find("]", i + 1)
                if j != -1 and not re.match(r"\[[A-Za-z]:", text[i:]):
                    inner = text[i + 1 : j]
                    # optional length after ]
                    lm = re.match(r"(\d+/\d+|/\d+|\d+|/+)?", text[j + 1 :])
                    outer_len = _parse_len(lm.group(0) or None)
                    chord = [
                        (self._note_pitch(nm, key_acc, st),
                         _parse_len(nm.group("len")) * unit_ql * outer_len)
                        for nm in _NOTE_RE.finditer(inner)
                        if nm.group("letter")
                    ]
                    # tuplet and broken rhythm apply to chords exactly as to
                    # single notes (they previously bypassed emit() and the
                    # tuplet counter leaked onto following plain notes)
                    factor = Fraction(1)
                    if st.tuplet_remaining > 0:
                        factor *= st.tuplet_factor
                        st.tuplet_remaining -= 1
                    if st.pending_broken:
                        k = st.broken_count
                        f_long = Fraction(2 ** (k + 1) - 1, 2 ** k)
                        f_short = Fraction(1, 2 ** k)
                        prev_f = f_long if st.pending_broken == ">" else f_short
                        this_f = f_short if st.pending_broken == ">" else f_long
                        if st.last_group:
                            delta = max(nt.duration for nt in st.last_group
                                        ) * (prev_f - 1)
                            for nt in st.last_group:
                                nt.duration = nt.duration * prev_f
                            st.time += delta
                        factor *= this_f
                        st.pending_broken = None
                        st.broken_count = 0
                    if factor != 1:
                        chord = [(pp, dd * factor) for pp, dd in chord]
                    st.tie_pending = None  # ties don't bind into chords here
                    max_d = max((d for _, d in chord), default=Fraction(0))
                    if st.pending_graces and chord:
                        # same steal rule as single notes: graces take the
                        # first 1/4 of the chord span, chord scales to 3/4
                        steal = max_d * GRACE_NUM / GRACE_DEN
                        per = steal / len(st.pending_graces)
                        for gp in st.pending_graces:
                            tune.notes.append(AbcNote(gp, st.time, per, vidx))
                            st.time += per
                        st.pending_graces.clear()
                        chord = [(p, d * (GRACE_DEN - GRACE_NUM) / GRACE_DEN)
                                 for p, d in chord]
                        max_d = max_d * (GRACE_DEN - GRACE_NUM) / GRACE_DEN
                    start = st.time
                    group = [AbcNote(pitch, start, d, vidx)
                             for pitch, d in chord]
                    tune.notes.extend(group)
                    if group:
                        st.last_group = group
                    st.time = start + max_d
                    i = j + 1 + (lm.end() if lm else 0)
                    continue
                i += 1
                continue
            # rest
            m = _REST_RE.match(text, i)
            if m:
                if m.group("kind") in "ZX":
                    try:
                        bars = int(m.group("len") or 1)
                    except ValueError:
                        i += 1  # 'Z/2' is malformed (Z takes an integer
                        continue  # bar count): skip the Z, rescan the rest
                    bar_ql = Fraction(4 * tune.meter[0], tune.meter[1])
                    emit(-1, bar_ql * bars, st, vidx)
                else:
                    emit(-1, _parse_len(m.group("len")) * unit_ql, st, vidx)
                i = m.end()
                continue
            # note
            m = _NOTE_RE.match(text, i)
            if m and m.group("letter"):
                pitch = self._note_pitch(m, key_acc, st)
                dur = _parse_len(m.group("len")) * unit_ql
                emit(pitch, dur, st, vidx)
                i = m.end()
                continue
            i += 1  # unknown char: skip

        tune.n_voices = max(1, len(voice_ids))
        tune.notes.sort(key=lambda x: (x.voice, x.start, x.pitch))

    def _expand_repeat(self, tune: AbcTune, st: _VoiceState, vidx: int) -> None:
        """Duplicate the notes of the current repeat section (abc2midi expands
        repeats into the MIDI event stream). Handles a [1/[2 first ending by
        repeating only up to the first-ending start."""
        end_idx = len(tune.notes)
        if st.first_ending_start is not None:
            section = [x for x in tune.notes[st.repeat_start_idx : st.first_ending_start]
                       if x.voice == vidx]
            ending_len = st.time - (st.first_ending_time or st.time)
        else:
            section = [x for x in tune.notes[st.repeat_start_idx : end_idx] if x.voice == vidx]
            ending_len = Fraction(0)
        shift = st.time - st.repeat_start_time
        base = st.time
        for x in section:
            tune.notes.append(
                AbcNote(x.pitch, x.start + shift, x.duration, x.voice)
            )
        if vidx == 0:
            # chord symbols inside the repeated window play again too
            # (voice 0 drives the single accompaniment line, like abc2midi)
            window_end = (st.first_ending_time if st.first_ending_time is not None
                          else st.time)
            copied = [
                (t + shift, sym) for t, sym in tune.chord_symbols
                if st.repeat_start_time <= t < window_end
            ]
            tune.chord_symbols.extend(copied)
        # advance by the COPIED section's time span: with a [1 first ending
        # the copy stops at the ending, so the advance excludes it; without
        # one it is the full shift. (Summing durations instead would
        # overcount chords.)
        if st.first_ending_time is not None:
            section_span = st.first_ending_time - st.repeat_start_time
        else:
            section_span = shift
        st.time = base + section_span
        st.repeat_start_idx = len(tune.notes)
        st.repeat_start_time = st.time
        st.first_ending_start = None
        st.first_ending_time = None

    def _generate_gchord(self, tune: AbcTune) -> None:
        """Render chord-symbol accompaniment on a dedicated voice: the
        meter's ``fzcz`` pattern over an eighth-note grid anchored at t=0,
        fundamental at octave 2, chord tones at octave 3, from the first
        chord symbol to the melody's end (abc2midi's gchord engine)."""
        pattern = gchord_pattern(tune.meter)
        changes = []
        for t, sym in sorted(tune.chord_symbols, key=lambda x: x[0]):
            parsed = parse_chord_symbol(sym)
            if parsed:
                changes.append((t, parsed))
        if not pattern or not changes:
            return
        end = tune.duration()
        voice = max(tune.n_voices, 1 + max((x.voice for x in tune.notes), default=0))
        first = changes[0][0]
        k = -(-first.numerator * GCHORD_SLOT.denominator
              // (first.denominator * GCHORD_SLOT.numerator))  # ceil(first/slot)
        active_idx = 0
        while True:
            t = k * GCHORD_SLOT
            if t >= end:
                break
            c = pattern[k % len(pattern)]
            while (active_idx + 1 < len(changes)
                   and changes[active_idx + 1][0] <= t):
                active_idx += 1
            root_pc, intervals, bass_pc = changes[active_idx][1]
            if c in "fb":
                pc = bass_pc if bass_pc is not None else root_pc
                tune.notes.append(AbcNote(FUNDAMENTAL_BASE + pc, t, GCHORD_SLOT, voice))
            if c in "cb":
                for iv in intervals:
                    tune.notes.append(
                        AbcNote(CHORD_BASE + root_pc + iv, t, GCHORD_SLOT, voice)
                    )
            k += 1
        tune.accomp_voice = voice

    def _note_pitch(self, m: re.Match, key_acc: dict[str, int], st: _VoiceState) -> int:
        letter = m.group("letter")
        upper = letter.upper()
        octave = 5 if letter.islower() else 4  # C=60 (octave 4), c=72
        for o in m.group("oct"):
            octave += 1 if o == "'" else -1
        acc_token = m.group("acc")
        key = (upper, octave)
        if acc_token:
            alter = {"^": 1, "^^": 2, "_": -1, "__": -2, "=": 0}[acc_token]
            st.measure_accidentals[key] = alter
        if key in st.measure_accidentals:
            alter = st.measure_accidentals[key]
        else:
            alter = key_acc.get(upper, 0)
        return 12 * (octave + 1) + _LETTER_SEMITONE[upper] + alter
