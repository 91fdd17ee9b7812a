"""Lightweight score model: the music21-free core the codec operates on.

The port's copy of ``ai_music_generation_tpu/codec/score.py`` (the port
imports nothing of the JAX package; tests/test_torch_host_copies.py holds
the two to each other).

Replaces the music21 Score/Part/Measure object graph used throughout the
reference codec (ref: core/encodings/quantized_converter.py) with a small,
deterministic model:

    Score -> Part -> Measure -> elements (NoteEl / Clef / KeySig / TimeSig)

All offsets/durations are in quarter lengths, stored as ``Fraction`` so the
1/16-grid (and x3 triplet-grid) arithmetic is exact — the same reason the
reference leans on music21's ``opFrac`` (ref: quantized_converter.py:17,885).

Conversion helpers:
- :func:`score_from_midi` — MIDI -> quantized Score: snap-to-grid
  quantization (min-error divisor, like music21 ``Stream.quantize``),
  measure splitting from the time-signature map, cross-measure note ties
  (music21 ``makeTies``), same-offset/same-duration chord grouping, and gap
  rests (music21 ``makeNotation`` rest filling).
- :func:`score_to_midi` — Score -> MIDI for the text->midi pipelines.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Iterable, Optional, Union

from ai_music_generation_tpu_torch.codec import midi_io

QL = Fraction  # quarter-length type


@dataclasses.dataclass(frozen=True)
class Clef:
    sign: str = "G"
    line: int = 2
    octave_change: int = 0


@dataclasses.dataclass(frozen=True)
class KeySig:
    sharps: int = 0


@dataclasses.dataclass(frozen=True)
class TimeSig:
    numerator: int = 4
    denominator: int = 4

    @property
    def bar_duration(self) -> QL:
        return Fraction(4 * self.numerator, self.denominator)


@dataclasses.dataclass
class NoteEl:
    """A note, chord, or rest at an offset within its measure.

    ``pitches`` empty => rest. ``tie_next`` marks continuation into the
    following measure (informational; the token text does not encode ties,
    matching the reference where makeTies splits silently).
    """

    offset: QL
    quarter_length: QL
    pitches: tuple[int, ...] = ()
    velocity: int = 64
    tie_next: bool = False

    @property
    def is_rest(self) -> bool:
        return not self.pitches

    @property
    def is_chord(self) -> bool:
        return len(self.pitches) > 1


@dataclasses.dataclass
class Measure:
    offset: QL = Fraction(0)  # absolute offset of measure start in the part
    time_sig: Optional[TimeSig] = None  # set when it CHANGES at this measure
    key_sig: Optional[KeySig] = None
    clef: Optional[Clef] = None
    notes: list[NoteEl] = dataclasses.field(default_factory=list)
    bar_duration: QL = Fraction(4)  # nominal duration from the time signature
    real_duration: QL = Fraction(4)  # actual content span (anacrusis < nominal)
    padding_left: QL = Fraction(0)  # anacrusis padding (music21 paddingLeft)
    left_repeat: bool = False
    right_repeat: bool = False


@dataclasses.dataclass
class Part:
    measures: list[Measure] = dataclasses.field(default_factory=list)
    name: str = ""
    program: Optional[int] = None
    channel: Optional[int] = None

    def has_notes(self) -> bool:
        return any(not n.is_rest for m in self.measures for n in m.notes)


@dataclasses.dataclass
class Score:
    parts: list[Part] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# quantization


def quantize_ql(value: QL, divisors: Iterable[int]) -> QL:
    """Snap a quarter-length to the best divisor grid (min absolute error),
    mirroring music21 ``Stream.quantize`` (ref: quantized_converter.py:190-196)."""
    best: Optional[QL] = None
    best_err: Optional[Fraction] = None
    v = Fraction(value)
    for d in divisors:
        snapped = Fraction(round(v * d), d)
        err = abs(snapped - v)
        if best_err is None or err < best_err:
            best, best_err = snapped, err
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# MIDI -> Score


def score_from_midi(
    midi: midi_io.MidiFile,
    quarter_divisors: Iterable[int] = (4, 6),
    fill_rests: bool = True,
) -> Score:
    """Build a quantized, measure-split Score from a parsed MIDI file."""
    divisors = list(quarter_divisors)
    tpq = midi.ticks_per_quarter

    tsigs = [
        (Fraction(e.tick, tpq), TimeSig(e.numerator, e.denominator))
        for e in midi.time_signatures
    ] or [(Fraction(0), TimeSig(4, 4))]
    if tsigs[0][0] != 0:
        tsigs.insert(0, (Fraction(0), TimeSig(4, 4)))
    ksigs = [(Fraction(e.tick, tpq), KeySig(e.sharps)) for e in midi.key_signatures]
    ksig0 = ksigs[0][1] if ksigs else KeySig(0)

    score = Score()
    for track in midi.tracks:
        if not track.notes:
            continue
        notes = []
        for n in track.notes:
            start = quantize_ql(Fraction(n.start_tick, tpq), divisors)
            end = quantize_ql(Fraction(n.end_tick, tpq), divisors)
            if end <= start:
                end = start + Fraction(1, max(divisors))
            notes.append((start, end, n.pitch, n.velocity))
        part = _notes_to_part(notes, tsigs, fill_rests)
        part.name = track.name
        part.program = track.program
        part.channel = track.channel
        if part.measures:
            part.measures[0].key_sig = ksig0
            part.measures[0].clef = _guess_clef(notes)
        score.parts.append(part)
    return score


def _guess_clef(notes) -> Clef:
    """Treble vs bass by mean pitch (music21 uses clef inference on import)."""
    if not notes:
        return Clef("G", 2, 0)
    mean = sum(p for _, _, p, _ in notes) / len(notes)
    return Clef("G", 2, 0) if mean >= 60 else Clef("F", 4, 0)


def measure_boundaries(tsigs, end: QL) -> list[tuple[QL, QL, TimeSig, bool]]:
    """[(start, bar_duration, tsig, is_change), ...] measure grid up to ``end``.

    A signature change that falls mid-bar TRUNCATES the previous
    signature's last measure at the change point — letting it run past
    produced two overlapping measures whose shared region's notes were
    emitted twice (review finding). The final segment's last bar still
    extends to its full nominal length past ``end``."""
    out = []
    for i, (ts_off, ts) in enumerate(tsigs):
        has_next = i + 1 < len(tsigs)
        next_off = tsigs[i + 1][0] if has_next else max(end, ts_off)
        pos = ts_off
        first = True
        while pos < next_off or (first and pos == ts_off and ts_off >= end):
            dur = ts.bar_duration
            if has_next and pos + dur > next_off:
                dur = next_off - pos  # truncated pickup before the change
            out.append((pos, dur, ts, first))
            pos += dur
            first = False
            if pos >= end and pos >= next_off:
                break
        if ts_off >= end:
            break
    return out


def _notes_to_part(notes, tsigs, fill_rests: bool) -> Part:
    """Split (start, end, pitch, velocity) tuples into measures with ties."""
    if not notes:
        return Part()
    end = max(e for _, e, _, _ in notes)
    grid = measure_boundaries(tsigs, end)

    part = Part()
    prev_ts: Optional[TimeSig] = None
    for m_start, bar_dur, ts, is_change in grid:
        m_end = m_start + bar_dur
        measure = Measure(
            offset=m_start,
            bar_duration=bar_dur,
            real_duration=bar_dur,
            time_sig=ts if (prev_ts is None or ts != prev_ts) else None,
        )
        prev_ts = ts
        raw: list[NoteEl] = []
        for start, nend, pitch, vel in notes:
            if start < m_end and nend > m_start:
                seg_start = max(start, m_start)
                seg_end = min(nend, m_end)
                if seg_end <= seg_start:
                    continue
                raw.append(
                    NoteEl(
                        offset=seg_start - m_start,
                        quarter_length=seg_end - seg_start,
                        pitches=(pitch,),
                        velocity=vel,
                        tie_next=nend > m_end,
                    )
                )
        measure.notes = _group_chords(raw)
        if fill_rests:
            _fill_gap_rests(measure)
        part.measures.append(measure)

    # trim trailing all-rest measures beyond the music; keep any measure
    # that carries a time-signature change
    while (
        part.measures
        and all(n.is_rest for n in part.measures[-1].notes)
        and part.measures[-1].time_sig is None
    ):
        part.measures.pop()
    if not part.measures and grid:
        part.measures.append(Measure(offset=grid[0][0], bar_duration=grid[0][1]))
    return part


def _group_chords(raw: list[NoteEl]) -> list[NoteEl]:
    """Merge same-offset same-duration notes into chords (reference:
    flattenUnnecessaryVoices + chordify, quantized_converter.py:264-267)."""
    groups: dict[tuple[QL, QL], list[NoteEl]] = {}
    for n in raw:
        groups.setdefault((n.offset, n.quarter_length), []).append(n)
    out = []
    for (off, ql), members in sorted(groups.items()):
        pitches = tuple(sorted({p for m in members for p in m.pitches}))
        out.append(
            NoteEl(
                offset=off, quarter_length=ql, pitches=pitches,
                velocity=members[0].velocity,
                tie_next=any(m.tie_next for m in members),
            )
        )
    return out


def _fill_gap_rests(measure: Measure) -> None:
    """Insert rests covering gaps in note coverage (monophonic union)."""
    spans = sorted((n.offset, n.offset + n.quarter_length) for n in measure.notes)
    merged: list[list[QL]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = []
    pos = Fraction(0)
    for s, e in merged:
        if s > pos:
            gaps.append((pos, s))
        pos = max(pos, e)
    if pos < measure.bar_duration:
        gaps.append((pos, measure.bar_duration))
    for s, e in gaps:
        measure.notes.append(NoteEl(offset=s, quarter_length=e - s, pitches=()))
    measure.notes.sort(key=lambda n: (n.offset, n.pitches))


# ---------------------------------------------------------------------------
# Score -> MIDI


def score_to_midi(
    score: Score,
    ticks_per_quarter: int = 480,
    tempo_bpm: float = 120.0,
    velocity: int = 64,
) -> midi_io.MidiFile:
    tpq = ticks_per_quarter
    tracks = []
    tsig_events: list[midi_io.TimeSignatureEvent] = []
    ksig_events: list[midi_io.KeySignatureEvent] = []

    for t_idx, part in enumerate(score.parts):
        info = midi_io.TrackInfo(index=t_idx + 1, name=part.name,
                                 program=part.program, channel=part.channel or 0)
        pos = Fraction(0)
        for measure in part.measures:
            m_start = pos + measure.padding_left
            for n in measure.notes:
                if n.is_rest:
                    continue
                start_tick = int((m_start + n.offset - measure.padding_left) * tpq)
                end_tick = int((m_start + n.offset - measure.padding_left + n.quarter_length) * tpq)
                for p in n.pitches:
                    info.notes.append(
                        midi_io.MidiNote(p, n.velocity or velocity, start_tick,
                                         end_tick, part.channel or 0, t_idx + 1)
                    )
            if t_idx == 0:
                if measure.time_sig is not None:
                    tsig_events.append(
                        midi_io.TimeSignatureEvent(
                            int(pos * tpq), measure.time_sig.numerator,
                            measure.time_sig.denominator,
                        )
                    )
                if measure.key_sig is not None:
                    ksig_events.append(
                        midi_io.KeySignatureEvent(int(pos * tpq), measure.key_sig.sharps)
                    )
            pos += measure.bar_duration - measure.padding_left
        info.notes.sort(key=lambda n: (n.start_tick, n.pitch))
        tracks.append(info)

    return midi_io.MidiFile(
        ticks_per_quarter=tpq,
        tracks=tracks,
        tempos=[midi_io.TempoEvent(0, int(60_000_000 / tempo_bpm))],
        time_signatures=tsig_events,
        key_signatures=ksig_events,
    )
