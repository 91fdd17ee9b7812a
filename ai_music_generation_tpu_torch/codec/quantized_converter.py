"""Quantized MIDI <-> token-text codec.

The port's copy of ``ai_music_generation_tpu/codec/quantized_converter.py``
(the port imports nothing of the JAX package;
tests/test_torch_host_copies.py holds the two to each other).

Reimplements the reference's ``MidiQuantizedConverter``
(ref: src/ai_music_generation/core/encodings/quantized_converter.py:52-913)
over the music21-free score model in ``codec/score.py``.

Token grammar (identical to the reference):

- ``p<midi>`` pitch, ``d<int>`` duration, ``o<int>`` offset (int encodings on
  the 1/shortest grid, x3 when triplets are allowed), ``rest``, ``|`` bar,
  ``/N`` part prefix, ``/`` padding-part prefix, ``clef_<sign>_<line>_<oct>``,
  ``key_signature_<-7..7>``, ``time_signature_<N>/<D>``,
  ``repeat_start``/``repeat_end``, ``shift``, ``tuplet_start``/``tuplet_end``.

Emission strategies (ref :326-552):
- **Queue parallel measures** (default): per measure, each part's content is
  emitted sequentially as ``/0 ... /1 ...``, followed by the padding part
  ``/ o<real_dur> [repeat_end]`` and the bar token.
- **Join parallel measures**: parts' offset dicts are merged; one combined
  event stream per measure.

Inverse (``text_to_score``, ref :541-644): measures split on ``|``, parts on
``/N``, anacrusis from the padding part, repeat barlines, invalid-token
warnings counted.

Known deviations (deliberate):
- The reference clamps over-long durations to ``longest_note_duration * 4``
  — an int encoding inconsistent with its own grid (decodes to 2/3 quarter
  at default settings; ref :877-903). Here the clamp is the top of the
  valid duration range (``durations_range[1]``).
- The reference vocab contains a typo token ``time_signature_1/2,`` (ref
  :86); the comma is dropped here. Emission never produced it either way.
"""

from __future__ import annotations

import logging
import re
from enum import Enum
from fractions import Fraction
from pathlib import Path
from typing import Optional, Tuple, Union

from pydantic import BaseModel

from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.codec.encoding_settings import EncodingSetting
from ai_music_generation_tpu_torch.codec.instrument_types import InstrumentTypes
from ai_music_generation_tpu_torch.codec.score import (
    Clef,
    KeySig,
    Measure,
    NoteEl,
    Part,
    Score,
    TimeSig,
    score_from_midi,
)

logger = logging.getLogger(__name__)

QL = Fraction


class TokenType(str, Enum):
    PITCH = "PITCH"
    DURATION = "DURATION"
    REST = "REST"
    BAR = "BAR"
    TIME_SHIFT = "TIME_SHIFT"
    TIME_SIGNATURE = "TIME_SIGNATURE"
    CLEF = "CLEF"
    KEY_SIGNATURE = "KEY_SIGNATURE"


class BarModel(BaseModel):
    """ref BarModel (quantized_converter.py:42-49). Deviation: durations
    are exact Fractions, not floats — Fraction(float(8/3)) has a dyadic
    denominator, so a triplet-grid anacrusis (e.g. real duration 8/3)
    re-encoded through a float emitted the wrong offset token plus a
    spurious off-grid warning."""

    model_config = {"arbitrary_types_allowed": True}

    bar_duration_quarterLength: Union[Fraction, float]
    real_duration_quarterLength: Union[Fraction, float]
    is_repeat: bool = False
    is_end: bool = True
    times: Optional[int] = None


_COMMON_TIME_SIGNATURES = [
    "1/2", "2/2", "3/2", "4/2",
    "1/4", "2/4", "3/4", "4/4", "5/4", "6/4", "7/4", "8/4",
    "1/8", "2/8", "3/8", "4/8", "5/8", "6/8", "7/8", "8/8", "9/8", "10/8",
    "11/8", "12/8",
]

_CLEF_PARAMS = [
    ("G", 1, 0), ("G", 2, 0), ("G", 2, -1), ("G", 2, 1), ("G", 3, 0),
    ("C", 1, 0), ("C", 2, 0), ("C", 3, 0), ("C", 4, 0), ("C", 5, 0),
    ("F", 3, 0), ("F", 4, 0), ("F", 4, 1), ("F", 4, -1), ("F", 5, 0),
    ("TAB", 5, 0),
]


class MidiQuantizedConverter:
    def __init__(self, settings: EncodingSetting = EncodingSetting()) -> None:
        self.settings = settings
        self.durations_range: Tuple[int, int] = (
            1,
            settings.longest_note_duration
            * settings.shortest_note_duration
            * (3 if settings.allow_triplet_quarterLength else 1),
        )
        self.durations = [f"d{i}" for i in range(self.durations_range[0], self.durations_range[1] + 1)]
        self.pitches_range = settings.notes_range
        self.pitches = [f"p{i}" for i in range(self.pitches_range[0], self.pitches_range[1] + 1)]
        self.rest = "rest"
        self.time_shift = "shift"
        self.bar = "|"
        self.tuplet_start = "tuplet_start"
        self.tuplet_end = "tuplet_end"
        self.parts_separator = "/"
        self.repeat_start = "repeat_start"
        self.repeat_end = "repeat_end"
        self.time_signatures = (
            [] if not settings.include_time_signature
            else [f"time_signature_{s}" for s in _COMMON_TIME_SIGNATURES]
        )
        self.clefs = (
            [] if not settings.include_clef
            else [f"clef_{s}_{l}_{o}" for s, l, o in _CLEF_PARAMS]
        )
        self.key_signatures = (
            [] if not settings.include_key_signature
            else [f"key_signature_{i}" for i in range(-7, 8)]
        )
        self.all_possible_tokens, self.tokens_types = self._create_all_possible_tokens_list()

    def _create_all_possible_tokens_list(self) -> Tuple[list[str], list[TokenType]]:
        """Vocab construction, same ordering as ref :140-173."""
        tokens: list[str] = [self.time_shift]
        types: list[TokenType] = [TokenType.TIME_SHIFT]
        if self.settings.include_bars:
            tokens.append(self.bar)
            types.append(TokenType.BAR)
        if self.settings.include_rests:
            tokens.append(self.rest)
            types.append(TokenType.REST)
        if self.settings.include_clef:
            tokens.extend(self.clefs)
            types.extend([TokenType.CLEF] * len(self.clefs))
        if self.settings.include_key_signature:
            tokens.extend(self.key_signatures)
            types.extend([TokenType.KEY_SIGNATURE] * len(self.key_signatures))
        if self.settings.include_time_signature:
            tokens.extend(self.time_signatures)
            types.extend([TokenType.TIME_SIGNATURE] * len(self.time_signatures))
        tokens.extend(self.durations)
        types.extend([TokenType.DURATION] * len(self.durations))
        tokens.extend(self.pitches)
        types.extend([TokenType.PITCH] * len(self.pitches))
        return tokens, types

    # -- grid math (ref :817-913) -----------------------------------------

    def _get_quarterLengthDivisors(self) -> list[int]:
        shortest_q = self.settings.shortest_note_duration / 4
        if not shortest_q.is_integer():
            raise RuntimeError(
                f"shortest_note_quarterLength must be integer, got {shortest_q}"
            )
        divisors = [int(shortest_q)]
        if self.settings.allow_triplet_quarterLength:
            triplet = int(shortest_q) / 2 * 3
            if not triplet.is_integer():
                raise RuntimeError(f"triplet divisor must be integer, got {triplet}")
            divisors.append(int(triplet))
        return divisors

    def duration_or_offset_to_int_enc(self, quarterLength: Union[float, Fraction, None]) -> int:
        if quarterLength is None:
            raise ValueError("Got quarterLength which is None")
        ql = Fraction(quarterLength)
        enc = ql * Fraction(self.settings.shortest_note_duration, 4)
        if self.settings.allow_triplet_quarterLength:
            enc *= 3
        if enc.denominator != 1:
            msg = (
                f"duration {quarterLength} is not an integer multiple of the "
                f"1/{self.settings.shortest_note_duration} grid"
            )
            logger.warning(msg)
            if self.settings.raise_duration_errors:
                raise ValueError(msg)
            return max(1, int(enc))
        if ql > self.settings.longest_note_duration * 4:
            msg = (
                f"duration {quarterLength} exceeds longest_note_duration "
                f"{self.settings.longest_note_duration} whole notes"
            )
            logger.warning(msg)
            if self.settings.raise_duration_errors:
                raise ValueError(msg)
            return self.durations_range[1]
        return int(enc)

    def int_enc_to_quarterLength(self, int_enc: int) -> Fraction:
        ql = Fraction(int_enc * 4, self.settings.shortest_note_duration)
        if self.settings.allow_triplet_quarterLength:
            ql = ql / 3
        return ql

    # -- part filtering (ref :835-875) ------------------------------------

    def filter_allowed_parts(self, score: Score) -> list[Part]:
        accepted = []
        for part in score.parts:
            if not part.has_notes():
                continue
            if self.settings.only_SATB_parts:
                if self.is_SATB_part(part):
                    accepted.append(part)
            elif not self.settings.allowed_instruments:
                accepted.append(part)
            elif self.is_allowed_part_instrument(part):
                accepted.append(part)
        return accepted

    def is_SATB_part(self, part: Part) -> bool:
        return part.name in ("Soprano", "Alto", "Tenor", "Bass")

    def is_allowed_part_instrument(self, part: Part) -> bool:
        if part.program is not None:
            return any(
                part.program in allowed.value
                for allowed in self.settings.allowed_instruments
            )
        if part.channel is not None:
            return (
                part.channel == 9
                and InstrumentTypes.PERCUSSIVE in self.settings.allowed_instruments
            )
        return False

    # -- MIDI -> text ------------------------------------------------------

    def filepath_to_texts(
        self, midi_path: Union[str, Path], transpose_pitches_by_n: Optional[int] = None
    ) -> dict[str, str]:
        midi_path = Path(midi_path)
        midi = midi_io.parse_midi_file(midi_path)
        score = score_from_midi(midi, self._get_quarterLengthDivisors())
        return self.stream_to_texts(score, midi_path.name, transpose_pitches_by_n)

    def stream_to_texts(
        self,
        score: Score,
        file_name: str,
        transpose_pitches_by_n: Optional[int] = None,
    ) -> dict[str, str]:
        if transpose_pitches_by_n:
            score = _transpose(score, transpose_pitches_by_n)
        if self.settings.repeats_handling == "Expand":
            score = expand_repeats(score)
        parts = self.filter_allowed_parts(score)
        if not parts:
            return {}
        text = self._convert_parts_to_text(parts)
        return {file_name: text}

    def _bar_model_for(self, measure: Measure) -> BarModel:
        bm = BarModel(
            bar_duration_quarterLength=Fraction(measure.bar_duration),
            real_duration_quarterLength=Fraction(
                measure.bar_duration - measure.padding_left),
        )
        if self.settings.repeats_handling == "Special tokens":
            if measure.left_repeat:
                bm.is_repeat = True
                bm.is_end = False
            if measure.right_repeat:
                bm.is_repeat = True
                bm.is_end = True
        return bm

    def _measure_has_notes(self, measure: Measure) -> bool:
        return any(not n.is_rest for n in measure.notes)

    def _signature_tokens(self, measure: Measure) -> list[str]:
        """clef/key/time tokens for a measure where they changed (ref dedup
        via last_* tracking, :784-815 — the score model stores changes only)."""
        out = []
        if measure.clef is not None and self.settings.include_clef:
            c = measure.clef
            out.append(f"clef_{c.sign}_{c.line}_{c.octave_change}")
        if measure.key_sig is not None and self.settings.include_key_signature:
            out.append(f"key_signature_{measure.key_sig.sharps}")
        if measure.time_sig is not None and self.settings.include_time_signature:
            ts = measure.time_sig
            out.append(f"time_signature_{ts.numerator}/{ts.denominator}")
        return out

    def _note_tokens_at_offsets(self, measure: Measure) -> list[tuple[QL, list[str]]]:
        """[(offset, tokens)] per distinct event offset, in offset order."""
        by_offset: dict[QL, list[NoteEl]] = {}
        for n in measure.notes:
            by_offset.setdefault(n.offset, []).append(n)
        out = []
        for off in sorted(by_offset):
            elements = by_offset[off]
            tokens: list[str] = []
            has_sounding = any(not e.is_rest for e in elements)
            has_rest = any(e.is_rest for e in elements)
            if self.settings.include_offset_in_notes and (
                has_sounding or (self.settings.include_rests and has_rest)
            ):
                tokens.append(f"o{self.duration_or_offset_to_int_enc(off)}")
            for e in elements:
                if e.is_rest:
                    if self.settings.include_rests:
                        tokens.append(self.rest)
                        tokens.append(f"d{self.duration_or_offset_to_int_enc(e.quarter_length)}")
                else:
                    for p in e.pitches:
                        tokens.append(f"p{p}")
                    tokens.append(f"d{self.duration_or_offset_to_int_enc(e.quarter_length)}")
            if tokens:
                out.append((off, tokens))
        return out

    def _convert_parts_to_text(self, parts: list[Part]) -> str:
        if self.settings.joining_parts_strategy == "Join parallel measures":
            return self._text_by_joining(parts)
        elif self.settings.joining_parts_strategy == "Queue parallel measures":
            return self._text_by_queuing(parts)
        raise ValueError(
            f"Got unexpected joining_parts_strategy {self.settings.joining_parts_strategy}"
        )

    def _text_by_queuing(self, parts: list[Part]) -> str:
        """Queue strategy (ref :344-442): sequential per-part measure chunks."""
        n_measures = max(len(p.measures) for p in parts)
        tokens: list[str] = []
        for m_idx in range(n_measures):
            bar_model: Optional[BarModel] = None
            is_first_part = True
            for p_idx, part in enumerate(parts):
                if len(part.measures) <= m_idx:
                    continue
                measure = part.measures[m_idx]
                if self.settings.skip_measures_without_notes and not self._measure_has_notes(measure):
                    continue
                if is_first_part:
                    is_first_part = False
                    bar_model = self._bar_model_for(measure)
                    if bar_model.is_repeat and not bar_model.is_end:
                        tokens.append(self.repeat_start)
                tokens.append(f"{self.parts_separator}{p_idx}")
                tokens.extend(self._signature_tokens(measure))
                for _off, toks in self._note_tokens_at_offsets(measure):
                    tokens.extend(toks)
            # padding part for pickup/anacrusis bars (ref :434-441)
            tokens.append(self.parts_separator)
            if bar_model is not None:
                tokens.append(
                    f"o{self.duration_or_offset_to_int_enc(Fraction(bar_model.real_duration_quarterLength))}"
                )
                if bar_model.is_repeat and bar_model.is_end:
                    tokens.append(self.repeat_end)
            else:
                tokens.append(f"o{self.duration_or_offset_to_int_enc(4)}")
            tokens.append(self.bar)
        return " ".join(tokens)

    def _text_by_joining(self, parts: list[Part]) -> str:
        """Join strategy (ref :444-539): merged offset dict per measure."""
        n_measures = max(len(p.measures) for p in parts)
        tokens: list[str] = []
        for m_idx in range(n_measures):
            sig_tokens: list[str] = []
            merged: dict[QL, list[NoteEl]] = {}
            bar_model: Optional[BarModel] = None
            time_sig: Optional[TimeSig] = None
            any_part = False
            for part in parts:
                if len(part.measures) <= m_idx:
                    continue
                measure = part.measures[m_idx]
                if self.settings.skip_measures_without_notes and not self._measure_has_notes(measure):
                    continue
                if not any_part:
                    any_part = True
                    bar_model = self._bar_model_for(measure)
                sigs = self._signature_tokens(measure)
                for s in sigs:
                    if s not in sig_tokens:
                        sig_tokens.append(s)
                if measure.time_sig is not None:
                    time_sig = measure.time_sig
                for n in measure.notes:
                    merged.setdefault(n.offset, []).append(n)

            tokens.extend(sig_tokens)
            is_nonempty = False
            for off in sorted(merged):
                elements = merged[off]
                has_sounding = any(not e.is_rest for e in elements)
                has_rest = any(e.is_rest for e in elements)
                if has_sounding or (self.settings.include_rests and has_rest):
                    is_nonempty = True
                    if self.settings.include_offset_in_notes:
                        tokens.append(f"o{self.duration_or_offset_to_int_enc(off)}")
                for e in elements:
                    if e.is_rest:
                        if self.settings.include_rests:
                            tokens.append(self.rest)
                            tokens.append(f"d{self.duration_or_offset_to_int_enc(e.quarter_length)}")
                    else:
                        for p in e.pitches:
                            tokens.append(f"p{p}")
                        tokens.append(f"d{self.duration_or_offset_to_int_enc(e.quarter_length)}")
            if not is_nonempty and self.settings.include_rests:
                if self.settings.include_offset_in_notes:
                    tokens.append("o0")
                tokens.append(self.rest)
                bar_len = time_sig.bar_duration if time_sig is not None else Fraction(4)
                tokens.append(f"d{self.duration_or_offset_to_int_enc(bar_len)}")
            if self.settings.include_offset_in_notes:
                if bar_model is not None:
                    tokens.append(
                        f"o{self.duration_or_offset_to_int_enc(Fraction(bar_model.real_duration_quarterLength))}"
                    )
                else:
                    tokens.append(f"o{self.duration_or_offset_to_int_enc(4)}")
            tokens.append(self.bar)
        return " ".join(tokens)

    # -- text -> Score (ref :541-644) --------------------------------------

    def text_to_score(self, text: str) -> Score:
        sep = re.escape(self.parts_separator)
        parts_numbers = re.compile(rf"\s*(?<!\d){sep}(\d?)(?!\d)\s*").findall(text)
        n_parts = 0
        for pn in parts_numbers:
            if pn:
                n_parts = max(n_parts, int(pn) + 1)

        measure_strs = [m for m in re.split(rf"\s*{re.escape(self.bar)}\s*", text) if m]
        part_regex = re.compile(rf"(\s*(?<!\d){sep}\d?(?!\d)\s*)")
        measures_parts_raw = [part_regex.split(m) for m in measure_strs]
        pre_measures_tokens = [mp[0] for mp in measures_parts_raw]
        measures_parts = [
            [(mp[i] + mp[i + 1]).strip() for i in range(1, len(mp) - 1, 2)]
            for mp in measures_parts_raw
        ]
        padding_parts = [
            mp[-1] if mp and mp[-1].startswith("/ ") else None for mp in measures_parts
        ]
        # Deliberate deviation: the reference strips the last chunk of every
        # measure unconditionally (ref :568-574) because codec-emitted text
        # always ends a measure with the "/ oXX" padding part. Model-
        # generated or truncated text may omit it — stripping then silently
        # empties the measure's LAST REAL part, so only strip when the
        # padding part was actually detected. Identical on codec output.
        measures_parts = [
            mp[:-1] if pad is not None else mp
            for mp, pad in zip(measures_parts, padding_parts)
        ]

        parts = [Part() for _ in range(n_parts)]
        current_ts: list[Optional[TimeSig]] = [None] * max(n_parts, 1)
        n_invalid = 0
        for measure_parts, padding_part, pre_tokens in zip(
            measures_parts, padding_parts, pre_measures_tokens
        ):
            added = [False] * n_parts
            for measure_part in measure_parts:
                try:
                    part_index = int(measure_part.split()[0][1:])
                except (ValueError, IndexError) as e:
                    logger.warning(
                        f"Got measure_part with invalid part_index {measure_part}: {e}"
                    )
                    continue
                measure, bad = self.parse_single_measure_part(measure_part)
                n_invalid += bad
                if measure.time_sig is not None:
                    current_ts[part_index] = measure.time_sig
                ts = current_ts[part_index]
                if ts is not None:
                    measure.bar_duration = ts.bar_duration
                    measure.real_duration = ts.bar_duration
                self._apply_padding_and_repeats(measure, padding_part, pre_tokens)
                parts[part_index].measures.append(measure)
                added[part_index] = True
            for p_idx, part in enumerate(parts):
                if not added[p_idx]:
                    measure = Measure()
                    ts = current_ts[p_idx]
                    if ts is not None:
                        measure.bar_duration = ts.bar_duration
                        measure.real_duration = ts.bar_duration
                    self._apply_padding_and_repeats(measure, padding_part, pre_tokens)
                    part.measures.append(measure)
        if n_invalid > 0:
            logger.warning(f"Got total of {n_invalid} invalid tokens")
        return Score(parts)

    def _apply_padding_and_repeats(
        self, measure: Measure, padding_part: Optional[str], pre_tokens: str
    ) -> None:
        if padding_part is not None:
            bar_offset: Optional[int] = None
            for token in padding_part.split():
                if token.startswith("o"):
                    try:
                        bar_offset = int(token[1:])
                    except ValueError:
                        pass
                elif token == self.repeat_end:
                    measure.right_repeat = True
            if bar_offset is not None:
                measure.padding_left = max(
                    Fraction(0),
                    measure.bar_duration - self.int_enc_to_quarterLength(bar_offset),
                )
                measure.real_duration = measure.bar_duration - measure.padding_left
        if self.repeat_start in pre_tokens.split():
            measure.left_repeat = True

    def parse_single_measure_part(self, measure_part: str) -> tuple[Measure, int]:
        if self.settings.include_offset_in_notes:
            return self.parse_single_measure_part_with_notes_offsets(measure_part)
        return self.parse_single_measure_part_without_notes_offsets(measure_part)

    def _parse_signature_token(self, token: str, measure: Measure) -> bool:
        if token.startswith("clef"):
            try:
                _, sign, line, octave_change = token.split("_")
                measure.clef = Clef(sign, int(line), int(octave_change))
            except ValueError:
                logger.warning(f"Got invalid clef token {token}")
            return True
        if token.startswith("key_signature"):
            try:
                measure.key_sig = KeySig(int(token.split("_")[-1]))
            except ValueError:
                logger.warning(f"Got invalid key_signature token {token}")
            return True
        if token.startswith("time_signature"):
            try:
                num, den = token.split("_")[-1].split("/", maxsplit=1)
                measure.time_sig = TimeSig(int(num), int(den))
                measure.bar_duration = measure.time_sig.bar_duration
                measure.real_duration = measure.bar_duration
            except ValueError:
                logger.warning(f"Got invalid time_signature token {token}")
            return True
        return False

    def parse_single_measure_part_with_notes_offsets(
        self, measure_part: str
    ) -> tuple[Measure, int]:
        """Offset-mode parser (ref :652-722): o sets position, p accumulates
        pitches, d flushes a Note/Chord/Rest insert; rest => pitch sentinel 0."""
        n_invalid = 0
        measure = Measure()
        offset: Optional[int] = None
        pitches: Optional[list[int]] = None
        for token in measure_part.split()[1:]:
            if self._parse_signature_token(token, measure):
                continue
            if token.startswith("o"):
                if pitches is not None:
                    logger.warning(f"Got invalid offset token {token} in measure {measure_part}")
                try:
                    offset = int(token[1:])
                except ValueError:
                    n_invalid += 1
                    continue
                pitches = None
            elif token.startswith("p"):
                if pitches is None:
                    pitches = []
                try:
                    pitches.append(int(token[1:]))
                except ValueError:
                    n_invalid += 1
                    continue
                if offset is None:
                    n_invalid += 1
                    logger.warning(f"Got invalid pitch token {token} in measure {measure_part}")
            elif token.startswith("d"):
                try:
                    duration = int(token[1:])
                except ValueError:
                    n_invalid += 1
                    continue
                if offset is None or pitches is None:
                    n_invalid += 1
                    logger.warning(f"Got invalid duration token {token} in measure {measure_part}")
                else:
                    real_pitches = tuple(p for p in pitches if p > 0)
                    measure.notes.append(
                        NoteEl(
                            offset=self.int_enc_to_quarterLength(offset),
                            quarter_length=self.int_enc_to_quarterLength(duration),
                            pitches=real_pitches,
                        )
                    )
                    pitches = None
            elif token == self.rest:
                pitches = [0]
                if offset is None:
                    n_invalid += 1
                    logger.warning(f"Got invalid rest token {token} in measure {measure_part}")
            else:
                logger.warning(f"Got unexpected token {token}")
        return measure, n_invalid

    def parse_single_measure_part_without_notes_offsets(
        self, measure_part: str
    ) -> tuple[Measure, int]:
        """No-offset-mode parser (ref :724-782): positions accumulate from
        consecutive durations."""
        n_invalid = 0
        measure = Measure()
        cursor = Fraction(0)
        pitches: Optional[list[int]] = None
        for token in measure_part.split()[1:]:
            if self._parse_signature_token(token, measure):
                continue
            if token.startswith("p"):
                if pitches is None:
                    pitches = []
                try:
                    pitches.append(int(token[1:]))
                except ValueError:
                    n_invalid += 1
            elif token.startswith("d"):
                try:
                    duration = int(token[1:])
                except ValueError:
                    n_invalid += 1
                    continue
                if pitches is None:
                    n_invalid += 1
                    logger.warning(f"Got invalid duration token {token} in measure {measure_part}")
                else:
                    ql = self.int_enc_to_quarterLength(duration)
                    real_pitches = tuple(p for p in pitches if p > 0)
                    measure.notes.append(
                        NoteEl(offset=cursor, quarter_length=ql, pitches=real_pitches)
                    )
                    pitches = None
                    cursor += ql
            elif token == self.rest:
                pitches = [0]
            else:
                logger.warning(f"Got unexpected token {token}")
        return measure, n_invalid


# ---------------------------------------------------------------------------
# score transforms


def _transpose(score: Score, semitones: int) -> Score:
    import copy

    out = copy.deepcopy(score)
    for part in out.parts:
        for measure in part.measures:
            for note in measure.notes:
                note.pitches = tuple(p + semitones for p in note.pitches)
    return out


def expand_repeats(score: Score) -> Score:
    """Expand |: ... :| repeat sections by duplication (music21
    ``expandRepeats`` equivalent for the simple one-level case)."""
    import copy

    out = Score()
    for part in score.parts:
        new_part = Part(name=part.name, program=part.program, channel=part.channel)
        section: list[Measure] = []
        in_repeat = False
        for measure in part.measures:
            if measure.left_repeat:
                in_repeat = True
                section = []
            if in_repeat:
                section.append(measure)
                if measure.right_repeat:
                    for m in section + section:
                        m2 = copy.deepcopy(m)
                        m2.left_repeat = m2.right_repeat = False
                        new_part.measures.append(m2)
                    in_repeat = False
                    section = []
            else:
                new_part.measures.append(copy.deepcopy(measure))
        # unclosed repeat: emit once
        for m in section:
            new_part.measures.append(copy.deepcopy(m))
        out.parts.append(new_part)
    return out
