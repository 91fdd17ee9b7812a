"""music21 oracle adapter — alternative converter + host-side test oracle.

The port's copy of ``ai_music_generation_tpu/abcnotation/music21_oracle.py``
(the port imports nothing of the JAX package;
tests/test_torch_host_copies.py holds the two to each other).

The reference eval pipeline can route ABC->MIDI through music21 instead of
abc2midi (ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:117-121:
``score = music21.converter.parse(...); score.write("midi", fp=...)``), and
SURVEY §7 prescribes keeping music21 as a host-side oracle for codec/parser
semantics. music21 is NOT installed in this environment; every entry point
here degrades cleanly (``have_music21()`` gate, ``Music21Missing`` error),
and the differential tests skip when it is absent
(tests/test_music21_oracle.py).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional


class Music21Missing(RuntimeError):
    """Raised when a music21-backed path is requested but music21 is absent."""


def have_music21() -> bool:
    try:
        import music21  # noqa: F401

        return True
    except ImportError:
        return False


def _m21():
    try:
        import music21

        return music21
    except ImportError as e:
        raise Music21Missing(
            "abc_to_midi_converter='music21' requires the music21 package "
            "(not installed in this environment); use 'builtin' instead"
        ) from e


def abc_file_to_midi_file_music21(abc_path: str, midi_path: str) -> None:
    """ABC file -> MIDI file via music21, byte-for-byte the reference recipe
    (ref: abc_to_midi_wav_and_aesthetics.py:119-121)."""
    m21 = _m21()
    score = m21.converter.parse(abc_path)
    score.write("midi", fp=midi_path)


def abc_note_events(abc_text: str) -> list[tuple[Fraction, int, Fraction]]:
    """Oracle note-event stream for an ABC tune: sorted
    (offset_quarterLength, midi_pitch, duration_quarterLength) triples,
    chords expanded, rests dropped — directly comparable to
    ``AbcParser().parse(...).notes``."""
    m21 = _m21()
    score = m21.converter.parse(abc_text, format="abc")
    out = []
    for el in score.flatten().notes:
        off = Fraction(el.offset).limit_denominator(1 << 16)
        dur = Fraction(el.duration.quarterLength).limit_denominator(1 << 16)
        pitches = el.pitches if hasattr(el, "pitches") else [el.pitch]
        for p in pitches:
            out.append((off, int(p.midi), dur))
    return sorted(out)


def midi_note_events(midi_path: str) -> list[tuple[Fraction, int, Fraction]]:
    """Oracle note-event stream for a MIDI file via music21 — comparable to
    ``codec.midi_io.parse_midi_file`` output in quarter lengths."""
    m21 = _m21()
    score = m21.converter.parse(midi_path)
    out = []
    for el in score.flatten().notes:
        off = Fraction(el.offset).limit_denominator(1 << 16)
        dur = Fraction(el.duration.quarterLength).limit_denominator(1 << 16)
        for p in (el.pitches if hasattr(el, "pitches") else [el.pitch]):
            out.append((off, int(p.midi), dur))
    return sorted(out)


def parser_note_events(abc_text: str) -> list[tuple[Fraction, int, Fraction]]:
    """The in-repo parser's events in the same normal form as the oracle's."""
    from ai_music_generation_tpu_torch.abcnotation.parser import AbcParser

    tune = AbcParser().parse(abc_text)
    return sorted(
        (n.start, n.pitch, n.duration) for n in tune.notes if not n.is_rest
    )
