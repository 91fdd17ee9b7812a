"""ABC -> MIDI conversion (the abc2midi replacement's output stage).

The port's copy of ``ai_music_generation_tpu/abcnotation/to_midi.py`` (the
port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds the two to each other).

Usage parity with the reference's subprocess calls
(ref: scripts/irishman_sripts/irishman_dataset_to_midi.py:55):

    abc_text -> AbcParser -> MidiFile -> .mid

One MIDI track per ABC voice; tempo from Q: (default 120 qpm); time/key
signature meta events from M:/K:.
"""

from __future__ import annotations

from fractions import Fraction

from ai_music_generation_tpu_torch.abcnotation.parser import AbcParser, AbcTune
from ai_music_generation_tpu_torch.codec import midi_io


def tune_to_midi(tune: AbcTune, ticks_per_quarter: int = 480,
                 velocity: int = 105, program: int = 0,
                 accomp_program: int = 24,
                 accomp_velocity: int = 80) -> midi_io.MidiFile:
    tpq = ticks_per_quarter
    n_voices = max(tune.n_voices, 1 + max((n.voice for n in tune.notes), default=0))
    # melodic channels only: skip GM percussion channel 9 without collisions
    melodic_channels = [c for c in range(16) if c != 9]
    tracks = [
        midi_io.TrackInfo(
            index=v + 1,
            name="gchord" if v == tune.accomp_voice else f"Voice {v + 1}",
            # generated accompaniment: nylon guitar, quieter (gchord-style)
            program=accomp_program if v == tune.accomp_voice else program,
            channel=melodic_channels[v % len(melodic_channels)],
        )
        for v in range(n_voices)
    ]
    for note in tune.notes:
        if note.is_rest:
            continue
        start = int(note.start * tpq)
        end = int((note.start + note.duration) * tpq)
        if end <= start:
            end = start + 1
        tr = tracks[note.voice]
        vel = accomp_velocity if note.voice == tune.accomp_voice else velocity
        tr.notes.append(
            midi_io.MidiNote(note.pitch, vel, start, end, tr.channel or 0, note.voice + 1)
        )
    for tr in tracks:
        tr.notes.sort(key=lambda n: (n.start_tick, n.pitch))
    return midi_io.MidiFile(
        ticks_per_quarter=tpq,
        tracks=[t for t in tracks if t.notes],
        tempos=[midi_io.TempoEvent(0, int(60_000_000 / tune.tempo_bpm))],
        time_signatures=[midi_io.TimeSignatureEvent(0, tune.meter[0], tune.meter[1])],
        key_signatures=[midi_io.KeySignatureEvent(0, tune.sharps)],
    )


def abc_to_midi(abc_text: str, prefer_native: bool = True,
                gchord: bool = False, **kwargs) -> midi_io.MidiFile:
    """Compile ABC text to MIDI, using the C++ compiler when built
    (differentially tested against the Python parser). ``gchord=True``
    renders chord-symbol accompaniment (abc2midi's gchord engine)."""
    from ai_music_generation_tpu_torch.abcnotation.native import get_parser

    parser = get_parser(prefer_native, gchord=gchord)
    return tune_to_midi(parser.parse(abc_text), **kwargs)


def abc_file_to_midi_file(abc_path, midi_path, **kwargs) -> None:
    with open(abc_path) as f:
        midi = abc_to_midi(f.read(), **kwargs)
    midi_io.write_midi_file(midi, midi_path)
