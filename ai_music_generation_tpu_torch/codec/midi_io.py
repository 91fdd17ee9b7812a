"""Standard MIDI File (SMF) reader/writer — clean-room, dependency-free.

The port's copy of ``ai_music_generation_tpu/codec/midi_io.py`` (the port
imports nothing of the JAX package; tests/test_torch_host_copies.py holds
the two to each other).

Replaces the music21 MIDI parsing layer the reference relies on
(ref: core/encodings/quantized_converter.py:180 ``music21.converter.parseFile``)
with a minimal host-side implementation covering the corpus feature set:
note on/off, program change, set-tempo, time signature, key signature,
track names. Format 0 and 1 files are supported.

All times are absolute ticks; ``ticks_per_quarter`` converts to quarter
lengths for the score layer (codec/score.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional


@dataclasses.dataclass
class MidiNote:
    pitch: int
    velocity: int
    start_tick: int
    end_tick: int
    channel: int
    track: int

    def duration_ticks(self) -> int:
        return self.end_tick - self.start_tick


@dataclasses.dataclass
class TempoEvent:
    tick: int
    microseconds_per_quarter: int

    @property
    def bpm(self) -> float:
        return 60_000_000 / self.microseconds_per_quarter


@dataclasses.dataclass
class TimeSignatureEvent:
    tick: int
    numerator: int
    denominator: int


@dataclasses.dataclass
class KeySignatureEvent:
    tick: int
    sharps: int  # -7..7
    minor: bool = False


@dataclasses.dataclass
class TrackInfo:
    index: int
    name: str = ""
    program: Optional[int] = None  # first program change seen
    channel: Optional[int] = None  # first channel seen
    notes: list[MidiNote] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MidiFile:
    ticks_per_quarter: int
    tracks: list[TrackInfo]
    tempos: list[TempoEvent]
    time_signatures: list[TimeSignatureEvent]
    key_signatures: list[KeySignatureEvent]

    @property
    def notes(self) -> list[MidiNote]:
        return [n for t in self.tracks for n in t.notes]


# ---------------------------------------------------------------------------
# parsing


def _read_varlen(data: bytes, i: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, i


def parse_midi_bytes(data: bytes) -> MidiFile:
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    header_len = int.from_bytes(data[4:8], "big")
    fmt = int.from_bytes(data[8:10], "big")
    n_tracks = int.from_bytes(data[10:12], "big")
    division = int.from_bytes(data[12:14], "big")
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    pos = 8 + header_len

    tracks: list[TrackInfo] = []
    tempos: list[TempoEvent] = []
    tsigs: list[TimeSignatureEvent] = []
    ksigs: list[KeySignatureEvent] = []

    for t in range(n_tracks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError(f"track {t}: missing MTrk chunk")
        length = int.from_bytes(data[pos + 4 : pos + 8], "big")
        body = data[pos + 8 : pos + 8 + length]
        pos += 8 + length

        info = TrackInfo(index=t)
        open_notes: dict[tuple[int, int], MidiNote] = {}
        tick = 0
        i = 0
        running_status = 0
        while i < len(body):
            delta, i = _read_varlen(body, i)
            tick += delta
            status = body[i]
            if status & 0x80:
                i += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status

            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90:  # note on
                pitch, vel = body[i], body[i + 1]
                i += 2
                if vel > 0:
                    note = MidiNote(pitch, vel, tick, tick, channel, t)
                    # replace any unclosed same-pitch note
                    key = (channel, pitch)
                    if key in open_notes:
                        open_notes[key].end_tick = tick
                        info.notes.append(open_notes.pop(key))
                    open_notes[key] = note
                    if info.channel is None:
                        info.channel = channel
                else:  # velocity-0 note on == note off
                    key = (channel, pitch)
                    if key in open_notes:
                        open_notes[key].end_tick = tick
                        info.notes.append(open_notes.pop(key))
            elif kind == 0x80:  # note off
                pitch = body[i]
                i += 2
                key = (channel, pitch)
                if key in open_notes:
                    open_notes[key].end_tick = tick
                    info.notes.append(open_notes.pop(key))
            elif kind == 0xC0:  # program change
                program = body[i]
                i += 1
                if info.program is None:
                    info.program = program
            elif kind in (0xA0, 0xB0, 0xE0):  # aftertouch / CC / pitch bend
                i += 2
            elif kind == 0xD0:  # channel pressure
                i += 1
            elif status == 0xFF:  # meta
                meta_type = body[i]
                i += 1
                mlen, i = _read_varlen(body, i)
                payload = body[i : i + mlen]
                i += mlen
                if meta_type == 0x51:
                    tempos.append(TempoEvent(tick, int.from_bytes(payload, "big")))
                elif meta_type == 0x58 and mlen >= 2:
                    tsigs.append(TimeSignatureEvent(tick, payload[0], 2 ** payload[1]))
                elif meta_type == 0x59 and mlen >= 2:
                    sharps = int.from_bytes(payload[0:1], "big", signed=True)
                    ksigs.append(KeySignatureEvent(tick, sharps, bool(payload[1])))
                elif meta_type == 0x03:
                    info.name = payload.decode("latin-1", errors="replace")
            elif status in (0xF0, 0xF7):  # sysex
                slen, i = _read_varlen(body, i)
                i += slen
            else:
                raise ValueError(f"unhandled MIDI status byte 0x{status:02x}")
        # close any dangling notes at end of track
        for note in open_notes.values():
            note.end_tick = tick
            info.notes.append(note)
        info.notes.sort(key=lambda n: (n.start_tick, n.pitch))
        tracks.append(info)

    tempos.sort(key=lambda e: e.tick)
    tsigs.sort(key=lambda e: e.tick)
    ksigs.sort(key=lambda e: e.tick)
    return MidiFile(division, tracks, tempos, tsigs, ksigs)


def parse_midi_file(path) -> MidiFile:
    with open(path, "rb") as f:
        return parse_midi_bytes(f.read())


# ---------------------------------------------------------------------------
# writing


def _varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _meta(tick_delta: int, meta_type: int, payload: bytes) -> bytes:
    return _varlen(tick_delta) + bytes([0xFF, meta_type]) + _varlen(len(payload)) + payload


def write_midi_bytes(
    midi: MidiFile,
    default_tempo_bpm: float = 120.0,
) -> bytes:
    """Serialize to SMF format 1 (track 0 = conductor)."""
    tpq = midi.ticks_per_quarter

    # conductor track: tempo + time/key signatures
    events: list[tuple[int, int, bytes]] = []  # (tick, order, payload)
    tempos = midi.tempos or [TempoEvent(0, int(60_000_000 / default_tempo_bpm))]
    for e in tempos:
        events.append((e.tick, 0, bytes([0xFF, 0x51, 3]) + e.microseconds_per_quarter.to_bytes(3, "big")))
    for ts in midi.time_signatures:
        denom_pow = max(0, ts.denominator.bit_length() - 1)
        events.append((ts.tick, 1, bytes([0xFF, 0x58, 4, ts.numerator, denom_pow, 24, 8])))
    for ks in midi.key_signatures:
        events.append((ks.tick, 2, bytes([0xFF, 0x59, 2, ks.sharps & 0xFF, int(ks.minor)])))
    events.sort(key=lambda e: (e[0], e[1]))
    body = b""
    last = 0
    for tick, _, payload in events:
        body += _varlen(tick - last) + payload
        last = tick
    body += _meta(0, 0x2F, b"")
    chunks = [b"MTrk" + len(body).to_bytes(4, "big") + body]

    for info in midi.tracks:
        tev: list[tuple[int, int, bytes]] = []
        channel = info.channel if info.channel is not None else 0
        if info.name:
            tev.append((0, 0, bytes([0xFF, 0x03]) + _varlen(len(info.name)) + info.name.encode("latin-1")))
        if info.program is not None:
            tev.append((0, 1, bytes([0xC0 | channel, info.program])))
        for n in info.notes:
            ch = n.channel if n.channel is not None else channel
            tev.append((n.start_tick, 2, bytes([0x90 | ch, n.pitch, n.velocity or 64])))
            tev.append((n.end_tick, 2, bytes([0x80 | ch, n.pitch, 0])))
        tev.sort(key=lambda e: (e[0], e[1]))
        body = b""
        last = 0
        for tick, _, payload in tev:
            body += _varlen(tick - last) + payload
            last = tick
        body += _meta(0, 0x2F, b"")
        chunks.append(b"MTrk" + len(body).to_bytes(4, "big") + body)

    header = b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
    header += len(chunks).to_bytes(2, "big") + tpq.to_bytes(2, "big")
    return header + b"".join(chunks)


def write_midi_file(midi: MidiFile, path) -> None:
    with open(path, "wb") as f:
        f.write(write_midi_bytes(midi))
