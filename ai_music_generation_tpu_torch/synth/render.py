"""Audio synthesis on the card: MIDI note events -> PCM waveform.

The port of ``ai_music_generation_tpu/synth/render.py``, the eval
pipeline's renderer (it replaces the reference's FluidSynth/Timidity,
ref: scripts/common/midi_to_wav_and_aesthetics.py:100-110):

- note events become a float32 tensor [N, 4] (pitch, start_sample,
  dur_samples, velocity), built on the host (:func:`midi_to_events`);
- each note renders a bounded-length (``MAX_NOTE_SECONDS``) enveloped
  segment: a pitch-shifted gather from a sample bank (the embedded piano
  bank or an ``.sf2`` file's zones) or the additive harmonic-stack voice;
- the segments are added into the output buffer one note after another,
  in event order, as JAX's ``lax.scan`` adds them. Each add reads the
  note's window and writes it back (no atomics), so the sum's bits repeat
  from run to run and the peak and the trim index never wander;
- the result is peak-normalized, then end-silence trimmed (the sox
  silence-trim replacement, ref: midi_to_wav_and_aesthetics.py:113-132).

Segments are built for chunks of notes at a time (``SEGMENT_ELEMENTS``
bounds one chunk's [rows, notes, samples] tensor), which bounds the memory
of a batch whatever its note count. XLA's one-compile-per-shape devices
(``EVENT_PAD``, ``_event_bucket``, ``_pad_events``) are not ported: they
only add silent events. The render length ``total`` is kept exactly: it
decides which notes the start clip pulls to the last sample and the peak
that normalises the wave.

Every entry point runs on the card unless the caller passes
``device="cpu"``; a CUDA device without a card raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16_000
MAX_NOTE_SECONDS = 4.0
N_HARMONICS = 12
CANONICAL_SECONDS = 128  # the render length JAX's batch path uses
# elements of one chunk of note segments [rows, notes, max_note]: 128 MiB
# of fp32 a tensor (8 rows x 65 notes at 16 kHz); the chunk's temporaries
# are a dozen such tensors
SEGMENT_ELEMENTS = 1 << 25

_banks: dict = {}


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant divisor: XLA compiles ``x / c``
    for a constant ``c`` as ``x * (1 / c)`` (its algebraic simplifier), so
    the JAX render multiplies by it, and so does the port."""
    return float(np.float32(1.0) / np.float32(c))


def midi_to_events(midi: midi_io.MidiFile, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """MidiFile -> float32 [N, 4]: (midi_pitch, start_sample, dur_samples, velocity01).

    Tempo map applied (piecewise-constant tempo; ref corpora use one tempo).
    """
    tpq = midi.ticks_per_quarter
    tempos = midi.tempos or [midi_io.TempoEvent(0, 500000)]
    # piecewise tick -> seconds conversion
    marks = []  # (tick, seconds_at_tick, sec_per_tick)
    t_sec = 0.0
    prev_tick = 0
    prev_spt = tempos[0].microseconds_per_quarter / 1e6 / tpq
    marks.append((0, 0.0, prev_spt))
    for ev in tempos[1:]:
        t_sec += (ev.tick - prev_tick) * prev_spt
        prev_tick = ev.tick
        prev_spt = ev.microseconds_per_quarter / 1e6 / tpq
        marks.append((ev.tick, t_sec, prev_spt))

    def tick_to_sec(tick: int) -> float:
        for mtick, msec, spt in reversed(marks):
            if tick >= mtick:
                return msec + (tick - mtick) * spt
        return tick * marks[0][2]

    events = []
    for n in midi.notes:
        start = tick_to_sec(n.start_tick)
        end = tick_to_sec(n.end_tick)
        events.append(
            (float(n.pitch), start * sample_rate, max((end - start), 0.01) * sample_rate,
             (n.velocity or 64) / 127.0)
        )
    if not events:
        return np.zeros((0, 4), np.float32)
    return np.asarray(events, np.float32)


def _voice_bank(voice: str, sample_rate: int):
    """Resolve a sample-bank voice string to host arrays.

    ``"sample_bank"`` -> the embedded piano bank (synth/piano_bank.py) with
    full key/velocity ranges and the measured 80 ms piano release;
    ``"sf2:<path>"`` -> zones parsed from a SoundFont file (synth/sf2.py),
    honoring key/velocity ranges, tuning, loops, envelopes (the equivalent
    of FluidSynth loading the reference's .sf2,
    ref: midi_to_wav_and_aesthetics.py:105-110).

    Returns (samples [K, Lb], root_pitch [K], key_ranges [K, 2],
    vel_ranges [K, 2], release_tau [K], tail_cut [K]).
    """
    if voice.startswith("sf2:"):
        from ai_music_generation_tpu_torch.synth.sf2 import bank_from_sf2

        samples, pitches, keyr, velr, rel = bank_from_sf2(voice[4:], sample_rate)
        return (samples, pitches, keyr, velr, rel,
                np.minimum(4.0 * rel, 1.5).astype(np.float32))
    from ai_music_generation_tpu_torch.synth.piano_bank import get_bank

    bank_np, pitches_np = get_bank(sample_rate)
    k = len(pitches_np)
    full = np.tile(np.asarray([[0.0, 127.0]], np.float32), (k, 1))
    return (bank_np, pitches_np, full, full.copy(),
            np.full((k,), 0.08, np.float32),
            np.full((k,), 0.35, np.float32))


def _device_bank(voice: str, sample_rate: int, device: torch.device):
    """:func:`_voice_bank` as float32 tensors on ``device``, built once per
    (voice, sample_rate, device)."""
    key = (voice, sample_rate, str(device))
    if key not in _banks:
        _banks[key] = tuple(
            torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in _voice_bank(voice, sample_rate))
    return _banks[key]


def _pow2(x: torch.Tensor) -> torch.Tensor:
    """2 ** x in float64, rounded to float32: a per-note scalar whose bits
    do not depend on where the note sits in the batch (the CPU's vector and
    scalar fp32 ``pow`` differ by an ulp); on every integer semitone offset
    it equals XLA's fp32 ``pow`` (tests/test_torch_synth.py)."""
    return torch.pow(2.0, x.double()).float()


def _zones(pitch, vel, root, key_r, vel_r):
    """Each note's zone: the nearest root among zones whose key AND
    velocity ranges match; out-of-range zones only as fallback. argmin
    takes the first index on ties, as jnp.argmin does."""
    p = pitch[..., None]
    vel127 = (vel * 127.0)[..., None]
    key_miss = (p < key_r[:, 0]) | (p > key_r[:, 1])
    vel_miss = (vel127 < vel_r[:, 0]) | (vel127 > vel_r[:, 1])
    score = (root - p).abs() + 1e3 * key_miss + 1e3 * vel_miss
    return score.argmin(-1)


def _bank_segments(ev, t, bank, sample_rate):
    """[rows, notes, max_note] segments of the sample-bank voices: JAX's
    ``render_note`` over a chunk of notes, op for op."""
    samples, root, key_r, vel_r, rel, cut = bank
    pitch, dur_samples, vel = ev[..., 0], ev[..., 2], ev[..., 3]
    dur = (dur_samples * _recip(sample_rate))[..., None]
    k = _zones(pitch, vel, root, key_r, vel_r)
    rate = _pow2((pitch - root[k]) * _recip(12.0))
    bank_len = samples.shape[1]
    pos = torch.arange(t.shape[0], dtype=torch.float32,
                       device=t.device) * rate[..., None]
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.long()
    valid = i0 < bank_len - 1
    base = k[..., None] * bank_len + i0.clamp(0, bank_len - 2)
    flat = samples.view(-1)
    seg = flat[base] * (1.0 - frac) + flat[base + 1] * frac
    # damp at note-off with the zone's release time-constant
    release = torch.exp(-(t - dur).clamp_min(0.0) / rel[k][..., None])
    seg = seg * valid * release * (t < dur + cut[k][..., None])
    return vel[..., None] * seg


def _additive_segments(ev, t, sample_rate):
    """[rows, notes, max_note] segments of the additive voice: JAX's
    ``render_note``, op for op; the harmonic sum runs in fp32, harmonic
    by harmonic, and the phase keeps JAX's order ``(2 pi f_h) t``."""
    f32 = dict(dtype=torch.float32, device=t.device)
    pitch, dur_samples, vel = ev[..., 0], ev[..., 2], ev[..., 3]
    dur = (dur_samples * _recip(sample_rate))[..., None]
    freq = 440.0 * _pow2((pitch - 69.0) * _recip(12.0))
    # piano-ish envelope: 5 ms attack, exponential decay scaled by pitch,
    # release after note-off
    attack = torch.clamp_max(t * _recip(0.005), 1.0)
    decay_rate = 0.5 + freq * _recip(2000.0)  # higher notes decay faster
    decay = torch.exp(-decay_rate[..., None] * t)
    release = torch.exp(-(t - dur).clamp_min(0.0) * _recip(0.05))
    env = attack * decay * release
    env = env * (t < dur + 0.25)  # hard stop after release tail
    h = torch.arange(1, N_HARMONICS + 1, **f32)
    inharm = 1.0 + torch.tensor(0.0004, **f32) * h * h  # slight stiffness
    f_h = freq[..., None] * h * inharm  # [rows, notes, H]
    amp = h ** -1.7 * (f_h < sample_rate / 2)  # Nyquist guard
    w = torch.tensor(2.0 * math.pi, **f32) * f_h
    wave = torch.zeros_like(env)
    for j in range(N_HARMONICS):
        wave += torch.sin(w[..., j, None] * t) * amp[..., j, None]
    return vel[..., None] * env * wave


def render_events_batch(events, total_samples: int,
                        sample_rate: int = SAMPLE_RATE,
                        voice: str = "sample_bank",
                        device="cuda") -> torch.Tensor:
    """Render a batch of event tensors [N, E, 4] -> [N, total_samples]
    float32 on ``device``.

    ``voice``: ``"sample_bank"`` (default; pitch-shifted gather from the
    embedded multi-sample piano bank, see synth/piano_bank.py),
    ``"sf2:<path>"`` (zones from a SoundFont file, see synth/sf2.py), or
    ``"additive"`` (the harmonic-stack voice). Rows shorter than ``E`` are
    padded with velocity-0 events, which add exact zeros.
    """
    device = resolve_device(device)
    events = torch.as_tensor(events, dtype=torch.float32, device=device)
    n_rows, n_events = events.shape[0], events.shape[1]
    max_note = int(MAX_NOTE_SECONDS * sample_rate)
    t = torch.arange(max_note, dtype=torch.float32,
                     device=device) * _recip(sample_rate)
    bank = None if voice == "additive" else _device_bank(
        voice, sample_rate, device)
    # JAX: int32(start) (truncation), clipped to [0, total - 1]; clipping
    # the float first is the same and cannot overflow int32
    starts = events[..., 1].clamp(0, total_samples - 1).long()
    # the buffer is padded so a note near the end cannot overrun
    buf = torch.zeros((n_rows, total_samples + max_note), dtype=torch.float32,
                      device=device)
    cols = torch.arange(max_note, device=device)
    chunk = max(1, SEGMENT_ELEMENTS // max(1, n_rows * max_note))
    for lo in range(0, n_events, chunk):
        ev = events[:, lo:lo + chunk]
        segs = (_additive_segments(ev, t, sample_rate) if bank is None
                else _bank_segments(ev, t, bank, sample_rate))
        # add each note's window in event order: read, add, write back
        for j in range(ev.shape[1]):
            idx = starts[:, lo + j, None] + cols
            buf.scatter_(1, idx, buf.gather(1, idx) + segs[:, j])
        del segs
    out = buf[:, :total_samples]
    peak = torch.clamp_min(out.abs().amax(1, keepdim=True), 1e-6)
    return out * (0.9 / peak)


def render_events(events, total_samples: int,
                  sample_rate: int = SAMPLE_RATE,
                  voice: str = "sample_bank", device="cuda") -> torch.Tensor:
    """Render [N, 4] note events into a [total_samples] float32 waveform on
    ``device`` (one row of :func:`render_events_batch`)."""
    events = torch.as_tensor(events, dtype=torch.float32)
    return render_events_batch(events[None], total_samples, sample_rate,
                               voice, device)[0]


def trim_trailing_silence(wave: torch.Tensor, threshold: float = 1e-3,
                          pad_samples: int = 1600) -> torch.Tensor:
    """Index one past the last above-threshold sample (+pad), on the wave's
    device. Host slices.

    sox end-silence-trim equivalent (ref: midi_to_wav_and_aesthetics.py:113-132).
    """
    above = wave.abs() > threshold
    idx = torch.where(above, torch.arange(wave.shape[0], device=wave.device),
                      -1).amax()
    return torch.clamp_max(idx + 1 + pad_samples, wave.shape[0])


def synthesize_midi_batch(
    midis: list, sample_rate: int = SAMPLE_RATE,
    max_seconds: float = 120.0, trim: bool = True,
    voice: str = "sample_bank", mesh=None, device="cuda",
) -> list:
    """Render many MidiFiles in one device call.

    Returns a list of trimmed float32 waveforms (numpy), order-matched to
    ``midis``. The trim index is found on the device, and one copy brings
    the batch's samples up to its longest trimmed wave to the host.

    ``mesh``: a (data, model) ``DeviceMesh`` (``parallel/mesh.py::
    make_mesh``; JAX :242-285). A collective call: every rank passes the
    same ``midis``. The rows are padded to a multiple of the data-axis
    size, each data rank renders its share, and the waves, all ``total``
    samples long, come back to every rank in one gather; every rank
    returns the whole list. Each note's window is added in event order
    whatever the batch, so the waves are bit-equal to the unsharded
    render's.
    """
    all_events = [midi_to_events(m, sample_rate) for m in midis]
    total = int(min(CANONICAL_SECONDS, max_seconds) * sample_rate)
    needs = [
        min(float((ev[:, 1] + ev[:, 2]).max()) / sample_rate + 1.0, max_seconds)
        if len(ev) else 0.0
        for ev in all_events
    ]
    n_events = max((len(ev) for ev in all_events), default=0)
    if n_events == 0:
        return [np.zeros(0, np.float32) for _ in midis]
    n_rows = len(midis)
    if mesh is not None:
        from ai_music_generation_tpu_torch.parallel.mesh import Layout

        lay = Layout(mesh)
        n_rows = -(-n_rows // lay.n_data) * lay.n_data
    batch = np.zeros((n_rows, n_events, 4), np.float32)
    for i, ev in enumerate(all_events):
        batch[i, : len(ev)] = ev
    if mesh is None:
        waves = render_events_batch(batch, total, sample_rate, voice, device)
    else:
        mine = batch.reshape(lay.n_data, -1, n_events, 4)[lay.data_rank]
        local = render_events_batch(mine, total, sample_rate, voice, device)
        waves = local.new_empty((n_rows, total))
        dist.all_gather_into_tensor(waves, local.contiguous(),
                                    group=lay.data_group)
        waves = waves[:len(midis)]
    if trim:
        above = waves.abs() > 1e-3
        idx = torch.where(above, torch.arange(total, device=waves.device),
                          -1).amax(1).clamp_min(0)
        ends = (idx + 1 + 1600).clamp_max(total).tolist()
    else:
        ends = [total] * len(midis)
    ends = [min(end, int(need * sample_rate)) for end, need in zip(ends, needs)]
    host = waves[:, : max(ends)].cpu().numpy()
    return [host[i, :end] if needs[i] else np.zeros(0, np.float32)
            for i, end in enumerate(ends)]


def synthesize_midi(midi: midi_io.MidiFile, sample_rate: int = SAMPLE_RATE,
                    max_seconds: float = 120.0, trim: bool = True,
                    voice: str = "sample_bank", device="cuda") -> np.ndarray:
    """Host convenience: MidiFile -> trimmed float32 waveform (numpy).

    The render length is JAX's: ``CANONICAL_SECONDS``, doubled while the
    piece needs more, capped at ``max_seconds``.
    """
    events = midi_to_events(midi, sample_rate)
    if len(events) == 0:
        return np.zeros(0, np.float32)
    need = float((events[:, 1] + events[:, 2]).max()) / sample_rate + 1.0
    need = min(need, max_seconds)
    # canonical length, doubling only for unusually long pieces
    seconds = CANONICAL_SECONDS
    while seconds < need:
        seconds *= 2
    total = int(min(seconds, max_seconds) * sample_rate)
    wave = render_events(events, total, sample_rate, voice, device)
    if trim:
        end = int(trim_trailing_silence(wave))
        wave = wave[:min(end, int(need * sample_rate))]
    return wave.cpu().numpy()
