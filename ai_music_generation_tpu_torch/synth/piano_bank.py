"""Embedded multi-sample piano bank for the sample-bank synth voice.

The port's copy of ``ai_music_generation_tpu/synth/piano_bank.py`` (the port
imports nothing of the JAX package; tests/test_torch_host_copies.py holds
the two to each other).

The reference renders with FluidSynth + "Essential Keys-sforzando-v9.6.sf2"
(ref: scripts/common/midi_to_wav_and_aesthetics.py:105-110, README.md:18-25).
No soundfont ships with this environment, so the bank is SYNTHESIZED once
per process from a physical piano model that the realtime additive voice
cannot afford per note:

- inharmonic partial series f_n = n*f0*sqrt(1 + B*n^2) with a register-
  dependent stiffness coefficient B (bass strings less stiff than treble);
- PER-PARTIAL decay rates (high partials die faster — the single shared
  envelope is the audible weakness of the additive voice);
- two slightly detuned unison strings per note -> slow amplitude beating;
- a filtered hammer-noise transient in the first ~20 ms;
- velocity handled at playback (amplitude + spectral tilt is baked per
  sample layer here only through the partial rolloff).

One sample every ``BANK_STEP`` semitones across the piano range; playback
pitch-shifts to the nearest sample with a linear-interpolation gather
(synth/render.py). Total bank ~3 MB fp32 — it lives on the device, built
once per (voice, sample rate).
"""

from __future__ import annotations

import numpy as np

BANK_LO = 21  # A0
BANK_HI = 108  # C8
BANK_STEP = 6  # one sample per tritone -> max shift +-3 semitones
BANK_SECONDS = 3.0

_cache: dict = {}


def bank_pitches() -> np.ndarray:
    return np.arange(BANK_LO, BANK_HI + 1, BANK_STEP, dtype=np.float32)


def _one_sample(pitch: int, sample_rate: int, seconds: float,
                rng: np.random.Generator) -> np.ndarray:
    f0 = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
    n = int(seconds * sample_rate)
    t = np.arange(n, dtype=np.float64) / sample_rate

    # stiffness: bass ~1e-4 rising toward treble ~3e-3 (piano-typical range)
    B = 1e-4 * (f0 / 27.5) ** 0.6
    max_partial = int(min(24, (sample_rate / 2) / f0))
    wave = np.zeros(n)
    # base decay: bass notes ring seconds, treble fractions of a second
    tau0 = 4.0 * (27.5 / f0) ** 0.35
    detune = 0.0007  # unison string detuning -> beating
    for k in range(1, max(2, max_partial + 1)):
        f_k = k * f0 * np.sqrt(1.0 + B * k * k)
        if f_k >= sample_rate / 2:
            break
        amp = k ** -1.3 * np.exp(-f_k / 6500.0)  # rolloff + soft lowpass
        tau_k = tau0 / (1.0 + 0.6 * (k - 1))
        env = np.exp(-t / tau_k)
        wave += amp * env * (
            np.sin(2 * np.pi * f_k * (1 + detune) * t)
            + np.sin(2 * np.pi * f_k * (1 - detune) * t)
        )
    # hammer transient: 20 ms of lowpassed noise shaped by a fast decay
    h_len = int(0.02 * sample_rate)
    noise = rng.normal(0.0, 1.0, h_len)
    kernel = np.exp(-np.arange(24) / 6.0)
    noise = np.convolve(noise, kernel / kernel.sum(), mode="same")
    wave[:h_len] += 0.6 * noise * np.exp(-np.arange(h_len) / (0.004 * sample_rate))
    # 2 ms attack ramp removes the onset click
    a_len = int(0.002 * sample_rate)
    wave[:a_len] *= np.linspace(0.0, 1.0, a_len)
    peak = np.max(np.abs(wave)) or 1.0
    return (0.9 * wave / peak).astype(np.float32)


def get_bank(sample_rate: int = 16_000,
             seconds: float = BANK_SECONDS) -> tuple[np.ndarray, np.ndarray]:
    """(samples [K, L] float32, pitches [K] float32), built once per process.

    Deterministic: the hammer noise uses a fixed seed so renders are
    reproducible across processes (golden-generation test discipline)."""
    key = (sample_rate, seconds)
    if key not in _cache:
        pitches = bank_pitches()
        rng = np.random.default_rng(2024)
        samples = np.stack(
            [_one_sample(int(p), sample_rate, seconds, rng) for p in pitches]
        )
        _cache[key] = (samples, pitches)
    return _cache[key]
