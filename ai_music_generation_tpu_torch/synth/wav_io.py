"""WAV file I/O (16-bit PCM mono), stdlib-only.

The port's copy of ``ai_music_generation_tpu/synth/wav_io.py`` (the port
imports nothing of the JAX package; tests/test_torch_host_copies.py holds
the two to each other).
"""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path, samples: np.ndarray, sample_rate: int = 16_000) -> None:
    """Atomic write: temp file + os.replace, so parallel pipeline workers
    never observe torn files (the reference's sox temp+replace pattern,
    ref: midi_to_wav_and_aesthetics.py:119-132)."""
    import os
    import tempfile

    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    directory = os.path.dirname(os.path.abspath(str(path))) or "."
    fd, tmp_path = tempfile.mkstemp(dir=directory, suffix=".wav")
    try:
        os.close(fd)
        with wave.open(tmp_path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm16.tobytes())
        os.replace(tmp_path, str(path))
    finally:
        if os.path.exists(tmp_path):
            try:
                os.unlink(tmp_path)
            except OSError:
                pass


def read_wav(path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 127.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate
