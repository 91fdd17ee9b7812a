"""GM program-number taxonomy (parity: core/pydantic_models/instrument_types.py:5-21).

The port's copy of ``ai_music_generation_tpu/codec/instrument_types.py``
(the port imports nothing of the JAX package;
tests/test_torch_host_copies.py holds the two to each other).
"""

from enum import Enum


class InstrumentTypes(Enum):
    PIANO = range(0, 8)
    CHROMATIC_PERCUSSION = range(8, 16)
    ORGAN = range(16, 24)
    GUITAR = range(24, 32)
    BASS = range(32, 40)
    STRINGS = range(40, 48)
    ENSEMBLE = range(48, 56)
    BRASS = range(56, 64)
    REED = range(64, 72)
    PIPE = range(72, 80)
    SYNTH_LEAD = range(80, 88)
    SYNTH_PAD = range(88, 96)
    SYNTH_EFFECTS = range(96, 104)
    ETHNIC = range(104, 112)
    PERCUSSIVE = range(112, 120)
    SOUND_EFFECTS = range(120, 128)
