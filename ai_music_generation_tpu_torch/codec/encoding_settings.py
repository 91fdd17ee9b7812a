"""Codec configuration (parity: core/encodings/encoding_settings.py:8-51).

The port's copy of ``ai_music_generation_tpu/codec/encoding_settings.py``
(the port imports nothing of the JAX package;
tests/test_torch_host_copies.py holds the two to each other).
"""

from __future__ import annotations

from typing import Literal, Tuple

from pydantic import BaseModel, ConfigDict, Field

from ai_music_generation_tpu_torch.codec.instrument_types import InstrumentTypes

PIANO_RANGE = (21, 108)


class EncodingSetting(BaseModel):
    """Frozen codec options — same fields/defaults as the reference."""

    include_bars: bool = True
    include_rests: bool = True
    include_clef: bool = True
    include_key_signature: bool = True
    include_time_signature: bool = True
    include_offset_in_notes: bool = True
    include_offset_in_tuplets: bool = True
    joining_parts_strategy: Literal[
        "Join parallel measures", "Queue parallel measures"
    ] = "Queue parallel measures"
    skip_measures_without_notes: bool = False
    notes_range: Tuple[int, int] = PIANO_RANGE
    shortest_note_duration: int = 16  # 1/n, shortest accepted note duration
    longest_note_duration: int = 2  # n, longest accepted (in whole notes)
    allow_triplet_quarterLength: bool = True
    repeats_handling: Literal["Ignore", "Special tokens", "Expand"] = "Ignore"
    only_SATB_parts: bool = False
    allowed_instruments: list[InstrumentTypes] = Field(default_factory=list)
    raise_duration_errors: bool = False

    model_config = ConfigDict(frozen=True)
