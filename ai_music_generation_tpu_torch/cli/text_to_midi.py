"""Batch token-text -> MIDI conversion.

Parity with ref: scripts/common/text_to_midi_unified.py:10-40 — serial loop,
``.txt`` -> ``text_to_score`` -> ``.mid``.

The port's copy of ``ai_music_generation_tpu/cli/text_to_midi.py`` over the
port's ``codec/``.

    python -m ai_music_generation_tpu_torch.cli.text_to_midi texts/ midis/
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ai_music_generation_tpu_torch.codec.encoding_settings import EncodingSetting
from ai_music_generation_tpu_torch.codec.quantized_converter import MidiQuantizedConverter
from ai_music_generation_tpu_torch.codec.score import score_to_midi
from ai_music_generation_tpu_torch.codec import midi_io


def convert_directory(
    input_dir: str,
    output_dir: str,
    settings: EncodingSetting = EncodingSetting(),
) -> tuple[int, int]:
    os.makedirs(output_dir, exist_ok=True)
    converter = MidiQuantizedConverter(settings)
    ok = bad = 0
    for path in sorted(Path(input_dir).glob("*.txt")):
        try:
            score = converter.text_to_score(path.read_text())
            midi = score_to_midi(score)
            midi_io.write_midi_file(midi, os.path.join(output_dir, path.stem + ".mid"))
            ok += 1
        except Exception as e:
            print(f"FAILED {path.name}: {e}")
            bad += 1
    print(f"converted {ok} files, {bad} failures -> {output_dir}")
    return ok, bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--no_offsets", action="store_true")
    a = ap.parse_args(argv)
    settings = EncodingSetting(include_offset_in_notes=not a.no_offsets)
    return convert_directory(a.input_dir, a.output_dir, settings)


if __name__ == "__main__":
    main()
