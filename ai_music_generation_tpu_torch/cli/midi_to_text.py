"""Batch MIDI -> token-text conversion.

Parity with ref: scripts/common/midi_to_text_unified.py:35-123 —
multiprocessing pool with per-worker converter init, optional per-file
semitone transposition list writing ``<stem>_tr{+N|-N}.txt`` variants,
per-file error tolerance.

The port's copy of ``ai_music_generation_tpu/cli/midi_to_text.py`` over
the port's ``codec/``; it imports no torch, so a pool worker forked from a
process that holds a CUDA context never touches the card.

    python -m ai_music_generation_tpu_torch.cli.midi_to_text midis/ texts/ --processes=2
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
from pathlib import Path

from ai_music_generation_tpu_torch.codec.encoding_settings import EncodingSetting
from ai_music_generation_tpu_torch.codec.quantized_converter import MidiQuantizedConverter

_worker_converter: MidiQuantizedConverter | None = None


def _init_worker(settings_json: str) -> None:
    global _worker_converter
    _worker_converter = MidiQuantizedConverter(
        EncodingSetting.model_validate_json(settings_json)
    )


def _process_file(args: tuple[str, str, list[int]]) -> tuple[str, bool, str]:
    midi_path, out_dir, transpositions = args
    assert _worker_converter is not None
    stem = Path(midi_path).stem
    try:
        wrote = 0
        for tr in transpositions:
            suffix = "" if tr == 0 else f"_tr{tr:+d}"
            texts = _worker_converter.filepath_to_texts(
                Path(midi_path), transpose_pitches_by_n=tr if tr != 0 else None
            )
            for _, text in texts.items():
                out_path = os.path.join(out_dir, f"{stem}{suffix}.txt")
                with open(out_path, "w") as f:
                    f.write(text)
                wrote += 1
        if wrote == 0:
            # all parts rejected by filter_allowed_parts: no .txt written —
            # report it (counting it 'converted' overstated the corpus and
            # the gap surfaced later as missing files in prepare)
            return midi_path, False, "no allowed parts (nothing written)"
        return midi_path, True, ""
    except Exception as e:  # per-file tolerance (ref :82-88)
        return midi_path, False, str(e)


def convert_directory(
    input_dir: str,
    output_dir: str,
    settings: EncodingSetting = EncodingSetting(),
    transpositions: list[int] = [0],
    processes: int | None = None,
) -> tuple[int, int]:
    os.makedirs(output_dir, exist_ok=True)
    files = sorted(
        str(p) for p in Path(input_dir).iterdir()
        if p.suffix.lower() in (".mid", ".midi")
    )
    jobs = [(f, output_dir, transpositions) for f in files]
    settings_json = settings.model_dump_json()
    ok = bad = 0
    if processes == 1 or len(jobs) <= 1:
        _init_worker(settings_json)
        results = map(_process_file, jobs)
        for _, success, err in results:
            ok += success
            bad += not success
            if err:
                print(f"FAILED: {err}")
    else:
        with mp.Pool(processes, initializer=_init_worker, initargs=(settings_json,)) as pool:
            for _, success, err in pool.imap_unordered(_process_file, jobs):
                ok += success
                bad += not success
                if err:
                    print(f"FAILED: {err}")
    print(f"converted {ok} files, {bad} failures -> {output_dir}")
    return ok, bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--transpositions", type=int, nargs="*", default=[0])
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--no_offsets", action="store_true")
    ap.add_argument("--joining", default="Queue parallel measures",
                    choices=["Queue parallel measures", "Join parallel measures"])
    a = ap.parse_args(argv)
    settings = EncodingSetting(
        include_offset_in_notes=not a.no_offsets, joining_parts_strategy=a.joining
    )
    return convert_directory(
        a.input_dir, a.output_dir, settings, a.transpositions, a.processes
    )


if __name__ == "__main__":
    main()
