"""IrishMAN corpus pipeline CLI (ref: scripts/irishman_sripts/).

The port of ``ai_music_generation_tpu/cli/irishman_pipeline.py``: the same
subcommands and outputs over the port's copies (``data/curation.py``,
``abcnotation/to_midi.py``, ``codec/midi_io.py``); ``to-midi --render_wav``
renders on the card and scores with ``eval/aesthetics.py`` there, and
gains ``--device`` (default ``cuda``; ``cpu`` for the CPU).

Subcommands:
- ``preprocess``       strip X:<id> headers into id fields (ref irishman_preprocess.py)
- ``leadsheet-subset`` filter splits by leadsheet_ids.json (ref irishman_to_leadsheet_subset.py)
- ``split-validation`` half split into val/test (ref irishman_split_validation_to_val_and_test.py)
- ``to-midi``          per-tune .abc + MIDI (+ optional WAV/aesthetics)
                       (ref irishman_dataset_to_midi{,_and_wav}.py)
"""

from __future__ import annotations

import argparse
import json
import os

from ai_music_generation_tpu_torch.data.curation import (
    filter_by_ids,
    split_validation,
    strip_x_header,
)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _save(obj, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def cmd_preprocess(a):
    for path in a.inputs:
        entries = strip_x_header(_load(path))
        out = os.path.join(a.out_dir, os.path.basename(path))
        _save(entries, out)
        print(f"{path}: {len(entries)} entries -> {out}")


def cmd_leadsheet_subset(a):
    ids = set(_load(a.leadsheet_ids))
    for path in a.inputs:
        entries = filter_by_ids(_load(path), ids)
        stem, ext = os.path.splitext(os.path.basename(path))
        out = os.path.join(a.out_dir, f"{stem}_leadsheet{ext}")
        _save(entries, out)
        print(f"{path}: kept {len(entries)} leadsheet entries -> {out}")


def cmd_split_validation(a):
    entries = _load(a.input)
    val, test = split_validation(entries, a.seed)
    stem, ext = os.path.splitext(os.path.basename(a.input))
    _save(val, os.path.join(a.out_dir, f"{stem}_val{ext}"))
    _save(test, os.path.join(a.out_dir, f"{stem}_test{ext}"))
    print(f"split {len(entries)} -> val {len(val)} / test {len(test)}")


def cmd_to_midi(a):
    from ai_music_generation_tpu_torch.abcnotation.to_midi import abc_to_midi
    from ai_music_generation_tpu_torch.codec import midi_io

    if a.render_wav:
        from ai_music_generation_tpu_torch.utils.device import resolve_device

        # a CUDA device without a card raises here, not once a tune
        resolve_device(a.device)
    entries = _load(a.input)
    abc_dir = os.path.join(a.out_dir, "abc")
    midi_dir = os.path.join(a.out_dir, "midi")
    os.makedirs(abc_dir, exist_ok=True)
    os.makedirs(midi_dir, exist_ok=True)
    n_ok = n_bad = 0
    wav_paths = []
    for entry in entries:
        idx = entry.get("id", n_ok + n_bad)
        abc_text = f"X:{idx}\n" + entry["abc notation"].strip() + "\n"
        abc_path = os.path.join(abc_dir, f"{idx}.abc")
        with open(abc_path, "w") as f:
            f.write(abc_text)
        try:
            midi = abc_to_midi(abc_text)
            midi_path = os.path.join(midi_dir, f"{idx}.mid")
            midi_io.write_midi_file(midi, midi_path)
            if a.render_wav:
                from ai_music_generation_tpu_torch.synth.render import synthesize_midi
                from ai_music_generation_tpu_torch.synth.wav_io import write_wav

                wav_dir = os.path.join(a.out_dir, "wav")
                os.makedirs(wav_dir, exist_ok=True)
                wav_path = os.path.join(wav_dir, f"{idx}.wav")
                write_wav(wav_path, synthesize_midi(midi, device=a.device))
                wav_paths.append(os.path.abspath(wav_path))
            # counted ONCE per tune, after every requested stage succeeded
            # (incrementing before the WAV render made a render failure
            # count the tune as both converted and failed)
            n_ok += 1
        except Exception as e:  # per-tune tolerance (ref check=False subprocess)
            print(f"FAILED {idx}: {e}")
            n_bad += 1
    print(f"converted {n_ok} tunes, {n_bad} failures -> {a.out_dir}")
    if wav_paths:
        from ai_music_generation_tpu_torch.eval.aesthetics import (
            aggregate_jsonl_stats,
            run_aesthetics,
        )

        in_jsonl = os.path.join(a.out_dir, "wav_paths.jsonl")
        out_jsonl = os.path.join(a.out_dir, "aesthetics.jsonl")
        with open(in_jsonl, "w") as f:
            for p in wav_paths:
                f.write(json.dumps({"path": p}) + "\n")
        run_aesthetics(in_jsonl, out_jsonl, device=a.device)
        agg = aggregate_jsonl_stats(out_jsonl, ["CE", "CU", "PC", "PQ"])
        _save(agg, os.path.join(a.out_dir, "aesthetics_aggregated.json"))
        print(json.dumps(agg.get("mean", {}), indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("preprocess")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("leadsheet-subset")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--leadsheet_ids", required=True)
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_leadsheet_subset)

    p = sub.add_parser("split-validation")
    p.add_argument("input")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_split_validation)

    p = sub.add_parser("to-midi")
    p.add_argument("input")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--render_wav", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where --render_wav renders and scores (cuda, or cpu)")
    p.set_defaults(fn=cmd_to_midi)

    a = ap.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    main()
