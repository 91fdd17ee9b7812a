"""Drop-in replacement for the ``audio-aes`` CLI, backed by the port's
Audiobox predictor.

The port of ``ai_music_generation_tpu/cli/audio_aes.py``: the same flags,
output and exit codes, plus ``--device`` (default ``cuda``; ``cpu`` scores
on the CPU; a card that is missing raises).

The reference's eval pipelines shell out to Meta's audiobox-aesthetics CLI
(``audio-aes input.jsonl --batch-size 10 > output.jsonl``,
ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:323-325). This module
reproduces that exact command surface on top of ``eval/audiobox.py``: each
input line ``{"path": wav}`` yields one stdout line of
``{"CE": .., "CU": .., "PC": .., "PQ": ..}`` (all NaN for a file that
cannot be read or scored).

Install as ``audio-aes`` (a shim script on PATH running
``python -m ai_music_generation_tpu_torch.cli.audio_aes "$@"``) and the
reference's pipelines, and this repo's own ``eval/aesthetics.py`` bridge,
which prefers an on-PATH ``audio-aes``, pick it up unchanged.

Weights: ``--ckpt`` or ``$AUDIOBOX_WEIGHTS`` (a torch checkpoint, loaded by
``eval/audiobox.py::load_state_dict``). Without weights the command
refuses to emit model-lookalike numbers unless ``--allow-random`` is given
(compute-path smoke testing only). Exit code 2: no weights without
``--allow-random``, a checkpoint that does not exist, ``--batch-size``
below 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="audio-aes",
        description="Audiobox-aesthetics scoring (PyTorch backend)")
    ap.add_argument("input_jsonl", help='lines of {"path": "file.wav"}')
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--ckpt", default=None,
                    help="torch checkpoint (default: $AUDIOBOX_WEIGHTS)")
    ap.add_argument("--output", default=None,
                    help="write here instead of stdout")
    ap.add_argument("--allow-random", action="store_true",
                    help="run with random-init weights (smoke testing only; "
                         "scores are meaningless)")
    ap.add_argument("--device", default="cuda",
                    help="where the predictor runs (cuda, or cpu)")
    args = ap.parse_args(argv)

    if args.batch_size < 1:
        print(f"audio-aes: --batch-size must be >= 1, got {args.batch_size}",
              file=sys.stderr)
        return 2
    ckpt = args.ckpt or os.environ.get("AUDIOBOX_WEIGHTS")
    if ckpt and not os.path.exists(ckpt):
        print(f"audio-aes: checkpoint not found: {ckpt}", file=sys.stderr)
        return 2
    if not ckpt and not args.allow_random:
        print("audio-aes: no weights — pass --ckpt/set $AUDIOBOX_WEIGHTS, or "
              "--allow-random for a smoke run", file=sys.stderr)
        return 2

    from ai_music_generation_tpu_torch.eval.audiobox import AesPredictor

    predictor = AesPredictor(weights=ckpt, batch=args.batch_size,
                             device=args.device)

    with open(args.input_jsonl) as f:
        paths = [json.loads(ln)["path"] for ln in f if ln.strip()]

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        # file groups of batch_size: chunks share canonical-shape batches;
        # per-file NaN-row semantics live in score_paths (single source)
        for s in range(0, len(paths), args.batch_size):
            for scores in predictor.score_paths(paths[s:s + args.batch_size]):
                out.write(json.dumps(scores) + "\n")
        out.flush()
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
