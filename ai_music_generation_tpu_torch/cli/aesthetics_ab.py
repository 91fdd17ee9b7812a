"""A/B-compare the real Audiobox-aesthetics scorer against the DSP proxy.

    python -m ai_music_generation_tpu_torch.cli.aesthetics_ab \
        <wav_paths.jsonl> <out_dir> [--batch-size N] [--device cuda|cpu]

The port of ``ai_music_generation_tpu/cli/aesthetics_ab.py``: the same
flags and outputs, plus ``--device`` (default ``cuda``; a card that is
missing raises): where the real leg's fallback to the Audiobox predictor
would run. The proxy runs on the host, ``audio-aes`` in its own process.

``wav_paths.jsonl`` is the same {"path": ...}-per-line file the eval
pipeline feeds ``audio-aes`` (ref: abc_to_midi_wav_and_aesthetics.py:323).
Writes proxy.jsonl (+ real.jsonl when audio-aes is installed) and
ab_report.json with per-axis mean deltas and Pearson/Spearman agreement.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    from ai_music_generation_tpu_torch.eval.aesthetics import compare_scorers
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("wav_paths_jsonl")
    ap.add_argument("out_dir")
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the run's device (cuda, or cpu)")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    report = compare_scorers(a.wav_paths_jsonl, a.out_dir, a.batch_size,
                             device=a.device)
    print(json.dumps(report, indent=2))
    if not report["real_available"]:
        print("NOTE: audio-aes not on PATH — only proxy scores produced; "
              "re-run once audio-aes is installed for calibration numbers.")
    return report


if __name__ == "__main__":
    main()
