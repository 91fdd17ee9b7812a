"""Metrics-only re-scoring over existing MIDI (+WAV) outputs.

Parity with ref: scripts/common/midi_and_wav_to_aesthetics.py — recompute
structural metrics and aesthetics when the WAVs already exist, with
crash-proof per-file handling.

The port of ``ai_music_generation_tpu/cli/midi_and_wav_to_aesthetics.py``:
the same flags and behaviour. The pipeline runs with ``render_wav=False``,
so only the structural metrics are written and the aesthetics stage never
runs (the JAX package's gap, ROADMAP queue 3); no stage touches a device,
so the CLI has no ``--device``.
"""

from __future__ import annotations

import argparse

from ai_music_generation_tpu_torch.eval.pipeline import EvalPipeline, PipelineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("midi_input_folder")
    ap.add_argument("base_output_dir")
    ap.add_argument("--reference_midi_files_dir", default=None)
    ap.add_argument("--n_conditioned_measures", type=int, default=0)
    a = ap.parse_args(argv)
    pipeline = EvalPipeline(PipelineConfig(
        midi_input_folder=a.midi_input_folder,
        base_output_dir=a.base_output_dir,
        reference_midi_files_dir=a.reference_midi_files_dir,
        n_conditioned_measures=a.n_conditioned_measures,
        render_wav=False,
    ))
    return pipeline.run()


if __name__ == "__main__":
    main()
