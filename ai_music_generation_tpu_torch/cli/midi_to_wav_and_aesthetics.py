"""MIDI -> WAV -> metrics + aesthetics pipeline CLI.

Parity with ref: scripts/common/midi_to_wav_and_aesthetics.py (the ABC
stage skipped; reference filename mapping strips the ``sample_`` prefix).

The port of ``ai_music_generation_tpu/cli/midi_to_wav_and_aesthetics.py``:
the same flags, plus ``--device`` (default ``cuda``; ``cpu`` renders on the
CPU).
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
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--device", default="cuda",
                    help="where the synth renders (cuda, or cpu)")
    a = ap.parse_args(argv)
    pipeline = EvalPipeline(PipelineConfig(
        midi_input_folder=a.midi_input_folder,
        base_output_dir=a.base_output_dir,
        reference_midi_files_dir=a.reference_midi_files_dir,
        n_conditioned_measures=a.n_conditioned_measures,
        sample_rate=a.sample_rate,
        device=a.device,
    ))
    return pipeline.run()


if __name__ == "__main__":
    main()
