"""ABC -> MIDI -> WAV -> metrics + aesthetics pipeline CLI.

Parity with ref: scripts/common/abc_to_midi_wav_and_aesthetics.py — same
directory layout, JSONL schemas, and aggregation; the external binaries
(abc2midi, FluidSynth, sox, audio-aes) are replaced by the in-repo ABC
compiler, the synth on the card, the on-device trim, and the aesthetics
module (audio-aes if installed, proxy otherwise).

The port of ``ai_music_generation_tpu/cli/abc_to_midi_wav_and_aesthetics.py``:
the same flags, plus ``--device`` (default ``cuda``; ``cpu`` renders on the
CPU).
"""

from __future__ import annotations

import argparse

from ai_music_generation_tpu_torch.eval.pipeline import EvalPipeline, PipelineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("abc_input_folder")
    ap.add_argument("base_output_dir")
    ap.add_argument("--reference_midi_files_dir", default=None)
    ap.add_argument("--n_conditioned_measures", type=int, default=0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--no_wav", action="store_true", help="skip audio rendering")
    ap.add_argument("--abc_to_midi_converter", default="builtin",
                    choices=["builtin", "music21"])
    ap.add_argument("--gchord", action="store_true",
                    help='render "G7" chord-symbol accompaniment '
                         "(abc2midi's gchord engine; for leadsheet corpora)")
    ap.add_argument("--device", default="cuda",
                    help="where the synth renders (cuda, or cpu)")
    a = ap.parse_args(argv)
    pipeline = EvalPipeline(PipelineConfig(
        abc_input_folder=a.abc_input_folder,
        base_output_dir=a.base_output_dir,
        reference_midi_files_dir=a.reference_midi_files_dir,
        n_conditioned_measures=a.n_conditioned_measures,
        sample_rate=a.sample_rate,
        render_wav=not a.no_wav,
        abc_to_midi_converter=a.abc_to_midi_converter,
        gchord=a.gchord,
        device=a.device,
    ))
    return pipeline.run()


if __name__ == "__main__":
    main()
