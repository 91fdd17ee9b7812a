"""Per-measure feature extraction (parity: core/metrics/vectorization.py:17-92).

The port's copy of ``ai_music_generation_tpu/eval/vectorization.py`` (the
port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds the two to each other).

``MidiVectorizer.midi_or_score_to_notes_and_offsets_feature_vectors`` returns,
per measure stack (measures at the same index across all parts):

1. a 12-dim pitch-class distribution weighted by note duration, normalized by
   the measure duration (and optionally by the number of parts);
2. the multiset of note-onset offsets (one entry PER PITCH for chords, like
   the reference's per-pitch append, ref :76-80).

Shorter parts are padded with empty measures. Operates on the framework's
Score model or a MIDI path (quantized on load, like the reference's
``_quantize_stream``).
"""

from __future__ import annotations

from fractions import Fraction
from pathlib import Path
from typing import Optional, Union

from ai_music_generation_tpu_torch.codec import midi_io
from ai_music_generation_tpu_torch.codec.encoding_settings import EncodingSetting
from ai_music_generation_tpu_torch.codec.quantized_converter import MidiQuantizedConverter
from ai_music_generation_tpu_torch.codec.score import Measure, Score, score_from_midi


class MidiVectorizer:
    def __init__(self, settings: Optional[EncodingSetting] = None):
        self.settings = settings or EncodingSetting()
        self.converter = MidiQuantizedConverter(self.settings)

    def midi_or_score_to_notes_and_offsets_feature_vectors(
        self,
        midi_path_or_score: Union[str, Path, Score],
        normalize_by_n_parts: bool = False,
    ) -> tuple[list[list[float]], list[list[Union[float, Fraction]]]]:
        if isinstance(midi_path_or_score, Score):
            score = midi_path_or_score
        else:
            midi = midi_io.parse_midi_file(Path(midi_path_or_score))
            score = score_from_midi(
                midi, self.converter._get_quarterLengthDivisors()
            )

        parts_measures = [list(p.measures) for p in score.parts]
        if not parts_measures:
            return [], []
        max_measures = max(len(pm) for pm in parts_measures)
        for pm in parts_measures:
            pm.extend(Measure(notes=[]) for _ in range(max_measures - len(pm)))

        pitch_distributions: list[list[float]] = []
        offsets_per_measure: list[list[Union[float, Fraction]]] = []
        for i in range(max_measures):
            stack = [pm[i] for pm in parts_measures]
            measure_duration: Optional[float] = None
            dist = [Fraction(0)] * 12
            offsets: list[Union[float, Fraction]] = []
            for measure in stack:
                if measure_duration is None:
                    # reference uses measure.duration (content span)
                    measure_duration = float(measure.real_duration)
                for el in measure.notes:
                    for pitch in el.pitches:  # rests contribute nothing
                        offsets.append(el.offset)
                        dist[pitch % 12] += el.quarter_length
            if measure_duration is None or measure_duration == 0:
                measure_duration = 4.0
            norm = measure_duration * (len(stack) if normalize_by_n_parts else 1)
            pitch_distributions.append([float(v) / norm for v in dist])
            offsets_per_measure.append(offsets)
        return pitch_distributions, offsets_per_measure
