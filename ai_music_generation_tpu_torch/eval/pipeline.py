"""Shared evaluation pipeline: render + structural metrics + aesthetics.

The port of ``ai_music_generation_tpu/eval/pipeline.py``: the same stages,
output tree, JSONL schemas and aggregates (tests/test_torch_eval_pipeline.py
holds them to the JAX package's), with the render on the card
(``synth/render.py``) and, when ``$AUDIOBOX_WEIGHTS`` names a checkpoint,
the Audiobox predictor's scoring there too (``eval/audiobox.py``);
``PipelineConfig.device``, ``"cpu"`` for the CPU.
The WAV directory keeps JAX's ``midi_to_wav_converter`` name
(``"tpu_synth"``) so the two trees line up. ``run`` also returns each
stage's wall seconds (``stage_seconds``).

The engine behind the three reference pipeline scripts
(ref: scripts/common/abc_to_midi_wav_and_aesthetics.py,
midi_to_wav_and_aesthetics.py, midi_and_wav_to_aesthetics.py). Directory
layout, JSONL schemas, and aggregation match the reference:

    <out>/midi/<converter>/file_<idx>.mid
    <out>/wav/<converter>/<synth>/<bank>/file_<idx>.wav
    <out>/metrics/<converter>/structure/{inner,reference_similarity,
        conditional_prefix_similarity}.jsonl + aggregated_similarities.json
    <out>/audiobox_aesthetics/.../wav_paths.jsonl, aesthetics.jsonl,
        aesthetics_aggregated.jsonl

Per-file failures are tolerated (ref crash-proof workers,
midi_and_wav_to_aesthetics.py:130-149). The ABC->MIDI stage uses the
in-repo compiler (abc2midi replacement) and the WAV stage the synth.

``shard_synth`` (JAX :87-90, 251-285): under ``torchrun`` the render is
sharded over ``make_mesh()`` of every process (``synth/render.py::
synthesize_midi_batch(mesh=)``). Every rank builds the pipeline and calls
:meth:`EvalPipeline.run`; rank 0 alone compiles and parses the tunes,
writes the MIDI and WAV files, runs the metrics and the scorer. Before each
render batch it sends the parsed MIDI files (with the voice) to the other
ranks over a gloo group, and each rank renders its share; their ``run``
returns None once rank 0 has sent the end of the render stage. In a plain
process the mesh is the one device: the render runs unsharded on the card,
as JAX's ``make_mesh()`` over one device shards nothing.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass
from typing import Optional

from ai_music_generation_tpu_torch.eval.aesthetics import aggregate_jsonl_stats, run_aesthetics
from ai_music_generation_tpu_torch.eval.calculate import (
    SimilarityResult,
    calculate_conditioned_similarity_of_music_vectors,
    calculate_inner_similarity_of_music_vectors,
    calculate_reference_similarity_of_music_vectors,
)
from ai_music_generation_tpu_torch.eval.similarities import (
    cyclic_pitch_similarity,
    cyclic_pitch_similarity_matrix,
    rhythmic_similarity,
)
from ai_music_generation_tpu_torch.eval.vectorization import MidiVectorizer
from ai_music_generation_tpu_torch.utils.device import resolve_device


_worker_vectorizer: Optional[MidiVectorizer] = None


def _init_metrics_worker() -> None:
    global _worker_vectorizer
    _worker_vectorizer = MidiVectorizer()


def _metrics_job(args):
    """Pool worker: (midi_path, ref_path, n_conditioned) -> rows or error.

    Mirrors the reference's multiprocessing fan-out of per-file metrics
    (ref: abc_to_midi_wav_and_aesthetics.py:226-227) — crash-proof like
    midi_and_wav_to_aesthetics.py:130-149."""
    midi_path, ref_path, n_conditioned = args
    try:
        vec = _worker_vectorizer or MidiVectorizer()
        inner, reference, conditioned = structural_metrics(
            midi_path, vec, ref_path, n_conditioned
        )
        return midi_path, inner, reference, conditioned, None
    except Exception as e:
        return midi_path, None, None, None, str(e)


@dataclass
class PipelineConfig:
    abc_input_folder: Optional[str] = None
    midi_input_folder: Optional[str] = None
    base_output_dir: str = "eval_out"
    abc_to_midi_converter: str = "builtin"  # replaces abc2midi/music21 choice
    gchord: bool = False  # render "G7" chord-symbol accompaniment (abc2midi)
    # replaces FluidSynth/Timidity; the name is the JAX package's, so the
    # two output trees line up
    midi_to_wav_converter: str = "tpu_synth"
    # "builtin_sample_bank" (embedded multi-sample piano, default — A/B
    # winner, docs/PERF.md) or "builtin_additive" (round-1 harmonic voice);
    # replaces the reference's soundfont choice (midi_to_wav_and_aesthetics
    # .py:105-110)
    sound_font: str = "builtin_sample_bank"
    sample_rate: int = 16_000
    reference_midi_files_dir: Optional[str] = None
    n_conditioned_measures: int = 0
    render_wav: bool = True
    aesthetics_batch_size: int = 10
    synth_batch: int = 8  # tunes rendered per device call (batched synth)
    # shard the render batch over a data-axis mesh of every process under
    # torchrun (module docstring); False = one device (identical waveforms
    # either way)
    shard_synth: bool = False
    metrics_processes: Optional[int] = None  # Pool size for the metrics stage
    # where the synth renders and the Audiobox predictor scores ("cpu" for
    # the CPU)
    device: str = "cuda"


def extract_index(abc_content: str, filename: str) -> str:
    """X: header index, else trailing filename chunk (ref :103-110)."""
    m = re.search(r"^X:\s*(\d+)", abc_content, flags=re.MULTILINE)
    if m:
        return m.group(1)
    return os.path.splitext(os.path.basename(filename))[0].split("_")[-1]


def structural_metrics(
    midi_path: str,
    vectorizer: MidiVectorizer,
    reference_midi_path: Optional[str],
    n_conditioned: int,
):
    """(inner, reference, conditioned) melody+rhythm SimilarityResult pairs."""
    pf, of = vectorizer.midi_or_score_to_notes_and_offsets_feature_vectors(midi_path)
    # pitch uses the vectorized all-pairs builder (one broadcast instead of
    # O(N^2) scalar calls; provably equal to the scalar definition and
    # tested so in tests/test_metrics.py). Rhythm stays on the exact
    # Counter path: the histogram builder clamps offsets past its lattice
    # into an overflow bin, which is only multiset-equal on in-range
    # grid offsets — exactness beats speed for the cheap Counter Dice.
    inner = (
        calculate_inner_similarity_of_music_vectors(
            pf, cyclic_pitch_similarity,
            matrix_fn=cyclic_pitch_similarity_matrix),
        calculate_inner_similarity_of_music_vectors(of, rhythmic_similarity),
    )
    reference = (None, None)
    if reference_midi_path and os.path.exists(reference_midi_path):
        rpf, rof = vectorizer.midi_or_score_to_notes_and_offsets_feature_vectors(
            reference_midi_path
        )
        reference = (
            calculate_reference_similarity_of_music_vectors(
                pf, rpf, cyclic_pitch_similarity,
                n_measures_to_skip=n_conditioned,
                matrix_fn=cyclic_pitch_similarity_matrix
            ),
            calculate_reference_similarity_of_music_vectors(
                of, rof, rhythmic_similarity, n_measures_to_skip=n_conditioned
            ),
        )
    conditioned = (None, None)
    if n_conditioned > 0 and len(pf) >= n_conditioned:
        conditioned = (
            calculate_conditioned_similarity_of_music_vectors(
                pf, n_conditioned, cyclic_pitch_similarity,
                matrix_fn=cyclic_pitch_similarity_matrix
            ),
            calculate_conditioned_similarity_of_music_vectors(
                of, n_conditioned, rhythmic_similarity
            ),
        )
    return inner, reference, conditioned


class EvalPipeline:
    def __init__(self, config: PipelineConfig):
        if config.render_wav:
            # a CUDA device without a card raises here, before any stage:
            # the render never carries on on the CPU
            resolve_device(config.device)
        self.c = config
        c = config
        # directory tag only — a sound_font given as /path/to/font.sf2 must
        # not reset os.path.join (ref uses the soundfont NAME in the layout,
        # midi_to_wav_and_aesthetics.py:105-110)
        font_tag = os.path.basename(c.sound_font.rstrip("/")) or "default"
        self.midi_dir = os.path.join(c.base_output_dir, "midi", c.abc_to_midi_converter)
        self.wav_dir = os.path.join(
            c.base_output_dir, "wav", c.abc_to_midi_converter,
            c.midi_to_wav_converter, font_tag,
        )
        self.structure_dir = os.path.join(
            c.base_output_dir, "metrics", c.abc_to_midi_converter, "structure"
        )
        self.audiobox_dir = os.path.join(
            c.base_output_dir, "audiobox_aesthetics", c.abc_to_midi_converter,
            c.midi_to_wav_converter, font_tag,
        )
        # the render's mesh: every process of the group (None: one device)
        self.mesh = self._control = None
        if c.shard_synth and c.render_wav:
            import torch
            import torch.distributed as dist

            if dist.is_initialized():
                from ai_music_generation_tpu_torch.parallel.mesh import (
                    make_mesh,
                )

                self.mesh = make_mesh(
                    device=torch.device(c.device).type)
                self._control = dist.new_group(backend="gloo")
        if self._follower():
            return
        for d in (self.midi_dir, self.wav_dir, self.structure_dir, self.audiobox_dir):
            os.makedirs(d, exist_ok=True)

    # -- stages -----------------------------------------------------------

    def abc_to_midi(self, abc_path: str) -> tuple[str, str]:
        with open(abc_path) as f:
            idx = extract_index(f.read(), abc_path)
        midi_path = os.path.join(self.midi_dir, f"file_{idx}.mid")
        if self.c.abc_to_midi_converter == "music21":
            # the reference's alternative converter path
            # (ref: abc_to_midi_wav_and_aesthetics.py:119-121)
            from ai_music_generation_tpu_torch.abcnotation.music21_oracle import (
                abc_file_to_midi_file_music21,
            )

            abc_file_to_midi_file_music21(abc_path, midi_path)
        else:
            from ai_music_generation_tpu_torch.abcnotation.to_midi import (
                abc_file_to_midi_file,
            )

            abc_file_to_midi_file(abc_path, midi_path, gchord=self.c.gchord)
        return idx, midi_path

    def reference_midi_for(self, idx: str, midi_filename: str) -> Optional[str]:
        if not self.c.reference_midi_files_dir:
            return None
        # ref mapping: strip the sample_ prefix (midi_to_wav_and_aesthetics.py:82)
        candidates = [
            f"file_{idx}.mid",
            os.path.basename(midi_filename).removeprefix("sample_"),
            f"{idx}.mid",
        ]
        for cand in candidates:
            p = os.path.join(self.c.reference_midi_files_dir, cand)
            if os.path.exists(p):
                return p
        return None

    # -- the sharded render -------------------------------------------------

    def _follower(self) -> bool:
        import torch.distributed as dist

        return self.mesh is not None and dist.get_rank() != 0

    def _send(self, item) -> None:
        """Rank 0: one render batch (or None, the end) to the other ranks."""
        import torch.distributed as dist

        if self.mesh is not None:
            dist.broadcast_object_list([item], src=0, group=self._control)

    def _follow(self) -> None:
        """A rank other than 0: render its share of each batch rank 0
        sends, until the end of the render stage."""
        import torch.distributed as dist

        from ai_music_generation_tpu_torch.synth.render import (
            synthesize_midi_batch,
        )

        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._control)
            if box[0] is None:
                return
            midis, voice = box[0]
            synthesize_midi_batch(midis, self.c.sample_rate, voice=voice,
                                  mesh=self.mesh, device=self.c.device)

    # -- full run ---------------------------------------------------------

    def run(self, files: Optional[list[str]] = None) -> Optional[dict]:
        """Every stage; returns the summary (None on a rank other than 0 of
        a sharded render, module docstring)."""
        if self._follower():
            self._follow()
            return None
        c = self.c
        if c.abc_input_folder:
            files = files or sorted(
                f for f in os.listdir(c.abc_input_folder) if f.endswith(".abc")
            )
            inputs = [(os.path.join(c.abc_input_folder, f), "abc") for f in files]
        else:
            files = files or sorted(
                f for f in os.listdir(c.midi_input_folder)
                if f.endswith((".mid", ".midi"))
            )
            inputs = [(os.path.join(c.midi_input_folder, f), "midi") for f in files]

        # stage 1: compile ABC -> MIDI (host, fast)
        seconds = dict.fromkeys(
            ("abc_to_midi", "render", "write", "metrics", "scoring"), 0.0)
        clock = time.perf_counter()
        todo = []  # (idx, midi_path)
        n_failed = 0
        parse_failed: set = set()
        for path, kind in inputs:
            try:
                if kind == "abc":
                    idx, midi_path = self.abc_to_midi(path)
                else:
                    idx = os.path.splitext(os.path.basename(path))[0].split("_")[-1]
                    midi_path = path
                todo.append((idx, midi_path))
            except Exception as e:
                print(f"Error processing {path}: {e}")
                n_failed += 1

        # stage 2: batched rendering on the device (synth_batch tunes per
        # call), per-file tolerant like the reference's crash-proof workers
        seconds["abc_to_midi"] = time.perf_counter() - clock
        wav_paths = []
        if c.render_wav and todo:
            from ai_music_generation_tpu_torch.codec import midi_io
            from ai_music_generation_tpu_torch.synth.render import synthesize_midi_batch
            from ai_music_generation_tpu_torch.synth.wav_io import write_wav

            for lo in range(0, len(todo), c.synth_batch):
                chunk = []
                midis = []
                for idx, midi_path in todo[lo : lo + c.synth_batch]:
                    try:
                        midis.append(midi_io.parse_midi_file(midi_path))
                        chunk.append((idx, midi_path))
                    except Exception as e:
                        print(f"Error parsing {midi_path}: {e}")
                        n_failed += 1
                        # the metrics stage would re-parse and fail again —
                        # count each bad file ONCE (review finding)
                        parse_failed.add(idx)
                if not chunk:
                    continue
                # soundfont choice (ref midi_to_wav_and_aesthetics.py:105-110):
                # a path to a .sf2 file renders through synth/sf2.py zones;
                # "builtin_additive" / "builtin_sample_bank" pick built-ins
                if c.sound_font.endswith(".sf2"):
                    voice = f"sf2:{c.sound_font}"
                elif "additive" in c.sound_font:
                    voice = "additive"
                else:
                    voice = "sample_bank"
                clock = time.perf_counter()
                self._send((midis, voice))
                try:
                    waves = synthesize_midi_batch(midis, c.sample_rate,
                                                  voice=voice, mesh=self.mesh,
                                                  device=c.device)
                except Exception as e:
                    print(f"Error rendering batch at {lo}: {e}")
                    n_failed += len(chunk)
                    continue
                finally:
                    seconds["render"] += time.perf_counter() - clock
                clock = time.perf_counter()
                for (idx, _), wave in zip(chunk, waves):
                    try:
                        wav_path = os.path.join(self.wav_dir, f"file_{idx}.wav")
                        write_wav(wav_path, wave, c.sample_rate)
                        wav_paths.append(os.path.abspath(wav_path))
                    except Exception as e:
                        print(f"Error writing wav for {idx}: {e}")
                        n_failed += 1
                seconds["write"] += time.perf_counter() - clock
        self._send(None)  # the end of the render stage

        # stage 3: structural metrics, fanned out over a process pool
        # (reference's multiprocessing.Pool, ref :226-227)
        clock = time.perf_counter()
        jobs = [
            (midi_path, self.reference_midi_for(idx, os.path.basename(midi_path)),
             c.n_conditioned_measures)
            for idx, midi_path in todo if idx not in parse_failed
        ]
        inner_rows, ref_rows, cond_rows = [], [], []

        def consume(results):
            nonlocal n_failed
            for midi_path, inner, reference, conditioned, err in results:
                if err is not None:
                    print(f"Error processing {midi_path}: {err}")
                    n_failed += 1
                    continue
                inner_rows.append((midi_path, *inner))
                if reference[0] is not None:
                    ref_rows.append((midi_path, *reference))
                if conditioned[0] is not None:
                    cond_rows.append((midi_path, *conditioned))

        if c.metrics_processes == 1 or len(jobs) <= 2:
            _init_metrics_worker()
            consume(map(_metrics_job, jobs))
        else:
            import multiprocessing as mp

            # spawn: fork after stage 2 initialized the CUDA runtime is
            # unsafe (inherited locked mutexes can deadlock children);
            # workers import only host modules and never touch CUDA
            n_failed_pre_pool = n_failed
            try:
                ctx = mp.get_context("spawn")
                with ctx.Pool(c.metrics_processes,
                              initializer=_init_metrics_worker) as pool:
                    consume(pool.imap(_metrics_job, jobs))
            except Exception as e:
                # spawn re-imports __main__, which fails for stdin/notebook
                # entry points — fall back to serial metrics. The pool may
                # have died MID-iteration (e.g. a worker OOM-killed), so
                # drop any rows it already yielded before re-running the
                # full job list, or every consumed file would appear twice
                # in the JSONLs and double-weight the aggregates
                print(f"metrics pool unavailable ({e}); running serially")
                inner_rows.clear()
                ref_rows.clear()
                cond_rows.clear()
                n_failed = n_failed_pre_pool
                _init_metrics_worker()
                consume(map(_metrics_job, jobs))

        # JSONL outputs (ref :232-284)
        def write_rows(rows, out_path):
            with open(out_path, "w") as f:
                for midi_path, melody, rhythm in rows:
                    f.write(json.dumps({
                        "path": midi_path,  # key parity: ref writes "path"
                        "melody": melody.model_dump(mode="json"),
                        "rhythm": rhythm.model_dump(mode="json"),
                    }) + "\n")

        inner_jsonl = os.path.join(self.structure_dir, "inner_similarity.jsonl")
        ref_jsonl = os.path.join(self.structure_dir, "reference_similarity.jsonl")
        cond_jsonl = os.path.join(
            self.structure_dir, "conditional_prefix_similarity.jsonl"
        )
        write_rows(inner_rows, inner_jsonl)
        write_rows(ref_rows, ref_jsonl)
        write_rows(cond_rows, cond_jsonl)

        def aggregate_similarity(jsonl_file: str) -> dict:
            import pandas as pd

            from ai_music_generation_tpu_torch.eval.aesthetics import frame_ci_stats

            if not os.path.exists(jsonl_file) or os.path.getsize(jsonl_file) == 0:
                return {"error": "No data available"}
            df = pd.read_json(jsonl_file, lines=True)
            if df.empty:
                return {"error": "No data available"}
            return frame_ci_stats(pd.DataFrame({
                "melody": df["melody"].apply(lambda x: x["mean_best_similarities"]),
                "rhythm": df["rhythm"].apply(lambda x: x["mean_best_similarities"]),
            }))

        aggregated = {
            "inner": aggregate_similarity(inner_jsonl),
            "reference": aggregate_similarity(ref_jsonl) if c.reference_midi_files_dir else None,
            "conditioned": aggregate_similarity(cond_jsonl) if c.n_conditioned_measures > 0 else None,
        }
        with open(os.path.join(self.structure_dir, "aggregated_similarities.json"), "w") as f:
            json.dump(aggregated, f, indent=4)

        seconds["metrics"] = time.perf_counter() - clock
        clock = time.perf_counter()
        result = {"aggregated_similarities": aggregated, "n_failed": n_failed,
                  "stage_seconds": seconds}
        if c.render_wav and wav_paths:
            input_jsonl = os.path.join(self.audiobox_dir, "wav_paths.jsonl")
            with open(input_jsonl, "w") as f:
                for p in wav_paths:
                    f.write(json.dumps({"path": p}) + "\n")
            output_jsonl = os.path.join(self.audiobox_dir, "aesthetics.jsonl")
            used_real = run_aesthetics(input_jsonl, output_jsonl,
                                       c.aesthetics_batch_size,
                                       device=c.device)
            agg = aggregate_jsonl_stats(output_jsonl, ["CE", "CU", "PC", "PQ"])
            with open(os.path.join(self.audiobox_dir, "aesthetics_aggregated.jsonl"), "w") as f:
                json.dump(agg, f, indent=4)
            result["aesthetics"] = agg
            result["aesthetics_engine"] = "audio-aes" if used_real else "proxy"
            if "mean" in agg:
                print("\nMean ± MoE (95% CI half-width)")
                print("-" * 40)
                for col, m in agg["mean"].items():
                    print(f"{col:>3}: {m:.6f} ± {agg['moe'][col]:.6f}")
        seconds["scoring"] = time.perf_counter() - clock
        return result
