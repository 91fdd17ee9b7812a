"""Hermetic real-data golden replay harness: the port of
``ai_music_generation_tpu/cli/replay_goldens.py``, with its stages,
goldens, ``--goldens`` override, SKIP/PASS/FAIL report and exit codes. The
stages run the port's own pieces, and ``--device`` (default ``cuda``)
places the Audiobox scorer and the render on the card unless the caller
asks for the CPU.

Three parity proofs are blocked in the build environment (no network, no
IrishMAN/Bach corpora, no released weights). This one command turns them
into replayable debt the moment the artifacts exist locally:

1. **Prepare goldens** — the reference pins its corpus stats as trailing
   comments that act as regression oracles
   (ref: nanoGPT/data/irishman/prepare_char.py:110-159 — vocab 95,
   60,944,859 train / 611,888 val tokens; leadsheet subset 12,935,627 /
   117,776; ref: nanoGPT/data/bach/prepare.py trailing comments — vocab 121,
   310,183 train / 30,509 val tokens). Each provided corpus is prepared and
   checked against those numbers.
2. **TunesFormer checkpoint bridge** — the published ``weights.pth``
   (ref: tunesformer/generate.py:57-89 auto-download) is imported, its
   architecture inferred from tensor shapes, mapped to the port's state
   dict, exported back to the reference layout, and compared
   tensor-for-tensor (byte equality) — the real-weights leg of the two-way
   bridge validated on synthetic weights in tests/.
3. **Audiobox score parity** — with the released audiobox-aesthetics
   checkpoint (and optionally the ``audio-aes`` CLI on PATH), scores wavs
   through the port's scorer, asserts every checkpoint key mapped, and compares
   per-axis scores against the reference scorer
   (ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:323-355).
4. **abc2midi differential** — with the real ``abc2midi`` binary (ref
   invocation: subprocess at scripts/common/abc_to_midi_wav_and_aesthetics
   .py:118), compiles every ``.abc`` in a directory through BOTH compilers
   and diffs the normalized note-event streams (pitch, onset seconds,
   duration seconds — tempo map applied), reporting per-file match rates
   against a golden threshold. This is the one-command answer to "does the
   C++ ABC compiler reproduce abc2midi" the in-repo differential twins
   cannot give.
5. **FluidSynth/SF2 A/B** — with the real ``fluidsynth`` binary + the
   reference soundfont (ref: scripts/common/midi_to_wav_and_aesthetics
   .py:105-110; "Essential Keys-sforzando-v9.6.sf2", README.md:18-25),
   renders every ``.mid`` in a directory both ways at 16 kHz, scores both
   sets through the port's Audiobox scorer (requires --audiobox_ckpt), and
   asserts the per-axis mean score delta sits within the pipeline's 95% CI
   (ref CI formula: abc_to_midi_wav_and_aesthetics.py:287-321) or the
   golden tolerance, whichever is wider.
6. **GPT-2 BPE prepare goldens** — with the shakespeare ``input.txt`` and
   resolvable GPT-2 BPE assets (data/gpt2_bpe.py), runs the gpt2bpe
   prepare and checks the reference's pinned token counts
   (ref: nanoGPT/data/shakespeare/prepare.py:32-33 — 301,966 train /
   36,059 val).

Every stage is gated on its inputs: absent inputs SKIP with a reason
(exit 0); present inputs must PASS their goldens (any FAIL exits 1).
``--goldens custom.json`` overrides the expected numbers — used by the
plumbing test to replay the whole harness on tiny fixtures.

Usage (full replay):
    python -m ai_music_generation_tpu_torch.cli.replay_goldens \
        --irishman_train train.json --irishman_valid validation.json \
        --leadsheet_train train_leadsheet.json \
        --leadsheet_valid validation_leadsheet.json \
        --bach_train_dir data/bach/train/midi_texts \
        --bach_valid_dir data/bach/validation/midi_texts \
        --bach_extra_vocab_dirs data/irishman_midi/texts \
        --tunesformer_weights weights.pth \
        --audiobox_ckpt checkpoint.pt --wav_jsonl input.jsonl \
        --out_dir /tmp/replay --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable, Optional

# Reference golden numbers (see module docstring for ref: citations).
GOLDENS = {
    "irishman_char": {"vocab": 95, "train_tokens": 60_944_859,
                      "val_tokens": 611_888},
    "leadsheet_char": {"vocab": 95, "train_tokens": 12_935_627,
                       "val_tokens": 117_776},
    "bach_midi": {"vocab": 121, "train_tokens": 310_183,
                  "val_tokens": 30_509},
    "tunesformer": {"patch_layers": 9, "char_layers": 3, "n_embd": 768,
                    "patch_size": 32},
    "audiobox_score_atol": 1e-3,
    # abc2midi differential: fraction of note events matched per file
    # (pitch exact, onset within onset_tol_s, duration within dur_tol_s),
    # aggregated as the mean over files; min_note_match guards the tail.
    "abc2midi": {"mean_note_match": 0.97, "min_note_match": 0.85,
                 "onset_tol_s": 0.02, "dur_tol_s": 0.05},
    # FluidSynth A/B: per-axis |mean(ours - fluidsynth)| must sit within
    # max(tol, the 95% CI half-width of the per-file deltas)
    "fluidsynth_aes_tol": 0.25,
    # ref: nanoGPT/data/shakespeare/prepare.py:32-33
    "shakespeare_gpt2": {"train_tokens": 301_966, "val_tokens": 36_059},
}


class Report:
    def __init__(self):
        self.rows: list[tuple[str, str, str]] = []

    def skip(self, stage: str, why: str):
        self.rows.append((stage, "SKIP", why))
        print(f"SKIP {stage}: {why}")

    def check(self, stage: str, got: dict, want: dict):
        bad = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
        if bad:
            detail = ", ".join(f"{k}: got {g} want {w}"
                               for k, (g, w) in bad.items())
            self.rows.append((stage, "FAIL", detail))
            print(f"FAIL {stage}: {detail}")
        else:
            self.rows.append((stage, "PASS", json.dumps(got, sort_keys=True)))
            print(f"PASS {stage}: {got}")

    def fail(self, stage: str, why: str):
        self.rows.append((stage, "FAIL", why))
        print(f"FAIL {stage}: {why}")

    def ok(self, stage: str, detail: str):
        self.rows.append((stage, "PASS", detail))
        print(f"PASS {stage}: {detail}")

    @property
    def failed(self) -> bool:
        return any(s == "FAIL" for _, s, _ in self.rows)


def _gate(report: Report, stage: str, *paths: Optional[str]) -> bool:
    """True when every path for the stage is provided and exists."""
    if any(p is None for p in paths):
        report.skip(stage, "inputs not provided")
        return False
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        report.skip(stage, f"missing: {', '.join(missing)}")
        return False
    return True


def _load_json(path: str) -> list:
    with open(path) as f:
        return json.load(f)


def _char_stage(report, goldens, stage, train_json, valid_json, out_dir):
    from ai_music_generation_tpu_torch.data.prepare import prepare_char

    vocab, n_train, n_val = prepare_char(
        _load_json(train_json), _load_json(valid_json),
        os.path.join(out_dir, stage))
    report.check(stage, {"vocab": vocab, "train_tokens": n_train,
                         "val_tokens": n_val}, goldens[stage])


def _bach_stage(report, goldens, train_dir, valid_dir, extra_dirs, out_dir):
    from ai_music_generation_tpu_torch.data.prepare import prepare_midi_texts

    vocab, n_train, n_val = prepare_midi_texts(
        train_dir, valid_dir, os.path.join(out_dir, "bach_midi"),
        extra_dirs or ())
    report.check("bach_midi", {"vocab": vocab, "train_tokens": n_train,
                               "val_tokens": n_val}, goldens["bach_midi"])


def _tunesformer_stage(report, goldens, weights, out_dir):
    import numpy as np

    from ai_music_generation_tpu_torch.models.tunesformer_export import (
        reference_layout)
    from ai_music_generation_tpu_torch.models.tunesformer_import import (
        config_from_reference_state,
        port_state_from_reference,
        read_reference,
    )

    _, state = read_reference(weights)
    state = {k: v for k, v in state.items()
             if not k.endswith((".attn.bias", ".attn.masked_bias"))}
    cfg = config_from_reference_state(state)
    report.check("tunesformer_arch", {
        "patch_layers": cfg.patch_layers, "char_layers": cfg.char_layers,
        "n_embd": cfg.n_embd, "patch_size": cfg.patch_size,
    }, goldens["tunesformer"])

    back = reference_layout(port_state_from_reference(state, cfg), cfg)
    missing = sorted(set(state) - set(back))
    diff = [k for k in back
            if k in state and not np.array_equal(
                np.asarray(back[k], np.float32),
                np.asarray(state[k].float().numpy() if hasattr(state[k], "numpy")
                           else state[k], np.float32))]
    if missing or diff:
        report.fail("tunesformer_bridge",
                    f"missing={missing[:5]} diff={diff[:5]}")
    else:
        report.ok("tunesformer_bridge",
                  f"{len(back)} tensors byte-equal through import->export")


def _audiobox_stage(report, goldens, ckpt, wav_jsonl, out_dir, device):
    import shutil
    import subprocess

    from ai_music_generation_tpu_torch.eval.audiobox import AesPredictor

    pred = AesPredictor(weights=ckpt, device=device)
    if pred.unmapped:
        report.fail("audiobox_keys",
                    f"{len(pred.unmapped)} unmapped checkpoint keys "
                    f"(extend HEAD_KEY_HINTS): {pred.unmapped[:8]}")
        return
    report.ok("audiobox_keys", "all checkpoint keys mapped")
    ours_path = os.path.join(out_dir, "audiobox_ours.jsonl")
    pred.score_jsonl(wav_jsonl, ours_path)
    ours = [json.loads(ln) for ln in open(ours_path)]

    aes = shutil.which("audio-aes")
    if not aes:
        report.skip("audiobox_parity",
                    "audio-aes CLI not on PATH (scores written to "
                    + ours_path + ")")
        return
    theirs_raw = subprocess.run(
        [aes, wav_jsonl, "--batch-size", "10"],
        capture_output=True, text=True, check=True).stdout
    theirs = [json.loads(ln) for ln in theirs_raw.splitlines() if ln.strip()]
    atol = goldens["audiobox_score_atol"]
    bad = [
        (i, ax, a[ax], b[ax])
        for i, (a, b) in enumerate(zip(ours, theirs))
        for ax in ("CE", "CU", "PC", "PQ")
        if not abs(a[ax] - b[ax]) <= atol
    ]
    if bad:
        report.fail("audiobox_parity", f"{len(bad)} scores off: {bad[:5]}")
    else:
        report.ok("audiobox_parity",
                  f"{len(ours)} files x 4 axes within {atol}")


def _event_stream(midi_path: str):
    """Normalized note events (pitch, onset_s, dur_s) sorted by (pitch,
    onset): the tempo-map seconds domain makes streams comparable across
    compilers with different tick resolutions / tempo encodings."""
    from ai_music_generation_tpu_torch.codec.midi_io import parse_midi_file
    from ai_music_generation_tpu_torch.synth.render import midi_to_events

    sr = 1000  # millisecond resolution through the shared tempo-map code
    ev = midi_to_events(parse_midi_file(midi_path), sample_rate=sr)
    notes = [(int(p), s / sr, d / sr) for p, s, d, _ in ev.tolist()]
    return sorted(notes)


def _match_rate(ours, theirs, onset_tol, dur_tol) -> float:
    """Greedy bipartite match of two sorted note streams; rate is matches
    over the larger stream (so both insertions and deletions count)."""
    if not ours and not theirs:
        return 1.0
    used = [False] * len(theirs)
    matched = 0
    j0 = 0
    for p, s, d in ours:
        for j in range(j0, len(theirs)):
            q, t, e = theirs[j]
            if q < p or (q == p and t < s - onset_tol):
                if not used[j] and q < p:
                    j0 = j  # streams are pitch-major sorted: safe to skip
                continue
            if q > p or t > s + onset_tol:
                break
            if not used[j] and abs(d - e) <= dur_tol:
                used[j] = True
                matched += 1
                break
    return matched / max(len(ours), len(theirs))


def _abc2midi_stage(report, goldens, abc2midi_bin, abc_dir, out_dir):
    import subprocess

    from ai_music_generation_tpu_torch.abcnotation.to_midi import (
        abc_file_to_midi_file,
    )

    g = goldens["abc2midi"]
    ref_dir = os.path.join(out_dir, "abc2midi_ref")
    ours_dir = os.path.join(out_dir, "abc2midi_ours")
    os.makedirs(ref_dir, exist_ok=True)
    os.makedirs(ours_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(abc_dir) if f.endswith(".abc"))
    if not files:
        report.skip("abc2midi_diff", f"no .abc files in {abc_dir}")
        return
    rows, rates = [], []
    for name in files:
        stem = os.path.splitext(name)[0]
        abc_path = os.path.join(abc_dir, name)
        ref_mid = os.path.join(ref_dir, stem + ".mid")
        ours_mid = os.path.join(ours_dir, stem + ".mid")
        # the reference tolerates abc2midi failures per file
        # (ref: irishman_dataset_to_midi.py:55 check=False)
        proc = subprocess.run([abc2midi_bin, abc_path, "-o", ref_mid],
                              capture_output=True, text=True)
        row = {"file": name}
        try:
            abc_file_to_midi_file(abc_path, ours_mid)
            if proc.returncode != 0 or not os.path.exists(ref_mid):
                row["status"] = "abc2midi_failed"
            else:
                rate = _match_rate(
                    _event_stream(ours_mid), _event_stream(ref_mid),
                    g["onset_tol_s"], g["dur_tol_s"])
                row.update(status="ok", note_match=round(rate, 4))
                rates.append(rate)
        except Exception as e:  # our compiler must not crash on corpus abc
            row.update(status="ours_failed", error=f"{type(e).__name__}: {e}")
            rates.append(0.0)
        rows.append(row)
    with open(os.path.join(out_dir, "abc2midi_diff.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    if not rates:
        report.skip("abc2midi_diff", "abc2midi produced no comparable files")
        return
    mean_rate = sum(rates) / len(rates)
    min_rate = min(rates)
    got = {"files": len(rates), "mean_note_match": round(mean_rate, 4),
           "min_note_match": round(min_rate, 4)}
    if mean_rate >= g["mean_note_match"] and min_rate >= g["min_note_match"]:
        report.ok("abc2midi_diff", json.dumps(got))
    else:
        worst = sorted((r for r in rows if "note_match" in r or
                        r["status"] != "ok"),
                       key=lambda r: r.get("note_match", -1.0))[:5]
        report.fail("abc2midi_diff",
                    f"{got} below threshold {g}; worst: {worst}")


def _fluidsynth_stage(report, goldens, fluidsynth_bin, sf2, midi_dir,
                      audiobox_ckpt, out_dir, device):
    import subprocess
    from statistics import NormalDist

    import numpy as np

    from ai_music_generation_tpu_torch.codec.midi_io import parse_midi_file
    from ai_music_generation_tpu_torch.synth.render import synthesize_midi
    from ai_music_generation_tpu_torch.synth.wav_io import write_wav

    files = sorted(f for f in os.listdir(midi_dir)
                   if f.lower().endswith((".mid", ".midi")))
    if not files:
        report.skip("fluidsynth_ab", f"no .mid files in {midi_dir}")
        return
    ref_dir = os.path.join(out_dir, "fs_ref")
    ours_dir = os.path.join(out_dir, "fs_ours")
    os.makedirs(ref_dir, exist_ok=True)
    os.makedirs(ours_dir, exist_ok=True)
    pairs = []
    for name in files:
        stem = os.path.splitext(name)[0]
        mid = os.path.join(midi_dir, name)
        ref_wav = os.path.join(ref_dir, stem + ".wav")
        ours_wav = os.path.join(ours_dir, stem + ".wav")
        # the reference renders via midi2audio.FluidSynth at 16 kHz
        # (ref: midi_to_wav_and_aesthetics.py:105-110) — same CLI shape
        proc = subprocess.run(
            [fluidsynth_bin, "-ni", sf2, mid, "-F", ref_wav, "-r", "16000"],
            capture_output=True, text=True)
        if proc.returncode != 0 or not os.path.exists(ref_wav):
            continue
        wave = synthesize_midi(parse_midi_file(mid), voice=f"sf2:{sf2}",
                               device=device)
        write_wav(ours_wav, np.asarray(wave))
        pairs.append((stem, ours_wav, ref_wav))
    if not pairs:
        report.fail("fluidsynth_ab", "fluidsynth rendered no files")
        return
    report.ok("fluidsynth_render",
              f"{len(pairs)}/{len(files)} files rendered both ways")
    if not (audiobox_ckpt and os.path.exists(audiobox_ckpt)):
        report.skip("fluidsynth_ab",
                    "renders written but --audiobox_ckpt missing for the "
                    "aesthetics A/B")
        return
    from ai_music_generation_tpu_torch.eval.audiobox import AesPredictor

    pred = AesPredictor(weights=audiobox_ckpt, device=device)

    def score(paths, tag):
        jsonl_in = os.path.join(out_dir, f"fs_{tag}.jsonl")
        jsonl_out = os.path.join(out_dir, f"fs_{tag}_scores.jsonl")
        with open(jsonl_in, "w") as f:
            for p in paths:
                f.write(json.dumps({"path": p}) + "\n")
        pred.score_jsonl(jsonl_in, jsonl_out)
        return [json.loads(ln) for ln in open(jsonl_out)]

    ours = score([p for _, p, _ in pairs], "ours")
    ref = score([p for _, _, p in pairs], "ref")
    tol = goldens["fluidsynth_aes_tol"]
    z = NormalDist().inv_cdf(0.975)  # ref CI formula (abc_...py:287-321)
    bad, detail = [], {}
    for ax in ("CE", "CU", "PC", "PQ"):
        deltas = np.asarray([a[ax] - b[ax] for a, b in zip(ours, ref)])
        mean = float(deltas.mean())
        ci = float(z * deltas.std(ddof=1) / np.sqrt(len(deltas))) if len(
            deltas) > 1 else 0.0
        detail[ax] = {"mean_delta": round(mean, 4), "ci95": round(ci, 4)}
        if abs(mean) > max(tol, ci):
            bad.append(ax)
    if bad:
        report.fail("fluidsynth_ab", f"axes {bad} outside CI/tol: {detail}")
    else:
        report.ok("fluidsynth_ab", json.dumps(detail))


def _shakespeare_stage(report, goldens, input_txt, bpe_assets, out_dir):
    from ai_music_generation_tpu_torch.data.gpt2_bpe import (
        Gpt2AssetsUnavailable)
    from ai_music_generation_tpu_torch.data.prepare import prepare_gpt2bpe

    with open(input_txt, encoding="utf-8") as f:
        text = f.read()
    try:
        _, n_train, n_val = prepare_gpt2bpe(
            text, os.path.join(out_dir, "shakespeare_gpt2"),
            assets_dir=bpe_assets)
    except Gpt2AssetsUnavailable as e:
        report.skip("shakespeare_gpt2", str(e))
        return
    report.check("shakespeare_gpt2",
                 {"train_tokens": n_train, "val_tokens": n_val},
                 goldens["shakespeare_gpt2"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--irishman_train")
    ap.add_argument("--irishman_valid")
    ap.add_argument("--leadsheet_train")
    ap.add_argument("--leadsheet_valid")
    ap.add_argument("--bach_train_dir")
    ap.add_argument("--bach_valid_dir")
    ap.add_argument("--bach_extra_vocab_dirs", nargs="*", default=[])
    ap.add_argument("--tunesformer_weights")
    ap.add_argument("--audiobox_ckpt")
    ap.add_argument("--wav_jsonl")
    ap.add_argument("--abc2midi_bin", help="path to the real abc2midi "
                    "binary (stage 4: event-stream differential)")
    ap.add_argument("--abc_dir", help="directory of .abc files for the "
                    "abc2midi differential (e.g. the validation set)")
    ap.add_argument("--fluidsynth_bin", help="path to the real fluidsynth "
                    "binary (stage 5: SF2 render A/B)")
    ap.add_argument("--sf2", help="the reference soundfont "
                    "(Essential Keys-sforzando-v9.6.sf2)")
    ap.add_argument("--midi_dir", help="directory of .mid files for the "
                    "FluidSynth A/B")
    ap.add_argument("--shakespeare_txt", help="tiny-shakespeare input.txt "
                    "(stage 6: GPT-2 BPE prepare goldens)")
    ap.add_argument("--bpe_assets", help="dir with encoder.json + vocab.bpe "
                    "(else tiktoken/HF-cache resolution, data/gpt2_bpe.py)")
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(),
                                                      "replay_goldens"))
    ap.add_argument("--goldens", help="JSON file overriding the expected "
                    "numbers (plumbing tests on tiny fixtures)")
    ap.add_argument("--device", default="cuda",
                    help="where the Audiobox scorer and the render run "
                    "('cuda' | 'cpu')")
    a = ap.parse_args(argv)

    goldens = dict(GOLDENS)
    if a.goldens:
        with open(a.goldens) as f:
            goldens.update(json.load(f))
    os.makedirs(a.out_dir, exist_ok=True)
    report = Report()

    stages: list[tuple[str, list, Callable]] = [
        ("irishman_char", [a.irishman_train, a.irishman_valid],
         lambda: _char_stage(report, goldens, "irishman_char",
                             a.irishman_train, a.irishman_valid, a.out_dir)),
        ("leadsheet_char", [a.leadsheet_train, a.leadsheet_valid],
         lambda: _char_stage(report, goldens, "leadsheet_char",
                             a.leadsheet_train, a.leadsheet_valid, a.out_dir)),
        ("bach_midi", [a.bach_train_dir, a.bach_valid_dir],
         lambda: _bach_stage(report, goldens, a.bach_train_dir,
                             a.bach_valid_dir, a.bach_extra_vocab_dirs,
                             a.out_dir)),
        ("tunesformer", [a.tunesformer_weights],
         lambda: _tunesformer_stage(report, goldens, a.tunesformer_weights,
                                    a.out_dir)),
        ("audiobox", [a.audiobox_ckpt, a.wav_jsonl],
         lambda: _audiobox_stage(report, goldens, a.audiobox_ckpt,
                                 a.wav_jsonl, a.out_dir, a.device)),
        ("abc2midi_diff", [a.abc2midi_bin, a.abc_dir],
         lambda: _abc2midi_stage(report, goldens, a.abc2midi_bin,
                                 a.abc_dir, a.out_dir)),
        ("fluidsynth_ab", [a.fluidsynth_bin, a.sf2, a.midi_dir],
         lambda: _fluidsynth_stage(report, goldens, a.fluidsynth_bin,
                                   a.sf2, a.midi_dir, a.audiobox_ckpt,
                                   a.out_dir, a.device)),
        ("shakespeare_gpt2", [a.shakespeare_txt],
         lambda: _shakespeare_stage(report, goldens, a.shakespeare_txt,
                                    a.bpe_assets, a.out_dir)),
    ]
    for stage, paths, fn in stages:
        if _gate(report, stage, *paths):
            fn()

    with open(os.path.join(a.out_dir, "replay_report.json"), "w") as f:
        json.dump([{"stage": s, "status": st, "detail": d}
                   for s, st, d in report.rows], f, indent=2)
    n_pass = sum(s == "PASS" for _, s, _ in report.rows)
    n_skip = sum(s == "SKIP" for _, s, _ in report.rows)
    print(f"replay: {n_pass} pass, {n_skip} skip, "
          f"{sum(s == 'FAIL' for _, s, _ in report.rows)} fail")
    return 1 if report.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
