"""Audio aesthetics scoring: audio-aes bridge + built-in proxy.

The port of ``ai_music_generation_tpu/eval/aesthetics.py``: the same
``audio-aes`` leg, proxy scorer and aggregation (tests/test_torch_host_copies.py
and tests/test_torch_eval_pipeline.py hold them to the originals), and the
same second leg: the Audiobox predictor (``eval/audiobox.py``, on the card
unless ``device="cpu"``) over a checkpoint named by ``weights`` or
``$AUDIOBOX_WEIGHTS``. A checkpoint that exists is never passed over for
the proxy.

The reference scores WAVs with Meta's Audiobox-aesthetics CLI
(``audio-aes``, CE/CU/PC/PQ axes; ref:
scripts/common/abc_to_midi_wav_and_aesthetics.py:323-355). That model
requires network-downloaded weights; this module:

1. shells out to ``audio-aes`` with the reference's exact invocation when
   the binary is on PATH (score parity with the reference);
2. otherwise falls back to a **documented proxy scorer** producing the same
   JSONL schema from interpretable DSP statistics — useful for relative
   comparisons and pipeline testing, NOT calibrated to Audiobox absolute
   scores (each record carries ``"proxy": true``).

Proxy axes:
- PQ (production quality): bandwidth occupancy + absence of clipping;
- PC (production complexity): spectral-flux variability;
- CE (content enjoyment): harmonicity (tonal peak energy vs noise floor);
- CU (content usefulness): blend of PQ and CE with duration adequacy.

Aggregation (mean/SE/MoE/95% CI via NormalDist) matches ref :327-355.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from statistics import NormalDist
from typing import Optional

import numpy as np

AXES = ("CE", "CU", "PC", "PQ")


def proxy_score_wave(wave: np.ndarray, sample_rate: int = 16_000) -> dict[str, float]:
    """DSP-statistics proxy for the four Audiobox axes, each mapped to ~[1, 10]."""
    wave = np.asarray(wave, np.float32)
    if wave.size < sample_rate // 4 or np.max(np.abs(wave)) < 1e-5:
        return {a: 1.0 for a in AXES}
    # frame-wise spectra
    frame = 1024
    hop = 512
    n_frames = max(1, (len(wave) - frame) // hop)
    frames = np.stack([wave[i * hop : i * hop + frame] for i in range(n_frames)])
    frames = frames * np.hanning(frame)
    spec = np.abs(np.fft.rfft(frames, axis=1))  # [F, bins]
    power = spec ** 2
    total = power.sum() + 1e-12

    # PQ: spectral rolloff (bandwidth use) and clipping penalty
    freqs = np.fft.rfftfreq(frame, 1 / sample_rate)
    cum = np.cumsum(power.mean(axis=0))
    rolloff = freqs[int(np.searchsorted(cum, 0.95 * cum[-1]))]
    clip_frac = float(np.mean(np.abs(wave) > 0.985))
    pq = 4.0 + 6.0 * min(rolloff / (sample_rate / 2), 1.0) - 20.0 * clip_frac

    # PC: spectral flux variability
    flux = np.sqrt(((np.diff(spec, axis=0)) ** 2).sum(axis=1))
    pc = 2.0 + 8.0 * float(np.tanh(3.0 * np.std(flux) / (np.mean(flux) + 1e-9) - 0.5)) if len(flux) else 2.0
    pc = float(np.clip(pc, 1.0, 10.0))

    # CE: harmonicity — share of energy in the top spectral peaks
    mean_spec = power.mean(axis=0)
    top = np.sort(mean_spec)[-32:].sum()
    harmonicity = top / (mean_spec.sum() + 1e-12)
    ce = 1.0 + 9.0 * float(harmonicity)

    # CU: blend with duration adequacy (>= 5 s considered adequate)
    dur_factor = min(len(wave) / (5 * sample_rate), 1.0)
    cu = 0.5 * pq + 0.3 * ce + 2.0 * dur_factor

    return {
        "CE": float(np.clip(ce, 1.0, 10.0)),
        "CU": float(np.clip(cu, 1.0, 10.0)),
        "PC": pc,
        "PQ": float(np.clip(pq, 1.0, 10.0)),
    }


def run_aesthetics(
    input_jsonl: str,
    output_jsonl: str,
    batch_size: int = 10,
    force_proxy: bool = False,
    weights: Optional[str] = None,
    device: str = "cuda",
) -> bool:
    """Score every {"path": wav} line of input_jsonl into output_jsonl.

    Scorer precedence (VERDICT #2): the real ``audio-aes`` CLI if on PATH >
    the Audiobox predictor (``eval/audiobox.py``, on ``device``) when a
    torch checkpoint is supplied via ``weights`` or ``$AUDIOBOX_WEIGHTS`` >
    the DSP proxy. Returns True when a model-based scorer (the CLI or the
    predictor with real weights) was used.
    """
    binary = shutil.which("audio-aes")
    if binary and not force_proxy:
        # reference invocation (ref :323-325)
        with open(output_jsonl, "w") as out:
            proc = subprocess.run(
                [binary, input_jsonl, "--batch-size", str(batch_size)],
                stdout=out, check=False,
            )
        # a broken install (nonzero exit / empty output) must engage the
        # fallback ladder, not silently report "real scorer used" with an
        # empty aesthetics.jsonl (review finding)
        if proc.returncode == 0 and os.path.getsize(output_jsonl) > 0:
            return True
        print(f"audio-aes failed (rc={proc.returncode}); falling back")

    weights = weights or os.environ.get("AUDIOBOX_WEIGHTS")
    if weights and os.path.exists(weights) and not force_proxy:
        from ai_music_generation_tpu_torch.eval.audiobox import AesPredictor

        AesPredictor(weights=weights, batch=batch_size,
                     device=device).score_jsonl(input_jsonl, output_jsonl)
        return True

    from ai_music_generation_tpu_torch.synth.wav_io import read_wav

    with open(input_jsonl) as f, open(output_jsonl, "w") as out:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path = json.loads(line)["path"]
            try:
                wave, rate = read_wav(path)
                scores = proxy_score_wave(wave, rate)
            except Exception:
                scores = {a: float("nan") for a in AXES}
            scores["proxy"] = True
            out.write(json.dumps(scores) + "\n")
    return False


def compare_scorers(
    input_jsonl: str,
    out_dir: str,
    batch_size: int = 10,
    device: str = "cuda",
) -> dict:
    """A/B harness: score the SAME wav list with the real ``audio-aes`` CLI
    and the proxy, then report per-axis deltas and rank agreement.

    Writes ``proxy.jsonl`` (+ ``real.jsonl`` when audio-aes is installed)
    and ``ab_report.json`` into ``out_dir``. When the real scorer is absent
    (as in this environment) the report records ``real_available: false`` —
    the harness is ready to produce calibration numbers the moment
    ``audio-aes`` lands on PATH. (VERDICT #2; ref scorer invocation:
    abc_to_midi_wav_and_aesthetics.py:323-355.) ``device`` is where the
    real leg's fallback to the Audiobox predictor would run.
    """
    os.makedirs(out_dir, exist_ok=True)
    proxy_path = os.path.join(out_dir, "proxy.jsonl")
    run_aesthetics(input_jsonl, proxy_path, batch_size, force_proxy=True)
    report: dict = {
        "real_available": shutil.which("audio-aes") is not None,
        "proxy_jsonl": proxy_path,
        "axes": {},
    }
    if report["real_available"]:
        real_path = os.path.join(out_dir, "real.jsonl")
        run_aesthetics(input_jsonl, real_path, batch_size, device=device)
        report["real_jsonl"] = real_path
        real = _load_axis_rows(real_path)
        prox = _load_axis_rows(proxy_path)
        n = min(len(real), len(prox))
        for axis in AXES:
            r = np.asarray([row.get(axis, float("nan")) for row in real[:n]])
            p = np.asarray([row.get(axis, float("nan")) for row in prox[:n]])
            ok = ~(np.isnan(r) | np.isnan(p))
            r, p = r[ok], p[ok]
            entry = {"n": int(ok.sum())}
            if len(r) >= 2:
                entry.update(
                    mean_real=float(r.mean()), mean_proxy=float(p.mean()),
                    mean_delta=float((p - r).mean()),
                    pearson=float(np.corrcoef(r, p)[0, 1]),
                    spearman=float(np.corrcoef(_ranks(r), _ranks(p))[0, 1]),
                )
            report["axes"][axis] = entry
    with open(os.path.join(out_dir, "ab_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def _load_axis_rows(jsonl_path: str) -> list[dict]:
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _ranks(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(x))
    return ranks


def frame_ci_stats(df) -> dict:
    """mean/se/moe/ci95 per column of a numeric DataFrame — the ONE
    implementation of the reference's CI aggregation convention
    (ref :329-349; NormalDist z, sem ddof=1), shared by the aesthetics
    and structural-similarity aggregates (eval/pipeline.py)."""
    mean = df.mean()
    se = df.sem(ddof=1)
    z95 = NormalDist().inv_cdf(0.975)
    moe = z95 * se
    return {
        "mean": mean.to_dict(),
        "se": se.to_dict(),
        "moe": moe.to_dict(),
        "ci95_lower": (mean - moe).to_dict(),
        "ci95_upper": (mean + moe).to_dict(),
    }


def aggregate_jsonl_stats(jsonl_path: str, columns: Optional[list[str]] = None) -> dict:
    """mean/se/moe/ci95 per numeric column (ref aggregation :329-349)."""
    import pandas as pd

    if not os.path.exists(jsonl_path) or os.path.getsize(jsonl_path) == 0:
        return {"error": "No data available"}
    df = pd.read_json(jsonl_path, lines=True)
    if df.empty:
        return {"error": "No data available"}
    df = df.select_dtypes("number")
    if columns:
        df = df[[c for c in columns if c in df.columns]]
    return frame_ci_stats(df)
