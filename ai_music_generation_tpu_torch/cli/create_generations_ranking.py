"""Multi-metric generation ranking CLI.

Parity with ref: scripts/common/create_generations_ranking.py:38-278 —
joins structural similarity JSONLs and aesthetics by normalized identifier
(``file_sample_X``/``sample_X``/``file_X`` -> ``X``), ranks every metric
descending with method="min", sums ranks, final rank ascending; writes
``all_metrics.csv``, ``detailed_ranking.csv``, ``final_ranking.csv``,
``ranked_identifiers.txt``; prints metric correlations.

A copy of ``ai_music_generation_tpu/cli/create_generations_ranking.py``
(the port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds its outputs byte-equal to the original's).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Any

import pandas as pd


def read_jsonl(filepath) -> list[dict[str, Any]]:
    data = []
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if line:
                data.append(json.loads(line))
    return data


def extract_identifier_from_path(path: str) -> str:
    """'file_sample_bwv103.6' -> 'bwv103.6' (ref :38-55)."""
    filename = Path(path).stem
    if "file_sample_" in filename:
        return filename.replace("file_sample_", "")
    if "sample_" in filename:
        return filename.replace("sample_", "")
    if "file_" in filename:
        return filename.replace("file_", "")
    return filename


def extract_similarities_as_dict(data: list[dict[str, Any]]) -> dict[str, tuple[float, float]]:
    out = {}
    for entry in data:
        identifier = extract_identifier_from_path(entry["path"])
        out[identifier] = (
            entry["melody"]["mean_best_similarities"],
            entry["rhythm"]["mean_best_similarities"],
        )
    return out


def create_rankings(df: pd.DataFrame, ranking_columns: list[str]) -> pd.DataFrame:
    """Descending per-metric ranks, rank-sum, ascending final rank (ref :72-87)."""
    for col in ranking_columns:
        df[f"{col}_rank"] = df[col].rank(ascending=False, method="min")
    rank_cols = [f"{c}_rank" for c in ranking_columns]
    df["sum_of_ranks"] = df[rank_cols].sum(axis=1)
    df["final_rank"] = df["sum_of_ranks"].rank(ascending=True, method="min").astype(int)
    return df


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("structural_metrics_dir",
                    help=".../metrics/<converter>/structure directory")
    ap.add_argument("aesthetics_dir",
                    help=".../audiobox_aesthetics/... directory")
    ap.add_argument("results_dir")
    ap.add_argument("--include_reference_similarities", action="store_true")
    a = ap.parse_args(argv)

    sm = Path(a.structural_metrics_dir)
    ad = Path(a.aesthetics_dir)
    results = Path(a.results_dir)
    results.mkdir(parents=True, exist_ok=True)

    inner_sim = extract_similarities_as_dict(read_jsonl(sm / "inner_similarity.jsonl"))
    prefix_path = sm / "conditional_prefix_similarity.jsonl"
    prefix_sim = (
        extract_similarities_as_dict(read_jsonl(prefix_path))
        if prefix_path.exists() else {}
    )
    ref_sim = {}
    if a.include_reference_similarities and (sm / "reference_similarity.jsonl").exists():
        ref_sim = extract_similarities_as_dict(read_jsonl(sm / "reference_similarity.jsonl"))

    aesthetics = read_jsonl(ad / "aesthetics.jsonl")
    wav_paths = [d["path"] for d in read_jsonl(ad / "wav_paths.jsonl")]

    rows = []
    for i, wav_path in enumerate(wav_paths):
        identifier = extract_identifier_from_path(wav_path)
        row: dict[str, Any] = {
            "identifier": identifier,
            "original_wav_path": wav_path,
        }
        for axis in ("CE", "CU", "PC", "PQ"):
            row[axis] = aesthetics[i].get(axis) if i < len(aesthetics) else None
        m = inner_sim.get(identifier, (None, None))
        row["inner_melodic_sim"], row["inner_rhythmic_sim"] = m
        if prefix_sim:
            m = prefix_sim.get(identifier, (None, None))
            row["prefix_melodic_sim"], row["prefix_rhythmic_sim"] = m
        if ref_sim:
            m = ref_sim.get(identifier, (None, None))
            row["reference_melodic_sim"], row["reference_rhythmic_sim"] = m
        rows.append(row)

    df = pd.DataFrame(rows)
    df.to_csv(results / "all_metrics.csv", index=False)

    ranking_columns = [
        c for c in (
            "CE", "CU", "PC", "PQ",
            "inner_melodic_sim", "inner_rhythmic_sim",
            "prefix_melodic_sim", "prefix_rhythmic_sim",
            "reference_melodic_sim", "reference_rhythmic_sim",
        ) if c in df.columns and df[c].notna().any()
    ]
    df = create_rankings(df, ranking_columns)

    df_sorted = df.sort_values("final_rank")
    df_sorted.to_csv(results / "detailed_ranking.csv", index=False)
    df_sorted[["identifier", "final_rank"]].to_csv(results / "final_ranking.csv", index=False)
    with open(results / "ranked_identifiers.txt", "w") as f:
        f.write("Rank\tIdentifier\n")
        for _, row in df_sorted.iterrows():
            f.write(f"{row['final_rank']}\t{row['identifier']}\n")

    print("\nSummary Statistics:")
    print(f"Total number of files: {len(df)}")
    print("\nTop 5 files by final ranking:")
    print(df_sorted[["identifier", "final_rank", "sum_of_ranks"]].head())
    print("\nCorrelation between metrics:")
    print(df[ranking_columns].corr())
    return df_sorted


if __name__ == "__main__":
    main()
