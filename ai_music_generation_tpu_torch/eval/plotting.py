"""Metric plots (parity: core/metrics/plotting.py:9-99).

A copy of ``ai_music_generation_tpu/eval/plotting.py`` (host code; the port
imports nothing of the JAX package): tests/test_torch_host_copies.py holds
its figures' data and saved files to the original's.
"""

from __future__ import annotations

from typing import Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from ai_music_generation_tpu_torch.eval.calculate import SimilarityResult


def plot_similarity_matrix(
    result: SimilarityResult, title: str = "Similarity matrix",
    save_path: Optional[str] = None,
):
    fig, ax = plt.subplots(figsize=(8, 6))
    mat = np.asarray(result.similarity_matrix, dtype=float)
    if mat.size == 0:
        mat = np.zeros((1, 1))
    im = ax.imshow(mat, cmap="viridis", vmin=0.0, vmax=1.0, aspect="auto")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("measure j")
    ax.set_ylabel("measure i")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_distribution_of_best_similarities(
    result: SimilarityResult, title: str = "Best similarity distribution",
    bins: int = 20, save_path: Optional[str] = None,
):
    fig, ax = plt.subplots(figsize=(8, 4))
    values = [m[0] for m in result.best_matches]
    ax.hist(values, bins=bins, range=(0.0, 1.0))
    ax.set_title(title)
    ax.set_xlabel("best similarity")
    ax.set_ylabel("count")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_distribution_of_best_match_measure_distances(
    result: SimilarityResult, title: str = "Best-match distance distribution",
    save_path: Optional[str] = None,
):
    fig, ax = plt.subplots(figsize=(8, 4))
    distances = [d for m in result.best_matches for d in m[2]]
    if distances:
        ax.hist(distances, bins=range(0, max(distances) + 2))
    ax.set_title(title)
    ax.set_xlabel("|j - i|")
    ax.set_ylabel("count")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig
