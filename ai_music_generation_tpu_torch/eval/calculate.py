"""Similarity-matrix calculators (parity: core/metrics/calculate.py:9-325).

The port's copy of ``ai_music_generation_tpu/eval/calculate.py`` (the port
imports nothing of the JAX package; tests/test_torch_host_copies.py holds
the two to each other).

Three modes, identical outputs to the reference:

- inner: NxN self-similarity, best match per measure excluding self;
- reference: (M-skip)x(N-skip) cross-similarity generated-vs-ground-truth,
  skipping the conditioned prefix from both;
- conditioned: Nxk similarity of every measure vs the first k conditioning
  measures, best matches reported for measures >= k.

The matrix construction accepts either a scalar ``similarity_function``
(reference-compatible path) or a precomputed matrix via the vectorized
builders in ``eval/similarities.py`` (``matrix_fn``) — the hot path for the
1,000-sample eval protocol.
"""

from __future__ import annotations

import math
from typing import Callable, Literal, Optional, Sequence, TypeVar

from pydantic import BaseModel

vectorT = TypeVar("vectorT")

BestMatchMode = Literal["first", "closest", "all"]


class SimilarityResult(BaseModel):
    similarity_matrix: list[list[float]]
    best_matches: list[tuple[float, list[int], list[int]]]
    mean_best_similarities: float


def _build_matrix(rows, cols, similarity_function, matrix_fn):
    if matrix_fn is not None:
        import numpy as np

        return [[float(v) for v in row] for row in np.asarray(matrix_fn(rows, cols))]
    return [[similarity_function(r, c) for c in cols] for r in rows]


def _tie_select(row, i, max_sim, mode: BestMatchMode, rel_tol, abs_tol, exclude=None):
    tied_js = [
        j for j, s in enumerate(row)
        if j != exclude and math.isclose(s, max_sim, rel_tol=rel_tol, abs_tol=abs_tol)
    ]
    tied_diffs = [abs(j - i) for j in tied_js]
    if mode == "first" and tied_js:
        return tied_js[:1], tied_diffs[:1]
    if mode == "closest" and tied_js:
        min_diff = min(tied_diffs)
        for j, d in zip(tied_js, tied_diffs):
            if d == min_diff:
                return [j], [d]
    return tied_js, tied_diffs


def _finalize(similarity_matrix, best_matches) -> SimilarityResult:
    mean_max = (
        sum(m[0] for m in best_matches) / len(best_matches) if best_matches else 0.0
    )
    return SimilarityResult(
        similarity_matrix=similarity_matrix,
        best_matches=best_matches,
        mean_best_similarities=mean_max,
    )


def calculate_inner_similarity_of_music_vectors(
    vectors: Sequence,
    similarity_function: Optional[Callable] = None,
    return_best_matches: BestMatchMode = "all",
    rel_tol: float = 1e-9,
    abs_tol: float = 1e-12,
    matrix_fn: Optional[Callable] = None,
) -> SimilarityResult:
    """NxN self-similarity; best match per row excludes the diagonal
    (ref :15-82)."""
    n = len(vectors)
    sim = _build_matrix(vectors, vectors, similarity_function, matrix_fn)
    best_matches = []
    for i in range(n):
        if n < 2:
            break
        max_sim = max(sim[i][j] for j in range(n) if j != i)
        tied_js, tied_diffs = _tie_select(
            sim[i], i, max_sim, return_best_matches, rel_tol, abs_tol, exclude=i
        )
        best_matches.append((max_sim, tied_js, tied_diffs))
    return _finalize(sim, best_matches)


def calculate_reference_similarity_of_music_vectors(
    source_piece_vectors: Sequence,
    reference_piece_vectors: Sequence,
    similarity_function: Optional[Callable] = None,
    return_best_matches: BestMatchMode = "all",
    rel_tol: float = 1e-9,
    abs_tol: float = 1e-12,
    n_measures_to_skip: int = 0,
    matrix_fn: Optional[Callable] = None,
) -> SimilarityResult:
    """Cross-similarity after skipping the conditioned prefix (ref :85-179)."""
    src = source_piece_vectors[n_measures_to_skip:]
    ref = reference_piece_vectors[n_measures_to_skip:]
    sim = _build_matrix(src, ref, similarity_function, matrix_fn)
    best_matches = []
    for i in range(len(src)):
        row = sim[i]
        if not row:
            continue
        max_sim = max(row)
        tied_js, tied_diffs = _tie_select(
            row, i, max_sim, return_best_matches, rel_tol, abs_tol
        )
        best_matches.append((max_sim, tied_js, tied_diffs))
    return _finalize(sim, best_matches)


def calculate_conditioned_similarity_of_music_vectors(
    vectors: Sequence,
    conditioned_n_measures: int,
    similarity_function: Optional[Callable] = None,
    return_best_matches: BestMatchMode = "all",
    rel_tol: float = 1e-9,
    abs_tol: float = 1e-12,
    matrix_fn: Optional[Callable] = None,
) -> SimilarityResult:
    """Every measure vs the first k conditioning measures; best matches for
    measures >= k (ref :180-259)."""
    n = len(vectors)
    k = conditioned_n_measures
    if not (1 <= k <= n):
        raise ValueError(f"conditioned_n_measures must be between 1 and {n}, got {k}")
    sim = _build_matrix(vectors, vectors[:k], similarity_function, matrix_fn)
    best_matches = []
    for i in range(k, n):
        row = sim[i]
        max_sim = max(row)
        tied_js, tied_diffs = _tie_select(
            row, i, max_sim, return_best_matches, rel_tol, abs_tol
        )
        best_matches.append((max_sim, tied_js, tied_diffs))
    return _finalize(sim, best_matches)


def aggregate_similarity_results(
    similarity_results: list[SimilarityResult],
) -> SimilarityResult:
    """Element-wise mean over ragged matrices + concatenated best matches
    (ref :262-325)."""
    if not similarity_results:
        return SimilarityResult(
            similarity_matrix=[], best_matches=[], mean_best_similarities=0.0
        )
    max_rows = max(len(r.similarity_matrix) for r in similarity_results)
    max_cols = max(
        (len(row) for r in similarity_results for row in r.similarity_matrix),
        default=0,
    )
    accum = [[0.0] * max_cols for _ in range(max_rows)]
    counts = [[0] * max_cols for _ in range(max_rows)]
    for res in similarity_results:
        mat = res.similarity_matrix
        if mat and any(len(row) != len(mat[0]) for row in mat):
            raise ValueError("Each input similarity_matrix must be rectangular")
        for i, row in enumerate(mat):
            for j, val in enumerate(row):
                accum[i][j] += val
                counts[i][j] += 1
    averaged = [
        [accum[i][j] / counts[i][j] if counts[i][j] else 0.0 for j in range(max_cols)]
        for i in range(max_rows)
    ]
    best = [bm for r in similarity_results for bm in r.best_matches]
    mean_max = sum(s for s, _, _ in best) / len(best) if best else 0.0
    return SimilarityResult(
        similarity_matrix=averaged, best_matches=best, mean_best_similarities=mean_max
    )
