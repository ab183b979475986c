"""Model-quality metrics: ROC AUC.

A copy of ``deeprecsys_tpu/utils/metrics_ml.py`` (numpy only; the port
imports nothing of the JAX package). ``tests/test_torch_config.py`` holds it
equal to the original.
"""

from __future__ import annotations

import numpy as np


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC via the rank-sum (Mann-Whitney U) formulation, ties handled
    by midranks. O(n log n), no sklearn dependency."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    r = np.empty(scores.size, dtype=np.float64)
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i : j + 1] = (i + j) / 2.0 + 1.0
        i = j + 1
    ranks[order] = r
    rank_sum_pos = ranks[labels].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))
