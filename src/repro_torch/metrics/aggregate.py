# Copied from src/repro/metrics/aggregate.py; keep the two in step.
"""rliable-style aggregate metrics (Agarwal et al., 2021).

The paper reports Median / IQM / Mean / Optimality Gap with stratified
bootstrap 95% CIs over (tasks x seeds) matrices of min-max normalized
returns (Figs. 3, 8, 10).  numpy host-side — these run on logged results,
not in jit.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


def minmax_normalize(
    scores_by_alg: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Per-task min-max normalization across ALL algorithms (paper §5.1:
    "use the maximum and minimum score obtained from all the algorithms").

    Each value is [n_tasks, n_seeds]; normalization is per task row.
    """
    algs = list(scores_by_alg)
    stacked = np.stack([scores_by_alg[a] for a in algs])  # [A, T, S]
    lo = stacked.min(axis=(0, 2), keepdims=True)
    hi = stacked.max(axis=(0, 2), keepdims=True)
    rng = np.where(hi - lo < 1e-12, 1.0, hi - lo)
    normed = (stacked - lo) / rng
    return {a: normed[i] for i, a in enumerate(algs)}


def iqm(scores: np.ndarray) -> float:
    """Interquartile mean over the flattened (task, seed) matrix."""
    x = np.sort(scores.reshape(-1))
    n = x.size
    lo, hi = int(np.floor(n * 0.25)), int(np.ceil(n * 0.75))
    return float(np.mean(x[lo:hi])) if hi > lo else float(np.mean(x))


def median(scores: np.ndarray) -> float:
    """Median of per-task mean scores (rliable convention)."""
    return float(np.median(scores.mean(axis=-1)))


def mean(scores: np.ndarray) -> float:
    return float(np.mean(scores))


def optimality_gap(scores: np.ndarray, gamma_thresh: float = 1.0) -> float:
    """Mean shortfall below the `gamma_thresh` performance level."""
    return float(np.mean(np.maximum(gamma_thresh - scores, 0.0)))


AGGREGATES: Dict[str, Callable[[np.ndarray], float]] = {
    "median": median,
    "iqm": iqm,
    "mean": mean,
    "optimality_gap": optimality_gap,
}


def stratified_bootstrap_ci(
    scores: np.ndarray,
    fn: Callable[[np.ndarray], float],
    n_boot: int = 2000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float, float]:
    """Percentile bootstrap CI, resampling seeds independently per task.

    `scores` is [n_tasks, n_seeds].  Returns (point, lo, hi).
    """
    rng = np.random.default_rng(seed)
    t, s = scores.shape
    stats = np.empty(n_boot)
    for b in range(n_boot):
        idx = rng.integers(0, s, size=(t, s))
        stats[b] = fn(np.take_along_axis(scores, idx, axis=1))
    lo = float(np.percentile(stats, 100 * alpha / 2))
    hi = float(np.percentile(stats, 100 * (1 - alpha / 2)))
    return fn(scores), lo, hi


def aggregate_metrics(
    scores_by_alg: Dict[str, np.ndarray],
    normalize: bool = True,
    n_boot: int = 2000,
    seed: int = 0,
) -> Dict[str, Dict[str, Tuple[float, float, float]]]:
    """Full Fig. 3-style table: per algorithm, per aggregate, (pt, lo, hi)."""
    if normalize:
        scores_by_alg = minmax_normalize(scores_by_alg)
    out: Dict[str, Dict[str, Tuple[float, float, float]]] = {}
    for alg, scores in scores_by_alg.items():
        out[alg] = {
            name: stratified_bootstrap_ci(scores, fn, n_boot=n_boot, seed=seed)
            for name, fn in AGGREGATES.items()
        }
    return out


def auc(curve: np.ndarray, axis: int = -1) -> np.ndarray:
    """Area under a (normalized-return vs step) curve — Fig. 4 bottom-right."""
    return np.trapezoid(curve, axis=axis) / max(curve.shape[axis] - 1, 1)
