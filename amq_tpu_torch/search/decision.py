"""Post-search decision making: high-tradeoff point selection.

numpy re-expression of the reference's ``HighTradeoffPoints``
(amq_quantization.py:15-54, itself built on pymoo's DecisionMaking): for
each non-dominated point, find neighbors within an epsilon ball (after
min-max normalization) and score mu = min over neighbors of
sacrifice/gain; points with the largest mu are the knees of the front.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def high_tradeoff_points(F: np.ndarray, epsilon: float = 0.125,
                         n_survive: Optional[int] = None,
                         normalize: bool = True) -> np.ndarray:
    """Indices of high-tradeoff (knee) points of a 2-D objective set."""
    F = np.asarray(F, float)
    n = F.shape[0]
    if n <= 1:
        # a single point is trivially the knee (and has no neighbors)
        return np.arange(n)
    if normalize:
        lo, hi = F.min(axis=0), F.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        F = (F - lo) / span

    mu = np.full(n, -np.inf)
    for i in range(n):
        d = np.linalg.norm(F - F[i], axis=1)
        neighbors = np.where((d < epsilon) & (d > 0))[0]
        if neighbors.size == 0:
            # fall back to all others (pymoo NeighborFinder auto widening)
            neighbors = np.array([j for j in range(n) if j != i], int)
        diff = F[neighbors] - F[i]
        sacrifice = np.maximum(0, diff).sum(axis=1)
        gain = np.maximum(0, -diff).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            tradeoff = sacrifice / gain
        mu[i] = np.nanmin(tradeoff)

    if n_survive is not None:
        # best knee first (descending mu) — callers treat index 0 as the
        # primary pick, matching the ASF path's ordering contract
        return np.argsort(mu)[::-1][:n_survive]
    # outliers above 2 sigma (pymoo find_outliers_upper_tail)
    finite = mu[np.isfinite(mu)]
    if finite.size == 0:
        return np.array([], int)
    thresh = finite.mean() + 2 * finite.std()
    return np.where(mu > thresh)[0]
