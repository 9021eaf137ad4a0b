"""RBF surrogate: cubic kernel + linear polynomial tail.

From-scratch replacement for the reference's pySOT ``RBFInterpolant``
(predictor/rbf.py:4-38): interpolant

    s(x) = sum_i lam_i * ||x - x_i||^3 + c0 + c^T x

fit by solving the standard augmented saddle system; points are scaled
into the unit box by lb/ub as pySOT does (the Search passes per-dimension
bounds, search/optimizer.py:230-242).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RBF:
    name = "rbf"

    def __init__(self, kernel: str = "cubic", tail: str = "linear",
                 lb: Optional[np.ndarray] = None,
                 ub: Optional[np.ndarray] = None):
        assert kernel == "cubic" and tail == "linear"
        self.lb = None if lb is None else np.asarray(lb, float)
        self.ub = None if ub is None else np.asarray(ub, float)
        self._X: Optional[np.ndarray] = None
        self._lam: Optional[np.ndarray] = None
        self._c: Optional[np.ndarray] = None

    def _scale(self, X: np.ndarray) -> np.ndarray:
        if self.lb is None or self.ub is None:
            return X
        span = np.where(self.ub > self.lb, self.ub - self.lb, 1.0)
        return (X - self.lb) / span

    def fit(self, train_data: np.ndarray, train_label: np.ndarray) -> None:
        X = self._scale(np.asarray(train_data, float))
        y = np.asarray(train_label, float).reshape(-1)
        n, d = X.shape
        r = np.linalg.norm(X[:, None, :] - X[None, :, :], axis=-1)
        Phi = r**3
        P = np.hstack([np.ones((n, 1)), X])
        A = np.zeros((n + d + 1, n + d + 1))
        A[:n, :n] = Phi + 1e-10 * np.eye(n)
        A[:n, n:] = P
        A[n:, :n] = P.T
        rhs = np.concatenate([y, np.zeros(d + 1)])
        sol = np.linalg.lstsq(A, rhs, rcond=None)[0]
        self._X = X
        self._lam = sol[:n]
        self._c = sol[n:]

    def predict(self, test_data: np.ndarray) -> np.ndarray:
        assert self._X is not None, "call fit first"
        Xq = self._scale(np.atleast_2d(np.asarray(test_data, float)))
        r = np.linalg.norm(Xq[:, None, :] - self._X[None, :, :], axis=-1)
        P = np.hstack([np.ones((Xq.shape[0], 1)), Xq])
        out = r**3 @ self._lam + P @ self._c
        return out[:, None]
