"""Surrogate factory (reference predictor/factory.py:1-16)."""

from __future__ import annotations

import numpy as np


def get_predictor(name: str, inputs: np.ndarray, targets: np.ndarray, **kwargs):
    if name == "rbf":
        from .rbf import RBF
        model = RBF(lb=kwargs.get("lb"), ub=kwargs.get("ub"))
        model.fit(inputs, targets)
    elif name == "mlp":
        from .mlp import MLP
        model = MLP(epochs=kwargs.get("epochs", 2000))
        model.fit(inputs, targets)
    else:
        raise NotImplementedError(f"unknown predictor {name!r}")
    return model
