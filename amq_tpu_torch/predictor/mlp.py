"""MLP surrogate in PyTorch, the recipe of the JAX package's flax/optax
``predictor/mlp.py``.

Three hidden layers of 300 ReLU units (one input layer and ``n_layers``
more), 0.2 dropout before the linear regressor, Kaiming-uniform weights
and zero biases, full-batch Adam (0.9, 0.999, eps 1e-8) at lr 8e-4 with
cosine decay to 0 over ``epochs``, SmoothL1 (Huber, delta 1) loss, a seeded
80/20 train/validation split, and the best-validation snapshot kept.  Every
random draw (split, init, dropout) comes from one ``torch.Generator``
seeded with ``seed``; its numbers differ from JAX's for the same seed.
The surrogate is small (hundreds of samples, 300 units) and runs on the
CPU.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class _Net(nn.Module):
    def __init__(self, n_in: int, n_hidden: int = 300, n_layers: int = 2,
                 drop: float = 0.2):
        super().__init__()
        self.hidden = nn.ModuleList(
            [nn.Linear(n_in, n_hidden)]
            + [nn.Linear(n_hidden, n_hidden) for _ in range(n_layers)])
        self.out = nn.Linear(n_hidden, 1)
        self.drop = drop

    def reset(self, gen: torch.Generator) -> None:
        """Kaiming-uniform weights (bound sqrt(6 / fan_in)), zero biases."""
        with torch.no_grad():
            for lin in [*self.hidden, self.out]:
                bound = math.sqrt(6.0 / lin.in_features)
                w = torch.rand(lin.weight.shape, generator=gen)
                lin.weight.copy_(w * (2 * bound) - bound)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_gen`` given: training forward with inverted dropout."""
        for lin in self.hidden:
            x = F.relu(lin(x))
        if dropout_gen is not None and self.drop > 0:
            keep = torch.rand(x.shape, generator=dropout_gen) >= self.drop
            x = x * keep / (1.0 - self.drop)
        return self.out(x)


class MLP:
    name = "mlp"

    def __init__(self, seed: int = 0, epochs: int = 2000, lr: float = 8e-4,
                 trn_split: float = 0.8, n_hidden: int = 300):
        self.seed = seed
        self.epochs = epochs
        self.lr = lr
        self.trn_split = trn_split
        self.n_hidden = n_hidden
        self.net: Optional[_Net] = None

    def fit(self, train_data: np.ndarray, train_label: np.ndarray) -> None:
        X = torch.as_tensor(np.asarray(train_data, np.float32))
        y = torch.as_tensor(np.asarray(train_label, np.float32)).reshape(-1, 1)
        gen = torch.Generator().manual_seed(self.seed)
        n = X.shape[0]
        perm = torch.randperm(n, generator=gen)
        n_trn = int(n * self.trn_split)
        trn, vld = perm[:n_trn], perm[n_trn:]

        net = _Net(X.shape[1], self.n_hidden)
        net.reset(gen)
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        best_loss, best_state = math.inf, copy.deepcopy(net.state_dict())
        for epoch in range(self.epochs):
            for group in opt.param_groups:
                group["lr"] = self.lr * 0.5 * (
                    1 + math.cos(math.pi * epoch / self.epochs))
            loss = F.smooth_l1_loss(net(X[trn], dropout_gen=gen), y[trn])
            opt.zero_grad()
            loss.backward()
            opt.step()
            if vld.numel():
                with torch.no_grad():
                    vld_loss = float(F.smooth_l1_loss(net(X[vld]), y[vld]))
                if vld_loss < best_loss:
                    best_loss = vld_loss
                    best_state = copy.deepcopy(net.state_dict())
        net.load_state_dict(best_state)
        self.net = net

    @torch.no_grad()
    def predict(self, test_data: np.ndarray) -> np.ndarray:
        if self.net is None:
            raise RuntimeError("call fit first")
        X = torch.as_tensor(np.atleast_2d(np.asarray(test_data, np.float32)))
        return self.net(X).numpy()
