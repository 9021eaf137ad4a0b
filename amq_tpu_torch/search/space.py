"""Mixed-precision search space: arch dict <-> integer vectors.

Behavioral mirror of amq/search/space.py:7-132, generalized over the
topology's linear list instead of hard-coding the seven Llama projections:

* an architecture is ``{'linear': {site: [bits]*n_block}}``,
* ``encode`` flattens to a length ``n_linear * n_block`` vector of
  bit-range *indices* ordered (linear-major, block-minor),
* random sampling draws a per-sample random bit-mix probability vector and
  rejects archs whose avg-bits fall outside
  ``[min_bits + 32/g, max_bits + 32/g]`` (space.py:34-84),
* DOE initialization seeds the all-min/all-mid/all-max archs first
  (space.py:86-93),
* pruned ("pass") layers are pinned to max bits in samples and removed
  from the predictor feature encoding (space.py:54-73, 120-132).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..evaluation.metrics import get_bits_usage

Arch = Dict[str, Dict[str, List[int]]]


class SearchSpace:
    def __init__(
        self,
        config: Dict,                      # topology dict (ModelConfig.topology())
        group_size: int = 128,
        pass_linear_list: Sequence[str] = (),
        bits_range: Sequence[int] = (2, 3, 4),
        rng: Optional[np.random.Generator] = None,
    ):
        self.config = config
        self.n_block = config["n_block"]
        self.linears = list(config["linear"])
        self.n_linear = len(self.linears)
        self.bits_range = list(bits_range)
        self.group_size = group_size
        self.pass_linear_list = list(pass_linear_list)
        self.rng = rng or np.random.default_rng(0)

        # flat index (linear-major) of pinned layers (space.py:25-31)
        self.pass_linear_idx_list = sorted(
            int(p.split(".", 1)[0]) + self.n_block * self.linears.index(p.split(".", 1)[1])
            for p in self.pass_linear_list
        )

    # -- arch <-> vector ---------------------------------------------------

    def encode(self, arch: Arch) -> np.ndarray:
        out = []
        for linear in self.linears:
            out.extend(self.bits_range.index(b) for b in arch["linear"][linear])
        return np.asarray(out, int)

    def decode(self, x: np.ndarray) -> Arch:
        x = np.asarray(x, int).reshape(self.n_linear, self.n_block)
        return {"linear": {
            linear: [self.bits_range[i] for i in x[j]]
            for j, linear in enumerate(self.linears)
        }}

    def encode_predictor(self, arch: Arch) -> np.ndarray:
        return np.delete(self.encode(arch), self.pass_linear_idx_list)

    def decode_encode_predictor(self, X: np.ndarray) -> np.ndarray:
        return np.delete(np.asarray(X, int), self.pass_linear_idx_list, axis=-1)

    # -- sampling ----------------------------------------------------------

    def _pin_pass_layers(self, arch: Arch) -> None:
        for p in self.pass_linear_list:
            blk, linear = p.split(".", 1)
            arch["linear"][linear][int(blk)] = max(self.bits_range)

    def _bits_window_ok(self, usage: float) -> bool:
        lo = self.bits_range[0] + 32 / self.group_size
        hi = self.bits_range[-1] + 32 / self.group_size
        return ((math.isclose(usage, lo) or usage > lo)
                and (math.isclose(usage, hi) or usage < hi))

    def sample(self, n_samples: int = 1, bits: Optional[Sequence[int]] = None,
               pool: Sequence[Arch] = ()) -> List[Arch]:
        bits = list(bits) if bits is not None else self.bits_range
        data: List[Arch] = []
        pool = list(pool)
        for _ in range(n_samples):
            while True:
                prob = self.rng.random(len(self.bits_range))
                p = prob[[self.bits_range.index(b) for b in bits]]
                p = p / p.sum()
                arch: Arch = {"linear": {
                    linear: self.rng.choice(bits, size=self.n_block, p=p).tolist()
                    for linear in self.linears
                }}
                self._pin_pass_layers(arch)
                usage = get_bits_usage(arch, self.config, self.group_size)
                if (arch not in data and arch not in pool
                        and self._bits_window_ok(usage)):
                    break
            data.append(arch)
        return data

    def initialize(self, n_doe: int, pool: Sequence[Arch] = ()) -> List[Arch]:
        data: List[Arch] = []
        for bit in self.bits_range:
            data.extend(self.sample(1, bits=[bit]))
            n_doe -= 1
        data.extend(self.sample(n_doe, pool=list(pool) + data))
        return data

    # -- NSGA-II problem bounds -------------------------------------------

    def bounds(self):
        """(xl, xu) with pass layers pinned at max index (problem.py:26-34)."""
        xl = np.zeros(self.n_linear * self.n_block, int)
        xu = np.full(self.n_linear * self.n_block, len(self.bits_range) - 1, int)
        xl[self.pass_linear_idx_list] = len(self.bits_range) - 1
        return xl, xu

    def evaluate_problem(self, X: np.ndarray, predictor):
        """AuxiliarySingleLevelProblem (problem.py:36-52): F=(pred, bits), G=window."""
        X = np.asarray(X, int)
        preds = np.asarray(predictor.predict(
            self.decode_encode_predictor(X))).reshape(-1)
        F = np.empty((X.shape[0], 2))
        G = np.empty((X.shape[0], 2))
        lo = self.bits_range[0] + 32 / self.group_size
        hi = self.bits_range[-1] + 32 / self.group_size
        for i, x in enumerate(X):
            usage = get_bits_usage(self.decode(x), self.config, self.group_size)
            F[i] = (preds[i], usage)
            G[i] = (1 - usage / lo, usage / hi - 1)
        return F, G
