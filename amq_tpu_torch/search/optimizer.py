"""NSGA-II surrogate-assisted mixed-precision search loop.

The port's own numpy copy of the JAX package's ``search/optimizer.py``
(it carries no JAX): per iteration, fit a surrogate on the archive, run
NSGA-II over the surrogate seeded with the archive's non-dominated front,
pick a bit-usage-diverse subset of K candidates with a fixed-cardinality
GA, evaluate them at full fidelity (the proxy-switch JSD), track
hypervolume and surrogate quality (RMSE / Spearman rho / Kendall tau),
checkpoint to the ``iter_N.stats`` JSON schema, and resume from it.
Deterministic under an explicit seed; the matplotlib scatter is optional.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..evaluation.evaluator import Evaluator
from ..evaluation.metrics import get_correlation
from ..predictor.factory import get_predictor
from . import nsga2
from .space import Arch, SearchSpace


def prune_by_sensitivity(sensitivity: Dict, threshold: float) -> List[str]:
    """Layers whose sensitivity loss exceeds median * threshold
    (optimizer.py:53-55) — pinned to max bits during search."""
    losses = sensitivity["loss"]
    median = float(np.median([float(v) for v in losses.values()]))
    return [k for k, v in losses.items() if float(v) > median * threshold]


class Search:
    def __init__(
        self,
        evaluator: Evaluator,
        search_space: SearchSpace,
        dataset: str,
        iterations: int = 200,
        n_doe: int = 250,
        n_iter: int = 50,
        save_iter: int = 10,
        predictor: str = "rbf",
        ga_pop_size: int = 200,
        subset_pop_size: int = 100,
        crossover_prob: float = 0.9,
        mut_prob: float = 0.1,
        max_value: float = 10.0,
        save_path: Optional[str] = None,
        resume_path: Optional[str] = None,
        seed: int = 0,
        verbose: bool = True,
        predictor_kwargs: Optional[Dict] = None,
    ):
        self.evaluator = evaluator
        self.space = search_space
        self.dataset = dataset
        self.iterations = iterations
        self.n_doe = n_doe
        self.n_iter = n_iter
        self.save_iter = save_iter
        self.predictor_name = predictor
        self.ga_pop_size = ga_pop_size
        self.subset_pop_size = subset_pop_size
        self.crossover_prob = crossover_prob
        self.mut_prob = mut_prob
        self.max_value = max_value
        self.save_path = save_path
        self.resume_path = resume_path
        self.rng = np.random.default_rng(seed)
        self.verbose = verbose
        #: extra get_predictor kwargs (e.g. {'epochs': 50} for fast MLP
        #: fits in tests/smokes; the reference default is 2000)
        self.predictor_kwargs = dict(predictor_kwargs or {})
        #: archs evaluated at full fidelity and the wall seconds spent
        self.n_evaluated = 0
        self.eval_seconds = 0.0

    # ------------------------------------------------------------------

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _evaluate(self, architectures: Sequence[Arch]) -> Tuple[List[float], List[float]]:
        t0 = time.time()
        try:
            return self._evaluate_all(architectures)
        finally:
            self.n_evaluated += len(architectures)
            self.eval_seconds += time.time() - t0

    def _evaluate_all(self, architectures: Sequence[Arch]) -> Tuple[List[float], List[float]]:
        metric_list, bits_list = [], []
        # proxy evaluators take the batch in one call (eval_many, read back
        # from the device once); other evaluators go one arch at a time
        if len(architectures) > 1 and getattr(self.evaluator, "search", False):
            many = getattr(self.evaluator, "eval_many", None)
            if many is not None:
                for metric, usage in many(list(architectures)):
                    val = float(np.nan_to_num(metric[self.dataset],
                                              nan=self.max_value))
                    metric_list.append(min(self.max_value, val))
                    bits_list.append(usage)
                return metric_list, bits_list
        for arch in architectures:
            metric, usage = self.evaluator.eval(arch)
            val = float(np.nan_to_num(metric[self.dataset], nan=self.max_value))
            metric_list.append(min(self.max_value, val))
            bits_list.append(usage)
        return metric_list, bits_list

    def _fit_predictor(self, archive):
        inputs = np.array([self.space.encode_predictor(a) for a, _, _ in archive])
        targets = np.array([m for _, m, _ in archive])
        kwargs = {}
        if self.predictor_name == "rbf":
            n_var = self.space.n_linear * self.space.n_block
            lb = np.zeros(n_var)
            ub = np.full(n_var, len(self.space.bits_range) - 1, float)
            kwargs = {
                "lb": np.delete(lb, self.space.pass_linear_idx_list),
                "ub": np.delete(ub, self.space.pass_linear_idx_list),
            }
        kwargs.update(self.predictor_kwargs)
        predictor = get_predictor(self.predictor_name, inputs, targets,
                                  **kwargs)
        return predictor, predictor.predict(inputs)

    def _next(self, archive, predictor, K):
        """Surrogate NSGA-II + subset selection (optimizer.py:248-296)."""
        F = np.column_stack([[m for _, m, _ in archive],
                             [b for _, _, b in archive]])
        front = nsga2.non_dominated_front(F)
        nd_X = np.array([self.space.encode(archive[i][0]) for i in front])

        xl, xu = self.space.bounds()
        pop_X, pop_F = nsga2.nsga2(
            evaluate=lambda X: self.space.evaluate_problem(X, predictor),
            initial_X=nd_X, xl=xl, xu=xu,
            pop_size=self.ga_pop_size, n_gen=20, rng=self.rng,
            crossover_prob=self.crossover_prob, mutation_prob=self.mut_prob,
        )

        # drop archs already in the archive (optimizer.py:271-276)
        seen = {json.dumps(a, sort_keys=True) for a, _, _ in archive}
        keep = np.array([
            json.dumps(self.space.decode(x), sort_keys=True) not in seen
            for x in pop_X
        ])
        pop_X, pop_F = pop_X[keep], pop_F[keep]

        if pop_X.shape[0] >= K:
            idx = self._subset_selection(pop_F[:, 1], F[front, 1], K)
            pop_X, pop_F = pop_X[idx], pop_F[idx]

        candidates = [self.space.decode(x) for x in pop_X]
        cand_pred = predictor.predict(self.space.decode_encode_predictor(pop_X))
        return candidates, np.asarray(cand_pred).reshape(-1, 1)

    def _subset_selection(self, cand_bits, nd_bits, K) -> np.ndarray:
        """Pick K candidates minimizing std of sorted bit-usage gaps
        (problem.py:63-74 + optimizer.py:287-296)."""
        cand_bits = np.asarray(cand_bits)
        nd_bits = np.asarray(nd_bits)

        def fitness(mask: np.ndarray) -> float:
            merged = np.sort(np.concatenate([nd_bits, cand_bits[mask]]))
            f = float(np.std(np.diff(merged)))
            g = (K - int(mask.sum())) ** 2
            return f + 1e6 * g  # feasibility-first penalty

        best = nsga2.subset_ga(fitness, n_var=cand_bits.size, n_max=K,
                               pop_size=self.subset_pop_size, n_gen=60,
                               rng=self.rng)
        return np.where(best)[0]

    @staticmethod
    def _calc_hv(ref_pt, F, normalized=True) -> float:
        """Normalized hypervolume of the ND front (optimizer.py:298-307)."""
        ref = 1.01 * np.asarray(ref_pt, float)
        hv = nsga2.hypervolume_2d(np.asarray(F, float), ref)
        if normalized:
            hv = hv / float(np.prod(ref))
        return hv

    def _resume(self):
        with open(self.resume_path) as f:
            blob = json.load(f)
        archive = [tuple(x) for x in blob["archive"] + blob["candidates"]]
        return archive, blob["iteration"] + 1

    def _checkpoint(self, it, archive, n_cand, hv, predictor, stats,
                    cand_pred=None):
        """``iter_N.stats`` in the reference schema (optimizer.py:163-171)
        with one correction: the reference stores the full archive (which
        already contains the batch) AND ``archive[-n_iter:]`` as
        "candidates", so its resume (``archive + candidates``) duplicates
        the last batch — and the slice is wrong when dedup shrank the
        batch below n_iter.  We store the archive *minus* the actual
        last batch plus that batch, so resume reconstructs exactly."""
        os.makedirs(self.save_path, exist_ok=True)
        path = os.path.join(self.save_path, f"iter_{it}.stats")
        n_cand = min(n_cand, len(archive))
        with open(path, "w") as f:
            json.dump({
                "archive": archive[:len(archive) - n_cand],
                "candidates": archive[len(archive) - n_cand:],
                "hv": hv,
                "surrogate": {
                    "model": self.predictor_name,
                    "name": predictor.name,
                    "winner": predictor.name,
                    **stats,
                },
                "iteration": it,
            }, f)
        self._scatter_png(it, archive, n_cand, cand_pred)

    def _scatter_png(self, it, archive, n_cand, cand_pred):
        """Pareto scatter per checkpoint (optimizer.py:173-187)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            from matplotlib import pyplot as plt
        except Exception:
            return
        fig, axe = plt.subplots(1, 1, figsize=(5, 5))
        bits = np.array([x[2] for x in archive])
        metric = np.array([x[1] for x in archive])
        axe.scatter(bits, metric, s=5, facecolors="none", edgecolors="b",
                    label="archive")
        cand = archive[len(archive) - n_cand:]
        axe.scatter([x[2] for x in cand], [x[1] for x in cand], s=10,
                    color="r", label="candidates evaluated")
        if cand_pred is not None and len(cand_pred) == len(cand):
            axe.scatter([x[2] for x in cand],
                        np.asarray(cand_pred).reshape(-1), s=10,
                        facecolors="none", edgecolors="g",
                        label="candidates predicted")
        axe.legend()
        axe.grid(c="0.8")
        axe.set_xlabel("avg bits")
        axe.set_ylabel("loss")
        fig.tight_layout()
        fig.savefig(os.path.join(self.save_path, f"iter_{it}.png"))
        plt.close(fig)

    # ------------------------------------------------------------------

    def search(self) -> List[Tuple[Arch, float, float]]:
        total_start = time.time()
        start_it = 1
        if self.resume_path:
            archive, start_it = self._resume()
        else:
            doe = (self.space.initialize(self.n_doe) if self.iterations >= 1
                   else self.space.sample(self.n_doe))
            metric_list, bits_list = self._evaluate(doe)
            archive = list(zip(doe, metric_list, bits_list))

        ref_pt = np.array([max(m for _, m, _ in archive),
                           max(b for _, _, b in archive)])
        self._log(f"data preparation time : {time.time() - total_start:.2f}s")

        hv = 0.0
        for it in range(start_it, self.iterations + 1):
            iter_start = time.time()
            predictor, archive_pred = self._fit_predictor(archive)
            candidates, cand_pred = self._next(archive, predictor, self.n_iter)
            cand_metric, cand_bits = self._evaluate(candidates)

            rmse, rho, tau = get_correlation(
                np.vstack([np.asarray(archive_pred).reshape(-1, 1), cand_pred]),
                np.array([m for _, m, _ in archive] + cand_metric))

            archive.extend(zip(candidates, cand_metric, cand_bits))
            F = np.column_stack([[m for _, m, _ in archive],
                                 [b for _, _, b in archive]])
            hv = self._calc_hv(ref_pt, F)
            iter_time = time.time() - iter_start
            self._log(f"Iter {it}: hv = {hv:.4f}, iter time : {iter_time:.2f}s")
            self._log(f"fitting {self.predictor_name}: RMSE = {rmse:.4f}, "
                      f"Spearman's Rho = {rho:.4f}, Kendall's Tau = {tau:.4f}")

            if self.save_path and it % self.save_iter == 0:
                self._checkpoint(it, archive, len(candidates), hv, predictor, {
                    "rmse": rmse, "rho": rho, "tau": tau,
                    "total_time": iter_time,
                }, cand_pred=cand_pred)

        self._log(f"total time elapsed : {time.time() - total_start:.2f}s")
        return archive
