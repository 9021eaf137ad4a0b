"""Minimal evolutionary multi-objective toolkit (numpy, seedable).

Replaces the reference's pymoo dependency with exactly the pieces AMQ uses
(search/optimizer.py:248-296):

* fast non-dominated sorting + crowding distance (NSGA-II survival),
* feasibility-first constraint handling (pymoo semantics: feasible
  dominates infeasible; infeasible ranked by constraint violation),
* NSGA-II with binomial crossover + whole-vector integer reset mutation
  (the reference's ``IntMutation`` resamples the entire individual
  uniformly with probability ``prob``, utils/ga.py:50-57),
* single-objective GA over fixed-cardinality boolean vectors (subset
  selection, utils/ga.py:128-177),
* exact 2-D hypervolume.

Everything takes an explicit ``numpy.random.Generator`` — deterministic
under seed, unlike the reference's global-state pymoo runs.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# dominance machinery

def non_dominated_front(F: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows of F (minimization)."""
    n = F.shape[0]
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        dominated = np.all(F <= F[i], axis=1) & np.any(F < F[i], axis=1)
        if dominated.any():
            keep[i] = False
    return np.where(keep)[0]


def non_dominated_sort(F: np.ndarray) -> np.ndarray:
    """Front rank per row (0 = best)."""
    n = F.shape[0]
    rank = np.full(n, -1, dtype=int)
    remaining = np.arange(n)
    r = 0
    while remaining.size:
        front_local = non_dominated_front(F[remaining])
        rank[remaining[front_local]] = r
        remaining = np.delete(remaining, front_local)
        r += 1
    return rank


def crowding_distance(F: np.ndarray) -> np.ndarray:
    n, m = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n)
    for j in range(m):
        order = np.argsort(F[:, j], kind="stable")
        fj = F[order, j]
        span = fj[-1] - fj[0]
        d[order[0]] = d[order[-1]] = np.inf
        if span > 0:
            d[order[1:-1]] += (fj[2:] - fj[:-2]) / span
    return d


def constraint_violation(G: Optional[np.ndarray]) -> np.ndarray:
    if G is None:
        return np.zeros(0)
    return np.maximum(G, 0.0).sum(axis=1)


def _rank_with_constraints(F: np.ndarray, CV: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(front_rank, crowding) with feasibility-first ordering."""
    n = F.shape[0]
    rank = np.full(n, np.inf)
    crowd = np.zeros(n)
    feas = CV <= 0
    if feas.any():
        fr = non_dominated_sort(F[feas])
        rank[feas] = fr
        for r in np.unique(fr):
            idx = np.where(feas)[0][fr == r]
            crowd[idx] = crowding_distance(F[idx])
    if (~feas).any():
        # infeasible: ranked after all feasible fronts, by violation
        base = (rank[feas].max() + 1) if feas.any() else 0
        order = np.argsort(CV[~feas], kind="stable")
        inf_idx = np.where(~feas)[0][order]
        rank[inf_idx] = base + np.arange(inf_idx.size)
        crowd[inf_idx] = -CV[inf_idx]
    return rank, crowd


def _survival(F, CV, n_survive):
    rank, crowd = _rank_with_constraints(F, CV)
    # sort by (rank asc, crowding desc)
    order = np.lexsort((-crowd, rank))
    return order[:n_survive]


def _tournament(rng, rank, crowd, n):
    a = rng.integers(0, rank.size, n)
    b = rng.integers(0, rank.size, n)
    better = np.where(
        rank[a] < rank[b], a,
        np.where(rank[b] < rank[a], b, np.where(crowd[a] >= crowd[b], a, b)))
    return better


def _dedup_rows(X: np.ndarray) -> np.ndarray:
    _, idx = np.unique(X, axis=0, return_index=True)
    return np.sort(idx)


# ---------------------------------------------------------------------------
# NSGA-II

def nsga2(
    evaluate: Callable[[np.ndarray], Tuple[np.ndarray, Optional[np.ndarray]]],
    initial_X: np.ndarray,
    xl: np.ndarray,
    xu: np.ndarray,
    pop_size: int,
    n_gen: int,
    rng: np.random.Generator,
    crossover_prob: float = 0.9,
    mutation_prob: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integer-coded NSGA-II.  Returns (final population X, F).

    ``evaluate(X) -> (F, G)`` with F ``[n, n_obj]`` minimized, G ``[n, n_constr]``
    (<= 0 feasible) or None.  The initial population is ``initial_X`` (the
    non-dominated archive in the reference, optimizer.py:262-265), padded to
    ``pop_size`` with uniform random individuals.
    """
    xl = np.asarray(xl, int)
    xu = np.asarray(xu, int)
    n_var = xl.size

    X = np.asarray(initial_X, int).reshape(-1, n_var).copy()
    X = X[_dedup_rows(X)]
    if X.shape[0] < pop_size:
        pad = rng.integers(xl, xu + 1, (pop_size - X.shape[0], n_var))
        X = np.vstack([X, pad])
    elif X.shape[0] > pop_size:
        X = X[:pop_size]

    F, G = evaluate(X)
    CV = constraint_violation(G) if G is not None else np.zeros(X.shape[0])

    for _ in range(n_gen):
        rank, crowd = _rank_with_constraints(F, CV)
        parents_a = _tournament(rng, rank, crowd, pop_size)
        parents_b = _tournament(rng, rank, crowd, pop_size)
        # binomial crossover, single offspring (optimizer.py:266)
        M = rng.random((pop_size, n_var)) < crossover_prob
        off = np.where(M, X[parents_a], X[parents_b])
        # whole-vector uniform reset with prob mutation_prob (utils/ga.py:50-57)
        mut = rng.random(pop_size) < mutation_prob
        if mut.any():
            off[mut] = rng.integers(xl, xu + 1, (int(mut.sum()), n_var))

        off = off[_dedup_rows(off)]
        # drop offspring identical to current pop (eliminate_duplicates)
        if off.size:
            merged = np.vstack([X, off])
            keep = _dedup_rows(merged)
            keep_off = keep[keep >= X.shape[0]] - X.shape[0]
            off = off[keep_off]
        if off.shape[0] == 0:
            continue
        F_off, G_off = evaluate(off)
        CV_off = (constraint_violation(G_off) if G_off is not None
                  else np.zeros(off.shape[0]))

        X = np.vstack([X, off])
        F = np.vstack([F, F_off])
        CV = np.concatenate([CV, CV_off])
        sel = _survival(F, CV, pop_size)
        X, F, CV = X[sel], F[sel], CV[sel]

    return X, F


# ---------------------------------------------------------------------------
# fixed-cardinality subset GA (reference SubsetProblem machinery)

def subset_ga(
    fitness: Callable[[np.ndarray], float],
    n_var: int,
    n_max: int,
    pop_size: int,
    n_gen: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Minimize ``fitness`` over boolean vectors with exactly ``n_max`` True.

    Sampling/crossover/mutation mirror utils/ga.py:128-177: random-K
    sampling, AND-preserving crossover refilled from the XOR set, and a
    swap mutation.
    """

    def sample():
        x = np.zeros(n_var, dtype=bool)
        x[rng.permutation(n_var)[:n_max]] = True
        return x

    X = np.array([sample() for _ in range(pop_size)])
    F = np.array([fitness(x) for x in X])

    for _ in range(n_gen):
        order = np.argsort(F, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(pop_size)
        a = _tournament(rng, rank, np.zeros(pop_size), pop_size)
        b = _tournament(rng, rank, np.zeros(pop_size), pop_size)
        off = np.zeros((pop_size, n_var), dtype=bool)
        for k in range(pop_size):
            p1, p2 = X[a[k]], X[b[k]]
            child = p1 & p2
            need = n_max - int(child.sum())
            pool = np.where(p1 ^ p2)[0]
            if need > 0 and pool.size:
                child[rng.permutation(pool)[:need]] = True
            # swap mutation (utils/ga.py:166-177)
            on = np.where(child)[0]
            offi = np.where(~child)[0]
            if on.size and offi.size:
                child[rng.choice(offi)] = True
                child[rng.choice(on)] = False
            off[k] = child
        F_off = np.array([fitness(x) for x in off])
        X = np.vstack([X, off])
        F = np.concatenate([F, F_off])
        sel = np.argsort(F, kind="stable")[:pop_size]
        X, F = X[sel], F[sel]

    return X[np.argmin(F)]


# ---------------------------------------------------------------------------
# hypervolume (2-D exact)

def hypervolume_2d(F: np.ndarray, ref_point: np.ndarray) -> float:
    """Exact hypervolume of the non-dominated subset of 2-D points."""
    nd = F[non_dominated_front(F)]
    nd = nd[(nd[:, 0] <= ref_point[0]) & (nd[:, 1] <= ref_point[1])]
    if nd.size == 0:
        return 0.0
    nd = nd[np.argsort(nd[:, 0], kind="stable")]
    hv = 0.0
    prev_y = ref_point[1]
    for x, y in nd:
        if y < prev_y:
            hv += (ref_point[0] - x) * (prev_y - y)
            prev_y = y
    return float(hv)
