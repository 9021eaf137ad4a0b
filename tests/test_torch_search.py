"""The port's search stack held to the JAX package's on the same seeds.

The search space, NSGA-II toolkit, decision making and RBF surrogate are
numpy copies: their outputs must be identical.  One ``Search`` run over a
deterministic stub evaluator must give the JAX ``Search``'s archive and
checkpoint numbers.  The MLP surrogate is a PyTorch rewrite: with the
flax weights carried across, its forward matches within 1e-5.
"""

import json

import numpy as np
import pytest
import jax

from amq_tpu.evaluation.metrics import get_bits_usage as j_bits
from amq_tpu.models import get_config
from amq_tpu.predictor.mlp import MLP as JMLP
from amq_tpu.predictor.rbf import RBF as JRBF
from amq_tpu.search import Search as JSearch
from amq_tpu.search import nsga2 as jn
from amq_tpu.search.decision import high_tradeoff_points as j_knee
from amq_tpu.search.space import SearchSpace as JSpace

from amq_tpu_torch.evaluation.metrics import get_bits_usage as t_bits
from amq_tpu_torch.models import convert
from amq_tpu_torch.predictor.factory import get_predictor
from amq_tpu_torch.predictor.rbf import RBF as TRBF
from amq_tpu_torch.search import Search as TSearch
from amq_tpu_torch.search import nsga2 as tn
from amq_tpu_torch.search import prune_by_sensitivity
from amq_tpu_torch.search.decision import high_tradeoff_points as t_knee
from amq_tpu_torch.search.space import SearchSpace as TSpace

from test_torch_slice import torch_one_thread  # noqa: F401

PASS = ["0.self_attn.q_proj", "2.mlp.down_proj"]


def _spaces(seed=0):
    top = get_config("tiny-llama").topology()
    return (JSpace(top, pass_linear_list=PASS, rng=np.random.default_rng(seed)),
            TSpace(top, pass_linear_list=PASS, rng=np.random.default_rng(seed)))


def test_space_identical():
    js, ts = _spaces()
    assert ts.initialize(6) == js.initialize(6)
    archs = js.sample(4)
    assert ts.sample(4) == archs
    for a in archs:
        np.testing.assert_array_equal(ts.encode(a), js.encode(a))
        np.testing.assert_array_equal(ts.encode_predictor(a),
                                      js.encode_predictor(a))
        assert ts.decode(js.encode(a)) == a
    for got, want in zip(ts.bounds(), js.bounds()):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    X, y = rng.integers(0, 3, (30, 28)), rng.normal(size=30)
    pred = JRBF()
    pred.fit(js.decode_encode_predictor(X), y)
    for got, want in zip(ts.evaluate_problem(X, pred),
                         js.evaluate_problem(X, pred)):
        np.testing.assert_array_equal(got, want)


def test_nsga2_toolkit_identical():
    rng = np.random.default_rng(0)
    F = rng.normal(size=(40, 2))
    np.testing.assert_array_equal(tn.non_dominated_front(F),
                                  jn.non_dominated_front(F))
    np.testing.assert_array_equal(tn.non_dominated_sort(F),
                                  jn.non_dominated_sort(F))
    np.testing.assert_array_equal(tn.crowding_distance(F),
                                  jn.crowding_distance(F))
    ref = F.max(axis=0) + 1
    assert tn.hypervolume_2d(F, ref) == jn.hypervolume_2d(F, ref)

    def evaluate(X):
        x = X.astype(float)
        return np.column_stack([x.sum(1), (4 - x).sum(1)]), 1.5 - x[:, :1]

    runs = [mod.nsga2(evaluate, initial_X=np.ones((2, 5), int),
                      xl=np.zeros(5, int), xu=np.full(5, 4), pop_size=12,
                      n_gen=8, rng=np.random.default_rng(3))
            for mod in (tn, jn)]
    for got, want in zip(*runs):
        np.testing.assert_array_equal(got, want)
    vals = np.arange(20, dtype=float)

    def fitness(mask):
        return (float(np.std(np.diff(np.sort(vals[mask]))))
                + 1e6 * (5 - int(mask.sum())) ** 2)

    np.testing.assert_array_equal(
        tn.subset_ga(fitness, n_var=20, n_max=5, pop_size=16, n_gen=20,
                     rng=np.random.default_rng(2)),
        jn.subset_ga(fitness, n_var=20, n_max=5, pop_size=16, n_gen=20,
                     rng=np.random.default_rng(2)))


def test_decision_and_rbf_identical():
    rng = np.random.default_rng(4)
    F = np.sort(rng.random((12, 2)), axis=0) * [1, -1]
    np.testing.assert_array_equal(t_knee(F), j_knee(F))
    np.testing.assert_array_equal(t_knee(F, n_survive=3),
                                  j_knee(F, n_survive=3))
    X, y = rng.integers(0, 3, (25, 10)).astype(float), rng.normal(size=25)
    lb, ub = np.zeros(10), np.full(10, 2.0)
    jr, tr = JRBF(lb=lb, ub=ub), TRBF(lb=lb, ub=ub)
    jr.fit(X, y)
    tr.fit(X, y)
    Xq = rng.integers(0, 3, (7, 10)).astype(float)
    np.testing.assert_array_equal(tr.predict(Xq), jr.predict(Xq))
    sens = {"loss": {f"{i}.x": float(v) for i, v in enumerate(rng.random(9))}}
    from amq_tpu.search import prune_by_sensitivity as j_prune
    assert prune_by_sensitivity(sens, 1.2) == j_prune(sens, 1.2)


class StubEvaluator:
    """Deterministic analytic loss (lower bits -> higher loss); the same
    object drives both searches."""

    def __init__(self, topology, bits_fn):
        self.topology = topology
        self.bits_fn = bits_fn

    def eval(self, arch):
        bits = np.concatenate([np.asarray(v, float)
                               for v in arch["linear"].values()])
        w = np.linspace(1.0, 2.0, bits.size)
        return ({"synthetic": float(np.mean(w / bits))},
                self.bits_fn(arch, self.topology, 128))


def test_search_archive_identical(tmp_path):
    top = get_config("tiny-llama").topology()
    kw = dict(dataset="synthetic", iterations=2, n_doe=12, n_iter=4,
              save_iter=1, ga_pop_size=16, subset_pop_size=8, verbose=False,
              seed=5)
    js, ts = _spaces(seed=5)
    ja = JSearch(StubEvaluator(top, j_bits), js,
                 save_path=str(tmp_path / "jax"), **kw).search()
    ta = TSearch(StubEvaluator(top, t_bits), ts,
                 save_path=str(tmp_path / "torch"), **kw).search()
    assert len(ta) == 12 + 2 * 4
    assert ta == ja
    for it in (1, 2):
        want = json.load(open(tmp_path / "jax" / f"iter_{it}.stats"))
        got = json.load(open(tmp_path / "torch" / f"iter_{it}.stats"))
        for key in ("archive", "candidates", "hv", "iteration"):
            assert got[key] == want[key]
        for key in ("model", "name", "rmse", "rho", "tau"):
            assert got["surrogate"][key] == want["surrogate"][key]


def _toy(n=60, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, d)).astype(float)
    y = X @ np.linspace(1.0, 2.0, d) + 0.1 * (X[:, 0] * X[:, 1])
    return X, y


def test_mlp_forward_matches_flax_with_carried_weights():
    X, y = _toy()
    jm = JMLP(epochs=30)
    jm.fit(X, y)
    flax = jax.tree_util.tree_map(np.asarray, jm.params["params"])
    tm = convert.mlp_from_flax(flax)
    # f32 on both sides, three 300-wide layers: sums in other orders
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-5,
                               atol=1e-5)
    assert tm.predict(X[0]).shape == (1, 1)


def test_mlp_trains_and_ranks():
    X, y = _toy()
    mlp = get_predictor("mlp", X, y, epochs=80)
    pred = mlp.predict(X).ravel()
    assert np.all(np.isfinite(pred))
    from amq_tpu_torch.evaluation.metrics import get_correlation
    _, rho, _ = get_correlation(pred, y)
    assert rho > 0.8
    # seeded: a second fit gives the same network
    again = get_predictor("mlp", X, y, epochs=80)
    np.testing.assert_array_equal(again.predict(X).ravel(), pred)
