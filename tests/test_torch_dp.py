"""The port's data parallelism and multi-host layout on the CPU.

* data-parallel slots (``serving.dp.DPSlotEngine``, 4 gloo ranks, one slot
  each) give the JAX ``DPSlotEngine``'s tokens on its 4-device virtual
  mesh, float32,
* data-parallel evaluation (samples split over 2 ranks) gives one
  process's JSD losses and perplexities, and the sensitivity CLI with
  ``--data_parallel`` one process's table,
* ``multihost.pod_rows`` / ``pod_mesh`` lay ranks out by host and refuse
  what the JAX ``pod_mesh`` refuses.
"""

import math
import operator
from multiprocessing import resource_tracker

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models.stacked import stack_proxies
from amq_tpu.serving import ContinuousBatcher as JBatcher
from amq_tpu.serving import Request as JRequest
from amq_tpu.serving.dp import DPSlotEngine as JDPSlotEngine

import torch

from amq_tpu_torch.evaluation.data import synthetic_tokens
from amq_tpu_torch.evaluation.evaluator import Evaluator
from amq_tpu_torch.models import convert
from amq_tpu_torch.models.config import LINEAR_NAMES
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models.llama import init_params as t_init_params
from amq_tpu_torch.native import get_lib
from amq_tpu_torch.parallel import launch, multihost

from test_torch_slice import flatten_stacked, torch_one_thread  # noqa: F401

BITS = (2, 3, 4)


@pytest.fixture(scope="module")
def served():
    cfg = get_config("tiny-llama")
    params = init_params(cfg, jax.random.PRNGKey(0))
    model = stack_proxies([quantize_model(params, cfg, b) for b in BITS],
                          BITS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 7, 4, 6, 3, 8)]
    get_lib()        # the native scheduler, built once before the ranks
    return cfg, model, convert.stacked_from_flat(*flatten_stacked(model)), \
        prompts


@pytest.mark.parametrize("chunk_steps", [1, 3])
def test_dp_slots_match_jax(served, chunk_steps):
    cfg, model, tmodel, prompts = served
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    jdp = JDPSlotEngine(model, cfg, mesh, slots_per_shard=1, max_len=64,
                        compute_dtype=jnp.float32, use_pallas=False,
                        prefill_buckets=(8, 16), chunk_steps=chunk_steps)
    batcher = JBatcher(n_slots=jdp.n_slots, max_len=64)
    for i, p in enumerate(prompts):
        batcher.submit(JRequest(uid=i, prompt=p, max_new_tokens=5))
    want = jdp.run(batcher)
    got = launch.spawn(launch.dp_serving_run, 4, tmodel,
                       t_get_config(cfg.name), prompts, 5,
                       chunk_steps=chunk_steps, prefill_buckets=(8, 16),
                       max_len=64, device="cpu", use_kernels=False,
                       backend="gloo", threads=1)
    for rank_got in got:               # every rank holds every request
        assert rank_got == want


@pytest.fixture(scope="module")
def evaluated():
    cfg = t_get_config("tiny-llama")
    params = t_init_params(cfg, torch.Generator().manual_seed(0))
    # 5 samples: 3 + 2 over two ranks, each block's last batch padded
    data = {"s": synthetic_tokens(cfg.vocab_size, n_sample=5, seqlen=32,
                                  seed=0)}
    archs = [{"linear": {n: [b] * cfg.num_layers for n in LINEAR_NAMES}}
             for b in (2, 4)]
    archs.append({"linear": {n: [BITS[i % 3] for i in range(cfg.num_layers)]
                             for n in LINEAR_NAMES}})
    return cfg, params, data, archs


@pytest.mark.parametrize("search", [True, False])
def test_dp_eval_matches_one_process(evaluated, search):
    """JSD losses (search mode) and HQQ perplexities (final mode)."""
    cfg, params, data, archs = evaluated
    one = Evaluator(cfg, dense_params=params, datasets=data, batch_size=2,
                    compute_dtype=torch.float32, device="cpu", search=search,
                    quantize_fn=None if search else launch.hqq_realize)
    want = [one.eval(a) for a in archs]
    got = launch.spawn(launch.dp_eval_run, 2, cfg, params, data, archs,
                       search=search, device="cpu", backend="gloo",
                       threads=1)
    for rank_got in got:
        for (g, gb), (w, wb) in zip(rank_got, want):
            assert gb == wb
            assert g["s"] == pytest.approx(w["s"], rel=1e-6)


def test_sensitivity_cli_data_parallel(tmp_path):
    argv = ["--model_name", "tiny-llama", "--synthetic", "--device", "cpu",
            "--dataset", "synthetic", "--n_sample", "3", "--seqlen", "32",
            "--batch_size", "2", "--compute_dtype", "float32"]
    from amq_tpu_torch.cli import sensitivity
    want = sensitivity.main(argv + ["--save_path", str(tmp_path / "one")])
    got = launch.spawn(launch.cli_run, 2, "sensitivity",
                       argv + ["--save_path", str(tmp_path / "dp"),
                               "--data_parallel"],
                       backend="gloo", threads=1)
    for rank_got in got:
        assert set(rank_got["table"]["loss"]) == set(want["table"]["loss"])
        for k, w in want["table"]["loss"].items():
            assert rank_got["table"]["loss"][k] == pytest.approx(w, rel=1e-6)
    # rank 0 alone writes the table
    assert [p.name for p in (tmp_path / "dp").iterdir()] == [
        p.name for p in (tmp_path / "one").iterdir()]


def test_pod_rows_layout_and_refusals():
    assert multihost.pod_rows(["a"] * 4) == [[0, 1, 2, 3]]
    assert multihost.pod_rows(["a", "a", "b", "b"]) == [[0, 1], [2, 3]]
    assert multihost.pod_rows(["a", "b", "a", "b"], 1) == [[0], [2], [1],
                                                           [3]]
    assert multihost.pod_rows(["a"] * 8, 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="uneven"):
        multihost.pod_rows(["a", "a", "a", "b"])
    with pytest.raises(ValueError, match="must divide"):
        multihost.pod_rows(["a"] * 8, 3)
    multihost.initialize(num_processes=1)          # one process: no group
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 2, 0)


def pod_rank(rank, world, tensor_per_host):
    """pod_mesh over two fake hosts of two ranks: the layout, and a sum
    over each group (the row stays on its host)."""
    import torch.distributed as dist
    try:
        mesh = multihost.pod_mesh(tensor_per_host, host=f"h{rank // 2}")
    except ValueError as e:
        return str(e)
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=mesh.tensor_group)
    d = torch.tensor([float(rank)])
    dist.all_reduce(d, group=mesh.data_group)
    return (mesh.shape, mesh.data_index, mesh.tensor_index, float(t[0]),
            float(d[0]))


def test_pod_mesh_groups_by_host():
    got = launch.spawn(pod_rank, 4, None, backend="gloo", threads=1)
    # rows [[0, 1], [2, 3]]: tensor sums 0+1 and 2+3, data sums 0+2, 1+3
    assert got == [({"data": 2, "tensor": 2}, 0, 0, 1.0, 2.0),
                   ({"data": 2, "tensor": 2}, 0, 1, 1.0, 4.0),
                   ({"data": 2, "tensor": 2}, 1, 0, 5.0, 2.0),
                   ({"data": 2, "tensor": 2}, 1, 1, 5.0, 4.0)]
    refused = launch.spawn(pod_rank, 4, 3, backend="gloo", threads=1)
    assert all("must divide" in r for r in refused)


def test_spawn_leaves_no_process():
    """Every rank, and the resource tracker that starting them launched,
    has ended when spawn returns or raises; a tracker already running
    before is left running."""
    before = launch.descendants()
    assert launch.spawn(operator.add, 2, backend="gloo",
                        threads=1) == [2, 3]
    assert launch.descendants() == before
    with pytest.raises(RuntimeError, match="math domain error"):
        launch.spawn(math.log, 2, backend="gloo", threads=1)   # log(0, 2)
    assert launch.descendants() == before
    resource_tracker.ensure_running()
    try:
        tracker = launch.descendants()
        assert len(tracker) == len(before) + 1
        assert launch.spawn(operator.add, 2, backend="gloo",
                            threads=1) == [2, 3]
        assert launch.descendants() == tracker
    finally:
        resource_tracker._resource_tracker._stop()
    assert launch.descendants() == before
