"""The port's pipeline stages held to the JAX package's on the CPU.

JAX builds ``tiny-llama`` (4 layers) per-bit proxies and runs
``make_pp_step`` (GPipe ticks, ``ppermute``, ``psum`` of the last stage's
logits) on its virtual CPU mesh, alone and composed with tensor
parallelism; the port runs the same passes as gloo ranks (send / recv,
a broadcast from the last stage), float32: a prefill of 8 tokens, then
decode steps, batch 4 in 2 microbatches.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models.config import LINEAR_NAMES
from amq_tpu.models.llama import KVCache as JKVCache
from amq_tpu.models.stacked import stack_proxies
from amq_tpu.parallel import pp as jpp
from amq_tpu.parallel import tp_stacked as jtps

import torch

from amq_tpu_torch.models import convert
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models.stacked import merge_containers
from amq_tpu_torch.parallel import launch, multihost
from amq_tpu_torch.parallel import pp

from test_torch_slice import (flatten_params, flatten_stacked,  # noqa: F401
                              torch_one_thread)

BITS = (2, 3, 4)
B, S_PRE, T = 4, 8, 16


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("tiny-llama")
    params = init_params(cfg, jax.random.PRNGKey(0))
    proxies = [quantize_model(params, cfg, b, optimize=False) for b in BITS]
    arch = {"linear": {n: [BITS[i % 3] for i in range(cfg.num_layers)]
                       for n in LINEAR_NAMES}}
    model = stack_proxies(proxies, BITS, arch=arch)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, S_PRE)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (3, B, 1)).astype(np.int32)
    tproxies = [convert.params_from_flat(*flatten_params(p, cfg),
                                         num_layers=cfg.num_layers)
                for p in proxies]
    tmodel = convert.stacked_from_flat(*flatten_stacked(model))
    return cfg, proxies, arch, model, prompt, steps, tproxies, tmodel


def _jax_pp(cfg, mesh, model, sharded, cache, prompt, steps):
    outs = []
    for t in [prompt, *steps]:
        step = jpp.make_pp_step(cfg, mesh, model, n_micro=2,
                                seq_len=t.shape[1], batch=B,
                                compute_dtype=jnp.float32)
        lg, cache = step(sharded, jnp.asarray(t), cache)
        outs.append(np.asarray(lg))
    return outs


def test_pp_matches_jax(setup):
    """2 stages x 2 microbatches: prefill and 3 decode steps."""
    cfg, _, _, model, prompt, steps, _, tmodel = setup
    mesh = jpp.make_stage_mesh(2)
    cache = jax.device_put(
        JKVCache.create(cfg, B, T, dtype=jnp.float32),
        jax.tree.map(lambda s: NamedSharding(mesh, s), jpp.cache_specs(),
                     is_leaf=lambda x: isinstance(x, P)))
    want = _jax_pp(cfg, mesh, model, jpp.shard_model_pp(model, mesh), cache,
                   prompt, steps)
    res = launch.spawn(launch.pp_run, 2, tmodel, t_get_config(cfg.name),
                       prompt.astype(np.int64), steps.astype(np.int64),
                       n_micro=2, max_len=T, device="cpu", use_kernels=False,
                       backend="gloo", threads=1)
    for got in res:                 # the last stage's logits on every rank
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"call {i}")


def test_pp_tp_matches_jax(setup):
    """2 stages x tensor 2: every stage a TP group of tp_stacked shards."""
    cfg, proxies, arch, _, prompt, steps, tproxies, _ = setup
    steps = steps[:2]
    mesh = jpp.make_stage_mesh(2, tp=2)
    tp_model = jtps.stack_proxies_tp(proxies, BITS, cfg, 2, arch=arch)
    lcfg = jtps.local_stacked_config(cfg, 2)
    shape = (2, cfg.num_layers, B, lcfg.num_kv_heads, T, lcfg.head_dim_)
    cache = jax.device_put(
        JKVCache(k=jnp.zeros(shape, jnp.float32),
                 v=jnp.zeros(shape, jnp.float32), length=jnp.int32(0)),
        jax.tree.map(lambda s: NamedSharding(mesh, s),
                     jpp.cache_specs(tp=True),
                     is_leaf=lambda x: isinstance(x, P)))
    want = _jax_pp(cfg, mesh, tp_model, jpp.shard_model_pp(tp_model, mesh),
                   cache, prompt, steps)
    res = launch.spawn(launch.pp_run, 4, tproxies, t_get_config(cfg.name),
                       prompt.astype(np.int64), steps.astype(np.int64),
                       n_micro=2, tp=2, bits_range=BITS, arch=arch,
                       max_len=T, device="cpu", use_kernels=False,
                       backend="gloo", threads=1)
    for got in res:
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-4,
                                       err_msg=f"call {i}")


def test_stage_cut_and_refusals(setup):
    """A stage holds its layers of every stack; merged containers and a
    packed head are refused, as the JAX package refuses them."""
    cfg, _, _, _, _, _, _, tmodel = setup
    st = pp.shard_model_pp(tmodel, 2, 1)
    assert st.num_layers == 2
    for name, stacks in tmodel.sites.items():
        assert st.select[name] == tmodel.select[name][2:]
        for a, b in zip(st.sites[name], stacks):
            assert torch.equal(a.packed, b.packed[2:])
    assert torch.equal(st.input_norm, tmodel.input_norm[2:])
    uniform = convert.stacked_from_flat(*flatten_stacked(stack_proxies(
        [quantize_model(init_params(cfg, jax.random.PRNGKey(0)), cfg, b,
                        optimize=False) for b in BITS], BITS,
        arch={"linear": {n: [BITS[i % 3] for i in range(cfg.num_layers)]
                         for n in LINEAR_NAMES}})))
    uniform = dataclasses.replace(uniform, uniform_select=True)
    with pytest.raises(ValueError, match="merge"):
        pp.shard_model_pp(merge_containers(uniform), 2, 0)
    with pytest.raises(ValueError, match="do not split"):
        pp.shard_model_pp(tmodel, 3, 0)
    fake = multihost.PodMesh(rows=[[0], [1]], data_index=0, tensor_index=0,
                             tensor_group=None, data_group=None)
    head = dataclasses.replace(tmodel, lm_head_qt=object())
    with pytest.raises(ValueError, match="head"):
        pp.make_pp_step(t_get_config(cfg.name), fake, head, n_micro=2)
