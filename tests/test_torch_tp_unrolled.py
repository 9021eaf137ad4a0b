"""The port's unrolled tensor parallelism and TP engine held to the JAX
package's on the CPU.

``parallel/tp.py``'s forward (``graft-tp``, 3-bit proxies in 128-row
superblocks, so every row-parallel K shard is whole packing blocks)
against ``make_tp_forward`` on the JAX 8-device virtual CPU mesh; the TP
serving engine (``make_tp_engine``) against the JAX one, token for token;
and the two refusals (captured graphs on a gloo group, a row-parallel
bias).  The port's ranks run as gloo processes, float32.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models.llama import KVCache as JKVCache
from amq_tpu.models.llama import forward as jforward
from amq_tpu.parallel import tp as jtp
from amq_tpu.parallel import tp_stacked as jtps

import torch

from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.parallel import launch
from amq_tpu_torch.parallel import tp_stacked as tps

from test_torch_slice import torch_one_thread  # noqa: F401
from test_torch_tp import BITS, PREFILL_TOL, _arch, _port, built  # noqa: F401


@pytest.fixture(scope="module")
def unrolled():
    cfg = get_config("graft-tp")
    params = init_params(cfg, jax.random.PRNGKey(1))
    qparams = quantize_model(params, cfg, 3, optimize=False, superblock=128)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    steps = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 2, 1)).astype(np.int32)
    return cfg, qparams, _port(qparams, cfg), toks, steps


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_unrolled_matches_jax(unrolled, tp):
    """tp.py's unrolled forward (prefill with a cache; at tp 4 then 3
    decode steps) against make_tp_forward on the mesh."""
    cfg, qparams, tparams, toks, steps = unrolled
    mesh = jtp.make_mesh(n_devices=tp, data=1, tensor=tp)
    fwd = jax.jit(jtp.make_tp_forward(cfg, mesh, qparams,
                                      compute_dtype=jnp.float32))
    sharded = jtp.shard_params(qparams, mesh)
    cache = jax.device_put(
        JKVCache.create(cfg, batch=2, max_len=32, dtype=jnp.float32),
        jax.tree.map(lambda s: NamedSharding(mesh, s), jtp.cache_specs(),
                     is_leaf=lambda x: isinstance(x, P)))
    steps = steps if tp == 4 else steps[:0]
    want = []
    for t in [toks, *steps]:
        t = jax.device_put(jnp.asarray(t),
                           NamedSharding(mesh, P("data", None)))
        logits, cache = fwd(sharded, t, cache)
        want.append(np.asarray(logits))
    got = launch.spawn(launch.tp_run, tp, tparams, t_get_config("graft-tp"),
                       toks.astype(np.int64), steps.astype(np.int64),
                       device="cpu", backend="gloo", threads=1)[0]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=PREFILL_TOL, atol=PREFILL_TOL,
                                   err_msg=f"call {i}")
    # the JAX sharded program itself matches the single-device forward
    ref = np.asarray(jforward(qparams, cfg, jnp.asarray(toks),
                              compute_dtype=jnp.float32)[0])
    np.testing.assert_allclose(got[0], ref, rtol=PREFILL_TOL, atol=PREFILL_TOL)


def test_tp_unrolled_proxy_switch_matches_jax():
    """A ProxySwitch model (the JAX evaluator's working model: per-bit
    proxies of every linear and a selector) cut proxy by proxy, its
    selectors kept, against make_tp_forward over build_switch_model."""
    from amq_tpu.models.config import LINEAR_NAMES
    from amq_tpu.models.transform import build_switch_model
    from amq_tpu_torch.models.linear import ProxySwitch
    cfg = get_config("graft-tp")
    params = init_params(cfg, jax.random.PRNGKey(4))
    proxies = [quantize_model(params, cfg, b, optimize=False, superblock=128)
               for b in BITS]
    arch = _arch(cfg.num_layers, (4, 2, 3))
    jsw = build_switch_model(proxies, BITS, arch)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    mesh = jtp.make_mesh(n_devices=2, data=1, tensor=2)
    fwd = jax.jit(jtp.make_tp_forward(cfg, mesh, jsw,
                                      compute_dtype=jnp.float32))
    cache = jax.device_put(
        JKVCache.create(cfg, batch=2, max_len=32, dtype=jnp.float32),
        jax.tree.map(lambda s: NamedSharding(mesh, s), jtp.cache_specs(),
                     is_leaf=lambda x: isinstance(x, P)))
    want = np.asarray(fwd(jtp.shard_params(jsw, mesh), jax.device_put(
        jnp.asarray(toks), NamedSharding(mesh, P("data", None))), cache)[0])
    ported = [_port(p, cfg) for p in proxies]
    tsw = dict(ported[-1])
    tsw["layers"] = [
        {**layer, **{n: ProxySwitch(
            proxies=tuple(p["layers"][i][n] for p in ported),
            select=BITS.index(arch["linear"][n][i])) for n in LINEAR_NAMES}}
        for i, layer in enumerate(ported[-1]["layers"])]
    got = launch.spawn(launch.tp_run, 2, tsw, t_get_config("graft-tp"),
                       toks.astype(np.int64), device="cpu", backend="gloo",
                       threads=1)[0]
    np.testing.assert_allclose(got[0], want, rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)


def engine_rank(rank, world, proxies, bits, cfg, arch, prompt, n_new):
    """The TP engine's greedy tokens (eager on gloo) and the message of
    its refusal of captured graphs on a gloo group."""
    import torch.distributed as dist
    model = tps.stack_proxies_tp(proxies, bits, cfg, world, rank, arch=arch)
    try:
        tps.make_tp_engine(cfg, dist.group.WORLD, world, model, batch_size=2,
                           max_len=48, compute_dtype=torch.float32,
                           cache_dtype=torch.float32, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    eng = tps.make_tp_engine(cfg, dist.group.WORLD, world, model,
                             batch_size=2, max_len=48,
                             compute_dtype=torch.float32,
                             cache_dtype=torch.float32, device="cpu",
                             graphs=False)
    return eng.generate(prompt, max_new_tokens=n_new), refused


def test_tp_engine_generate_and_graph_refusal(built):
    """make_tp_engine reuses Engine.generate token-for-token with the JAX
    TP engine; graphs=True on a gloo group raises."""
    cfg, proxies, tproxies, tcfg = built["even"]
    arch = _arch(cfg.num_layers, (3, 2))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    mesh = jtps.make_tp_mesh(2)
    jm = jtps.stack_proxies_tp(proxies, BITS, cfg, 2, arch=arch, mesh=mesh)
    want = jtps.make_tp_engine(cfg, mesh, jm, batch_size=2, max_len=48,
                               compute_dtype=jnp.float32,
                               cache_dtype=jnp.float32,
                               use_pallas=False).generate(toks,
                                                          max_new_tokens=8)
    res = launch.spawn(engine_rank, 2, tproxies, BITS, tcfg, arch, toks, 8,
                       backend="gloo", threads=1)
    for got, refused in res:
        np.testing.assert_array_equal(got, want)
        assert refused is not None and "gloo" in refused


def test_shard_proxy_refuses_row_parallel_bias(built):
    cfg, _, tproxies, tcfg = built["even"]
    proxy = tproxies[0]
    layer = dict(proxy["layers"][0])
    for name in ("self_attn.o_proj", "mlp.down_proj"):
        ql = layer[name]
        bad = {**proxy, "layers": [
            {**layer, name: dataclasses.replace(
                ql, bias=torch.zeros(ql.qt.shape[0]))}]}
        with pytest.raises(ValueError, match="row-parallel bias"):
            tps.shard_proxy(bad, tcfg, 2, 0)
