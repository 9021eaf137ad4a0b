"""The port's tensor parallelism held to the JAX package's on the CPU.

JAX builds the per-bit proxies of ``graft-tp`` (4 layers, every cut
group-aligned up to tp 4) and of its uneven-intermediate variant (9
groups: 5 + 4 at tp 2, 3 + 2 + 2 + 2 at tp 4) and runs
``make_tp_forward_stacked`` on its 8-device virtual CPU mesh;
``models.convert`` carries the proxies across, and the port builds its
shards in one process (bit-equal leaves) and runs its ranks as gloo
processes (``parallel.launch.spawn``), float32.  The unrolled model and the
TP engine are in ``test_torch_tp_unrolled.py``.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models.config import LINEAR_NAMES
from amq_tpu.parallel import tp_stacked as jtps

import torch

from amq_tpu_torch.core.quantize import dequantize
from amq_tpu_torch.models import convert
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models.stacked import SERVE_CONTAINERS, quantize_head
from amq_tpu_torch.parallel import launch
from amq_tpu_torch.parallel import tp_stacked as tps

from test_torch_slice import (flatten_params, flatten_stacked,  # noqa: F401
                              torch_one_thread)

BITS = (2, 3, 4)
#: the JAX suite's TP tolerances (tests/test_tp_stacked.py)
PREFILL_TOL, CHAIN_TOL = 2e-4, 3e-4


def _arch(L, pattern):
    return {"linear": {n: [pattern[i % len(pattern)] for i in range(L)]
                       for n in LINEAR_NAMES}}


def _port(proxy, cfg):
    return convert.params_from_flat(*flatten_params(proxy, cfg),
                                    num_layers=cfg.num_layers)


def _configs():
    base = get_config("graft-tp")
    return {"even": base,
            "uneven": dataclasses.replace(base, intermediate_size=1152,
                                          name="graft-tp-odd")}


@pytest.fixture(scope="module")
def built():
    """Per config: JAX proxies, the port's copies, the port config."""
    out = {}
    for i, (kind, cfg) in enumerate(_configs().items()):
        params = init_params(cfg, jax.random.PRNGKey(1 + 2 * i))
        proxies = [quantize_model(params, cfg, b, optimize=False)
                   for b in BITS]
        tcfg = t_get_config("graft-tp")
        if kind == "uneven":
            tcfg = dataclasses.replace(tcfg, intermediate_size=1152,
                                       name="graft-tp-odd")
        out[kind] = (cfg, proxies, [_port(p, cfg) for p in proxies], tcfg)
    return out


#: the serving layout: cycled widths, 3-bit in 4-bit containers, merged
#: per-container stacks, the vocab-sharded 8-bit head
SERVE = dict(container_bits=SERVE_CONTAINERS, merge=True, head_bits=8)


def _serve_arch(cfg):
    return _arch(cfg.num_layers, (2, 3, 4))


def _assert_models_equal(got, want):
    assert got.num_layers == want.num_layers
    assert got.bits_range == want.bits_range
    assert got.select == want.select and got.slots == want.slots
    for f in ("embed", "final_norm", "input_norm", "post_norm"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert set(got.sites) == set(want.sites)
    for name in want.sites:
        for g, w in zip(got.sites[name], want.sites[name], strict=True):
            assert (g.nbits, g.group_size, g.superblock) == (
                w.nbits, w.group_size, w.superblock), name
            assert tuple(g.shape) == tuple(w.shape), name
            for f in ("packed", "scale", "zero"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (name, f)
    assert (got.lm_head_qt is None) == (want.lm_head_qt is None)
    if want.lm_head_qt is not None:
        g, w = got.lm_head_qt, want.lm_head_qt
        assert tuple(g.shape) == tuple(w.shape)
        assert g.superblock == w.superblock
        # the port's HQQ and XLA's round W * scale + zero and refine the
        # zero in another f32 order: on the same weights a few groups of
        # the dequantized head land up to a code step apart (0.16% of the
        # entries of one graft-tp shard)
        dg, dw = dequantize(g), dequantize(w)
        step = float(g.scale.float().abs().max())
        assert float((dg - dw).abs().max()) <= 2 * step
        assert int((dg != dw).sum()) <= dg.numel() // 100


def _head_shard(tproxies, tcfg, tp, s):
    """The head shard cut from the port's dense head and quantized by the
    port: what stack_proxies_tp's head must equal bit for bit."""
    v_loc = -(-tcfg.vocab_size // tp)
    rows = tproxies[-1]["lm_head"].weight[s * v_loc:(s + 1) * v_loc]
    return quantize_head(
        torch.nn.functional.pad(rows, (0, 0, 0, v_loc - rows.shape[0])),
        nbits=8)


@pytest.fixture(scope="module")
def jax_tp():
    """JAX stack_proxies_tp models in the serving layout, built once per
    (config, tp) for the module (host arrays, no mesh)."""
    cache = {}

    def get(built, kind, tp):
        if (kind, tp) not in cache:
            cfg, proxies, _, _ = built[kind]
            cache[kind, tp] = jtps.stack_proxies_tp(
                proxies, BITS, cfg, tp, arch=_serve_arch(cfg), **SERVE)
        return cache[kind, tp]

    return get


@pytest.mark.parametrize("kind", ["even", "uneven"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_leaves_equal_jax(built, jax_tp, kind, tp):
    """Every shard of the port's stack_proxies_tp (and shard_proxy of each
    width) built in one process is bit-equal to the JAX [tp, ...] leaves:
    the lane cuts, the row cuts repacked with a local superblock, the
    zero-scale phantom groups and the merged stacks.  The head shard is
    bit-equal to the port's quantization of the same vocab rows, and
    within the two packages' HQQ rounding of JAX's."""
    cfg, proxies, tproxies, tcfg = built[kind]
    arch = _serve_arch(cfg)
    jm = jax_tp(built, kind, tp)
    for s in range(tp):
        want = convert.stacked_from_flat(*flatten_stacked(
            jax.tree.map(lambda x: x[s], jm)))
        got = tps.stack_proxies_tp(tproxies, BITS, tcfg, tp, s, arch=arch,
                                   **SERVE)
        _assert_models_equal(got, want)
        head = _head_shard(tproxies, tcfg, tp, s)
        for f in ("packed", "scale", "zero"):
            assert torch.equal(getattr(got.lm_head_qt, f), getattr(head, f))
        # the 3-bit proxy in its native planes (the stacks above hold it
        # in 4-bit containers)
        want_p = _port(jtps.shard_proxy(proxies[1], cfg, tp, s), cfg)
        got_p = tps.shard_proxy(tproxies[1], tcfg, tp, s)
        for lw, lg in zip(want_p["layers"], got_p["layers"]):
            for n in LINEAR_NAMES:
                a, b = lw[n].qt, lg[n].qt
                assert (a.shape, a.superblock) == (b.shape, b.superblock)
                for f in ("packed", "scale", "zero"):
                    assert torch.equal(getattr(a, f), getattr(b, f)), n


def _jax_bits(t: torch.Tensor):
    """A port tensor as the JAX array of the same bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    if t.dtype == torch.int32:
        return jnp.asarray(t.numpy().view(np.uint32))
    return jnp.asarray(t.numpy())


def _jax_tp_chain(cfg, jm, heads, tp, toks, steps, T=32):
    """make_tp_forward_stacked's prefill and greedy chain over ``jm`` with
    its head shards replaced by ``heads`` (the port's quantization of the
    same rows), so the comparison holds the sharded forward alone."""
    mesh = jtps.make_tp_mesh(tp)
    qt = dataclasses.replace(jm.lm_head_qt, **{
        f: jnp.stack([_jax_bits(getattr(h, f)) for h in heads])
        for f in ("packed", "scale", "zero")})
    model = dataclasses.replace(jm, lm_head_qt=qt)
    model = jax.device_put(model, jax.tree.map(
        lambda sp: NamedSharding(mesh, sp), jtps.tp_specs(model),
        is_leaf=lambda x: isinstance(x, P)))
    fwd = jax.jit(jtps.make_tp_forward_stacked(cfg, mesh, model,
                                               compute_dtype=jnp.float32))
    cache = jtps.new_tp_cache(cfg, tp, toks.shape[0], T, dtype=jnp.float32,
                              mesh=mesh)
    logits, cache = fwd(model, jnp.asarray(toks), cache)
    outs = [np.asarray(logits)]
    for _ in range(steps):
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
        logits, cache = fwd(model, tok[:, None], cache)
        outs.append(np.asarray(logits))
    return outs


@pytest.mark.parametrize("kind,tp", [("even", 2), ("even", 4),
                                     ("uneven", 2), ("uneven", 4)])
def test_tp_stacked_chain_matches_jax(built, jax_tp, kind, tp):
    """Prefill and a 4-step greedy decode chain over gloo ranks against
    make_tp_forward_stacked on the mesh: merged containers, the
    vocab-sharded 8-bit head (the port's quantization of each shard's rows
    on both sides: the two HQQs part on rounding ties, see above), and
    uneven intermediate splits."""
    cfg, proxies, tproxies, tcfg = built[kind]
    arch = _serve_arch(cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    heads = [_head_shard(tproxies, tcfg, tp, s) for s in range(tp)]
    want = _jax_tp_chain(cfg, jax_tp(built, kind, tp), heads, tp, toks,
                         steps=4)
    res = launch.spawn(launch.tp_stacked_run, tp, tproxies, BITS, tcfg,
                       toks.astype(np.int64), steps=4,
                       stack_kw=dict(arch=arch, **SERVE), device="cpu",
                       use_kernels=False, backend="gloo", threads=1)
    # every rank returns the same gathered logits
    for _, _, outs in res[1:]:
        for a, b in zip(outs, res[0][2]):
            np.testing.assert_array_equal(a, b)
    got = res[0][2]
    np.testing.assert_allclose(got[0], want[0], rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_allclose(g, w, rtol=CHAIN_TOL, atol=CHAIN_TOL,
                                   err_msg=f"decode step {i}")


def test_tp_stacked_data_tensor_matches_jax(built):
    """data 2 x tensor 2 (pod_mesh): batch rows over 'data', shards over
    'tensor', against the JAX composed mesh."""
    cfg, proxies, tproxies, tcfg = built["even"]
    arch = _arch(cfg.num_layers, (2, 4))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    mesh = jtps.make_tp_mesh(2, data=2)
    model = jtps.stack_proxies_tp(proxies, BITS, cfg, 2, arch=arch, mesh=mesh)
    fwd = jax.jit(jtps.make_tp_forward_stacked(cfg, mesh, model,
                                               compute_dtype=jnp.float32))
    cache = jtps.new_tp_cache(cfg, 2, 2, 32, dtype=jnp.float32, mesh=mesh)
    want = np.asarray(fwd(model, jnp.asarray(toks), cache)[0])
    res = launch.spawn(launch.tp_stacked_run, 4, tproxies, BITS, tcfg,
                       toks.astype(np.int64), tp=2,
                       stack_kw=dict(arch=arch), device="cpu",
                       use_kernels=False, backend="gloo", threads=1)
    rows = {d: outs[0] for d, t, outs in res if t == 0}
    got = np.concatenate([rows[0], rows[1]])
    np.testing.assert_allclose(got, want, rtol=PREFILL_TOL, atol=PREFILL_TOL)


def test_all_reduce_follows_every_down_route(built, monkeypatch):
    """scan_layers(tp_group=...) sums the o output and the MLP output,
    whichever route made the latter: the one-launch MLP (row 6, which runs
    on the card only; stood in for here) or gateup -> SwiGLU-down."""
    from amq_tpu_torch.models import stacked as tst
    from amq_tpu_torch.parallel import comm
    _, _, tproxies, tcfg = built["even"]
    model = tps.stack_proxies_tp(tproxies, BITS, tcfg, 2, 0,
                                 arch=_serve_arch(tcfg))
    lcfg = tps.local_stacked_config(tcfg, 2)
    x = torch.randn(1, 3, tcfg.hidden_size)
    summed = []
    monkeypatch.setattr(comm, "all_reduce_",
                        lambda t, group: summed.append(t) or t)
    for merged in (False, True):
        made = []
        if merged:
            def mlp(model, i, h, compute_dtype, bit_idx):
                made.append(torch.full((*h.shape[:-1], tcfg.hidden_size),
                                       float(i)))
                return made[-1]
            monkeypatch.setattr(tst, "_apply_mlp_merged", mlp)
        summed.clear()
        tst.scan_layers(model, lcfg, x, compute_dtype=torch.float32,
                        tp_group=object())
        assert len(summed) == 2 * tcfg.num_layers
        if merged:
            assert all(a is b for a, b in zip(summed[1::2], made))
