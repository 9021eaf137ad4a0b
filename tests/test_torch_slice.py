"""The port's serving slice held to the JAX package on tiny models.

JAX builds the model (quantize_model x3 -> stack_proxies -> optionally
merge_containers); models.convert carries it across as numpy; prefill
logits and greedy tokens are compared in float32 on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.models import llama as jllama
from amq_tpu.models import stacked as jst
from amq_tpu.models.config import LINEAR_NAMES, cycled_arch
from amq_tpu.models.linear import DenseLinear as JDense
from amq_tpu.serving import Engine as JEngine

import torch

from amq_tpu_torch.models import convert
from amq_tpu_torch.models import llama as tllama
from amq_tpu_torch.models import stacked as tst
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models.transform import quantize_model as t_quantize_model
from amq_tpu_torch.serving.engine import Engine as TEngine

BITS = (2, 3, 4)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One intra-op thread for the module: these CPU tests run thousands of
    small ops, and several test processes each spinning a full thread pool
    slow one another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a)


def flatten_params(params, cfg):
    """A JAX init_params / quantize_model pytree -> (flat, static)."""
    flat, static = {"embed": _np(params["embed"]),
                    "final_norm": _np(params["final_norm"])}, {}
    if "lm_head" in params:
        flat["lm_head/weight"] = _np(params["lm_head"].weight)
    for i, layer in enumerate(params["layers"]):
        pre = f"layers/{i}"
        flat[f"{pre}/input_norm"] = _np(layer["input_norm"])
        flat[f"{pre}/post_norm"] = _np(layer["post_norm"])
        for name in LINEAR_NAMES:
            p = layer[name]
            if p.bias is not None:
                flat[f"{pre}/{name}/bias"] = _np(p.bias)
            if isinstance(p, JDense):
                flat[f"{pre}/{name}/weight"] = _np(p.weight)
            else:
                key = f"{pre}/{name}/qt"
                for f in ("packed", "scale", "zero"):
                    flat[f"{key}/{f}"] = _np(getattr(p.qt, f))
                static[key] = dict(nbits=p.qt.nbits, group_size=p.qt.group_size,
                                   shape=p.qt.shape, superblock=p.qt.superblock)
    return flat, static


def flatten_stacked(m):
    """A JAX StackedModel -> (flat, static) for convert.stacked_from_flat."""
    flat = {k: _np(getattr(m, k)) for k in
            ("embed", "final_norm", "input_norm", "post_norm")}
    if m.lm_head is not None:
        flat["lm_head"] = _np(m.lm_head)
    static = {"sites": {}, "bits_range": list(m.bits_range),
              "num_layers": m.num_layers, "uniform_select": m.uniform_select,
              "select": {n: _np(s).tolist() for n, s in m.select.items()},
              "slots": None if m.slots is None else _np(m.slots).tolist(),
              "lm_head_qt": None}
    for name, stacks in m.sites.items():
        static["sites"][name] = []
        for j, s in enumerate(stacks):
            for f in ("packed", "scale", "zero"):
                flat[f"sites/{name}/{j}/{f}"] = _np(getattr(s, f))
            static["sites"][name].append(dict(
                nbits=s.nbits, group_size=s.group_size, shape=s.shape,
                superblock=s.superblock))
        if m.biases[name] is not None:
            flat[f"biases/{name}"] = _np(m.biases[name])
    if m.lm_head_qt is not None:
        qt = m.lm_head_qt
        for f in ("packed", "scale", "zero"):
            flat[f"lm_head_qt/{f}"] = _np(getattr(qt, f))
        static["lm_head_qt"] = dict(nbits=qt.nbits, group_size=qt.group_size,
                                    shape=qt.shape, superblock=qt.superblock)
    return flat, static


def layer_uniform_arch(L):
    """Every site of layer i at BITS[i % 3] (the bench's 2/3/4 cycle):
    fusable and layer-uniform, so merge_containers applies."""
    return {"linear": {l: [BITS[i % 3] for i in range(L)]
                       for l in LINEAR_NAMES}}


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-qwen2"])
def built(request):
    cfg = get_config(request.param)
    params = init_params(cfg, jax.random.PRNGKey(0))
    proxies = [quantize_model(params, cfg, b) for b in BITS]
    return cfg, params, proxies


def _jax_model(cfg, proxies, arch, merge):
    m = jst.stack_proxies(proxies, BITS, arch,
                          container_bits=jst.SERVE_CONTAINERS, head_bits=8)
    return jst.merge_containers(m) if merge else m


def _port_model(m):
    return convert.stacked_from_flat(*flatten_stacked(m))


@pytest.mark.parametrize("arch_kind", ["layer_uniform_merged", "cycled"])
def test_prefill_logits_match(built, arch_kind):
    cfg, _, proxies = built
    L = cfg.num_layers
    arch = (layer_uniform_arch(L) if arch_kind == "layer_uniform_merged"
            else cycled_arch(L, BITS))
    jm = _jax_model(cfg, proxies, arch, arch_kind == "layer_uniform_merged")
    tm = _port_model(jm)
    assert tm.uniform_select == jm.uniform_select
    assert set(tm.sites) == set(jm.sites)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want, _ = jst.forward_stacked(jm, cfg, jnp.asarray(toks),
                                  compute_dtype=jnp.float32)
    got, _ = tst.forward_stacked(tm, t_get_config(cfg.name),
                                 torch.from_numpy(toks.astype(np.int64)),
                                 compute_dtype=torch.float32)
    # f32 on both sides; sums run in different orders
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_greedy_tokens_match(built):
    cfg, _, proxies = built
    jm = _jax_model(cfg, proxies, layer_uniform_arch(cfg.num_layers), True)
    tm = _port_model(jm)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 7)).astype(np.int32)
    jeng = JEngine(jm, cfg, batch_size=1, max_len=32,
                   compute_dtype=jnp.float32, use_pallas=False,
                   cache_dtype=jnp.float32)
    teng = TEngine(tm, t_get_config(cfg.name), batch_size=1, max_len=32,
                   compute_dtype=torch.float32, cache_dtype=torch.float32,
                   device="cpu")
    want = jeng.generate(prompt, max_new_tokens=8)
    got = teng.generate(prompt, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)


def test_decode_logits_with_cache_match(built):
    """Prefill then three single-token steps through the cached path
    (decode attention plain version on the port side)."""
    cfg, _, proxies = built
    jm = _jax_model(cfg, proxies, layer_uniform_arch(cfg.num_layers), True)
    tm = _port_model(jm)
    tcfg = t_get_config(cfg.name)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)
    jc = jllama.KVCache.create(cfg, 1, 16, dtype=jnp.float32)
    tc = tllama.KVCache.create(tcfg, 1, 16, dtype=torch.float32)
    teng = TEngine(tm, tcfg, compute_dtype=torch.float32, device="cpu")
    for s, e in ((0, 5), (5, 6), (6, 7), (7, 8)):
        want, jc = jst.forward_stacked(jm, cfg, jnp.asarray(toks[:, s:e]),
                                       cache=jc, compute_dtype=jnp.float32)
        got, tc = teng._forward(tm, torch.from_numpy(
            toks[:, s:e].astype(np.int64)), tc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    assert int(tc.length) == int(jc.length) == 8


def test_port_stacking_matches_jax(built):
    """The port's stack_proxies + merge_containers on the carried-across
    JAX proxies give the JAX stacked arrays bit for bit."""
    cfg, _, proxies = built
    arch = layer_uniform_arch(cfg.num_layers)
    jm = _jax_model(cfg, proxies, arch, True)
    t_proxies = [convert.params_from_flat(*flatten_params(p, cfg),
                                          num_layers=cfg.num_layers)
                 for p in proxies]
    tm = tst.merge_containers(tst.stack_proxies(
        t_proxies, BITS, arch, container_bits=tst.SERVE_CONTAINERS))
    assert tm.slots == _np(jm.slots).tolist()
    assert tm.bits_range == jm.bits_range
    for name, stacks in jm.sites.items():
        for js, ts in zip(stacks, tm.sites[name]):
            assert (ts.nbits, ts.shape, ts.superblock) == (
                js.nbits, tuple(js.shape), js.superblock)
            np.testing.assert_array_equal(ts.packed.numpy().view(np.uint32),
                                          _np(js.packed))
            np.testing.assert_array_equal(ts.scale.numpy(), _np(js.scale))
            np.testing.assert_array_equal(ts.zero.numpy(), _np(js.zero))
        assert tm.select[name] == _np(jm.select[name]).tolist()


@pytest.mark.parametrize("name,window", [("tiny-llama", None),
                                         ("tiny-qwen2", None),
                                         ("tiny-llama", 4)])
def test_dense_forward_matches(name, window):
    """llama.forward on init_params-shaped dense parameters: GQA, qkv bias
    and tied head (tiny-qwen2), sliding window; with and without cache."""
    cfg = dataclasses.replace(get_config(name), sliding_window=window)
    tcfg = dataclasses.replace(t_get_config(name), sliding_window=window)
    params = init_params(cfg, jax.random.PRNGKey(4))
    tparams = convert.params_from_flat(*flatten_params(params, cfg),
                                       num_layers=cfg.num_layers)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    want, _ = jllama.forward(params, cfg, jnp.asarray(toks))
    got, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    jc = jllama.KVCache.create(cfg, 2, 16, dtype=jnp.float32)
    tc = tllama.KVCache.create(tcfg, 2, 16, dtype=torch.float32)
    for s, e in ((0, 6), (6, 7)):
        want, jc = jllama.forward(params, cfg, jnp.asarray(toks[:, s:e]), cache=jc)
        got, tc = tllama.forward(tparams, tcfg,
                                 torch.from_numpy(toks[:, s:e].astype(np.int64)),
                                 cache=tc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_rope_llama3_scaling_matches():
    cfg = get_config("Llama-3.1-8B")
    pos = np.arange(0, 9000, 97, dtype=np.int32)[None]
    jc, js = jllama.rope_cos_sin(cfg, jnp.asarray(pos))
    tc, ts = tllama.rope_cos_sin(t_get_config(cfg.name), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=2e-3)


def test_port_quantize_model_builds_servable_model():
    """The CLI's own path on the CPU: port quantize_model x3 ->
    stack_proxies(cycled) -> Engine; tokens are in range and the greedy
    continuation is deterministic."""
    cfg = t_get_config("tiny-llama")
    gen = torch.Generator().manual_seed(0)
    params = tllama.init_params(cfg, gen)
    proxies = [(lambda b=b: t_quantize_model(params, cfg, b)) for b in BITS]
    m = tst.stack_proxies(proxies, BITS, cycled_arch(cfg.num_layers, BITS),
                          container_bits=tst.SERVE_CONTAINERS, head_bits=8)
    eng = TEngine(m, cfg, max_len=24, compute_dtype=torch.float32,
                  device="cpu")
    prompt = np.arange(6, dtype=np.int32)[None]
    a = eng.generate(prompt, max_new_tokens=5)
    assert a.shape == (1, 5) and ((a >= 0) & (a < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, eng.generate(prompt, max_new_tokens=5))


#: a Qwen2-style model (qkv bias, tied head, head dim 64) whose every K
#: (hidden 384, intermediate 640) gives superblocks of 128 rows, as
#: Qwen2-0.5B's hidden 896 does: native 3-bit planes there are the
#: kernels' 4-row superblocks (the pair forms)
QWEN_SB128 = dict(name="tiny-qwen2-sb128", hidden_size=384,
                  intermediate_size=640, num_layers=3, num_heads=6,
                  num_kv_heads=2)


@pytest.fixture(scope="module")
def qwen_sb128():
    cfg = dataclasses.replace(get_config("tiny-qwen2"), **QWEN_SB128)
    tcfg = dataclasses.replace(t_get_config("tiny-qwen2"), **QWEN_SB128)
    params = init_params(cfg, jax.random.PRNGKey(1))
    proxies = [quantize_model(params, cfg, b) for b in BITS]
    jm = jst.merge_containers(jst.stack_proxies(
        proxies, BITS, layer_uniform_arch(cfg.num_layers), container_bits={},
        head_bits=8))
    return cfg, tcfg, jm, _port_model(jm)


def test_qwen_native_3bit_sb128_matches_jax(qwen_sb128):
    """The Qwen2-style model served stacked with native 3-bit planes
    (every site's superblock 128: 3-bit q/k/v/o, gate/up and down on the
    4-row layouts) and the 8-bit packed head: float32 prefill logits
    within 2e-4 of the JAX package's stacked forward, and its greedy
    tokens equal to the JAX Engine's."""
    cfg, tcfg, jm, tm = qwen_sb128
    three = [s for stacks in tm.sites.values() for s in stacks
             if s.nbits == 3]
    assert three and all(s.superblock == 128 for s in three)
    assert tm.biases["self_attn.qkv_proj"] is not None
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want, _ = jst.forward_stacked(jm, cfg, jnp.asarray(toks),
                                  compute_dtype=jnp.float32)
    got, _ = tst.forward_stacked(tm, tcfg,
                                 torch.from_numpy(toks.astype(np.int64)),
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)
    jeng = JEngine(jm, cfg, batch_size=1, max_len=32,
                   compute_dtype=jnp.float32, use_pallas=False,
                   cache_dtype=jnp.float32)
    teng = TEngine(tm, tcfg, batch_size=1, max_len=32,
                   compute_dtype=torch.float32, cache_dtype=torch.float32,
                   device="cpu")
    prompt = toks[:1, :7]
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=8),
                                  jeng.generate(prompt, max_new_tokens=8))
