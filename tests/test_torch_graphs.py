"""The serving loops' in-place step bodies -- the ones the port captures
as CUDA graphs on the card -- held to the JAX package's jitted loops on
the CPU, where they run eagerly, one call per step:

(a) the engine's decode step against ``Engine.generate`` (its
    ``lax.scan``), the cache length advanced in place;
(b) the slot decode step against ``decode_chunk``;
(c) the device-indexed slot prefills against ``prefill_slot`` and
    ``prefill_chunk``;
(d) the speculative round, looped on its device flag, against
    ``speculative_decode``'s ``while_loop``;
(e) the graph runner's launch accounting and (f) its warm-up's restore,
    with the card's three capture steps replaced by CPU stand-ins; its
    refusal to replay on another model or cache, and the engines' one
    cache.

Tolerances: float32 caches 2e-4 (``tests/test_decode_attention.py``);
tokens exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.serving import Engine as JEngine
from amq_tpu.serving import batched as jb
from amq_tpu.serving.speculative import SpeculativeEngine as JSpec

from amq_tpu_torch import ops
from amq_tpu_torch.models import convert
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models import llama as tllama
from amq_tpu_torch.models.stacked import decode_switches, routing_key
from amq_tpu_torch.ops import decode_attention as tda
from amq_tpu_torch.ops import quant_matmul as tqm
from amq_tpu_torch.serving import batched as tb
from amq_tpu_torch.serving import graphs
from amq_tpu_torch.serving.engine import Engine, kernel_linear_impl
from amq_tpu_torch.serving.speculative import SpeculativeEngine

from test_torch_slice import (_jax_model, _port_model, flatten_params,
                              layer_uniform_arch, torch_one_thread)  # noqa: F401

BITS = (2, 3, 4)


@pytest.fixture(scope="module")
def models():
    """tiny-llama quantized by the JAX package (2/3/4 cycled per layer,
    fused and container-merged), and the same model carried across."""
    cfg = get_config("tiny-llama")
    params = init_params(cfg, jax.random.PRNGKey(0))
    proxies = [quantize_model(params, cfg, b) for b in BITS]
    jm = _jax_model(cfg, proxies, layer_uniform_arch(cfg.num_layers), True)
    return cfg, t_get_config(cfg.name), jm, _port_model(jm)


# ---------------------------------------------------------------------------
# (a) the engine's decode step

@pytest.mark.parametrize("kernels", [False, True])
def test_decode_step_matches_jax_generate(models, kernels):
    """Prefill, then the engine's decode body called n times on its own
    buffers, float32: the tokens equal the JAX ``Engine.generate``'s, and
    the cache length is the same tensor, advanced in place per step."""
    cfg, tcfg, jm, tm = models
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, 7)).astype(np.int32)
    n = 9
    want = JEngine(jm, cfg, batch_size=1, max_len=32,
                   compute_dtype=jnp.float32, use_pallas=False,
                   cache_dtype=jnp.float32).generate(prompt,
                                                     max_new_tokens=n + 1)
    eng = Engine(tm, tcfg, batch_size=1, max_len=32,
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 use_kernels=kernels, device="cpu")
    cache = eng.new_cache()
    length = cache.length
    first, cache = eng._prefill_token(tm, eng.tokens_to_device(prompt), cache)
    assert cache.length is length and int(length) == 7
    tok, step = first.clone(), torch.zeros(1, dtype=torch.int64)
    toks = torch.full((1, n), -1, dtype=torch.int32)
    with torch.inference_mode():
        for i in range(n):
            eng.decode_step(tm, cache, tok, toks, step)
            assert cache.length is length and int(length) == 7 + i + 1
            assert int(step) == i + 1 and int(tok[0]) == int(toks[0, i])
    got = np.concatenate([first.numpy()[:, None], toks.numpy()], axis=1)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the public loop runs the same body
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=n + 1),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# (b) the slot decode step

def _slot_state(cfg, seed, lengths, T=16):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, T, cfg.head_dim_)
    k = (rng.normal(size=shape) * 0.5).astype(np.float32)
    v = (rng.normal(size=shape) * 0.5).astype(np.float32)
    return k, v, np.asarray(lengths, np.int32), rng


def _jax_cache(k, v, lengths):
    return jb.SlotCache(k=jnp.asarray(k), v=jnp.asarray(v),
                        lengths=jnp.asarray(lengths))


def _port_cache(k, v, lengths):
    return tb.SlotCache(k=torch.from_numpy(k.copy()),
                        v=torch.from_numpy(v.copy()),
                        lengths=torch.from_numpy(lengths.copy()))


def _caches_close(tc, jc):
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("kernels", [False, True])
def test_slot_decode_step_matches_jax_decode_chunk(models, kernels):
    """Four calls of the slot decode body (three slots at lengths 3, 9 and
    0, the last idle), float32, against the JAX ``decode_chunk`` of four
    steps: tokens and lengths equal, caches within 2e-4; the port's
    ``decode_chunk``, which loops the same body, gives the same."""
    cfg, tcfg, jm, tm = models
    k, v, lengths, rng = _slot_state(cfg, 21, [3, 9, 0])
    tokens = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    active = np.array([True, True, False])
    n = 4
    want, jc = jb.decode_chunk(jm, cfg, jnp.asarray(tokens),
                               jnp.asarray(active), _jax_cache(k, v, lengths),
                               n_steps=n, compute_dtype=jnp.float32,
                               impl=None)
    impl = kernel_linear_impl if kernels else None
    tc = _port_cache(k, v, lengths)
    tok = torch.from_numpy(tokens.copy())
    toks = torch.zeros((3, n), dtype=torch.int32)
    step = torch.zeros(1, dtype=torch.int64)
    with torch.inference_mode():
        for _ in range(n):
            tb.slot_decode_step(tm, tcfg, tok, torch.from_numpy(active), tc,
                                toks, step, torch.float32, impl)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want)[:, -1])
    _caches_close(tc, jc)
    np.testing.assert_array_equal(tc.lengths.numpy(), [7, 13, 0])
    tc2 = _port_cache(k, v, lengths)
    got, _ = tb.decode_chunk(tm, tcfg, torch.from_numpy(tokens),
                             torch.from_numpy(active), tc2, n_steps=n,
                             compute_dtype=torch.float32, impl=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _caches_close(tc2, jc)


# ---------------------------------------------------------------------------
# (c) the device-indexed slot prefills

def _idx(x, dtype=torch.int32):
    return torch.tensor([x], dtype=dtype)


@pytest.mark.parametrize("slot", [0, 2])
def test_prefill_window_matches_jax_prefill_slot(models, slot):
    """A right-padded 8-token bucket holding 5 real tokens into one slot
    of three, slot and lengths as device tensors: the next token equals
    the JAX ``prefill_slot``'s, the cache and lengths within 2e-4 (the
    other slots untouched)."""
    cfg, tcfg, jm, tm = models
    k, v, lengths, rng = _slot_state(cfg, 31 + slot, [4, 6, 2])
    S, n = 8, 5
    tokens = np.zeros((1, S), np.int32)
    tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
    want, jc = jb.prefill_slot(jm, cfg, jnp.asarray(tokens), jnp.int32(n),
                               _jax_cache(k, v, lengths), jnp.int32(slot),
                               slot_len=S, compute_dtype=jnp.float32,
                               impl=None)
    tc = _port_cache(k, v, lengths)
    with torch.inference_mode():
        got = tb.prefill_window(tm, tcfg, torch.from_numpy(tokens).long(), tc,
                                _idx(slot, torch.int64), _idx(0), _idx(n), S,
                                torch.float32, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _caches_close(tc, jc)
    assert int(tc.lengths[slot]) == n


@pytest.mark.parametrize("slot,offset,n_new", [(1, 8, 8), (2, 5, 3)])
def test_prefill_window_matches_jax_prefill_chunk(models, slot, offset,
                                                  n_new):
    """One 8-token chunk at a device offset into a slot that already holds
    ``offset`` positions (the window ``offset + 8``): the next token equals
    the JAX ``prefill_chunk``'s, the cache and lengths within 2e-4; the
    wrapper with host ints gives the same."""
    cfg, tcfg, jm, tm = models
    k, v, lengths, rng = _slot_state(cfg, 41 + slot, [3, 3, 3], T=24)
    lengths[slot] = offset
    C = 8
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :n_new] = rng.integers(0, cfg.vocab_size, n_new)
    win = offset + C
    want, jc = jb.prefill_chunk(jm, cfg, jnp.asarray(tokens),
                                jnp.int32(n_new), jnp.int32(offset),
                                _jax_cache(k, v, lengths), jnp.int32(slot),
                                win_len=win, compute_dtype=jnp.float32,
                                impl=None)
    tc = _port_cache(k, v, lengths)
    with torch.inference_mode():
        got = tb.prefill_window(tm, tcfg, torch.from_numpy(tokens).long(), tc,
                                _idx(slot, torch.int64), _idx(offset),
                                _idx(n_new), win, torch.float32, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _caches_close(tc, jc)
    assert int(tc.lengths[slot]) == offset + n_new
    tc2 = _port_cache(k, v, lengths)
    got2, _ = tb.prefill_chunk(tm, tcfg, torch.from_numpy(tokens).long(),
                               n_new, offset, tc2, slot, win_len=win,
                               compute_dtype=torch.float32)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want))
    _caches_close(tc2, jc)


# ---------------------------------------------------------------------------
# (d) the speculative round, looped on its device flag

@pytest.fixture(scope="module")
def spec_models():
    """A two-layer dense tiny-llama target and its 2-bit quantization as
    the weak draft, in both packages (two layers: the JAX side's compile
    dominates these tests)."""
    cfg = dataclasses.replace(get_config("tiny-llama"), num_layers=2)
    params = init_params(cfg, jax.random.PRNGKey(1))
    draft = quantize_model(params, cfg, 2)

    def port(p):
        return convert.params_from_flat(*flatten_params(p, cfg),
                                        num_layers=cfg.num_layers)

    tcfg = dataclasses.replace(t_get_config(cfg.name), num_layers=2)
    return cfg, tcfg, (params, draft), (port(params), port(draft))


@pytest.mark.parametrize("draft,max_new", [
    ("perfect", 12), ("weak", 12),
    # gamma 3 emits 4 a round when the draft is perfect: 10 new tokens
    # clip the third round to 2 (the masked write's tail)
    ("perfect", 11)])
def test_speculative_round_matches_jax(spec_models, draft, max_new):
    """The JAX ``SpeculativeEngine`` and the port's (whose rounds are
    :func:`speculative_round` on device state, looped while its device
    flag is set), float32, gamma 3: the same tokens, rounds and accepted
    draft tokens."""
    cfg, tcfg, (jp, jd), (tp, td) = spec_models
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32)
    jeng = JEngine(jp, cfg, batch_size=1, max_len=32,
                   compute_dtype=jnp.float32, use_pallas=False,
                   cache_dtype=jnp.float32)
    want, jstats = JSpec(jeng, draft_params=jp if draft == "perfect" else jd,
                         gamma=3).generate(prompt, max_new_tokens=max_new)
    teng = Engine(tp, tcfg, batch_size=1, max_len=32,
                  compute_dtype=torch.float32, cache_dtype=torch.float32,
                  device="cpu")
    spec = SpeculativeEngine(teng, draft_params=tp if draft == "perfect"
                             else td, gamma=3)
    got, stats = spec.generate(prompt, max_new_tokens=max_new)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.rounds, stats.accepted) == (jstats.rounds, jstats.accepted)
    if draft == "perfect":
        assert stats.rounds == -(-(max_new - 1) // 4)
    else:
        assert stats.accepted < 3 * stats.rounds


# ---------------------------------------------------------------------------
# (e), (f) the graph runner, its card steps replaced by CPU stand-ins

class _CpuCard(graphs.GraphRunner):
    """A runner that takes the graphed path on the CPU: the warm-up runs
    the body, the "capture" records the state it finds and runs the body
    once (a real capture runs its Python, launching nothing), and a replay
    does nothing but count."""

    def __init__(self):
        super().__init__("cpu")
        self.graphed = True
        self.found = []

    def _memory(self):
        return (0, 0)

    def _warm_up(self, body):
        body()

    def _record(self, body):
        self.found.append([t.clone() for t in self.watch])
        body()
        return types.SimpleNamespace(replay=lambda: None)


def _launching_body(state, fail_at=None):
    """A step that advances ``state`` and counts as three wrapper calls
    would: two GEMVs (grouped) and one decode attention."""
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        state[0].add_(1)
        state[1].mul_(2)
        n = 2 if calls["n"] != fail_at else 3
        tqm.quant_matmul_indexed.launches += n
        tqm.quant_matmul_indexed.grouped_launches += n
        tda.decode_attention_indexed.launches += 1
    return body


def test_runner_counts_replays_not_the_capture():
    """(e) The warm-up's and the capture's launches are taken back; each
    replay adds the step's (2 GEMVs, 2 of them grouped, 1 attention);
    another switch setting is another capture."""
    ops.reset_launch_counts()
    runner = _CpuCard()
    state = [torch.zeros(1, dtype=torch.int64), torch.ones(2)]
    runner.watch = state
    body = _launching_body(state)
    runner.run(("step", 1), body, state=state, times=5)
    assert ops.launch_counts()["quant_matmul_indexed"] == 10
    assert ops.grouped_launch_counts()["quant_matmul_indexed"] == 10
    assert ops.launch_counts()["decode_attention_indexed"] == 5
    runner.run(("step", 1), body, state=state, times=3)
    assert ops.launch_counts()["quant_matmul_indexed"] == 16
    assert (runner.captures, runner.replays) == (1, 8)
    with decode_switches(pipe=True, mlp=False):
        runner.run(("step", 1), body, state=state)
    assert (runner.captures, runner.replays) == (2, 9)
    assert ops.launch_counts()["decode_attention_indexed"] == 9
    assert runner.run(("step", 1), body, state=state, times=0) is None
    assert runner.replays == 9
    ops.reset_launch_counts()


def test_runner_warm_up_restores_state():
    """(f) The capture finds the lengths and token buffers as the caller
    gave them: the warm-up's writes are undone."""
    runner = _CpuCard()
    length = torch.tensor([7], dtype=torch.int64)
    toks = torch.tensor([3.0, 5.0])
    runner.watch = [length, toks]
    runner.run(("step", 2), _launching_body([length, toks]),
               state=[length, toks])
    (found_len, found_toks), = runner.found
    assert int(found_len) == 7
    np.testing.assert_array_equal(found_toks.numpy(), [3.0, 5.0])
    ops.reset_launch_counts()


def test_runner_refuses_a_step_that_launches_differently():
    """A step whose capture launches otherwise than its warm-up raises
    (routing must not depend on capturing), and so does a failed capture,
    instead of running eagerly."""
    runner = _CpuCard()
    state = [torch.zeros(1, dtype=torch.int64), torch.ones(2)]
    runner.watch = state
    with pytest.raises(RuntimeError, match="warm-up launched"):
        runner.run(("step", 3), _launching_body(state, fail_at=2),
                   state=state)

    def broken(body):
        raise RuntimeError("operation not permitted when stream is capturing")

    runner._record = broken
    with pytest.raises(RuntimeError, match="no eager fallback"):
        runner.run(("step", 4), _launching_body(state), state=state)
    ops.reset_launch_counts()


def test_cpu_engines_run_their_bodies_eagerly(models):
    """``device="cpu"`` never captures: the runners are not graphed and
    count no capture or replay over a generate, a slot run and a
    speculative run."""
    _, tcfg, _, tm = models
    eng = Engine(tm, tcfg, batch_size=1, max_len=32,
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 device="cpu")
    eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=3)
    se = tb.SlotEngine(tm, tcfg, n_slots=2, max_len=32,
                       compute_dtype=torch.float32, prefill_buckets=(8,),
                       device="cpu")
    se.prefill(0, np.arange(5, dtype=np.int32))
    se.step_chunk(np.array([True, False]), 2)
    spec = SpeculativeEngine(eng, draft_params=tm, gamma=2)
    spec.generate(np.zeros((1, 4), np.int32), max_new_tokens=4)
    for runner in (eng.runner, se.runner, spec.runner):
        assert not runner.graphed
        assert (runner.captures, runner.replays) == (0, 0)


def test_runner_replays_only_on_what_it_captured():
    """A graph holds the objects its body reaches by address: the same
    key with the same ones replays, with another model or cache raises
    instead of replaying on the old buffers.  Another switch setting
    (``routing_key``) is another graph."""
    runner = _CpuCard()
    state = [torch.zeros(1, dtype=torch.int64), torch.ones(2)]
    runner.watch = state
    model, cache, other = object(), object(), object()
    body = _launching_body(state)
    runner.run(("step", 5), body, state=state, binds=(model, cache))
    runner.run(("step", 5), body, state=state, times=2, binds=(model, cache))
    assert (runner.captures, runner.replays) == (1, 3)
    for binds in ((model, other), (other, cache), (model,)):
        with pytest.raises(ValueError, match="captured on"):
            runner.run(("step", 5), body, state=state, binds=binds)
    assert routing_key() == (0, False)
    with decode_switches(pipe=True, mlp=True):
        assert routing_key() == (1, True)
        runner.run(("step", 5), body, state=state, binds=(model, other))
    assert (runner.captures, runner.replays) == (2, 4)
    ops.reset_launch_counts()


def test_engines_keep_one_cache_and_refuse_others(models):
    """On every device the engine serves its one cache: ``new_cache()``
    returns the same object emptied, the serving methods refuse another
    cache or other params, and the speculative engine's draft cache is
    one object across generates."""
    _, tcfg, _, tm = models
    eng = Engine(tm, tcfg, batch_size=1, max_len=32,
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 device="cpu")
    prompt = np.arange(5, dtype=np.int32)[None]
    cache = eng.new_cache()
    first, got = eng._prefill_token(tm, eng.tokens_to_device(prompt), cache)
    assert got is cache and int(cache.length) == 5
    assert eng.new_cache() is cache and int(cache.length) == 0
    foreign = tllama.KVCache.create(tcfg, 1, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="its own cache"):
        eng._prefill_token(tm, eng.tokens_to_device(prompt), foreign)
    with pytest.raises(ValueError, match="its own"):
        eng._decode_n(object(), first, cache, n_steps=2)
    spec = SpeculativeEngine(eng, draft_params=tm, gamma=2)
    spec.generate(prompt, max_new_tokens=4)
    d_cache = spec._d_cache
    spec.generate(prompt, max_new_tokens=4)
    assert spec._d_cache is d_cache and d_cache is not cache
