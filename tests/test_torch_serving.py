"""The port's serving breadth held to the JAX package on the CPU: the
pipelined decode GEMVs and the one-launch decode MLP (plain versions
against the JAX Pallas kernels in interpret mode), the slot-batched decode
step, continuous batching (native and Python schedulers), speculative
decoding and the speed CLI's CONTINUOUS mode.

Four faults of the JAX reference (``ADVICE.md``) are repaired in the port;
each has a test below that passes on the port and fails when the port is
put back to the JAX behaviour.

Tolerances: bf16 decode GEMVs 2e-2 on outputs normalized by their largest
magnitude (``tests/test_quant_matmul.py``); float32 caches 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from amq_tpu.core import quantize as jq
from amq_tpu.models import get_config, init_params, quantize_model
from amq_tpu.ops import quant_matmul as jqm
from amq_tpu.serving import batched as jb
from amq_tpu.serving.engine import ContinuousBatcher as JBatcher
from amq_tpu.serving.engine import Request as JRequest

from amq_tpu_torch.models import llama as tllama
from amq_tpu_torch.models.config import get_config as t_get_config
from amq_tpu_torch.models.convert import to_tensor
from amq_tpu_torch.models.transform import quantize_model as t_quantize_model
from amq_tpu_torch.ops import quant_matmul as tqm
from amq_tpu_torch.serving import batched as tb
from amq_tpu_torch.serving.engine import ContinuousBatcher, Engine, Request
from amq_tpu_torch.serving.speculative import SpeculativeEngine

from test_torch_slice import (_jax_model, _port_model, layer_uniform_arch,
                              torch_one_thread)  # noqa: F401

BITS = (2, 3, 4)


def _norm_close(got, want, atol=2e-2):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _stack(qts):
    return tuple(jnp.stack([getattr(t, f) for t in qts])
                 for f in ("packed", "scale", "zero"))


def _t(arrays):
    return [to_tensor(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# kernels: plain versions against the JAX Pallas kernels

@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_pipelined_gemv_plain_matches_jax_pipe_kernel(nbits, swiglu,
                                                      monkeypatch):
    """The JAX pipelined decode GEMV (``_PIPE_DEFAULT`` on, T = 8) against
    the port's wrapper under the same switch; on the CPU the wrapper takes
    ``qmm_plain`` and counts no launch."""
    monkeypatch.setattr(jqm, "_PIPE_DEFAULT", 1)
    monkeypatch.setattr(tqm, "_PIPE_DEFAULT", 1)
    rng = np.random.default_rng(90 + nbits)
    L, N, K = 2, 256, 1024
    qts = [jq.quantize(jnp.asarray(rng.normal(size=(N, K)).astype(np.float32)
                                   * 0.02), nbits=nbits) for _ in range(L)]
    assert qts[0].superblock == 1024
    stack = _stack(qts)
    x = jnp.asarray(rng.normal(size=(1, K)).astype(np.float32)).astype(jnp.bfloat16)
    u = jnp.asarray(rng.normal(size=(1, K)).astype(np.float32)).astype(jnp.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=1024)
    xt, ut = to_tensor(np.asarray(x)), to_tensor(np.asarray(u))
    assert tqm._pipe_applies(xt, *(t[1] for t in _t(stack)), nbits, 128,
                             1024)
    before = tqm.quant_matmul_indexed_pipe.launches
    with pltpu.force_tpu_interpret_mode():
        if swiglu:
            want = jqm.quant_matmul_swiglu_indexed(
                x, u, *stack, jnp.int32(1), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
        else:
            want = jqm.quant_matmul_indexed(
                x, *stack, jnp.int32(1), acc_dtype=jnp.bfloat16,
                out_dtype=jnp.float32, **kw)
    if swiglu:
        got = tqm.quant_matmul_swiglu_indexed(xt, ut, *_t(stack), 1,
                                              out_dtype=torch.float32, **kw)
    else:
        got = tqm.quant_matmul_indexed(xt, *_t(stack), 1,
                                       out_dtype=torch.float32, **kw)
    _norm_close(got.numpy(), np.asarray(want))
    assert tqm.quant_matmul_indexed_pipe.launches == before


MLP_HID, MLP_INTER, MLP_SB = 512, 384, 128


@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 4])
def test_mlp_plain_matches_jax_mlp_kernel(M, nbits):
    """``qmm_mlp_plain`` (through the wrapper on the CPU) against the JAX
    one-call decode MLP in interpret mode, layer 1 of a 2-layer stack."""
    rng = np.random.default_rng(100 + nbits + M)

    def stack(n, k):
        return _stack([jq.quantize(
            jnp.asarray(rng.normal(size=(n, k)).astype(np.float32) * 0.05),
            nbits=nbits, group_size=128, superblock=MLP_SB) for _ in range(2)])

    gu, dn = stack(2 * MLP_INTER, MLP_HID), stack(MLP_HID, MLP_INTER)
    x = jnp.asarray(rng.normal(size=(M, MLP_HID)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    kw = dict(nbits=nbits, group_size=128, gu_shape=(2 * MLP_INTER, MLP_HID),
              d_shape=(MLP_HID, MLP_INTER), superblock=MLP_SB)
    with pltpu.force_tpu_interpret_mode():
        want = jqm.quant_matmul_mlp_indexed(x, *gu, *dn, jnp.int32(1),
                                            out_dtype=jnp.float32, **kw)
    got = tqm.quant_matmul_mlp_indexed(to_tensor(np.asarray(x)), *_t(gu),
                                       *_t(dn), 1, out_dtype=torch.float32,
                                       **kw)
    _norm_close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# slot-batched decode

@pytest.fixture(scope="module")
def models():
    """tiny-llama quantized by the JAX package (2/3/4 cycled per layer,
    fused and container-merged), and the same model carried across."""
    cfg = get_config("tiny-llama")
    params = init_params(cfg, jax.random.PRNGKey(0))
    proxies = [quantize_model(params, cfg, b) for b in BITS]
    jm = _jax_model(cfg, proxies, layer_uniform_arch(cfg.num_layers), True)
    return cfg, t_get_config(cfg.name), jm, _port_model(jm)


@pytest.mark.parametrize("kernels", [False, True])
def test_decode_step_matches_jax(models, kernels):
    """One slot-batched decode step from the same cache state (three slots
    at lengths 3, 9 and 0, the last idle), float32: the JAX decode_step
    without kernels against the port's, with and without the kernel
    wrappers (which take their plain versions on the CPU)."""
    cfg, tcfg, jm, tm = models
    rng = np.random.default_rng(5)
    L, B, T = cfg.num_layers, 3, 16
    shape = (L, B, cfg.num_kv_heads, T, cfg.head_dim_)
    k = (rng.normal(size=shape) * 0.5).astype(np.float32)
    v = (rng.normal(size=shape) * 0.5).astype(np.float32)
    lengths = np.array([3, 9, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    active = np.array([True, True, False])
    want, jc = jb.decode_step(
        jm, cfg, jnp.asarray(tokens), jnp.asarray(active),
        jb.SlotCache(k=jnp.asarray(k), v=jnp.asarray(v),
                     lengths=jnp.asarray(lengths)),
        compute_dtype=jnp.float32, impl=None)
    tc = tb.SlotCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                      lengths=torch.from_numpy(lengths.copy()))
    from amq_tpu_torch.serving.engine import kernel_linear_impl
    got, tc = tb.decode_step(tm, tcfg, torch.from_numpy(tokens),
                             torch.from_numpy(active), tc,
                             compute_dtype=torch.float32,
                             impl=kernel_linear_impl if kernels else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.lengths.numpy(), [4, 10, 0])
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


def _greedy(tcfg, tm, prompt, n_new):
    eng = Engine(tm, tcfg, batch_size=1, max_len=64,
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 device="cpu")
    return eng.generate(prompt[None], max_new_tokens=n_new)[0].tolist()


def _slot_engine(tcfg, tm, **kw):
    kw.setdefault("prefill_buckets", (8, 16, 24, 32))
    return tb.SlotEngine(tm, tcfg, n_slots=2, max_len=64,
                         compute_dtype=torch.float32, device="cpu", **kw)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for u, n in enumerate(lens)}


@pytest.mark.parametrize("chunk_steps,chunk_len,native", [
    (1, None, True), (3, None, False), (1, 8, True), (3, 8, False)])
def test_slot_engine_matches_generate(models, chunk_steps, chunk_len, native):
    """Requests of staggered prompt lengths (two longer than the prefill
    chunk) through two slots: every request's tokens equal its own greedy
    Engine.generate, with and without decode chunks and chunked prefill;
    n_new = 7 retires slots in mid-chunk."""
    cfg, tcfg, _, tm = models
    prompts = _prompts(cfg, (5, 7, 21, 4, 13), seed=1)
    n_new = 7
    want = {u: _greedy(tcfg, tm, p, n_new) for u, p in prompts.items()}
    eng = _slot_engine(tcfg, tm, chunk_steps=chunk_steps,
                       prefill_chunk_len=chunk_len)
    batcher = ContinuousBatcher(n_slots=2, max_len=64, use_native=native)
    assert (batcher._native is not None) == native
    for u, p in prompts.items():
        batcher.submit(Request(uid=u, prompt=p, max_new_tokens=n_new))
    assert eng.run(batcher) == want
    assert not eng._prefilling


def test_slot_engine_requests_retiring_at_prefill(models):
    """max_new = 1 requests retire at prefill; with every slot empty and
    requests still queued, run() refills rather than exits."""
    cfg, tcfg, _, tm = models
    prompts = _prompts(cfg, (5, 5, 5, 5), seed=2)
    eng = _slot_engine(tcfg, tm)
    batcher = ContinuousBatcher(n_slots=2, max_len=64)
    for u, p in prompts.items():
        batcher.submit(Request(uid=u, prompt=p, max_new_tokens=1))
    assert eng.run(batcher) == {u: _greedy(tcfg, tm, p, 1)
                                for u, p in prompts.items()}


def _run_with_arrival(eng, batcher, at_call, req):
    """``eng.run`` with ``req`` submitted at the ``at_call``-th has_work
    call (mid-flight)."""
    calls = {"n": 0}
    has_work = batcher.has_work

    def hooked():
        calls["n"] += 1
        if calls["n"] == at_call:
            batcher.submit(req)
        return has_work()

    batcher.has_work = hooked
    return eng.run(batcher)


@pytest.mark.parametrize("native", [False, True])
def test_preempted_request_resumes_token_exact(models, native):
    """A high-priority arrival evicts a decoding request; re-prefilled from
    prompt + generated, the victim's tokens equal its uninterrupted greedy
    generation."""
    cfg, tcfg, _, tm = models
    prompts = _prompts(cfg, (5, 6, 4), seed=3)
    n_new = {0: 10, 1: 10, 2: 3}
    want = {u: _greedy(tcfg, tm, prompts[u], n_new[u]) for u in prompts}
    eng = _slot_engine(tcfg, tm)
    batcher = ContinuousBatcher(n_slots=2, max_len=64, use_native=native)
    for u in (0, 1):
        batcher.submit(Request(uid=u, prompt=prompts[u], max_new_tokens=n_new[u]))
    got = _run_with_arrival(eng, batcher, 3, Request(
        uid=2, prompt=prompts[2], max_new_tokens=n_new[2], priority=5))
    assert got == want


# ---------------------------------------------------------------------------
# the reference faults the port repairs

def _evict_mid_prefill(models, native):
    """Slot 0 decodes request 0; request 1 (21 tokens, chunks of 8) is in
    chunked prefill in slot 1 when a priority-5 request arrives and evicts
    it (the latest admission)."""
    cfg, tcfg, _, tm = models
    prompts = _prompts(cfg, (5, 21, 4), seed=4)
    n_new = {0: 9, 1: 5, 2: 4}
    want = {u: _greedy(tcfg, tm, prompts[u], n_new[u]) for u in prompts}
    eng = _slot_engine(tcfg, tm, prefill_chunk_len=8)
    batcher = ContinuousBatcher(n_slots=2, max_len=64, use_native=native)
    for u in (0, 1):
        batcher.submit(Request(uid=u, prompt=prompts[u], max_new_tokens=n_new[u]))
    try:
        got = _run_with_arrival(eng, batcher, 2, Request(
            uid=2, prompt=prompts[2], max_new_tokens=n_new[2], priority=5))
    except (AttributeError, TypeError):
        return False               # the reference's crash on a freed slot
    return got == want and not eng._prefilling


@pytest.mark.parametrize("native", [False, True])
def test_eviction_drops_chunked_prefill_state(models, native, monkeypatch):
    """ADVICE.md, batched.py:416: ``run()`` ignores what ``preempt()``
    returns, so a slot evicted mid-chunked-prefill keeps its
    ``_prefilling`` entry and the next chunks of the evicted prompt land in
    the slot's new request.  The port releases evicted slots; put back to
    ignoring them, the same run is no longer token-exact."""
    assert _evict_mid_prefill(models, native)
    monkeypatch.setattr(tb.SlotEngine, "release", lambda self, slot: None)
    assert not _evict_mid_prefill(models, native)


def _chunk_columns_exact(models):
    """Request 1's 21-token prompt prefills in chunks of 8 while request 0
    decodes in chunks of 3 steps."""
    cfg, tcfg, _, tm = models
    prompts = _prompts(cfg, (5, 21), seed=6)
    want = {u: _greedy(tcfg, tm, p, 8) for u, p in prompts.items()}
    eng = _slot_engine(tcfg, tm, chunk_steps=3, prefill_chunk_len=8)
    batcher = ContinuousBatcher(n_slots=2, max_len=64)
    for u, p in prompts.items():
        batcher.submit(Request(uid=u, prompt=p, max_new_tokens=8))
    return eng.run(batcher) == want


def test_chunk_columns_exclude_slots_mid_prefill(models, monkeypatch):
    """ADVICE.md, batched.py:455: from a decode chunk's second column the
    reference counts every occupied slot as decoding, so a slot
    mid-chunked-prefill collects the masked decode's garbage tokens.  The
    port keeps the exclusion; with the reference's occupied-only mask the
    run is no longer token-exact."""
    assert _chunk_columns_exact(models)
    monkeypatch.setattr(tb.SlotEngine, "_decoding", lambda self, b: np.array(
        [s is not None for s in b.slots]))
    assert not _chunk_columns_exact(models)


def test_chunk_window_holds_the_padded_chunk(models, monkeypatch):
    """ADVICE.md, batched.py:376: the reference sizes a chunk's window
    from ``off + n_new`` while the padded chunk writes C positions, and its
    clamped write then shifts the chunk onto earlier keys.  The port's
    window is ``min(off + C, max_len)`` and a chunk that does not fit its
    window raises instead of shifting.  Prompt 19 in chunks of 8: the last
    chunk writes positions 16-23 (the reference's window would end at 20)."""
    cfg, tcfg, _, tm = models
    prompt = _prompts(cfg, (19,), seed=7)[0]
    eng = _slot_engine(tcfg, tm, prefill_chunk_len=8)
    batcher = ContinuousBatcher(n_slots=2, max_len=64)
    batcher.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    assert eng.run(batcher) == {0: _greedy(tcfg, tm, prompt, 5)}

    windows = []
    real = tb.prefill_chunk

    def jax_window(model, cfg_, tokens, true_new, offset, cache, slot,
                   win_len, **kw):
        windows.append((offset, tokens.shape[1], win_len))
        return real(model, cfg_, tokens, true_new, offset, cache, slot,
                    win_len=min(eng._bucket(offset + true_new), 64), **kw)

    monkeypatch.setattr(tb, "prefill_chunk", jax_window)
    eng = _slot_engine(tcfg, tm, prefill_chunk_len=8,
                       prefill_buckets=(8, 16, 20, 32))
    batcher = ContinuousBatcher(n_slots=2, max_len=64)
    batcher.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    with pytest.raises(ValueError, match="does not fit the window"):
        eng.run(batcher)
    assert windows[-1] == (16, 8, 24)


def _sched_log(batcher, req_cls, submits, n_steps=40, preempt_at=None):
    """Scripted submissions ``{step: [(uid, max_new, priority, prompt_len)]}``
    through a batcher, stepped as tests/test_native.py steps it; returns
    the event log."""
    log = []
    for t in range(n_steps):
        for uid, max_new, pri, plen in submits.get(t, []):
            batcher.submit(req_cls(uid=uid, prompt=np.zeros(plen, np.int32),
                                   max_new_tokens=max_new, priority=pri))
        if preempt_at is None or t in preempt_at:
            for slot, req in batcher.preempt():
                log.append(("evict", t, slot, req.uid, len(req.generated)))
        for slot, req in batcher.fill_slots():
            log.append(("fill", t, slot, req.uid))
            fin = batcher.prefill_bookkeeping(slot, 100)
            if fin is not None:
                log.append(("done", t, fin.uid))
        active = [s is not None for s in batcher.slots]
        if any(active):
            for req in batcher.step_bookkeeping(np.arange(len(active))):
                log.append(("done", t, req.uid))
        if not batcher.has_work():
            break
    assert not batcher.has_work(), log
    return log


#: tests/test_native.py's scenarios: (submits, n_slots, budget, preempt_at)
SCENARIOS = {
    "fcfs": ({0: [(u, n, 0, 4) for u, n in enumerate([3, 1, 2, 4, 1, 2])]},
             2, 0, None),
    "priority": ({0: [(0, 6, 0, 4), (1, 2, 0, 4)],
                  1: [(2, 2, 5, 4), (3, 2, 5, 4)]}, 1, 0, ()),
    "budget": ({0: [(0, 4, 0, 32), (1, 4, 0, 32), (2, 4, 0, 32)]}, 3, 64,
               None),
    "preemption": ({0: [(0, 10, 0, 4), (1, 10, 0, 4)], 2: [(2, 2, 9, 4)]},
                   2, 0, None),
    "v2": ({0: [(0, 5, 0, 8), (1, 3, 1, 16), (2, 4, 0, 8)],
            1: [(3, 2, 7, 8)], 3: [(4, 1, 3, 32), (5, 6, 0, 8)]}, 2, 24,
           None),
}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_batcher_matches_jax_python_batcher(name, native):
    """The port's batcher (native C++ core and pure Python) makes the JAX
    Python batcher's decisions on tests/test_native.py's scenarios: every
    eviction there happens with all slots busy, where the preemption
    repair changes nothing."""
    submits, n_slots, budget, preempt_at = SCENARIOS[name]
    want = _sched_log(JBatcher(n_slots=n_slots, max_len=64, use_native=False,
                               prefill_budget=budget), JRequest, submits,
                      preempt_at=preempt_at)
    got = _sched_log(ContinuousBatcher(n_slots=n_slots, max_len=64,
                                       use_native=native,
                                       prefill_budget=budget), Request,
                     submits, preempt_at=preempt_at)
    assert got == want
    if name == "preemption":
        assert [e[3] for e in got if e[0] == "evict"] == [1]


@pytest.mark.parametrize("native", [False, True])
def test_preemption_waits_for_a_full_slot_set(native):
    """ADVICE.md, native/amq_native.cpp:223 (and engine.py's mirror): the
    reference evicts a running request for a higher-priority arrival even
    while a free slot could admit it.  The port evicts only for pending
    requests the free slots cannot take: here the arrival takes the free
    slot, and a second arrival, with the slots full, evicts."""
    submits = {0: [(0, 10, 0, 4)], 2: [(1, 6, 9, 4)], 4: [(2, 3, 9, 4)]}
    ref = _sched_log(JBatcher(n_slots=2, max_len=64, use_native=False),
                     JRequest, submits)
    assert ("evict", 2, 0, 0, 3) in ref          # the reference's needless one
    log = _sched_log(ContinuousBatcher(n_slots=2, max_len=64,
                                       use_native=native), Request, submits)
    assert ("fill", 2, 1, 1) in log
    assert [e for e in log if e[0] == "evict"] == [("evict", 4, 0, 0, 5)]
    assert {e[-1] for e in log if e[0] == "done"} == {0, 1, 2}


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A native library that does not build raises, in the scheduler and
    in a batcher that asks for it: no quiet fall back to the Python path
    (the JAX batcher swallows the failure, engine.py:197-202)."""
    from amq_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path",
                        lambda: tmp_path / "libamq_native_unbuilt.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.NativeScheduler(2)
    with pytest.raises(RuntimeError, match="failed"):
        ContinuousBatcher(n_slots=2, max_len=64, use_native=True)
    monkeypatch.setenv("AMQ_NATIVE_SCHED", "0")
    assert ContinuousBatcher(n_slots=2, max_len=64)._native is None


def test_native_pack_matches_port_bitpack():
    from amq_tpu_torch.core import bitpack
    from amq_tpu_torch.native import pack_native, unpack_native
    rng = np.random.default_rng(8)
    for nbits in (1, 2, 3, 4, 8):
        codes = rng.integers(0, 2**nbits, size=(256, 64)).astype(np.uint32)
        want = bitpack.pack(torch.from_numpy(codes.astype(np.int64)), nbits,
                            128).numpy().view(np.uint32)
        got = pack_native(codes, nbits, 128)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(unpack_native(got, nbits, 256), codes)
    assert pack_native(codes, 5) is None


# ---------------------------------------------------------------------------
# speculative decoding

@pytest.fixture(scope="module")
def dense():
    cfg = t_get_config("tiny-llama")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(params, cfg, batch_size=1, max_len=64,
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32)
    return cfg, params, eng, prompt, eng.generate(prompt, max_new_tokens=12)


def test_speculative_perfect_draft_accepts_everything(dense):
    _, params, eng, prompt, want = dense
    got, stats = SpeculativeEngine(eng, draft_params=params, gamma=3).generate(
        prompt, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)
    assert stats.acceptance_rate == pytest.approx(3.0)
    assert (stats.tokens, stats.rounds) == (12, 3)


def test_speculative_weak_draft_still_lossless(dense):
    cfg, params, eng, prompt, want = dense
    draft = t_quantize_model(params, cfg, 2)
    got, stats = SpeculativeEngine(eng, draft_params=draft, gamma=3).generate(
        prompt, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= stats.acceptance_rate < 3.0


def test_speculative_matches_jax():
    """The JAX SpeculativeEngine and the port's, float32, on the same dense
    target and 2-bit draft (carried across): the same tokens, rounds and
    accepted draft tokens."""
    from amq_tpu.serving import Engine as JEngine
    from amq_tpu.serving.speculative import SpeculativeEngine as JSpec
    from amq_tpu_torch.models import convert
    from test_torch_slice import flatten_params
    # two layers: the JAX side's compile dominates this test
    cfg = dataclasses.replace(get_config("tiny-llama"), num_layers=2)
    params = init_params(cfg, jax.random.PRNGKey(1))
    draft = quantize_model(params, cfg, 2)
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32)
    jeng = JEngine(params, cfg, batch_size=1, max_len=64,
                   compute_dtype=jnp.float32, use_pallas=False,
                   cache_dtype=jnp.float32)
    want, jstats = JSpec(jeng, draft_params=draft, gamma=3).generate(
        prompt, max_new_tokens=12)

    def port(p):
        return convert.params_from_flat(*flatten_params(p, cfg),
                                        num_layers=cfg.num_layers)

    tcfg = dataclasses.replace(t_get_config(cfg.name), num_layers=2)
    teng = Engine(port(params), tcfg, batch_size=1, max_len=64,
                  compute_dtype=torch.float32, cache_dtype=torch.float32,
                  device="cpu")
    got, stats = SpeculativeEngine(teng, draft_params=port(draft),
                                   gamma=3).generate(prompt, max_new_tokens=12)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.rounds, stats.accepted) == (jstats.rounds, jstats.accepted)
    assert stats.accepted < 3 * stats.rounds          # the draft does miss


# ---------------------------------------------------------------------------
# the speed CLI

def test_speed_cli_continuous_on_cpu(tmp_path):
    """``--modes CONTINUOUS --device cpu``: one untimed serving run at tiny
    size, its counts and no rate; the timed modes refuse the CPU."""
    import json
    from amq_tpu_torch.cli import speed_benchmark
    args = ["--synthetic", "--device", "cpu", "--n_slots", "2",
            "--n_requests", "3", "--prompt_len", "8", "--gen_len", "4",
            "--save_path", str(tmp_path)]
    out = speed_benchmark.main(args + ["--modes", "CONTINUOUS"])
    assert out["CONTINUOUS"] == {"requests": 3, "slots": 2, "chunk_steps": 8,
                                 "total_tokens": 12, "device": "cpu"}
    saved = json.load(open(tmp_path / "tiny-llama_speed.json"))
    assert saved["CONTINUOUS"]["total_tokens"] == 12
    with pytest.raises(RuntimeError, match="CUDA"):
        speed_benchmark.main(args + ["--modes", "TPS"])
