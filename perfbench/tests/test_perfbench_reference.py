"""The plain reference against the port at a tiny size on the CPU, and the
check that decides ``correct`` against the faults a served cell can have.

The CPU runs the port's plain paths (the kernels run only on the card);
the cell's own comparison at full size runs in every chip run.  Tests
marked ``cuda`` run there: ``python3 -m pytest perfbench/tests -m cuda``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY_SHAPE, make_tiny_root, run_tiny
from perfbench import model
from perfbench.reference import llama as reference

QUANT = {"layer_bits_cycle": [2, 3, 4], "group_size": 128,
         "containers": {"3": 4}, "head_bits": 8, "logit_rms": 3.0}


def _tiny(seed=1, **shape):
    from amq_tpu_torch.models.config import get_config
    cfg = get_config("tiny-qwen2" if shape.get("qkv_bias") else "tiny-llama")
    s = dict(TINY_SHAPE, **shape)
    gen = torch.Generator().manual_seed(seed)
    net, weights = model.build(cfg, s, QUANT, gen, "cpu")
    return cfg, s, net, weights


def test_unpack_matches_port_packing():
    from amq_tpu_torch.core import bitpack
    g = torch.Generator().manual_seed(0)
    for nbits in (1, 2, 3, 4, 8):
        codes = torch.randint(0, 2**nbits, (1024, 40), generator=g)
        for block in (128, 256, 1024):
            words = bitpack.pack(codes, nbits, block)
            assert torch.equal(reference.unpack(words, nbits, block),
                               codes.to(torch.int32))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_reference_logits_match_port_forward(qkv_bias):
    from amq_tpu_torch.models.stacked import forward_stacked
    shape = {"qkv_bias": True, "intermediate_size": 384,
             "num_hidden_layers": 2, "rms_norm_eps": 1e-6} if qkv_bias else {}
    cfg, s, net, weights = _tiny(**shape)
    toks = torch.randint(0, s["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(2))
    port, _ = forward_stacked(net, cfg, toks, compute_dtype=torch.float32)
    ref = reference.logits_many(weights, s, [toks[0]])[0]
    scale = ref.abs().max()
    assert float((port[0] - ref).abs().max() / scale) < 1e-5


def test_reference_judges_slot_prefill_and_decode():
    """Slot prefill then decode through the cache (float32, plain paths):
    every served token is the reference's best, to rounding."""
    from amq_tpu_torch.serving.batched import SlotEngine
    cfg, s, net, weights = _tiny(seed=3)
    eng = SlotEngine(net, cfg, n_slots=2, max_len=128,
                     compute_dtype=torch.float32, prefill_buckets=(32, 64),
                     device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, s["vocab_size"], n).astype(np.int32)
               for n in (20, 45)]
    for slot, p in enumerate(prompts):
        eng.prefill(slot, p)
    first = eng.next_token.copy()
    toks = eng.step_chunk(np.ones(2, bool), 12)
    reqs = [dict(prompt=torch.as_tensor(p),
                 served=torch.as_tensor(np.concatenate([[first[i]], toks[i]])))
            for i, p in enumerate(prompts)]
    out = reference.judge(weights, s, reqs)
    assert out["tokens"] == 26
    assert out["logit_gap"] < 1e-3


def test_sound_run_is_correct(tiny_root):
    run = run_tiny(tiny_root, 2**31 + 77)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert run.checks["tokens_compared"]["value"] >= 10


def _alter_tokens(self, active, n):
    out = _ORIG(self, active, n)
    return (out + 1) % self.cfg.vocab_size


def _state_unchanged(self, active, n):
    lengths = self.cache.lengths.clone()
    out = _ORIG(self, active, n)
    self.cache.lengths.copy_(lengths)
    return out


def _half_batch(self, active, n):
    """Only the first half of the slots decodes; the rest hand back their
    last token again, as if computed, and advance."""
    half = active.copy()
    half[len(half) // 2:] = False
    last = self.next_token.copy()
    out = _ORIG(self, half, n)
    skipped = active & ~half
    out[skipped] = last[skipped, None]
    self.next_token[skipped] = last[skipped]
    self.cache.lengths.add_(torch.as_tensor(skipped, dtype=torch.int32) * n)
    return out


_ORIG = None


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_batch"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    global _ORIG
    from amq_tpu_torch.serving.batched import SlotEngine
    _ORIG = SlotEngine.step_chunk
    monkeypatch.setattr(SlotEngine, "step_chunk", fault)
    # a longer window, so the sample holds requests of several slots even
    # on a loaded CPU
    run = run_tiny(tiny_root, 2**31 + 78, seconds=1.5)
    assert not run.correct, run.checks


def test_control_is_not_correct(tmp_path):
    """The control (every linear in float8 e4m3) in the program's place:
    the tokens it puts first on the same served prompts fail the tiny
    cell's comparison, which the program's own tokens pass."""
    root = make_tiny_root(tmp_path)
    run = run_tiny(root, 2**31 + 79, control=True)
    assert not run.correct, run.checks
    gap = run.checks["logit_gap"]
    assert gap["value"] > gap["limit"]
    assert run.program_checks["logit_gap"]["value"] <= gap["limit"]


@pytest.mark.cuda
def test_cuda_chat_cell_is_correct():
    """The first Mistral cell, one short window on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    from perfbench import bench
    cell = bench.cell("mistral7b.chat_c8")
    loop = bench.module(bench.ROOT, "loops", "closed_chat")
    run = loop.run(cell, 2**31 + 5, 6.0, False, "cuda", time.perf_counter())
    assert run.correct, run.checks


def test_reference_jsd_matches_port_metric():
    from amq_tpu_torch.evaluation import metrics
    from perfbench.reference import jsd
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(2, 40, 300, generator=g) * 3
    want = float(metrics.jsd_shifted_per_sample(a[None], b[None])[0])
    assert jsd.sample_jsd(a, b, chunk=7) == pytest.approx(want, rel=1e-5)


def test_sound_eval_run_is_correct(tiny_root):
    run = run_tiny(tiny_root, 2**31 + 80, name="tiny.eval")
    assert run.correct, run.checks
    assert run.attempted >= 2 and run.failed == 0


def _eval_faults():
    from amq_tpu_torch.evaluation.evaluator import Evaluator
    orig_many, orig_batches = Evaluator.eval_many, Evaluator.loss_batches

    def loss_altered(self, archs):
        return [({k: v * 1.01 for k, v in d.items()}, bits)
                for d, bits in orig_many(self, archs)]

    def half_batch(self, name):
        # each batch's loss counts half its rows: the mean over the rest
        return [(b, max(1, n // 2), start)
                for b, n, start in orig_batches(self, name)]

    def arch_unchanged(self, arch, method="hqq"):
        return self.switch_params

    return {"loss_altered": ("eval_many", loss_altered),
            "half_batch": ("loss_batches", half_batch),
            "state_unchanged": ("sample", arch_unchanged)}


@pytest.mark.parametrize("fault", ["loss_altered", "half_batch",
                                   "state_unchanged"])
def test_broken_eval_path_is_not_correct(tiny_root, monkeypatch, fault):
    from amq_tpu_torch.evaluation.evaluator import Evaluator
    attr, fn = _eval_faults()[fault]
    monkeypatch.setattr(Evaluator, attr, fn)
    run = run_tiny(tiny_root, 2**31 + 81, name="tiny.eval")
    assert not run.correct, run.checks


def test_eval_control_is_not_correct(tmp_path):
    root = make_tiny_root(tmp_path, compute_dtype="bfloat16", eval_limit=3e-3)
    run = run_tiny(root, 2**31 + 82, control=True, name="tiny.eval")
    assert not run.correct, run.checks
    gap = run.checks["loss_rel_gap"]
    assert gap["value"] > gap["limit"]
    assert run.program_checks["loss_rel_gap"]["value"] <= gap["limit"]


@pytest.mark.cuda
def test_cuda_search_cell_is_correct():
    """The search-evaluation cell, one short window on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    from perfbench import bench
    cell = bench.cell("qwen25_7b.search_eval")
    loop = bench.module(bench.ROOT, "loops", "search_eval")
    run = loop.run(cell, 2**31 + 6, 3.0, False, "cuda", time.perf_counter())
    assert run.correct, run.checks
