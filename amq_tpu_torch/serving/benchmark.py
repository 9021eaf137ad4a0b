"""Speed measurement harness: the TPS, GEMV, GEMM and TTFT modes.

The port of ``benchmark_speed`` from the JAX package's
``serving/benchmark.py``.  Times are host clocks around work that ends in
``torch.cuda.synchronize()``; peak device memory is
``torch.cuda.max_memory_allocated``.  A measurement needs the card: on
any other device these functions raise.

* TPS  -- tokens/s of ``generate`` at prompt 64 -> gen 128, batch 1,
* GEMV -- per-decode-token latency of the decode loop,
* GEMM -- prefill forward latency over ``iters`` runs,
* TTFT -- prompt to first greedy token,

on the engine's captured CUDA graphs unless it was made with
``graphs=False`` (the eager loop);

and ``benchmark_continuous``: aggregate generated tokens/s of requests
streamed through a slot-batched engine (prefills and slot churn
included).  ``serve_continuous`` is the same serving run once, untimed:
what a CPU run of that mode can say (requests, tokens), no rate.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device, synchronize
from .engine import Engine


def _require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise RuntimeError("speed measurements need the CUDA device; the "
                           f"engine runs on {device}")


class PeakMemTracker:
    """Peak device memory of the serving loop (allocator high-water mark,
    reset when the tracker is made)."""

    def __init__(self, device):
        self.device = torch.device(device)
        torch.cuda.reset_peak_memory_stats(self.device)

    def result(self) -> tuple:
        return torch.cuda.max_memory_allocated(self.device) / 2**30, "peak"


def benchmark_speed(engine: Engine, mode: str = "TPS", prompt_len: int = 64,
                    gen_len: int = 128, iters: int = 20,
                    seed: int = 0) -> Dict[str, float]:
    _require_cuda(engine.device)
    cfg = engine.cfg
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size,
                          (engine.batch_size, prompt_len)).astype(np.int32)
    sync = torch.cuda.synchronize
    toks = engine.tokens_to_device(prompt)

    if mode == "TPS":
        engine.generate(prompt, max_new_tokens=gen_len)          # warm-up
        sync()
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=gen_len)
        sync()
        dt = time.perf_counter() - t0
        return {"tokens_per_s": gen_len * engine.batch_size / dt,
                "total_s": dt}

    # every timed call starts from an emptied (TTFT, GEMM) or restored
    # (GEMV) cache, and each mode's warm-up makes its graphs: the engine's
    # cache is one static buffer, its length advanced in place
    if mode == "TTFT":
        tok, _ = engine._prefill_token(engine.params, toks, engine.new_cache())
        tok.cpu()
        cache = engine.new_cache()
        sync()
        t0 = time.perf_counter()
        tok, cache = engine._prefill_token(engine.params, toks, cache)
        tok.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        return {"ttft_ms": ms}

    if mode == "GEMM":
        cache = engine.new_cache()
        engine._prefill(engine.params, toks, cache)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            cache.length.zero_()
            engine._prefill(engine.params, toks, cache)
        sync()
        ms = (time.perf_counter() - t0) / iters * 1e3
        return {"prefill_ms": ms}

    if mode == "GEMV":
        cache = engine.new_cache()
        first, cache = engine._prefill_token(engine.params, toks, cache)
        start = cache.length.clone()
        engine._decode_n(engine.params, first, cache, n_steps=gen_len)
        cache.length.copy_(start)
        sync()
        t0 = time.perf_counter()
        engine._decode_n(engine.params, first, cache, n_steps=gen_len)
        sync()
        per_tok = (time.perf_counter() - t0) / gen_len
        return {"decode_token_ms": per_tok * 1e3,
                "tokens_per_s": 1.0 / per_tok}

    raise ValueError(f"unknown mode {mode!r}")


def _continuous_engine(model, cfg, n_slots, prompt_len, max_len, use_kernels,
                       compute_dtype, chunk_steps, device, graphs=True):
    from .batched import SlotEngine
    return SlotEngine(model, cfg, n_slots=n_slots, max_len=max_len,
                      compute_dtype=compute_dtype or torch.bfloat16,
                      use_kernels=use_kernels, prefill_buckets=(prompt_len,),
                      chunk_steps=chunk_steps, device=device, graphs=graphs)


def _serve(eng, cfg, rng, n_requests, prompt_len, gen_len):
    """One ``SlotEngine.run`` over ``n_requests`` fresh prompts drawn from
    ``rng``; returns its results."""
    from .engine import ContinuousBatcher, Request
    b = ContinuousBatcher(n_slots=eng.n_slots, max_len=eng.max_len)
    for uid in range(n_requests):
        b.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, prompt_len).astype(np.int32),
            max_new_tokens=gen_len))
    return eng.run(b)


def benchmark_continuous(model, cfg, n_slots: int = 4, n_requests: int = 16,
                         prompt_len: int = 64, gen_len: int = 64,
                         max_len: int = 2048, use_kernels: bool = True,
                         compute_dtype=None, seed: int = 0,
                         chunk_steps: int = 8, device=None,
                         graphs: bool = True) -> Dict[str, float]:
    """Continuous-batching throughput: ``n_requests`` streamed through
    ``n_slots`` (native scheduler), one warm-up run (which makes the
    slot engine's graphs; ``graphs=False``: the eager loop), then a timed
    run; aggregate generated tokens/s of wall time, prefills and slot
    churn included.  Needs the card: a CPU device raises."""
    device = resolve_device(device)
    _require_cuda(device)
    rng = np.random.default_rng(seed)
    eng = _continuous_engine(model, cfg, n_slots, prompt_len, max_len,
                             use_kernels, compute_dtype, chunk_steps, device,
                             graphs)
    _serve(eng, cfg, rng, n_requests, prompt_len, gen_len)      # warm-up
    synchronize(device)
    t0 = time.perf_counter()
    results = _serve(eng, cfg, rng, n_requests, prompt_len, gen_len)
    synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    return {"requests": n_requests, "slots": n_slots,
            "chunk_steps": chunk_steps,
            "total_tokens": total, "total_s": dt,
            "tokens_per_s": total / dt, "graphs": eng.runner.stats()}


def serve_continuous(model, cfg, n_slots: int = 4, n_requests: int = 16,
                     prompt_len: int = 64, gen_len: int = 64,
                     max_len: int = 2048, use_kernels: bool = True,
                     compute_dtype=None, seed: int = 0,
                     chunk_steps: int = 8, device=None) -> Dict[str, object]:
    """The serving run of :func:`benchmark_continuous` once, untimed, on
    any device: what it counts (requests, generated tokens), no rate."""
    device = resolve_device(device)
    eng = _continuous_engine(model, cfg, n_slots, prompt_len, max_len,
                             use_kernels, compute_dtype, chunk_steps, device)
    results = _serve(eng, cfg, np.random.default_rng(seed), n_requests,
                     prompt_len, gen_len)
    return {"requests": n_requests, "slots": n_slots,
            "chunk_steps": chunk_steps,
            "total_tokens": sum(len(v) for v in results.values()),
            "device": str(device)}
