"""Speed measurement harness: the TPS, GEMV, GEMM and TTFT modes.

The port of ``benchmark_speed`` from the JAX package's
``serving/benchmark.py``.  Times are host clocks around work that ends in
``torch.cuda.synchronize()``; peak device memory is
``torch.cuda.max_memory_allocated``.  A measurement needs the card: on
any other device these functions raise.

* TPS  -- tokens/s of ``generate`` at prompt 64 -> gen 128, batch 1,
* GEMV -- per-decode-token latency of the decode loop,
* GEMM -- prefill forward latency over ``iters`` runs,
* TTFT -- prompt to first greedy token.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .engine import Engine


def _require_cuda(engine: Engine) -> None:
    if engine.device.type != "cuda":
        raise RuntimeError("speed measurements need the CUDA device; the "
                           f"engine runs on {engine.device}")


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
    _require_cuda(engine)
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

    if mode == "TTFT":
        # the cache is allocated outside the timed region
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
        engine._prefill(engine.params, toks, engine.new_cache())
        caches = [engine.new_cache() for _ in range(iters)]
        sync()
        t0 = time.perf_counter()
        for cache in caches:
            engine._prefill(engine.params, toks, cache)
        sync()
        ms = (time.perf_counter() - t0) / iters * 1e3
        return {"prefill_ms": ms}

    if mode == "GEMV":
        cache = engine.new_cache()
        last, cache = engine._prefill(engine.params, toks, cache)
        first = torch.argmax(last, dim=-1).to(torch.int32)
        engine._decode_n(engine.params, first, cache, n_steps=gen_len)
        sync()
        # decode appends past the live length only, so the warm-up left
        # `cache` (length = prompt) valid for a replay
        t0 = time.perf_counter()
        engine._decode_n(engine.params, first, cache, n_steps=gen_len)
        sync()
        per_tok = (time.perf_counter() - t0) / gen_len
        return {"decode_token_ms": per_tok * 1e3,
                "tokens_per_s": 1.0 / per_tok}

    raise ValueError(f"unknown mode {mode!r}")
