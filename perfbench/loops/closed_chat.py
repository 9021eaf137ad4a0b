"""Closed-loop chat clients against the port's continuous-batching loop.

Set-up: random packed weights from the seed (``perfbench.model``), one
``SlotEngine`` (the traffic file's slots, cache length, prefill buckets
and decode chunk, bf16), each prefill bucket and the decode chunk run
once so every graph is captured, then ``clients`` clients each send a
request and the loop runs until ``ramp_requests`` have completed, so the
slots no longer start together.  The window opens there: every
``SlotEngine.run(batcher, max_steps=1)`` iteration (fill, prefills, one
decode chunk) is one span, and a client whose reply completed sends its
next request at once (no think time).  The window closes at the end of
the first iteration that ends ``seconds`` after it opened.

Request sizes: blocks of ``block`` (prompt, output) pairs at fixed
quantiles of the two lognormals, each block in its own fixed order, the
same for every seed; the seed draws the token ids (uniform over the
vocab) and the weights.  In a closed loop with no think time the order
of sizes alone decides which replies end in the same decode chunk and so
which prefills queue behind each other: the schedule is a function of
token counts, not of time.  Seeds that ordered the same sizes
differently read a TTFT p95 of 48 against 64-69 ms, while two runs of
one seed agreed within 2 ms.

Times are host clocks (``time.perf_counter``): a request is sent when its
client submits it, its first token arrives when the prefill's token
reaches the host (the batcher's ``prefill_bookkeeping``), each later
token when its decode chunk's tokens do.  Every iteration reads its
tokens back, so no device work runs past an iteration's end.

Correctness: once the window has closed and the peak memory is read, the
engine is freed and ``perfbench.reference`` recomputes, for a sample of
the requests completed in the window (the longest among them, the rest
drawn from the seed, from as many slots as the sample has requests), the
float32 logits over prompt and served tokens; the widest gap by which a
served token's logit lies below the best one is held to the cell's
limit.  With ``control`` (calibration only) the control takes the
program's place in that comparison: the tokens it puts first on the same
prompts and served tokens are judged, so ``correct`` reads false;
``program_checks`` then holds the program's own reading.
"""

from __future__ import annotations

import gc
import math
import time
import types
from typing import Dict, List

import numpy as np
import torch

from perfbench import model, trace
from perfbench.reference import llama as reference


def request_sizes(tr: dict, n: int) -> List[tuple]:
    """``n`` (prompt, output) lengths: blocks of the same ``block`` pairs,
    each block in a fixed order of its own."""
    from statistics import NormalDist
    B = tr["block"]
    z = [NormalDist().inv_cdf((i + 0.5) / B) for i in range(B)]

    def lengths(spec):
        lo, hi = spec["clip"]
        return [int(min(hi, max(lo, round(spec["median"] * math.exp(spec["sigma"] * q)))))
                for q in z]

    prompts, outs = lengths(tr["prompt"]), lengths(tr["output"])
    # a fixed pairing of prompt and output quantiles, and fixed orders
    pair = np.random.default_rng(0).permutation(B)
    pairs = [(prompts[i], outs[pair[i]]) for i in range(B)]
    rng = np.random.default_rng(1)
    sizes = []
    while len(sizes) < n:
        sizes.extend(pairs[i] for i in rng.permutation(B))
    return sizes[:n]


def _batcher_class():
    from amq_tpu_torch.serving.engine import ContinuousBatcher

    class TimedBatcher(ContinuousBatcher):
        """The port's batcher, noting when each token reaches the host and
        which slot served each request."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first_t: Dict[int, float] = {}
            self.slot_of: Dict[int, int] = {}
            self.last_t: Dict[int, float] = {}

        def prefill_bookkeeping(self, slot, token):
            t = time.perf_counter()
            req = self.slots[slot]
            self.first_t.setdefault(req.uid, t)
            self.slot_of[req.uid] = slot
            self.last_t[req.uid] = t
            return super().prefill_bookkeeping(slot, token)

        def step_bookkeeping(self, tokens):
            t = time.perf_counter()
            for i, req in enumerate(self.slots):
                if req is not None and tokens[i] >= 0:
                    self.last_t[req.uid] = t
            return super().step_bookkeeping(tokens)

    return TimedBatcher


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False):
    """One run of a ``closed_chat`` cell; returns the record the metrics
    read (a namespace)."""
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.serving.batched import SlotEngine
    from amq_tpu_torch.serving.engine import Request
    conf, tr = cell["config_data"], cell["traffic_data"]
    shape, quant = conf["shape"], conf["quant"]
    cfg = get_config(conf["registry_name"])
    device = torch.device(device)
    dtype = getattr(torch, quant["compute_dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    net, weights = model.build(cfg, shape, quant, gen, device)
    n_slots, chunk = tr["slots"], tr["chunk_steps"]
    buckets = tuple(tr["prefill_buckets"])
    eng = SlotEngine(net, cfg, n_slots=n_slots, max_len=tr["max_len"],
                     compute_dtype=dtype, prefill_buckets=buckets,
                     chunk_steps=chunk, device=device)
    rng = np.random.default_rng([seed, 1])
    V = shape["vocab_size"]
    # capture every graph the traffic uses: each bucket, the decode chunk
    for b in buckets:
        eng.prefill(0, rng.integers(0, V, b).astype(np.int32))
    eng.step_chunk(np.ones(n_slots, bool), chunk)
    for s in range(n_slots):
        eng.release(s)

    batcher = _batcher_class()(n_slots=n_slots, max_len=tr["max_len"])
    sizes = iter(request_sizes(tr, tr["max_requests"]))
    live: Dict[int, object] = {}
    sent: Dict[int, float] = {}
    done: List[tuple] = []                 # (request, completion time)

    def send():
        uid = len(sent)
        p, o = next(sizes)
        req = Request(uid=uid, prompt=rng.integers(0, V, p).astype(np.int32),
                      max_new_tokens=o)
        sent[uid] = time.perf_counter()
        with trace.span("client_send"):
            batcher.submit(req)
        live[uid] = req

    def iterate():
        before = {u: len(r.generated) for u, r in live.items()}
        with trace.span("iteration"):
            finished = eng.run(batcher, max_steps=1)
        t1 = time.perf_counter()
        prefills, gains, keys = [], [], 0
        for u, r in list(live.items()):
            g, k0 = len(r.generated) - before[u], before[u]
            if k0 == 0 and g > 0:
                prefills.append(len(r.prompt))
                g, k0 = g - 1, 1
            gains.append(g)
            # decoded token k attends the prompt and tokens 0..k
            keys += g * (len(r.prompt) + k0) + g * (g - 1) // 2
        rows = [sum(g > j for g in gains) for j in range(max(gains, default=0))]
        for u in finished:
            done.append((live.pop(u), t1))
        for _ in finished:
            send()
        return dict(t1=t1, prefills=prefills, decode_rows=rows,
                    decode_keys=keys, tokens=sum(gains) + len(prefills))

    for _ in range(tr["clients"]):
        send()
    while len(done) < tr["ramp_requests"]:
        iterate()

    traced_slice = trace.Slice(traced, tr["trace_seconds"], seconds)
    setup_s = time.perf_counter() - t_start
    iters = []
    t_open = time.perf_counter()
    while True:
        active = traced_slice.active
        it = iterate()
        it["traced"] = active
        iters.append(it)
        if it["t1"] - t_open >= seconds:
            break
        traced_slice.step_ended(it["t1"] - t_open)
    t_close = iters[-1]["t1"]
    traced_slice.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    first_t, last_t = batcher.first_t, batcher.last_t
    completed = [r for r, t in done if t_open <= t <= t_close]
    bad = [r for r in completed
           if len(r.generated) != r.max_new_tokens
           or not all(0 <= t < V for t in r.generated)]
    ttft = [first_t[u] - sent[u] for u in first_t
            if t_open <= first_t[u] <= t_close]
    tpot = [(last_t[r.uid] - first_t[r.uid]) / (len(r.generated) - 1)
            for r in completed if len(r.generated) > 1]
    check_rng = np.random.default_rng([seed, 2])
    pool = sorted(completed, key=lambda r: -(len(r.prompt) + len(r.generated)))
    # the longest, then the rest in an order drawn from the seed, requests
    # of slots not yet in the sample first
    pick, later = pool[:1], []
    seen = {batcher.slot_of[r.uid] for r in pick}
    for i in check_rng.permutation(max(len(pool) - 1, 0)):
        r = pool[1 + i]
        (later if batcher.slot_of[r.uid] in seen else pick).append(r)
        seen.add(batcher.slot_of[r.uid])
    pick = (pick + later)[:tr["check_requests"]]
    sample = [dict(prompt=torch.as_tensor(r.prompt, device=device),
                   served=torch.as_tensor(np.asarray(r.generated, np.int64),
                                          device=device)) for r in pick]
    del eng, batcher, net, live, done
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limit = cell["checks"]["logit_gap"]

    def checks_of(ctl):
        j = (reference.judge(weights, shape, sample, control=ctl)
             if sample else {"logit_gap": math.inf, "tokens": 0})
        return {"logit_gap": {"value": j["logit_gap"], "limit": limit},
                "tokens_compared": {"value": j["tokens"],
                                    "limit": tr["check_tokens_min"]}}

    checks = checks_of(control)
    correct = (checks["logit_gap"]["value"] <= limit and not bad
               and checks["tokens_compared"]["value"] >= tr["check_tokens_min"])
    return types.SimpleNamespace(
        cell=cell, shape=shape, quant=quant, traffic=tr, correct=correct,
        attempted=len(completed), failed=len(bad), checks=checks,
        program_checks=checks_of(False) if control else checks,
        setup_s=setup_s,
        window_s=t_close - t_open, iterations=iters, ttft_s=ttft,
        tpot_s=tpot, memory_peak_bytes=peak,
        trace=traced_slice.summary(cell["root"]),
        n_slots=n_slots, buckets=buckets)
