"""Serving engine: prefill and greedy decode over a packed mixed-bit model.

The port of ``Engine`` from the JAX package's ``serving/engine.py``.  The
JAX engine runs prefill as one jitted call and decode as an on-device
``lax.scan``; here, on the card, the prefill is one captured CUDA graph
per (B, S) and decode replays one captured decode step ``n_steps`` times
with no host work in between (``serving.graphs``).  The step is in place:
it reads a static token buffer, writes its argmax back into it and into
the output row at a device step counter, and advances the cache length
in place.  The engine owns one static cache, on every device:
``new_cache()`` returns it emptied.  On the CPU (``device="cpu"``) and
on the card's eager loop (``graphs=False``) the same bodies run as one
eager call per step.  The KV cache is read-only inside the layer loop;
each step's keys and values are appended once, after all layers, in
place into the cache's buffers (``forward_stacked``).

Continuous batching: :class:`Request` and :class:`ContinuousBatcher`, the
host-side slot scheduler (native C++ core or pure Python) that
``serving.batched.SlotEngine`` drives.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.linear import QuantLinear, kernel_linears
from ..models.stacked import StackedModel, forward_stacked
from ..ops.quant_matmul import quant_matmul
from ..parallel import comm
from .graphs import GraphRunner


def kernel_linear_impl(p: QuantLinear, x: torch.Tensor, compute_dtype):
    """QuantLinear application through the dequant-matmul kernel."""
    y = quant_matmul(x.contiguous(), p.qt, out_dtype=compute_dtype)
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


@dataclasses.dataclass
class Engine:
    """Single-stream serving engine over a stacked or per-layer model.

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` to run the plain PyTorch path.  ``use_kernels=False``
    takes the dequantize-then-matmul path and the einsum attention
    everywhere.  On the card the prefill and the decode step are captured
    CUDA graphs; ``graphs=False`` runs the same bodies eagerly there (the
    eager loop beside the graph, for comparisons).  A graph captures this
    engine's ``params`` and its one cache (``new_cache()``): the serving
    methods take no others, on any device.

    ``forward_fn`` ``(params, tokens, cache) -> (logits, cache)`` replaces
    the forward and ``cache_factory`` makes the one cache (the JAX
    package's two overrides): the tensor-parallel engine
    (``parallel.tp_stacked.make_tp_engine``) runs its sharded forward on a
    rank-local cache through the same prefill and decode bodies.
    ``group`` is the process group that forward's collectives use: a
    captured graph can hold NCCL collectives only, so ``graphs=True`` on
    a group of another backend raises (pass ``graphs=False``).
    """

    params: Any
    cfg: ModelConfig
    batch_size: int = 1
    max_len: int = 2048
    compute_dtype: Any = torch.bfloat16
    use_kernels: bool = True
    cache_dtype: Any = torch.bfloat16
    device: Optional[Any] = None
    graphs: bool = True
    forward_fn: Optional[Callable] = None
    cache_factory: Optional[Callable[[], llama.KVCache]] = None
    group: Optional[Any] = None

    def __post_init__(self):
        if self.group is not None and self.graphs and \
                comm.backend(self.group) != "nccl":
            raise ValueError(
                f"a captured CUDA graph cannot hold {comm.backend(self.group)}"
                " collectives: pass graphs=False (the eager loop) or use an "
                "NCCL group")
        self.device = resolve_device(self.device)
        self._impl = kernel_linear_impl if self.use_kernels else None
        self.runner = GraphRunner(self.device, enabled=self.graphs)
        self._cache: Optional[llama.KVCache] = None

    def new_cache(self) -> llama.KVCache:
        """The engine's one cache, emptied: its length zeroed in place
        (positions past the length are masked, so the buffers are not
        cleared)."""
        if self._cache is None:
            with torch.inference_mode(False):
                self._cache = (
                    self.cache_factory() if self.cache_factory is not None
                    else llama.KVCache.create(
                        self.cfg, self.batch_size, self.max_len,
                        dtype=self.cache_dtype, device=self.device))
        self._cache.length.zero_()
        return self._cache

    def _own(self, params, cache: llama.KVCache) -> None:
        """Refuse params or a cache other than the engine's own (a graph
        replays on the ones it captured)."""
        if params is not self.params or cache is not self._cache:
            raise ValueError("the engine serves its own params and its own "
                             "cache (new_cache())")

    def _key(self, *key) -> tuple:
        return key + (self.max_len, self.compute_dtype, self.cache_dtype,
                      self.use_kernels)

    def _forward(self, params, tokens, cache):
        with kernel_linears(self._impl), \
                llama.forward_kernels(self.use_kernels):
            if self.forward_fn is not None:
                return self.forward_fn(params, tokens, cache)
            if isinstance(params, StackedModel):
                return forward_stacked(params, self.cfg, tokens, cache=cache,
                                       compute_dtype=self.compute_dtype)
            return llama.forward(params, self.cfg, tokens, cache=cache,
                                 compute_dtype=self.compute_dtype)

    def prefill_step(self, params, tokens: torch.Tensor,
                     cache: llama.KVCache, last: torch.Tensor,
                     tok: torch.Tensor) -> None:
        """The prefill body: ``tokens`` [B, S] into ``cache`` (its length
        advanced in place), the last position's logits into ``last`` [B, V]
        and their argmax into ``tok`` [B]."""
        logits, new = self._forward(params, tokens, cache)
        cache.length.copy_(new.length)
        last.copy_(logits[:, -1, :])
        tok.copy_(torch.argmax(last, dim=-1))

    def decode_step(self, params, cache: llama.KVCache, tok: torch.Tensor,
                    toks: torch.Tensor, step: torch.Tensor) -> None:
        """The decode body, in place: reads ``tok`` [B] (int32), writes its
        greedy successor back into ``tok`` and into ``toks[:, step]``,
        advances ``step`` [1] and the cache length."""
        logits, new = self._forward(params, tok[:, None], cache)
        cache.length.copy_(new.length)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        toks.index_copy_(1, step, nxt[:, None])
        tok.copy_(nxt)
        step.add_(1)

    @torch.inference_mode()
    def _prefill_both(self, params, tokens: torch.Tensor,
                      cache: llama.KVCache):
        self._own(params, cache)
        B, S = tokens.shape
        buf = self.runner.buffers(
            ("prefill", B, S), tokens=((B, S), torch.int64),
            last=((B, self.cfg.vocab_size), torch.float32),
            tok=((B,), torch.int32))
        buf.tokens.copy_(tokens)
        self.runner.run(
            self._key("prefill", B, S),
            lambda: self.prefill_step(params, buf.tokens, cache, buf.last,
                                      buf.tok),
            state=(cache.length, buf.last, buf.tok))
        return buf.last.clone(), buf.tok.clone(), cache

    def _prefill(self, params, tokens: torch.Tensor, cache: llama.KVCache):
        """Last-position logits [B, V] and the filled cache."""
        last, _, cache = self._prefill_both(params, tokens, cache)
        return last, cache

    def _prefill_token(self, params, tokens: torch.Tensor,
                       cache: llama.KVCache):
        """Prefill and greedy first token [B] (int32, on the device)."""
        _, tok, cache = self._prefill_both(params, tokens, cache)
        return tok, cache

    @torch.inference_mode()
    def _decode_n(self, params, first_token: torch.Tensor,
                  cache: llama.KVCache, n_steps: int):
        """Greedy-decode ``n_steps`` tokens -> ([B, n_steps] int32, cache):
        ``n_steps`` replays of one decode step (eager calls off the
        graphs); the cache length advances in place."""
        self._own(params, cache)
        B = first_token.shape[0]
        if n_steps > self.max_len:
            raise ValueError(f"{n_steps} decode steps exceed the cache's "
                             f"{self.max_len} positions")
        buf = self.runner.buffers(
            ("decode", B, self.max_len), tok=((B,), torch.int32),
            toks=((B, self.max_len), torch.int32), step=((1,), torch.int64))
        buf.tok.copy_(first_token)
        buf.step.zero_()
        self.runner.run(
            self._key("decode", B),
            lambda: self.decode_step(params, cache, buf.tok, buf.toks,
                                     buf.step),
            state=(cache.length, buf.tok, buf.toks, buf.step), times=n_steps)
        return buf.toks[:, :n_steps].clone(), cache

    def tokens_to_device(self, prompt_tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64,
                               device=self.device)

    def generate(self, prompt_tokens: np.ndarray,
                 max_new_tokens: int = 128) -> np.ndarray:
        """Greedy generation; prompt [B, S] -> [B, max_new_tokens]."""
        B, S = prompt_tokens.shape
        assert B == self.batch_size, (B, self.batch_size)
        cache = self.new_cache()
        first, cache = self._prefill_token(
            self.params, self.tokens_to_device(prompt_tokens), cache)
        rest, _ = self._decode_n(self.params, first, cache,
                                 n_steps=max_new_tokens - 1)
        out = torch.cat([first[:, None], rest], dim=1)
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# continuous batching

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0           # higher = served first (0 = default class)
    _seq: int = -1              # submission order (set by the batcher)


class ContinuousBatcher:
    """Slot-based continuous batching scheduler (host code: numpy and Python).

    The port of ``ContinuousBatcher`` from the JAX package's
    ``serving/engine.py``.  Sequences occupy fixed KV-cache slots; every
    engine step decodes one token for all active slots, finished slots are
    refilled from the queue.  Scheduling policy:

    * priority classes -- the queue is served (priority desc, FCFS within
      a class),
    * chunked-prefill admission -- each ``fill_slots`` call admits
      requests only while their summed prompt tokens stay within
      ``prefill_budget`` (0 = uncapped; one admission always allowed),
    * preemption -- ``preempt()`` evicts lower-priority active slots for a
      strictly-higher-priority pending request that no free slot can take
      (the JAX package evicts even while a free slot could admit it); the
      victims re-enter the queue with their generated tokens and are
      re-prefilled (prompt + generated) on re-admission.

    Slot lifecycle runs on the native C++ scheduler (``native.py``) unless
    ``use_native=False`` or ``AMQ_NATIVE_SCHED=0`` asks for the
    pure-Python path; a native library that fails to build or load raises.
    """

    def __init__(self, n_slots: int, max_len: int,
                 use_native: Optional[bool] = None,
                 prefill_budget: int = 0):
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_budget = prefill_budget
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * n_slots
        self._by_uid: Dict[int, Request] = {}
        self._next_seq = 0
        if use_native is None:
            use_native = os.environ.get("AMQ_NATIVE_SCHED", "1") == "1"
        self._native = None
        if use_native:
            from ..native import NativeScheduler
            self._native = NativeScheduler(n_slots)

    def _enqueue_ordered(self, req: Request) -> None:
        # insert before the first request served after req
        i = 0
        while i < len(self.queue) and (
                self.queue[i].priority > req.priority
                or (self.queue[i].priority == req.priority
                    and self.queue[i]._seq < req._seq)):
            i += 1
        self.queue.insert(i, req)

    def submit(self, req: Request) -> None:
        if req.uid < 0:
            # the native core uses uid < 0 as its free-slot sentinel; the
            # pure-Python path keeps the same contract
            raise ValueError(f"request uid must be >= 0, got {req.uid}")
        req._seq = self._next_seq
        self._next_seq += 1
        if self._native is not None:
            self._native.submit(req.uid, req.max_new_tokens,
                                priority=req.priority,
                                prompt_len=len(req.prompt))
            self._by_uid[req.uid] = req
        else:
            self._enqueue_ordered(req)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_work(self) -> bool:
        if self._native is not None:
            return self._native.pending > 0 or self._native.active > 0
        return bool(self.queue) or self.active > 0

    def fill_slots(self) -> List[Tuple[int, Request]]:
        filled = []
        if self._native is not None:
            for i, uid in self._native.fill(self.prefill_budget):
                req = self._by_uid.pop(uid)
                self.slots[i] = req
                filled.append((i, req))
            return filled
        spent = 0
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                head = self.queue[0]
                if (self.prefill_budget > 0 and filled
                        and spent + len(head.prompt) > self.prefill_budget):
                    break
                spent += len(head.prompt)
                req = self.queue.pop(0)
                self.slots[i] = req
                filled.append((i, req))
        return filled

    def preempt(self) -> List[Tuple[int, Request]]:
        """Evict active slots outprioritized by pending requests that the
        free slots cannot absorb; the victims rejoin the queue (tokens
        kept).  Returns ``[(slot, victim)]``."""
        evicted: List[Tuple[int, Request]] = []
        if self._native is not None:
            for slot, uid, _gen in self._native.preempt():
                req = self.slots[slot]
                self.slots[slot] = None
                self._by_uid[uid] = req
                evicted.append((slot, req))
            return evicted
        # the first `free` pending requests take the free slots at the
        # next fill: only those beyond them need a victim
        qi = self.n_slots - self.active
        while qi < len(self.queue):
            want = self.queue[qi].priority
            victim = -1
            for i, r in enumerate(self.slots):
                if r is None or r.priority >= want:
                    continue
                if (victim < 0
                        or r.priority < self.slots[victim].priority
                        or (r.priority == self.slots[victim].priority
                            and r._seq > self.slots[victim]._seq)):
                    victim = i
            if victim < 0:
                break
            req = self.slots[victim]
            self.slots[victim] = None
            self._enqueue_ordered(req)
            evicted.append((victim, req))
            qi += 1
        return evicted

    def prefill_bookkeeping(self, slot: int, token) -> Optional[Request]:
        """Record the prefill's first generated token; the request retires
        here iff max_new_tokens == 1.  Returns the retired request."""
        req = self.slots[slot]
        req.generated.append(int(token))
        if self._native is not None:
            done = self._native.prefill(slot)
        else:
            done = len(req.generated) >= req.max_new_tokens
        if done:
            req.done = True
            self.slots[slot] = None
            return req
        return None

    def step_bookkeeping(self, tokens: np.ndarray) -> List[Request]:
        """Record one decoded token per slot; retire finished requests.

        ``tokens[i] < 0`` marks a slot that did not decode this step
        (idle, or occupied but mid-chunked-prefill) -- skipped entirely.
        """
        finished = []
        decoded = np.asarray(tokens) >= 0
        if self._native is not None:
            for i, req in enumerate(self.slots):
                if req is not None and decoded[i]:
                    req.generated.append(int(tokens[i]))
            for i in self._native.step(mask=decoded):
                req = self.slots[i]
                req.done = True
                self.slots[i] = None
                finished.append(req)
            return finished
        for i, req in enumerate(self.slots):
            if req is None or not decoded[i]:
                continue
            req.generated.append(int(tokens[i]))
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.slots[i] = None
                finished.append(req)
        return finished
