"""Slot-batched decoding: per-slot cache lengths for continuous batching.

The port of the JAX package's ``serving/batched.py``:

* :class:`SlotCache` -- KV buffers ``[L, B, kv, T, hd]`` + ``lengths [B]``
  (an int32 tensor on the cache's device),
* :func:`prefill_slot` -- run one right-padded prompt (batch 1) and copy
  its KV into a slot,
* :func:`prefill_chunk` -- advance one slot's prefill by a chunk,
* :func:`prefill_window` -- the body of both: slot, offset and true
  length are device tensors (the JAX functions trace them), the window is
  gathered with ``index_select`` and written back with ``index_copy_``,
* :func:`decode_step` -- one token for all slots: per-slot rope positions
  and attention through ``models.stacked.scan_layers`` with a per-row
  ``[B]`` offset (the JAX package writes the layer body a second time),
  then one per-slot append of the new keys at each slot's own length
  (a scatter with device-tensor indices: no host sync, no loop over
  slots); idle slots are masked no-ops,
* :func:`decode_chunk` -- ``n_steps`` of those, each through
  :func:`slot_decode_step`, the in-place body that reads and writes a
  static token buffer,
* :class:`SlotEngine` -- ties them to ``ContinuousBatcher``.

The JAX ``jit``s become captured CUDA graphs on the card
(``serving.graphs``): one decode step, replayed ``n_steps`` times per
chunk, and one slot prefill per (bucket or chunk length, window), with
the slot and lengths in static device buffers; the cache is one
persistent object updated in place (the JAX functions donate it).  On the
CPU the same bodies run eagerly.  While kernels are active, S = 1 decode
attention takes the decode-attention kernel (the JAX package only at
T >= 1024 on its accelerator), and the decode step's linears and MLP take
whatever ``scan_layers`` routes them to (the pipelined GEMVs and the
one-launch MLP under the JAX package's ``AMQ_PIPE`` / ``AMQ_MLP_KERNEL``).

While a ``torch.profiler`` profile runs, :class:`SlotEngine` records into
``utils.profiling.TRACER``: a ``serve.step`` span per pass of ``run``'s
loop holding ``serve.preempt``, ``serve.fill``, ``serve.prefill`` (one
per admitted request, its uid) and ``serve.decode`` (one chunk); inside
them ``serve.inputs`` (host-to-device copies), ``serve.launch``
(``GraphRunner``, one per replay), ``serve.readback`` (the blocking
token reads) and ``serve.bookkeeping`` (the batcher's, with the uid for
a first token); and the counters ``serve.prefill_rows`` /
``serve.prefill_tokens`` (rows computed, real prompt tokens) and
``serve.decode_slot_steps`` / ``serve.decode_tokens`` (slots x steps
computed, tokens that reached a request).

Three faults of the JAX ``SlotEngine`` are not copied: ``run`` drops a
preempted slot's chunked-prefill state, the per-column active mask of a
decode chunk keeps excluding slots mid-prefill, and a prefill chunk's
window covers the C positions a padded chunk writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.linear import kernel_linears
from ..models.stacked import (StackedModel, apply_head, forward_stacked,
                              scan_layers)
from ..utils.profiling import TRACER
from .graphs import GraphRunner


@dataclasses.dataclass
class SlotCache:
    k: torch.Tensor        # [L, B, kv, T, hd]
    v: torch.Tensor
    lengths: torch.Tensor  # [B] int32

    @classmethod
    def create(cls, cfg: ModelConfig, n_slots: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> "SlotCache":
        shape = (cfg.num_layers, n_slots, cfg.num_kv_heads, max_len,
                 cfg.head_dim_)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((n_slots,), dtype=torch.int32,
                                       device=device))


@contextlib.contextmanager
def _kernels(impl):
    """Route the linears through ``impl`` and attention through its
    kernels while ``impl`` is set (``None``: the plain paths)."""
    with kernel_linears(impl), llama.forward_kernels(impl is not None):
        yield


def _model_forward(model, cfg, tokens, cache, compute_dtype):
    if isinstance(model, StackedModel):
        return forward_stacked(model, cfg, tokens, cache=cache,
                               compute_dtype=compute_dtype)
    return llama.forward(model, cfg, tokens, cache=cache,
                         compute_dtype=compute_dtype)


def _fill(buf: torch.Tensor, x) -> None:
    """Write ``x`` (a host int or a tensor) into the static [1] ``buf``."""
    if isinstance(x, torch.Tensor):
        buf.copy_(x.reshape(1))
    else:
        buf.fill_(x)


def prefill_window(model, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: SlotCache, slot: torch.Tensor, offset: torch.Tensor,
                   n_new: torch.Tensor, win: int, compute_dtype, impl):
    """The slot prefills' body.  ``tokens`` [1, C] (right-padded, ``n_new``
    real tokens) run against the window ``[0, win)`` of ``slot`` as an
    append-only cache at ``offset``; the window goes back into the slot
    and the slot's length becomes ``offset + n_new``.  ``slot``,
    ``offset`` and ``n_new`` are [1] device tensors, so one capture serves
    every slot and length.  Returns the next token [1] int32, read at
    chunk position ``n_new - 1``."""
    slot = slot.long()
    tmp = llama.KVCache(k=cache.k[:, :, :, :win].index_select(1, slot),
                        v=cache.v[:, :, :, :win].index_select(1, slot),
                        length=offset.reshape(()).to(torch.int32))
    with _kernels(impl):
        logits, _ = _model_forward(model, cfg, tokens, tmp, compute_dtype)
    # the forward wrote only the C new positions of the window; the rest
    # goes back unchanged (the JAX functions paste the whole window too)
    cache.k[:, :, :, :win].index_copy_(1, slot, tmp.k)
    cache.v[:, :, :, :win].index_copy_(1, slot, tmp.v)
    cache.lengths.index_copy_(0, slot, (offset + n_new).to(torch.int32))
    row = logits[0].index_select(0, (n_new - 1).long())
    return torch.argmax(row, dim=-1).to(torch.int32)


def _slot_prefill(model, cfg, tokens, cache, slot, offset, n_new, win,
                  compute_dtype, impl, runner):
    runner = runner or GraphRunner(cache.k.device, enabled=False)
    C = tokens.shape[1]
    buf = runner.buffers(("slot_prefill", C), tokens=((1, C), torch.int64),
                         slot=((1,), torch.int64),
                         offset=((1,), torch.int32),
                         n_new=((1,), torch.int32), nxt=((1,), torch.int32))
    with TRACER.span("serve.inputs"):
        buf.tokens.copy_(tokens)
        for name, x in (("slot", slot), ("offset", offset), ("n_new", n_new)):
            _fill(getattr(buf, name), x)
    runner.run(("slot_prefill", C, win, compute_dtype, impl is not None),
               lambda: buf.nxt.copy_(prefill_window(
                   model, cfg, buf.tokens, cache, buf.slot, buf.offset,
                   buf.n_new, win, compute_dtype, impl)),
               state=(cache.lengths, buf.nxt), binds=(model, cache))
    return buf.nxt.clone(), cache


@torch.inference_mode()
def prefill_slot(model, cfg: ModelConfig, tokens: torch.Tensor,
                 true_len, cache: SlotCache, slot,
                 compute_dtype=torch.bfloat16, impl=None,
                 runner: Optional[GraphRunner] = None):
    """Prefill one slot from a right-padded prompt ``tokens`` [1, S].

    Causality makes right-padding exact: real positions never attend the
    pad tail, the next token is read at ``true_len - 1``, and the slot
    length masks the pad KV entries out of later decode steps.
    ``true_len`` and ``slot`` are host ints or device tensors; with a
    ``runner`` the call is its graph per S.  Returns (next token [1]
    int32 on the device, cache).
    """
    S = tokens.shape[1]
    if S > cache.k.shape[3]:
        raise ValueError(f"prompt bucket {S} exceeds the cache's "
                         f"{cache.k.shape[3]} positions")
    return _slot_prefill(model, cfg, tokens, cache, slot, 0, true_len, S,
                         compute_dtype, impl, runner)


@torch.inference_mode()
def prefill_chunk(model, cfg: ModelConfig, tokens: torch.Tensor,
                  true_new, offset, cache: SlotCache, slot,
                  win_len: int, compute_dtype=torch.bfloat16, impl=None,
                  runner: Optional[GraphRunner] = None):
    """Advance one slot's prefill by a chunk ``tokens`` [1, C] (right-
    padded; ``true_new`` >= 1 real tokens) at ``offset``, the slot's
    length so far.

    Chunked prefill: long prompts go in fixed-size chunks so the serving
    loop decodes the other slots between chunks.  The chunk attends the
    slot's window ``[0, win_len)``, which must hold the C positions the
    padded chunk writes (``offset + C <= win_len``, checked for a host
    ``offset``; the JAX package sizes it from ``offset + true_new`` and
    its clamped write then overwrites earlier keys).  Pad positions past
    the new length are masked by the slot length and overwritten by the
    next chunk.  ``true_new``, ``offset`` and ``slot`` are host ints or
    device tensors; with a ``runner`` the call is its graph per (C,
    ``win_len``).

    Returns (next token [1], meaningful only on the final chunk; cache).
    """
    C = tokens.shape[1]
    if ((not isinstance(offset, torch.Tensor) and offset + C > win_len)
            or win_len > cache.k.shape[3]):
        raise ValueError(f"chunk [{offset}, {offset + C}) does not fit the "
                         f"window {win_len} of a {cache.k.shape[3]}-long cache")
    return _slot_prefill(model, cfg, tokens, cache, slot, offset, true_new,
                         win_len, compute_dtype, impl, runner)


@torch.inference_mode()
def decode_step(model: StackedModel, cfg: ModelConfig, tokens: torch.Tensor,
                active: torch.Tensor, cache: SlotCache,
                compute_dtype=torch.bfloat16, impl=None):
    """One decode token for every slot: ``tokens`` [B] int32 (one per
    slot), ``active`` [B] bool.  Returns (next [B] int32, cache); only
    active slots advance their length."""
    L, B, kv, T, hd = cache.k.shape
    x = model.embed[tokens.long()][:, None, :].to(compute_dtype)  # [B, 1, H]
    with _kernels(impl):
        x, (k_app, v_app) = scan_layers(
            model, cfg, x, cache_kv=(cache.k, cache.v), offset=cache.lengths,
            compute_dtype=compute_dtype)
        x = llama.rms_norm(x, model.final_norm, cfg.rms_norm_eps)
        logits = apply_head(model, x[:, 0], compute_dtype)
    # one per-slot append of the new keys [L, B, kv, 1, hd] at each slot's
    # own position (clamped inside the buffer, as the JAX update is)
    pos = cache.lengths.clamp(max=T - 1).long().view(1, B, 1, 1, 1)
    idx = pos.expand(L, B, kv, 1, hd)
    cache.k.scatter_(3, idx, k_app)
    cache.v.scatter_(3, idx, v_app)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    cache.lengths.add_(active.to(torch.int32))
    return nxt, cache


def slot_decode_step(model: StackedModel, cfg: ModelConfig,
                     tokens: torch.Tensor, active: torch.Tensor,
                     cache: SlotCache, toks: torch.Tensor,
                     step: torch.Tensor, compute_dtype, impl) -> None:
    """The body :func:`decode_chunk` replays: one :func:`decode_step`
    reading ``tokens`` [B] int32, its tokens written back into ``tokens``
    and into ``toks[:, step]``; ``step`` [1] advances."""
    nxt, _ = decode_step(model, cfg, tokens, active, cache, compute_dtype,
                         impl)
    toks.index_copy_(1, step, nxt[:, None])
    tokens.copy_(nxt)
    step.add_(1)


@torch.inference_mode()
def decode_chunk(model: StackedModel, cfg: ModelConfig, tokens: torch.Tensor,
                 active: torch.Tensor, cache: SlotCache, n_steps: int,
                 compute_dtype=torch.bfloat16, impl=None,
                 runner: Optional[GraphRunner] = None):
    """``n_steps`` decode tokens per slot with no host read in between:
    ``n_steps`` calls of :func:`slot_decode_step` (with a ``runner``,
    replays of its one graph).  Returns (tokens [B, n_steps] int32,
    cache)."""
    B, T = tokens.shape[0], cache.k.shape[3]
    if n_steps > T:
        raise ValueError(f"{n_steps} decode steps exceed the cache's {T} "
                         "positions")
    runner = runner or GraphRunner(tokens.device, enabled=False)
    buf = runner.buffers(
        ("slot_decode", B, T), tokens=((B,), torch.int32),
        active=((B,), torch.bool), toks=((B, T), torch.int32),
        step=((1,), torch.int64))
    with TRACER.span("serve.inputs"):
        buf.tokens.copy_(tokens)
        buf.active.copy_(active)
        buf.step.zero_()
    runner.run(("slot_decode", B, T, compute_dtype, impl is not None),
               lambda: slot_decode_step(model, cfg, buf.tokens, buf.active,
                                        cache, buf.toks, buf.step,
                                        compute_dtype, impl),
               state=(cache.lengths, buf.tokens, buf.toks, buf.step),
               times=n_steps, binds=(model, cache))
    return buf.toks[:, :n_steps].clone(), cache


class SlotEngine:
    """Continuous-batching serving loop over a stacked model.

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path.  ``use_kernels=False``
    takes the dequantize-then-matmul path and the einsum attention.  The
    scheduler's bookkeeping stays on the host; each prefill and decode
    chunk reads its tokens back once.
    """

    def __init__(self, model, cfg: ModelConfig, n_slots: int = 4,
                 max_len: int = 2048, compute_dtype=torch.bfloat16,
                 use_kernels: bool = True,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048),
                 chunk_steps: int = 1,
                 prefill_chunk_len: Optional[int] = None,
                 device=None, graphs: bool = True):
        from .engine import kernel_linear_impl
        self.device = resolve_device(device)
        #: on the card the decode step and the slot prefills are captured
        #: CUDA graphs; ``graphs=False`` runs them eagerly there
        self.runner = GraphRunner(self.device, enabled=graphs)
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.impl = kernel_linear_impl if use_kernels else None
        self.buckets = tuple(sorted(prefill_buckets))
        self.chunk_steps = chunk_steps
        #: chunked prefill: prompts longer than this are prefilled
        #: ``prefill_chunk_len`` tokens at a time, one chunk per serving
        #: iteration, so active slots keep decoding between chunks
        #: (None = whole-prompt prefill in one call)
        self.prefill_chunk_len = prefill_chunk_len
        self.cache = SlotCache.create(cfg, n_slots, max_len,
                                      dtype=compute_dtype, device=self.device)
        self.next_token = np.zeros(n_slots, np.int32)
        # slot -> (prompt, done_len) of in-flight chunked prefills; such
        # slots sit out decode until complete
        self._prefilling: Dict[int, tuple] = {}

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    def _bucket(self, S: int) -> int:
        for b in self.buckets:
            if S <= b:
                return b
        raise ValueError(f"prompt too long: {S} > {self.buckets[-1]}")

    def prefill(self, slot: int, prompt: np.ndarray) -> None:
        S = len(prompt)
        bucket = self._bucket(S)
        TRACER.count("serve.prefill_rows", bucket)
        TRACER.count("serve.prefill_tokens", S)
        padded = np.zeros(bucket, np.int32)
        padded[:S] = prompt          # right-pad (exact under causal masking)
        with TRACER.span("serve.inputs"):
            tokens = self._tokens(padded)[None]
        nxt, self.cache = prefill_slot(
            self.model, self.cfg, tokens, S, self.cache,
            slot, compute_dtype=self.compute_dtype, impl=self.impl,
            runner=self.runner)
        # the prefill's one blocking read: the device is empty after it
        with TRACER.span("serve.readback"):
            self.next_token[slot] = int(nxt[0])

    def start_prefill(self, slot: int, prompt: np.ndarray) -> bool:
        """Begin a slot's prefill.  Returns True when it completed now
        (whole-prompt path or short prompt); False when the prompt exceeds
        ``prefill_chunk_len`` and advances chunk by chunk through
        :meth:`advance_prefills` while other slots keep decoding."""
        C = self.prefill_chunk_len
        if C is None or len(prompt) <= C:
            self.prefill(slot, prompt)
            return True
        self.cache.lengths[slot] = 0      # chunks append from offset 0
        self._prefilling[slot] = (np.asarray(prompt, np.int32), 0)
        return False

    def release(self, slot: int) -> None:
        """Forget a slot's state (its request was evicted): an in-flight
        chunked prefill stops and the slot's length returns to 0."""
        self._prefilling.pop(slot, None)
        self.cache.lengths[slot] = 0

    def advance_prefills(self) -> List[int]:
        """Advance every in-flight chunked prefill by ONE chunk; returns
        the slots whose prefill completed this call (their first
        generated token is in ``next_token``)."""
        C = self.prefill_chunk_len
        done = []
        for slot in list(self._prefilling):
            prompt, off = self._prefilling[slot]
            S = len(prompt)
            n_new = min(C, S - off)
            # the padded chunk writes all its positions: the window holds
            # them (a chunk past the cache's end is cut to fit)
            c_len = min(C, self.max_len - off)
            TRACER.count("serve.prefill_rows", c_len)
            TRACER.count("serve.prefill_tokens", n_new)
            chunk = np.zeros(c_len, np.int32)
            chunk[:n_new] = prompt[off:off + n_new]
            with TRACER.span("serve.inputs"):
                tokens = self._tokens(chunk)[None]
            nxt, self.cache = prefill_chunk(
                self.model, self.cfg, tokens, n_new, off,
                self.cache, slot, win_len=off + c_len,
                compute_dtype=self.compute_dtype, impl=self.impl,
                runner=self.runner)
            off += n_new
            if off >= S:
                with TRACER.span("serve.readback"):
                    self.next_token[slot] = int(nxt[0])
                del self._prefilling[slot]
                done.append(slot)
            else:
                self._prefilling[slot] = (prompt, off)
        return done

    def _step_inputs(self, active_mask: np.ndarray):
        """(next tokens [B] int32, active [B] bool) on the device."""
        return (torch.as_tensor(self.next_token, device=self.device),
                torch.as_tensor(active_mask, device=self.device))

    def step(self, active_mask: np.ndarray) -> np.ndarray:
        return self.step_chunk(active_mask, 1)[:, 0]

    def step_chunk(self, active_mask: np.ndarray, n_steps: int) -> np.ndarray:
        # every slot is computed at every step, active or not
        TRACER.count("serve.decode_slot_steps", self.n_slots * n_steps)
        with TRACER.span("serve.inputs"):
            inputs = self._step_inputs(active_mask)
        toks, self.cache = decode_chunk(
            self.model, self.cfg, *inputs, self.cache,
            n_steps=n_steps, compute_dtype=self.compute_dtype, impl=self.impl,
            runner=self.runner)
        with TRACER.span("serve.readback"):
            out = toks.cpu().numpy()                            # [B, n_steps]
        self.next_token = np.where(active_mask, out[:, -1], self.next_token)
        return out

    def _decoding(self, batcher) -> np.ndarray:
        """Slots that decode this step: occupied and not mid-prefill."""
        return np.array([s is not None and i not in self._prefilling
                         for i, s in enumerate(batcher.slots)])

    def run(self, batcher, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive requests from a ContinuousBatcher to completion."""
        results: Dict[int, List[int]] = {}
        steps = 0
        while batcher.has_work() and steps < max_steps:
            with TRACER.span("serve.step"):
                self._iteration(batcher, results)
            steps += 1
        return results

    def _iteration(self, batcher, results: Dict[int, List[int]]) -> None:
        """One pass of :meth:`run`'s loop: preemption, admission and
        prefills, one chunk of each chunked prefill, one decode chunk."""
        # higher-priority pending requests may evict active slots; the
        # victims rejoin the queue and are re-prefilled on re-admission,
        # so whatever their slots held goes
        with TRACER.span("serve.preempt"):
            for slot, _ in batcher.preempt():
                self.release(slot)
        with TRACER.span("serve.fill"):
            filled = batcher.fill_slots()
        for slot, req in filled:
            TRACER.end("serve.queued", req.uid)
            with TRACER.span("serve.prefill", req.uid):
                # resumed victims re-prefill prompt + tokens generated
                # before eviction
                toks = (np.concatenate(
                    [req.prompt, np.asarray(req.generated, np.int32)])
                    if req.generated else req.prompt)
                if self.start_prefill(slot, toks):
                    self._first_token(batcher, slot, results)
        # in-flight chunked prefills advance ONE chunk per iteration;
        # slots still prefilling sit out this iteration's decode
        for slot in self.advance_prefills():
            self._first_token(batcher, slot, results)
        active = self._decoding(batcher)
        if not active.any():
            # every decodable slot retired at prefill (or is still
            # prefilling); queued requests may remain -- keep looping
            return
        with TRACER.span("serve.decode"):
            if self.chunk_steps > 1:
                toks = self.step_chunk(active, self.chunk_steps)
                for j in range(toks.shape[1]):
                    self._step_bookkeeping(batcher, active, toks[:, j],
                                           results)
                    # slots retired mid-chunk drop out of the remaining
                    # columns; slots mid-prefill never decoded in them
                    active = self._decoding(batcher)
                    if not active.any():
                        break
            else:
                self._step_bookkeeping(batcher, active, self.step(active),
                                       results)

    def _first_token(self, batcher, slot: int,
                     results: Dict[int, List[int]]) -> None:
        """The completed prefill's prediction is the slot's request's
        first generated token."""
        with TRACER.span("serve.bookkeeping", batcher.slots[slot].uid):
            fin = batcher.prefill_bookkeeping(slot, self.next_token[slot])
        if fin is not None:
            results[fin.uid] = fin.generated

    def _step_bookkeeping(self, batcher, active: np.ndarray,
                          toks: np.ndarray,
                          results: Dict[int, List[int]]) -> None:
        """One decode step's tokens ``toks`` [B] to the active slots'
        requests."""
        if TRACER.on:
            TRACER.count("serve.decode_tokens", int(active.sum()))
        with TRACER.span("serve.bookkeeping"):
            for req in batcher.step_bookkeeping(np.where(active, toks, -1)):
                results[req.uid] = req.generated
