"""Slot-batched decoding: per-slot cache lengths for continuous batching.

The port of the JAX package's ``serving/batched.py``:

* :class:`SlotCache` -- KV buffers ``[L, B, kv, T, hd]`` + ``lengths [B]``
  (an int32 tensor on the cache's device),
* :func:`prefill_slot` -- run one right-padded prompt (batch 1) and copy
  its KV into a slot,
* :func:`prefill_chunk` -- advance one slot's prefill by a chunk,
* :func:`decode_step` -- one token for all slots: per-slot rope positions
  and attention through ``models.stacked.scan_layers`` with a per-row
  ``[B]`` offset (the JAX package writes the layer body a second time),
  then one per-slot append of the new keys at each slot's own length
  (a scatter with device-tensor indices: no host sync, no loop over
  slots); idle slots are masked no-ops,
* :func:`decode_chunk` -- ``n_steps`` of those,
* :class:`SlotEngine` -- ties them to ``ContinuousBatcher``.

The JAX ``jit``s become eager calls; the cache is updated in place (the
JAX functions donate it).  While kernels are active, S = 1 decode
attention takes the decode-attention kernel (the JAX package only at
T >= 1024 on its accelerator), and the decode step's linears and MLP take
whatever ``scan_layers`` routes them to (the pipelined GEMVs and the
one-launch MLP under the JAX package's ``AMQ_PIPE`` / ``AMQ_MLP_KERNEL``).

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


def _run_window(model, cfg, tokens, cache: SlotCache, slot: int, offset: int,
                win: int, compute_dtype, impl):
    """Run ``tokens`` [1, C] against the window ``[0, win)`` of ``slot``
    as an append-only cache at ``offset``, and copy the C new positions
    back into the slot.  Returns the logits [1, C, V]."""
    C = tokens.shape[1]
    tmp = llama.KVCache(
        k=cache.k[:, slot:slot + 1, :, :win].clone(),
        v=cache.v[:, slot:slot + 1, :, :win].clone(),
        length=torch.tensor(offset, dtype=torch.int32, device=cache.k.device))
    with _kernels(impl):
        logits, _ = _model_forward(model, cfg, tokens, tmp, compute_dtype)
    new = slice(offset, offset + C)
    cache.k[:, slot:slot + 1, :, new] = tmp.k[:, :, :, new]
    cache.v[:, slot:slot + 1, :, new] = tmp.v[:, :, :, new]
    return logits


@torch.inference_mode()
def prefill_slot(model, cfg: ModelConfig, tokens: torch.Tensor,
                 true_len: int, cache: SlotCache, slot: int,
                 compute_dtype=torch.bfloat16, impl=None):
    """Prefill one slot from a right-padded prompt ``tokens`` [1, S].

    Causality makes right-padding exact: real positions never attend the
    pad tail, the next token is read at ``true_len - 1``, and the slot
    length masks the pad KV entries out of later decode steps.  Returns
    (next token [1] int32 on the device, cache).
    """
    S = tokens.shape[1]
    if S > cache.k.shape[3]:
        raise ValueError(f"prompt bucket {S} exceeds the cache's "
                         f"{cache.k.shape[3]} positions")
    logits = _run_window(model, cfg, tokens, cache, slot, 0, S,
                         compute_dtype, impl)
    cache.lengths[slot] = true_len
    nxt = torch.argmax(logits[0, true_len - 1], dim=-1).to(torch.int32)
    return nxt[None], cache


@torch.inference_mode()
def prefill_chunk(model, cfg: ModelConfig, tokens: torch.Tensor,
                  true_new: int, offset: int, cache: SlotCache, slot: int,
                  win_len: int, compute_dtype=torch.bfloat16, impl=None):
    """Advance one slot's prefill by a chunk ``tokens`` [1, C] (right-
    padded; ``true_new`` >= 1 real tokens) at ``offset``, the slot's
    length so far.

    Chunked prefill: long prompts go in fixed-size chunks so the serving
    loop decodes the other slots between chunks.  The chunk attends the
    slot's window ``[0, win_len)``, which must hold the C positions the
    padded chunk writes (``offset + C <= win_len``; the JAX package sizes
    it from ``offset + true_new`` and its clamped write then overwrites
    earlier keys).  Pad positions past the new length are masked by the
    slot length and overwritten by the next chunk.

    Returns (next token [1], meaningful only on the final chunk; cache).
    """
    C = tokens.shape[1]
    if offset + C > win_len or win_len > cache.k.shape[3]:
        raise ValueError(f"chunk [{offset}, {offset + C}) does not fit the "
                         f"window {win_len} of a {cache.k.shape[3]}-long cache")
    logits = _run_window(model, cfg, tokens, cache, slot, offset, win_len,
                         compute_dtype, impl)
    cache.lengths[slot] = offset + true_new
    nxt = torch.argmax(logits[0, true_new - 1], dim=-1).to(torch.int32)
    return nxt[None], cache


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


@torch.inference_mode()
def decode_chunk(model: StackedModel, cfg: ModelConfig, tokens: torch.Tensor,
                 active: torch.Tensor, cache: SlotCache, n_steps: int,
                 compute_dtype=torch.bfloat16, impl=None):
    """``n_steps`` decode tokens per slot with no host read in between.
    Returns (tokens [B, n_steps] int32, cache)."""
    toks = torch.empty((tokens.shape[0], n_steps), dtype=torch.int32,
                       device=tokens.device)
    tok = tokens
    for s in range(n_steps):
        tok, cache = decode_step(model, cfg, tok, active, cache,
                                 compute_dtype, impl)
        toks[:, s] = tok
    return toks, cache


class SlotEngine:
    """Continuous-batching serving loop over a stacked model.

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path.  ``use_kernels=False``
    takes the dequantize-then-matmul path and the einsum attention.
    """

    def __init__(self, model, cfg: ModelConfig, n_slots: int = 4,
                 max_len: int = 2048, compute_dtype=torch.bfloat16,
                 use_kernels: bool = True,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048),
                 chunk_steps: int = 1,
                 prefill_chunk_len: Optional[int] = None,
                 device=None):
        from .engine import kernel_linear_impl
        self.device = resolve_device(device)
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
        padded = np.zeros(self._bucket(S), np.int32)
        padded[:S] = prompt          # right-pad (exact under causal masking)
        nxt, self.cache = prefill_slot(
            self.model, self.cfg, self._tokens(padded)[None], S, self.cache,
            slot, compute_dtype=self.compute_dtype, impl=self.impl)
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
            chunk = np.zeros(c_len, np.int32)
            chunk[:n_new] = prompt[off:off + n_new]
            nxt, self.cache = prefill_chunk(
                self.model, self.cfg, self._tokens(chunk)[None], n_new, off,
                self.cache, slot, win_len=off + c_len,
                compute_dtype=self.compute_dtype, impl=self.impl)
            off += n_new
            if off >= S:
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
        nxt, self.cache = decode_step(
            self.model, self.cfg, *self._step_inputs(active_mask), self.cache,
            compute_dtype=self.compute_dtype, impl=self.impl)
        out = nxt.cpu().numpy()
        self.next_token = np.where(active_mask, out, self.next_token)
        return out

    def step_chunk(self, active_mask: np.ndarray, n_steps: int) -> np.ndarray:
        toks, self.cache = decode_chunk(
            self.model, self.cfg, *self._step_inputs(active_mask), self.cache,
            n_steps=n_steps, compute_dtype=self.compute_dtype, impl=self.impl)
        out = toks.cpu().numpy()                                # [B, n_steps]
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
            # higher-priority pending requests may evict active slots; the
            # victims rejoin the queue and are re-prefilled on re-admission,
            # so whatever their slots held goes
            for slot, _ in batcher.preempt():
                self.release(slot)
            for slot, req in batcher.fill_slots():
                # resumed victims re-prefill prompt + tokens generated
                # before eviction
                toks = (np.concatenate(
                    [req.prompt, np.asarray(req.generated, np.int32)])
                    if req.generated else req.prompt)
                if self.start_prefill(slot, toks):
                    # the prefill's prediction is the first generated token
                    fin = batcher.prefill_bookkeeping(
                        slot, self.next_token[slot])
                    if fin is not None:
                        results[fin.uid] = fin.generated
            # in-flight chunked prefills advance ONE chunk per iteration;
            # slots still prefilling sit out this iteration's decode
            for slot in self.advance_prefills():
                fin = batcher.prefill_bookkeeping(slot,
                                                  self.next_token[slot])
                if fin is not None:
                    results[fin.uid] = fin.generated
            active = self._decoding(batcher)
            if not active.any():
                # every decodable slot retired at prefill (or is still
                # prefilling); queued requests may remain -- keep looping
                steps += 1
                continue
            if self.chunk_steps > 1:
                toks = self.step_chunk(active, self.chunk_steps)
                for j in range(toks.shape[1]):
                    for req in batcher.step_bookkeeping(
                            np.where(active, toks[:, j], -1)):
                        results[req.uid] = req.generated
                    # slots retired mid-chunk drop out of the remaining
                    # columns; slots mid-prefill never decoded in them
                    active = self._decoding(batcher)
                    if not active.any():
                        break
            else:
                toks = self.step(active)
                for req in batcher.step_bookkeeping(
                        np.where(active, toks, -1)):
                    results[req.uid] = req.generated
            steps += 1
        return results
