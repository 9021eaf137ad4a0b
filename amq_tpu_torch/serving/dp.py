"""Data-parallel continuous batching: slots sharded over ranks.

The port of the JAX package's ``serving/dp.py``: the slot axis of the
continuous-batching cache is split over the ranks of a process group and
the model is replicated.  Rank ``r`` owns the global slots
``[r * slots_per_rank, (r + 1) * slots_per_rank)`` in a local
:class:`~amq_tpu_torch.serving.batched.SlotEngine`.

* A decode chunk runs every rank's own slots with no collective inside
  it (each slot's logits are local); after the chunk the ranks'
  tokens are gathered, so every rank holds every slot's tokens.
* A prefill runs redundantly on every rank (the prompt is the same
  everywhere); only the owner commits the KV into its slot, the others
  run it into a one-slot scratch cache.  Every rank gets the same first
  token with no collective.

The JAX package drives all shards from one controller.  Here every rank
is a process and runs the same scheduler (``ContinuousBatcher``) on the
same request list: the borrowed ``SlotEngine.run`` loop makes the same
decisions everywhere because every input to them (prompts, tokens,
finished requests) is the same on every rank.  Every rank must
therefore submit the same requests in the same order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..models.config import ModelConfig
from ..parallel import comm
from .batched import SlotCache, SlotEngine, prefill_slot
from .graphs import GraphRunner


class DPSlotEngine:
    """Continuous batching with the slots split over ``group``'s ranks:
    the surface of :class:`~amq_tpu_torch.serving.batched.SlotEngine`
    (``prefill`` / ``step_chunk`` / ``run``) over ``n_slots =
    slots_per_rank * group size`` global slots.  Whole-prompt prefills
    only (no chunked prefill).  The decode step and the prefills hold no
    collective, so they run as captured graphs on the card on any
    backend."""

    prefill_chunk_len = None
    start_prefill = SlotEngine.start_prefill
    advance_prefills = SlotEngine.advance_prefills
    _decoding = SlotEngine._decoding
    step = SlotEngine.step
    run = SlotEngine.run

    def __init__(self, model, cfg: ModelConfig, group,
                 slots_per_rank: int = 1, max_len: int = 2048,
                 compute_dtype=torch.bfloat16, use_kernels: bool = True,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048),
                 chunk_steps: int = 1, device=None, graphs: bool = True):
        self.device = resolve_device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.slots_per_rank = slots_per_rank
        self.n_slots = slots_per_rank * self.world
        self.cfg, self.max_len = cfg, max_len
        self.chunk_steps = chunk_steps
        self.local = SlotEngine(
            model, cfg, n_slots=slots_per_rank, max_len=max_len,
            compute_dtype=compute_dtype, use_kernels=use_kernels,
            prefill_buckets=prefill_buckets, chunk_steps=chunk_steps,
            device=self.device, graphs=graphs)
        self._scratch: Optional[SlotCache] = None
        self._scratch_runner = GraphRunner(self.device, enabled=graphs)
        self.next_token = np.zeros(self.n_slots, np.int32)
        self._prefilling: dict = {}

    def _owner(self, slot: int):
        """(owning rank, local slot) of global ``slot``."""
        return divmod(slot, self.slots_per_rank)

    def prefill(self, slot: int, prompt: np.ndarray) -> None:
        owner, local = self._owner(slot)
        if owner == self.rank:
            self.local.prefill(local, prompt)
            self.next_token[slot] = self.local.next_token[local]
            return
        # the same forward into a scratch slot: the same first token
        # without a collective, and nothing committed here
        eng = self.local
        if self._scratch is None:
            self._scratch = SlotCache.create(
                self.cfg, 1, self.max_len, dtype=eng.compute_dtype,
                device=self.device)
        S = len(prompt)
        padded = np.zeros(eng._bucket(S), np.int32)
        padded[:S] = prompt
        nxt, _ = prefill_slot(
            eng.model, self.cfg, eng._tokens(padded)[None], S, self._scratch,
            0, compute_dtype=eng.compute_dtype, impl=eng.impl,
            runner=self._scratch_runner)
        self.next_token[slot] = int(nxt[0])

    def release(self, slot: int) -> None:
        owner, local = self._owner(slot)
        if owner == self.rank:
            self.local.release(local)

    def step_chunk(self, active_mask: np.ndarray, n_steps: int) -> np.ndarray:
        """``n_steps`` tokens for every global slot ``[n_slots, n_steps]``:
        this rank decodes its own slots, then the ranks' tokens are
        gathered."""
        lo = self.rank * self.slots_per_rank
        mine = np.asarray(active_mask[lo:lo + self.slots_per_rank])
        self.local.next_token = self.next_token[lo:lo + self.slots_per_rank]
        toks = torch.as_tensor(self.local.step_chunk(mine, n_steps),
                               device=self.device)
        out = torch.cat(comm.all_gather(toks, self.group)).cpu().numpy()
        self.next_token = np.where(active_mask, out[:, -1], self.next_token)
        return out
