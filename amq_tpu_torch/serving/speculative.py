"""Speculative (assisted) decoding, greedy, batch 1.

The port of the JAX package's ``serving/speculative.py``.  The draft
proposes ``gamma`` tokens autoregressively; the target scores all
``gamma + 1`` positions in ONE forward (for a weight-bound model about the
bytes of one decode step: the speed-up); the accepted prefix is the
longest match with the target's argmax chain, plus one corrected bonus
token, so the output equals the target's own greedy decoding whatever the
draft.

The JAX on-device ``while_loop`` becomes a Python loop over rounds; each
round reads one number back to the host (the accepted count).  The
accepted-count arithmetic and the cache rewind are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import llama
from ..models.config import ModelConfig
from .batched import _kernels, _model_forward


@dataclasses.dataclass
class SpecStats:
    tokens: int
    rounds: int
    accepted: int

    @property
    def acceptance_rate(self) -> float:
        """Draft tokens accepted per round (at most ``gamma``)."""
        return self.accepted / max(1, self.rounds)


@torch.inference_mode()
def speculative_decode(t_params, d_params, t_cfg: ModelConfig,
                       d_cfg: ModelConfig, first_token: torch.Tensor,
                       t_cache: llama.KVCache, d_cache: llama.KVCache,
                       gamma: int = 4, max_new: int = 128,
                       compute_dtype=torch.bfloat16, impl=None):
    """Greedy speculative generation after the prefills: ``first_token``
    [1] int32 is the target's prediction from its prefill.  Returns
    (tokens [1, max_new] int32, n_rounds, n_accepted_draft)."""
    dev = first_token.device
    out = torch.zeros((1, max_new), dtype=torch.int32, device=dev)
    tok = first_token
    n_out = rounds = accepted = 0
    steps = torch.arange(gamma + 1, device=dev)
    with _kernels(impl):
        while n_out < max_new and rounds < max_new:
            # draft: gamma + 1 autoregressive steps (the extra step makes
            # the draft consume d_gamma too, so its cache has no hole when
            # the whole draft block is accepted)
            drafts_all = []
            dtok = tok
            for _ in range(gamma + 1):
                logits, d_cache = _model_forward(d_params, d_cfg,
                                                 dtok[:, None].long(),
                                                 d_cache, compute_dtype)
                dtok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                drafts_all.append(dtok)
            drafts_all = torch.stack(drafts_all, dim=1)          # [1, g+1]
            drafts = drafts_all[:, :gamma]

            # target scores [tok, d_1..d_gamma] in one forward
            t_in = torch.cat([tok[:, None], drafts], dim=1).long()
            t_logits, t_cache = _model_forward(t_params, t_cfg, t_in,
                                               t_cache, compute_dtype)
            t_pred = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [1, g+1]

            # prefix-match acceptance: index of the first mismatch
            match = torch.cat([(drafts == t_pred[:, :gamma])[0],
                               torch.zeros(1, dtype=torch.bool, device=dev)])
            n_acc = int(torch.argmin(match.to(torch.int32)))
            # emitted this round: d_1..d_n_acc, then t_pred[n_acc]
            emit = torch.where(steps < n_acc, drafts_all[0], t_pred[0])
            n_emit = min(n_acc + 1, max_new - n_out)
            out[0, n_out:n_out + n_emit] = emit[:n_emit]

            # rewind both caches to the accepted frontier: both models
            # have consumed everything before the next input token
            new_len = t_cache.length - (gamma + 1) + n_acc + 1
            t_cache = llama.KVCache(k=t_cache.k, v=t_cache.v, length=new_len)
            d_cache = llama.KVCache(k=d_cache.k, v=d_cache.v, length=new_len)

            tok = emit[max(n_emit - 1, 0)][None]
            n_out += n_emit
            rounds += 1
            accepted += n_acc
    return out, rounds, accepted


class SpeculativeEngine:
    """Target engine (``serving.engine.Engine``) + draft parameters sharing
    its tokenizer (e.g. a mixed-bit target and its own 2-bit proxy)."""

    def __init__(self, target_engine, draft_params,
                 draft_cfg: Optional[ModelConfig] = None, gamma: int = 4):
        self.t = target_engine
        self.d_params = draft_params
        self.d_cfg = draft_cfg or target_engine.cfg
        self.gamma = gamma

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 128
                 ) -> Tuple[np.ndarray, SpecStats]:
        """Greedy generation; prompt [1, S] -> ([1, max_new_tokens], stats)."""
        eng = self.t
        if eng.batch_size != 1 or prompt.shape[0] != 1:
            raise ValueError("speculative decoding is batch-1")
        t_cache = eng.new_cache()
        d_cache = llama.KVCache.create(self.d_cfg, 1, eng.max_len,
                                       dtype=eng.cache_dtype,
                                       device=eng.device)
        toks = eng.tokens_to_device(prompt)
        last, t_cache = eng._prefill(eng.params, toks, t_cache)
        # the draft prefills the same prompt: both caches track the sequence
        with torch.inference_mode(), _kernels(eng._impl):
            _, d_cache = _model_forward(self.d_params, self.d_cfg, toks,
                                        d_cache, eng.compute_dtype)
        first = torch.argmax(last, dim=-1).to(torch.int32)
        out, rounds, accepted = speculative_decode(
            eng.params, self.d_params, eng.cfg, self.d_cfg, first, t_cache,
            d_cache, gamma=self.gamma, max_new=max_new_tokens - 1,
            compute_dtype=eng.compute_dtype, impl=eng._impl)
        tokens = torch.cat([first[:, None], out], dim=1).cpu().numpy()
        return tokens, SpecStats(tokens=max_new_tokens, rounds=rounds,
                                 accepted=accepted)
