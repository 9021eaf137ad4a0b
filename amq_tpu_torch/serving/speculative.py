"""Speculative (assisted) decoding, greedy, batch 1.

The port of the JAX package's ``serving/speculative.py``.  The draft
proposes ``gamma`` tokens autoregressively; the target scores all
``gamma + 1`` positions in ONE forward (for a weight-bound model about the
bytes of one decode step: the speed-up); the accepted prefix is the
longest match with the target's argmax chain, plus one corrected bonus
token, so the output equals the target's own greedy decoding whatever the
draft.

The JAX on-device ``while_loop`` becomes a host loop over one round
body (:func:`speculative_round`, a captured CUDA graph on the card): the
gamma + 1 draft steps, the target's verify forward and the acceptance,
with every count a device scalar and both caches' lengths rewound in
place.  After each round the host reads one flag, the ``while_loop``'s
``cond``.  The accepted-count arithmetic, the full-width masked output
write and the cache rewind are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import llama
from ..models.config import ModelConfig
from .batched import _kernels, _model_forward
from .graphs import GraphRunner


@dataclasses.dataclass
class SpecStats:
    tokens: int
    rounds: int
    accepted: int

    @property
    def acceptance_rate(self) -> float:
        """Draft tokens accepted per round (at most ``gamma``)."""
        return self.accepted / max(1, self.rounds)


def speculative_round(t_params, d_params, t_cfg: ModelConfig,
                      d_cfg: ModelConfig, t_cache: llama.KVCache,
                      d_cache: llama.KVCache, st, gamma: int,
                      compute_dtype, impl) -> None:
    """One speculation round in place on the device state ``st``: ``tok``
    [1] int32 (the next input token), ``out`` [1, W] int32, the [1]
    int64 ``max_new``, ``n_out``, ``rounds`` and ``accepted``, and ``go``
    [1] int32 (the loop's condition for the next round).  Both caches'
    lengths are rewound in place to the accepted frontier."""
    dev = st.tok.device
    with _kernels(impl):
        # draft: gamma + 1 autoregressive steps (the extra step makes the
        # draft consume d_gamma too, so its cache has no hole when the
        # whole draft block is accepted)
        drafts_all = []
        dtok = st.tok
        for _ in range(gamma + 1):
            logits, new = _model_forward(d_params, d_cfg, dtok[:, None].long(),
                                         d_cache, compute_dtype)
            d_cache.length.copy_(new.length)
            dtok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            drafts_all.append(dtok)
        drafts_all = torch.stack(drafts_all, dim=1)              # [1, g+1]
        drafts = drafts_all[:, :gamma]

        # target scores [tok, d_1..d_gamma] in one forward
        t_in = torch.cat([st.tok[:, None], drafts], dim=1).long()
        t_logits, new = _model_forward(t_params, t_cfg, t_in, t_cache,
                                       compute_dtype)
        t_pred = torch.argmax(t_logits, dim=-1).to(torch.int32)  # [1, g+1]

    # prefix-match acceptance: index of the first mismatch
    match = torch.cat([(drafts == t_pred[:, :gamma])[0],
                       torch.zeros(1, dtype=torch.bool, device=dev)])
    n_acc = torch.argmin(match.to(torch.int32)).reshape(1)
    # emitted this round: d_1..d_n_acc, then t_pred[n_acc]
    steps = torch.arange(gamma + 1, device=dev)
    emit = torch.where(steps < n_acc, drafts_all[0], t_pred[0])  # [g+1]
    n_emit = torch.minimum(n_acc + 1, st.max_new - st.n_out)

    # full-width masked write (a clipped scatter would hit duplicate
    # indices at the buffer tail and lose the final token)
    rel = torch.arange(st.out.shape[1], device=dev) - st.n_out
    vals = emit.index_select(0, rel.clamp(0, gamma))
    write = (rel >= 0) & (rel < n_emit)
    st.out.copy_(torch.where(write[None, :], vals[None, :], st.out))

    # rewind both caches to the accepted frontier: both models have
    # consumed everything before the next input token
    new_len = new.length - (gamma + 1) + n_acc[0] + 1
    t_cache.length.copy_(new_len)
    d_cache.length.copy_(new_len)

    st.tok.copy_(emit.index_select(0, (n_emit - 1).clamp(min=0)))
    st.n_out.add_(n_emit)
    st.rounds.add_(1)
    st.accepted.add_(n_acc)
    st.go.copy_((st.n_out < st.max_new) & (st.rounds < st.max_new))


@torch.inference_mode()
def speculative_decode(t_params, d_params, t_cfg: ModelConfig,
                       d_cfg: ModelConfig, first_token: torch.Tensor,
                       t_cache: llama.KVCache, d_cache: llama.KVCache,
                       gamma: int = 4, max_new: int = 128,
                       compute_dtype=torch.bfloat16, impl=None,
                       runner: Optional[GraphRunner] = None):
    """Greedy speculative generation after the prefills: ``first_token``
    [1] int32 is the target's prediction from its prefill.  Rounds of
    :func:`speculative_round` (with a ``runner``, replays of its graph
    for this gamma and cache width) while the device flag says so; the
    caches' lengths advance in place.  Returns (tokens [1, max_new] int32,
    n_rounds, n_accepted_draft)."""
    W = t_cache.k.shape[3]
    if max_new > W:
        raise ValueError(f"{max_new} tokens exceed the cache's {W} positions")
    runner = runner or GraphRunner(first_token.device, enabled=False)
    st = runner.buffers(("spec", W), tok=((1,), torch.int32),
                        out=((1, W), torch.int32), go=((1,), torch.int32),
                        **{name: ((1,), torch.int64) for name in (
                            "max_new", "n_out", "rounds", "accepted")})
    st.tok.copy_(first_token.reshape(1))
    st.out.zero_()
    for name in ("n_out", "rounds", "accepted"):
        getattr(st, name).zero_()
    st.max_new.fill_(max_new)
    go = max_new > 0
    while go:
        runner.run(("spec_round", gamma, W, compute_dtype, impl is not None),
                   lambda: speculative_round(
                       t_params, d_params, t_cfg, d_cfg, t_cache, d_cache, st,
                       gamma, compute_dtype, impl),
                   state=(t_cache.length, d_cache.length, st.tok, st.out,
                          st.n_out, st.rounds, st.accepted, st.go),
                   binds=(t_params, d_params, t_cache, d_cache))
        go = bool(st.go)            # the while_loop's cond: 4 bytes a round
    return (st.out[:, :max_new].clone(), int(st.rounds[0]),
            int(st.accepted[0]))


class SpeculativeEngine:
    """Target engine (``serving.engine.Engine``) + draft parameters sharing
    its tokenizer (e.g. a mixed-bit target and its own 2-bit proxy).  On
    the card the draft's prefill and the rounds are captured CUDA graphs
    (the target engine's ``graphs`` setting), over the target engine's
    static cache and a static draft cache of the same length."""

    def __init__(self, target_engine, draft_params,
                 draft_cfg: Optional[ModelConfig] = None, gamma: int = 4):
        self.t = target_engine
        self.d_params = draft_params
        self.d_cfg = draft_cfg or target_engine.cfg
        self.gamma = gamma
        self.runner = GraphRunner(target_engine.device,
                                  enabled=target_engine.graphs)
        self._d_cache: Optional[llama.KVCache] = None

    def _draft_cache(self) -> llama.KVCache:
        """The one draft cache, emptied (its length zeroed in place)."""
        eng = self.t
        if self._d_cache is None:
            with torch.inference_mode(False):
                self._d_cache = llama.KVCache.create(
                    self.d_cfg, 1, eng.max_len, dtype=eng.cache_dtype,
                    device=eng.device)
        self._d_cache.length.zero_()
        return self._d_cache

    @torch.inference_mode()
    def _draft_prefill(self, tokens: torch.Tensor, d_cache: llama.KVCache):
        """The draft prefills the same prompt (its length advanced in
        place): both caches track the sequence."""
        eng = self.t
        S = tokens.shape[1]
        buf = self.runner.buffers(("draft_prefill", S),
                                  tokens=((1, S), torch.int64))
        buf.tokens.copy_(tokens)

        def body():
            with _kernels(eng._impl):
                _, new = _model_forward(self.d_params, self.d_cfg, buf.tokens,
                                        d_cache, eng.compute_dtype)
            d_cache.length.copy_(new.length)

        self.runner.run(("draft_prefill", S, eng.max_len, eng.compute_dtype,
                         eng.use_kernels), body, state=(d_cache.length,),
                        binds=(self.d_params, d_cache))

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 128
                 ) -> Tuple[np.ndarray, SpecStats]:
        """Greedy generation; prompt [1, S] -> ([1, max_new_tokens], stats)."""
        eng = self.t
        if eng.batch_size != 1 or prompt.shape[0] != 1:
            raise ValueError("speculative decoding is batch-1")
        t_cache = eng.new_cache()
        d_cache = self._draft_cache()
        toks = eng.tokens_to_device(prompt)
        first, t_cache = eng._prefill_token(eng.params, toks, t_cache)
        self._draft_prefill(toks, d_cache)
        out, rounds, accepted = speculative_decode(
            eng.params, self.d_params, eng.cfg, self.d_cfg, first, t_cache,
            d_cache, gamma=self.gamma, max_new=max_new_tokens - 1,
            compute_dtype=eng.compute_dtype, impl=eng._impl,
            runner=self.runner)
        tokens = torch.cat([first[:, None], out], dim=1).cpu().numpy()
        return tokens, SpecStats(tokens=max_new_tokens, rounds=rounds,
                                 accepted=accepted)
