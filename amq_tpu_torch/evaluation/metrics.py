"""Quality metrics: JSD against the dense model, perplexity, bits usage.

The port of the JAX package's ``evaluation/metrics.py``, with the same
numerics:

* JSD: symmetric KL of the two softmaxes against their mixture clamped at
  1e-7, averaged over token rows,
* per-sample losses over next-token-shifted logits (``[:, :-1]``), so a
  padded batch can be weight-averaged over its valid rows,
* ``get_bits_usage``: per-linear ``numel * (bit + 32 / group_size)`` summed
  over blocks over ``model_numel`` (the ``32/g`` term is the 16-bit scale
  and zero of each group).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def _kl_pair_rows(p_logits: torch.Tensor, q_logits: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """``KL(p || m) + KL(q || m)`` per row ``[...]`` of ``[..., V]`` logits,
    ``m`` the mixture clamped at ``eps``; all in float32."""
    p_log = F.log_softmax(p_logits.float(), dim=-1)
    q_log = F.log_softmax(q_logits.float(), dim=-1)
    p, q = p_log.exp(), q_log.exp()
    log_m = torch.clamp(0.5 * (p + q), min=eps).log()
    return (p * (p_log - log_m)).sum(-1) + (q * (q_log - log_m)).sum(-1)


def jsd(p_logits: torch.Tensor, q_logits: torch.Tensor,
        eps: float = 1e-7) -> torch.Tensor:
    """Jensen-Shannon divergence of two logit sets ``[..., V]``, the mean
    over all leading dims."""
    return 0.5 * _kl_pair_rows(p_logits, q_logits, eps).mean()


def jsd_shifted(lm_logits: torch.Tensor,
                dense_logits: torch.Tensor) -> torch.Tensor:
    """JSD over the ``[:, :-1]`` next-token rows."""
    return jsd(lm_logits[:, :-1], dense_logits[:, :-1])


def jsd_shifted_per_sample(lm_logits: torch.Tensor, dense_logits: torch.Tensor,
                           chunk: int = 0) -> torch.Tensor:
    """Per-sample JSD ``[B]``, each the mean over that sample's shifted rows.

    ``chunk > 0`` takes the rows ``chunk`` at a time, so only O(chunk) f32
    ``[B, chunk, V]`` temporaries are live (the fused form keeps several
    ``[B, S, V]`` ones).  Same rows and per-row values; the sum runs chunk
    by chunk."""
    if chunk <= 0:
        return 0.5 * _kl_pair_rows(lm_logits[:, :-1],
                                   dense_logits[:, :-1]).mean(-1)
    n_rows = lm_logits.shape[1] - 1
    sums = torch.zeros(lm_logits.shape[0], dtype=torch.float32,
                       device=lm_logits.device)
    for start in range(0, n_rows, chunk):
        stop = min(start + chunk, n_rows)
        sums += _kl_pair_rows(lm_logits[:, start:stop],
                              dense_logits[:, start:stop]).sum(-1)
    return 0.5 * sums / n_rows


def cross_entropy_shifted_per_sample(lm_logits: torch.Tensor,
                                     tokens: torch.Tensor) -> torch.Tensor:
    """Per-sample mean next-token cross-entropy ``[B]``."""
    logp = F.log_softmax(lm_logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].mean(-1)


def cross_entropy_shifted(lm_logits: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over all samples and rows."""
    return cross_entropy_shifted_per_sample(lm_logits, tokens).mean()


def ppl_from_losses(losses: List[float]) -> float:
    """exp(mean per-sample cross-entropy)."""
    return float(np.exp(np.mean(np.asarray(losses, np.float64))))


def loss_from_losses(losses: List[float]) -> float:
    """Mean per-sample JSD."""
    return float(np.mean(np.asarray(losses, np.float64)))


def get_bits_usage(architecture: Dict, config: Dict, group_size: int = 128) -> float:
    """Average bits per weight including the scale+zero overhead."""
    memory = 0.0
    for linear_group, bits in architecture["linear"].items():
        out_dim, in_dim = config["linear_shape"][linear_group]
        for bit in bits:
            g = in_dim if group_size == -1 else group_size
            b = bit + (32.0 / g if bit < 16 else 0.0)
            memory += int(out_dim) * int(in_dim) * b
    return memory / config["model_numel"]


def get_correlation(prediction, target):
    """(RMSE, Spearman rho, Kendall tau) of a surrogate's predictions."""
    from scipy import stats

    prediction = np.asarray(prediction, np.float64).flatten()
    target = np.asarray(target, np.float64).flatten()
    rmse = float(np.sqrt(((prediction - target) ** 2).mean()))
    rho, _ = stats.spearmanr(prediction, target)
    tau, _ = stats.kendalltau(prediction, target)
    return rmse, float(rho), float(tau)
