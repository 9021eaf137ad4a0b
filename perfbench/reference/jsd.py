"""Plain Jensen-Shannon divergence of a student model's logits against the
dense model's, the number AMQ's search minimises.

Per token row, ``0.5 * (KL(p || m) + KL(q || m))`` with ``m`` the mixture
of the two softmaxes clamped at 1e-7; per sample, the mean over its rows
but the last (next-token rows); an architecture's loss is the mean over
samples.  Rows go ``chunk`` at a time so a row of the vocabulary is the
largest temporary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_jsd(student: torch.Tensor, dense: torch.Tensor,
               chunk: int = 256) -> float:
    """Mean JSD over the next-token rows of one sample's ``[S, V]`` logits."""
    rows = student.shape[0] - 1
    total = 0.0
    for a in range(0, rows, chunk):
        b = min(a + chunk, rows)
        p_log = F.log_softmax(student[a:b].double(), -1)
        q_log = F.log_softmax(dense[a:b].double(), -1)
        p, q = p_log.exp(), q_log.exp()
        log_m = torch.clamp(0.5 * (p + q), min=1e-7).log()
        total += float(((p * (p_log - log_m)).sum()
                        + (q * (q_log - log_m)).sum()))
    return 0.5 * total / rows
