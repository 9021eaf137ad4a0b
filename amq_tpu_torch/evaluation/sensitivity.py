"""Layer-wise sensitivity analysis for search-space pruning.

The port of the JAX package's ``evaluation/sensitivity.py``: start from
the all-4-bit architecture, drop each (block, linear) site to 2 bits in
turn, and record the JSD loss against the dense model as a
``{"{block}.{linear}": loss}`` table (the search pins sites whose loss
exceeds ``median * threshold`` to max bits).  The output schema is the
JAX package's.

Two strategies:

* suffix (the default for a search-mode evaluator): a probe differs from
  the all-4 baseline only at its block b, so its activations entering b
  are the baseline's; the probe resumes from the baseline's block-b input
  and runs blocks ``b..L`` only (``stacked.forward_stacked_suffix``),
  about half the block computations of the naive stage at 32 layers;
* naive: a full forward per probe through ``Evaluator.eval_many``.

Under a data-parallel evaluator each rank runs its own samples and the
per-probe sums are added over the ranks.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.config import LINEAR_NAMES
from ..models.stacked import forward_stacked_suffix, scan_layers, set_arch
from . import metrics
from .evaluator import Evaluator


@torch.inference_mode()
def _suffix_losses(ev: Evaluator, dataset: str, keys, probes, base,
                   n_block: int, progress: bool) -> Dict[str, float]:
    cfg, cd = ev.cfg, ev.compute_dtype
    P = len(LINEAR_NAMES)
    m = set_arch(ev.switch_params, base)
    batches = ev.loss_batches(dataset)
    sums = np.zeros((n_block, P))
    with ev.kernels():
        for bi, (batch, n_valid, start) in enumerate(batches):
            dense = ev.dense_batch(ev.dense_logits[dataset], start, n_valid,
                                   batch.shape[0])
            x = m.embed[ev.tokens(batch)].to(cd)
            for b in range(n_block):
                vals = []
                for j in range(P):
                    logits = forward_stacked_suffix(
                        set_arch(m, probes[b * P + j]), cfg, x, b,
                        compute_dtype=cd)
                    vals.append(ev.loss_of_logits(logits, dense)[:n_valid].sum())
                if b + 1 < n_block:     # advance the baseline by block b
                    x = scan_layers(m, cfg, x, compute_dtype=cd,
                                    start_layer=b, stop_layer=b + 1)[0]
                sums[b] += torch.stack(vals).double().cpu().numpy()
            if progress:
                print(f"sensitivity batch {bi + 1}/{len(batches)} "
                      f"({start + n_valid}/{len(ev.local[dataset])} "
                      f"samples)", flush=True)
    sums = ev.reduce_sum(sums)          # every rank's samples
    total = len(ev.datasets[dataset])
    return {keys[b * P + j]: float(sums[b, j] / total)
            for b in range(n_block) for j in range(P)}


def make_suffix_arch_eval(ev: Evaluator, dataset: str):
    """``eval_fn(arch) -> ({dataset: loss}, bits)`` through the suffix
    program from block 0: the embedding, then every block, the head and the
    JSD -- the same numbers as ``Evaluator.eval``."""
    cfg, cd = ev.cfg, ev.compute_dtype
    batches = ev.loss_batches(dataset)
    total = len(ev.datasets[dataset])

    @torch.inference_mode()
    def eval_fn(arch):
        m = set_arch(ev.switch_params, arch)
        s = 0.0
        with ev.kernels():
            for batch, n_valid, start in batches:
                dense = ev.dense_batch(ev.dense_logits[dataset], start,
                                       n_valid, batch.shape[0])
                x = m.embed[ev.tokens(batch)].to(cd)
                logits = forward_stacked_suffix(m, cfg, x, 0, compute_dtype=cd)
                s += float(ev.loss_of_logits(logits, dense)[:n_valid].sum())
        s = float(ev.reduce_sum(np.array([s]))[0])
        bits = metrics.get_bits_usage(arch, ev.topology, ev.group_size)
        return {dataset: s / total}, bits

    return eval_fn


class SuffixArchEvaluator:
    """:func:`make_suffix_arch_eval` behind the ``Evaluator.eval`` surface
    the search loop uses (``search = False`` keeps the loop per arch)."""

    search = False

    def __init__(self, ev: Evaluator, dataset: str):
        self._fn = make_suffix_arch_eval(ev, dataset)

    def eval(self, arch):
        return self._fn(arch)


def linear_sensitivity(evaluator: Evaluator, dataset: str, max_bits: int = 4,
                       probe_bits: int = 2, progress: bool = False,
                       suffix: Optional[bool] = None) -> Dict:
    n_block = evaluator.cfg.num_layers
    base = {"linear": {l: [max_bits] * n_block for l in LINEAR_NAMES}}
    keys, probes = [], []
    for block_idx in range(n_block):
        for linear_group in LINEAR_NAMES:
            keys.append(f"{block_idx}.{linear_group}")
            a = copy.deepcopy(base)
            a["linear"][linear_group][block_idx] = probe_bits
            probes.append(a)

    searchable = bool(getattr(evaluator, "search", False))
    suffix = searchable if suffix is None else suffix
    start = time.time()
    if suffix and searchable:
        loss_list = _suffix_losses(evaluator, dataset, keys, probes, base,
                                   n_block, progress)
    else:
        many = getattr(evaluator, "eval_many", None) if searchable else None
        results = (many(probes) if many is not None
                   else [evaluator.eval(a) for a in probes])
        loss_list = {key: metric[dataset]
                     for key, (metric, _) in zip(keys, results)}
        if progress:
            for key, loss in loss_list.items():
                print(f"{key}: {loss:.6f}", flush=True)
    return {
        "loss": loss_list,
        "time_elapsed": time.time() - start,
        "dataset": dataset,
        "n_block": n_block,
        "linear": list(LINEAR_NAMES),
    }
