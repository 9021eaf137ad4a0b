"""Tensor parallelism for the unrolled (evaluation-style) model.

The port of the JAX package's ``parallel/tp.py`` in SPMD form: each rank
holds its shard of an ``init_params``-shaped model (:func:`shard_params`)
and runs ``llama.forward(tp_group=...)`` on it.

* q/k/v/gate/up are column-parallel: dense weights ``[out, in]`` and
  their bias cut on the out axis, packed codes ``[K * b / 32, N]`` and
  scale/zero ``[K / g, N]`` on the N (lane) axis -- head-aligned, so a
  rank owns whole heads,
* o/down are row-parallel: dense weights cut on the in axis, packed codes
  on the packed-row axis and scale/zero on the group axis, which needs
  every rank's K slice to be whole packing superblocks (the packed shard
  is then itself a valid packed tensor); their partial outputs are
  summed over the group, and their bias stays whole on every rank, as the
  JAX package replicates it,
* a :class:`~amq_tpu_torch.models.linear.ProxySwitch` is cut proxy by
  proxy and keeps its ``select``,
* the cache holds this rank's kv heads; norms and embeddings are whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..models import llama
from ..models.config import LINEAR_NAMES, ModelConfig
from ..models.linear import DenseLinear, ProxySwitch, QuantLinear

COLUMN_PARALLEL = ("self_attn.q_proj", "self_attn.k_proj",
                   "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj")
ROW_PARALLEL = ("self_attn.o_proj", "mlp.down_proj")


def _cut(x: torch.Tensor, dim: int, tp: int, s: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split "
                         f"over tp={tp}")
    return x.narrow(dim, s * (n // tp), n // tp).contiguous()


def _shard_linear(p, name: str, tp: int, s: int):
    """Rank ``s``'s shard of one linear (dense, quantized or a switch)."""
    column = name in COLUMN_PARALLEL
    if isinstance(p, ProxySwitch):
        return ProxySwitch(proxies=tuple(_shard_linear(q, name, tp, s)
                                         for q in p.proxies),
                           select=p.select)
    if isinstance(p, DenseLinear):
        if column:
            return DenseLinear(
                weight=_cut(p.weight, 0, tp, s),
                bias=None if p.bias is None else _cut(p.bias, 0, tp, s))
        return DenseLinear(weight=_cut(p.weight, 1, tp, s), bias=p.bias)
    if not isinstance(p, QuantLinear):
        raise TypeError(f"{name}: cannot shard {type(p).__name__}")
    qt = p.qt
    out_f, in_f = qt.shape
    if column:
        qt = dataclasses.replace(
            qt, packed=_cut(qt.packed, 1, tp, s),
            scale=_cut(qt.scale, 1, tp, s), zero=_cut(qt.zero, 1, tp, s),
            shape=(out_f // tp, in_f))
        return QuantLinear(
            qt=qt, bias=None if p.bias is None else _cut(p.bias, 0, tp, s))
    k_pad = qt.scale.shape[0] * qt.group_size
    if k_pad != in_f or (in_f // tp) % qt.superblock_:
        raise ValueError(f"{name}: K={in_f} (padded {k_pad}) does not cut "
                         f"into whole superblocks of {qt.superblock_} over "
                         f"tp={tp}; quantize with a smaller superblock")
    qt = dataclasses.replace(
        qt, packed=_cut(qt.packed, 0, tp, s), scale=_cut(qt.scale, 0, tp, s),
        zero=_cut(qt.zero, 0, tp, s), shape=(out_f, in_f // tp))
    return QuantLinear(qt=qt, bias=p.bias)


def shard_params(params: Dict[str, Any], tp: int, s: int) -> Dict[str, Any]:
    """Rank ``s``'s shard of ``params`` (the JAX ``param_specs`` /
    ``shard_params`` as one cut)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [
        {**{k: v for k, v in layer.items() if k not in LINEAR_NAMES},
         **{n: _shard_linear(layer[n], n, tp, s) for n in LINEAR_NAMES}}
        for layer in params["layers"]]
    return out


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Per-shard config: local heads / intermediate size."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or \
            cfg.intermediate_size % tp:
        raise ValueError(f"{cfg.name} does not split over tp={tp}")
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        head_dim=cfg.head_dim_,
        name=cfg.name + f"-tp{tp}",
    )


def make_tp_forward(cfg: ModelConfig, group, tp: int,
                    compute_dtype=torch.bfloat16) -> Callable:
    """The rank's forward ``(params shard, tokens, cache) -> (logits,
    cache)``: logits ``[B, S, V]`` float32 on every rank, the cache
    ``[L, B, kv / tp, T, hd]`` this rank's (``llama.KVCache.create`` with
    :func:`local_config`).  ``tokens`` are this rank's batch."""
    lcfg = local_config(cfg, tp)

    def fwd(params, tokens, cache=None):
        return llama.forward(params, lcfg, tokens, cache=cache,
                             compute_dtype=compute_dtype, tp_group=group)

    return fwd
