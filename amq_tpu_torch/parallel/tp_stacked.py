"""Tensor parallelism for the stacked serving model.

The port of the JAX package's ``parallel/tp_stacked.py``, in SPMD form:
one process per shard, each building and holding only its own shard
(:func:`stack_proxies_tp` with its rank), the collectives on a
``torch.distributed`` group.

* q/k/v and gate/up are column-parallel: lane slices cut at head /
  quantization-group boundaries; o/down are row-parallel: packed-row
  slices, unpacked, cut at whole groups and repacked with a local
  superblock, and their partial outputs are summed over the group
  (``models.stacked.scan_layers(tp_group=...)``, the JAX ``psum``),
* uneven splits (Llama-2-7B's intermediate 11008 = 86 groups over tp 4)
  are evened out with zero-scale padding: every shard owns
  ``ceil(G / tp)`` groups, phantom groups dequantize to exactly 0 and
  the matching gate/up pad lanes output 0,
* the KV cache holds only this rank's kv heads (attention is local),
* a packed (``head_bits``) lm_head is vocab-sharded: each rank serves
  ``ceil(V / tp)`` lanes and the forward gathers the logits
  (``forward_stacked(tp_group=...)``).

The JAX package stacks all shards into ``[tp, ...]`` leaves on one
controller; here shard ``s`` of ``tp`` is built in one process by
``stack_proxies_tp(..., tp, s)``, so a single process can build every
shard (the tests compare each with the JAX leaves).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core import bitpack
from ..core.device import resolve_device
from ..core.quantize import QuantizedTensor
from ..models import llama
from ..models.config import LINEAR_NAMES, ModelConfig
from ..models.linear import QuantLinear
from ..models.stacked import (StackedModel, forward_stacked,
                              merge_containers, quantize_head, stack_proxies)


# ---------------------------------------------------------------------------
# shard geometry

def _even_split(n: int, tp: int, s: int):
    """(start, length) of shard ``s`` for an exactly divisible axis."""
    if n % tp:
        raise ValueError(f"{n} does not split evenly over tp={tp}")
    return s * (n // tp), n // tp


def _group_split(n_groups: int, tp: int, s: int):
    """(start_group, real_groups, max_groups) for a group-granular axis.

    The first ``n_groups % tp`` shards own one extra group; every shard
    is padded (zero-scale) up to ``max_groups`` so shapes agree across
    the shards."""
    base, rem = divmod(n_groups, tp)
    start = s * base + min(s, rem)
    real = base + (1 if s < rem else 0)
    return start, real, base + (1 if rem else 0)


def local_stacked_config(cfg: ModelConfig, tp: int,
                         group_size: int = 128) -> ModelConfig:
    """Per-shard model config for the TP stacked model."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv "
                         f"heads do not split over tp={tp}")
    if (cfg.num_heads // tp * cfg.head_dim_) % group_size:
        raise ValueError("the o_proj K shard must own whole quantization "
                         f"groups ({cfg.num_heads} heads x {cfg.head_dim_} "
                         f"over tp={tp}, group {group_size})")
    _, _, g_max = _group_split(cfg.intermediate_size // group_size, tp, 0)
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=g_max * group_size,
        head_dim=cfg.head_dim_,
        name=cfg.name + f"-tp{tp}",
    )


# ---------------------------------------------------------------------------
# QuantizedTensor shard slicing

def _slice_qt_lanes(qt: QuantizedTensor, lo: int, n_real: int,
                    n_out: int) -> QuantizedTensor:
    """Column-parallel shard: lanes ``[lo, lo + n_real)`` zero-padded to
    ``n_out``.  Pad lanes get scale 0, so they output exactly 0."""
    def cut(x):
        return F.pad(x[:, lo:lo + n_real], (0, n_out - n_real))

    return dataclasses.replace(qt, packed=cut(qt.packed), scale=cut(qt.scale),
                               zero=cut(qt.zero), shape=(n_out, qt.shape[1]))


def _slice_qt_rows(qt: QuantizedTensor, g0: int, g_real: int,
                   g_out: int) -> QuantizedTensor:
    """Row-parallel shard: quantization groups ``[g0, g0 + g_real)`` of the
    K axis, zero-scale-padded to ``g_out`` groups and repacked with a
    local superblock (the planar packing block spans several groups, so
    packed rows cannot be sliced at group granularity)."""
    g = qt.group_size
    codes = bitpack.unpack(qt.packed, qt.nbits, qt.superblock_)
    codes = codes[g0 * g:(g0 + g_real) * g]
    k_loc = g_out * g
    sb, k_pad = bitpack.pick_superblock_padded(k_loc, g)
    codes = F.pad(codes, (0, 0, 0, k_loc + k_pad - codes.shape[0]))
    meta_pad = (0, 0, 0, g_out + k_pad // g - g_real)
    return dataclasses.replace(
        qt,
        packed=bitpack.pack(codes, qt.nbits, sb),
        scale=F.pad(qt.scale[g0:g0 + g_real], meta_pad),
        zero=F.pad(qt.zero[g0:g0 + g_real], meta_pad),
        shape=(qt.shape[0], k_loc),
        superblock=sb)


def shard_proxy(proxy: Dict[str, Any], cfg: ModelConfig, tp: int, s: int,
                group_size: int = 128) -> Dict[str, Any]:
    """Shard ``s``'s slice of one per-bit quantized proxy
    (``quantize_model``'s layout).

    Cut points: q/o at query-head boundaries, k/v at kv-head boundaries,
    gate/up/down at the same intermediate quantization-group boundaries
    (so the row-parallel down owns whole groups and its K slice matches
    the gate/up lane slices).  A row-parallel (o/down) bias is refused: it
    would be summed ``tp`` times.
    """
    hd = cfg.head_dim_
    g = group_size
    gi0, gi_real, gi_max = _group_split(cfg.intermediate_size // g, tp, s)
    i_loc = gi_max * g

    def slice_linear(name: str, ql: QuantLinear) -> QuantLinear:
        if not isinstance(ql, QuantLinear):
            raise TypeError(f"{name}: a quantized linear is needed, got "
                            f"{type(ql).__name__}")
        if name in ("self_attn.q_proj", "self_attn.k_proj",
                    "self_attn.v_proj"):
            heads = (cfg.num_heads if name.endswith("q_proj")
                     else cfg.num_kv_heads)
            h0, h_n = _even_split(heads, tp, s)
            qt = _slice_qt_lanes(ql.qt, h0 * hd, h_n * hd, h_n * hd)
            bias = (None if ql.bias is None
                    else ql.bias[h0 * hd:(h0 + h_n) * hd])
            return QuantLinear(qt=qt, bias=bias)
        if ql.bias is not None:
            raise ValueError(f"{name}: a bias on the MLP or o_proj cannot be "
                             "sharded (a row-parallel bias would be summed "
                             "over the ranks)")
        if name in ("mlp.gate_proj", "mlp.up_proj"):
            return QuantLinear(
                qt=_slice_qt_lanes(ql.qt, gi0 * g, gi_real * g, i_loc))
        if name == "self_attn.o_proj":
            kh0, kh_n = _even_split(cfg.num_heads, tp, s)
            if (kh_n * hd) % g:
                raise ValueError(f"o_proj shard of {kh_n * hd} rows is not "
                                 f"whole groups of {g}")
            return QuantLinear(qt=_slice_qt_rows(
                ql.qt, kh0 * hd // g, kh_n * hd // g, kh_n * hd // g))
        assert name == "mlp.down_proj", name
        return QuantLinear(qt=_slice_qt_rows(ql.qt, gi0, gi_real, gi_max))

    out = {k: v for k, v in proxy.items() if k != "layers"}
    out["layers"] = [
        {**{k: v for k, v in layer.items() if k not in LINEAR_NAMES},
         **{name: slice_linear(name, layer[name]) for name in LINEAR_NAMES}}
        for layer in proxy["layers"]]
    return out


# ---------------------------------------------------------------------------
# TP stacked-model assembly

def stack_proxies_tp(
    proxies: Sequence[Any],
    bits_range: Sequence[int],
    cfg: ModelConfig,
    tp: int,
    rank: int,
    *,
    arch: Optional[Dict] = None,
    fuse: str = "auto",
    container_bits: Optional[Dict[int, int]] = None,
    head_bits: Optional[int] = None,
    merge: bool = False,
    group_size: int = 128,
) -> StackedModel:
    """Shard ``rank`` of the ``tp``-way TP stacked serving model.

    ``proxies`` elements may be zero-argument factories: each is built,
    cut to this shard and freed before the next (one unsharded proxy
    resident at a time).  ``merge=True`` applies ``merge_containers``
    (needs a layer-uniform ``arch``).  ``head_bits`` quantizes and
    vocab-shards the lm_head: this shard serves vocab rows
    ``[rank * v_loc, (rank + 1) * v_loc)``, ``v_loc = ceil(V / tp)``,
    zero-padded past V.  Static fields describe the local shard.
    """
    v_loc = -(-cfg.vocab_size // tp)
    sliced = [(lambda p=p: shard_proxy(p() if callable(p) else p, cfg, tp,
                                       rank, group_size))
              for p in proxies]
    m = stack_proxies(sliced, bits_range, arch=arch, fuse=fuse,
                      container_bits=container_bits, head_bits=None)
    if merge:
        m = merge_containers(m)
    if head_bits is not None:
        head_w = m.lm_head if m.lm_head is not None else m.embed
        rows = head_w[rank * v_loc:(rank + 1) * v_loc]
        head_pad = F.pad(rows, (0, 0, 0, v_loc - rows.shape[0]))
        m = dataclasses.replace(
            m, lm_head=None,
            lm_head_qt=quantize_head(head_pad, nbits=head_bits))
    return m


def new_tp_cache(cfg: ModelConfig, tp: int, batch: int, max_len: int,
                 dtype=torch.bfloat16, device="cpu",
                 group_size: int = 128) -> llama.KVCache:
    """This rank's cache ``[L, B, kv / tp, T, hd]``."""
    return llama.KVCache.create(local_stacked_config(cfg, tp, group_size),
                                batch, max_len, dtype=dtype, device=device)


def make_tp_forward_stacked(cfg: ModelConfig, group, tp: int,
                            compute_dtype=torch.bfloat16,
                            group_size: int = 128) -> Callable:
    """The rank's forward ``(model, tokens, cache) -> (logits, cache)``:
    its shard's layers with the o and MLP outputs summed over ``group``,
    kv-head-local attention on its cache, logits ``[B, S, V]`` float32 on
    every rank (a vocab-sharded head's gathered).  ``tokens`` are this
    rank's whole batch (a data-parallel caller passes its own rows)."""
    lcfg = local_stacked_config(cfg, tp, group_size)

    def fwd(model, tokens, cache):
        return forward_stacked(model, lcfg, tokens, cache=cache,
                               compute_dtype=compute_dtype, tp_group=group)

    return fwd


def make_tp_engine(cfg: ModelConfig, group, tp: int, model: StackedModel,
                   batch_size: int = 1, max_len: int = 2048,
                   compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                   group_size: int = 128, use_kernels: bool = True,
                   device=None, graphs: bool = True):
    """Serving :class:`~amq_tpu_torch.serving.engine.Engine` over this
    rank's shard: the same ``generate`` / prefill / decode bodies, with
    the sharded forward and the rank-local cache.  Every rank of the
    group calls the same methods with the same prompts.  ``graphs=True``
    needs an NCCL group (the engine raises on another)."""
    from ..serving.engine import Engine
    dev = resolve_device(device)
    return Engine(
        params=model, cfg=cfg, batch_size=batch_size, max_len=max_len,
        compute_dtype=compute_dtype, cache_dtype=cache_dtype,
        use_kernels=use_kernels, device=dev, graphs=graphs,
        forward_fn=make_tp_forward_stacked(cfg, group, tp, compute_dtype,
                                           group_size),
        cache_factory=lambda: new_tp_cache(cfg, tp, batch_size, max_len,
                                           dtype=cache_dtype, device=dev,
                                           group_size=group_size),
        group=group)
