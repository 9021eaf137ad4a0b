"""Pipeline parallelism: layer stages and microbatched GPipe steps.

The port of the JAX package's ``parallel/pp.py``, in SPMD form: one
process per (stage, tensor shard).  Stage ``s`` of ``S`` owns layers
``[s * L / S, (s + 1) * L / S)`` (:func:`shard_model_pp` cuts them out of
the stacked model, so a rank holds only its stage) and the same layers of
the cache; embed, final norm and the dense head are replicated (stage 0
embeds, the last stage applies the head).

A step (:func:`make_pp_step`) runs ``S + n_micro - 1`` ticks: at tick
``t`` stage ``s`` processes microbatch ``t - s`` when it is in range and
sits the tick out otherwise; activations go one stage forward by
point-to-point send / recv (the JAX ``ppermute``), and the last stage's
logits reach every rank by a broadcast over the stage group (the JAX
``psum`` of zeros elsewhere).  With ``tp > 1`` each stage is itself a
tensor-parallel group over ``parallel.tp_stacked`` shards (the JAX
composed ('stage', 'tensor') mesh).

The cache is one :class:`~amq_tpu_torch.models.llama.KVCache` per
microbatch (:func:`new_pp_cache`), so a microbatch's rows are contiguous
for the decode kernels; the JAX package keeps one buffer and slices rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from ..models import linear as linear_mod
from ..models import llama
from ..models.config import ModelConfig
from ..models.stacked import StackedModel, StackedQuant, scan_layers
from . import comm, multihost


def stage_mesh(n_stages: int, tp: int = 1) -> multihost.PodMesh:
    """('stage', 'tensor') layout of ``n_stages * tp`` ranks: stage ``s``
    is ranks ``[s * tp, (s + 1) * tp)`` (its tensor group); the layout's
    ``data_index`` is the stage and ``data_group`` the ranks of one tensor
    index across the stages.  Every rank calls it."""
    return multihost.grid([[s * tp + j for j in range(tp)]
                           for s in range(n_stages)])


def shard_model_pp(model: StackedModel, n_stages: int,
                   stage: int) -> StackedModel:
    """Stage ``stage``'s layers of a stacked model (a TP shard too): every
    ``[L, ...]`` leaf cut to the stage's ``L / n_stages`` layers."""
    if model.slots is not None:
        raise ValueError("container-merged stacks are compact per container "
                         "and cannot be cut into stages; build without "
                         "merge_containers")
    L = model.num_layers
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    lo, hi = stage * L // n_stages, (stage + 1) * L // n_stages

    def cut(sq: StackedQuant) -> StackedQuant:
        return dataclasses.replace(sq, packed=sq.packed[lo:hi],
                                   scale=sq.scale[lo:hi], zero=sq.zero[lo:hi])

    return dataclasses.replace(
        model, input_norm=model.input_norm[lo:hi],
        post_norm=model.post_norm[lo:hi],
        sites={k: tuple(cut(s) for s in v) for k, v in model.sites.items()},
        biases={k: None if b is None else b[lo:hi]
                for k, b in model.biases.items()},
        select={k: list(v[lo:hi]) for k, v in model.select.items()},
        num_layers=hi - lo)


def new_pp_cache(cfg: ModelConfig, stage_layers: int, batch: int,
                 n_micro: int, max_len: int, dtype=torch.bfloat16,
                 device="cpu") -> List[llama.KVCache]:
    """One cache per microbatch, ``[L / S, B / n_micro, kv, T, hd]`` each
    (``cfg`` the stage's scan config: a TP rank's local one)."""
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not split into {n_micro} "
                         "microbatches")
    part = dataclasses.replace(cfg, num_layers=stage_layers)
    return [llama.KVCache.create(part, batch // n_micro, max_len, dtype=dtype,
                                 device=device) for _ in range(n_micro)]


def make_pp_step(cfg: ModelConfig, mesh: multihost.PodMesh,
                 model: StackedModel, n_micro: int,
                 compute_dtype=torch.bfloat16,
                 use_kernels: bool = False) -> Callable:
    """The rank's pipeline step ``step(model, tokens [B, S], caches) ->
    last-position logits [B, V] float32`` on every rank (``caches`` from
    :func:`new_pp_cache`, advanced in place).  ``model`` is this rank's
    stage (:func:`shard_model_pp`), of a ``parallel.tp_stacked`` shard
    when ``mesh`` has more than one rank per stage.  One call is one full
    pass: a prefill with S > 1, a decode step with S = 1.  Every rank
    calls it with the same tokens.  ``use_kernels`` routes the linears
    and decode attention through the kernels (the CPU takes their plain
    versions)."""
    n_stages, tp = mesh.shape["data"], mesh.shape["tensor"]
    stage = mesh.data_index
    if model.lm_head_qt is not None:
        raise ValueError("the pipeline keeps the dense replicated head; "
                         "build the model without head_bits")
    if tp > 1:
        from .tp_stacked import local_stacked_config
        scan_cfg = local_stacked_config(cfg, tp)
        tp_group = mesh.tensor_group
    else:
        scan_cfg, tp_group = cfg, None
    n_ticks = n_stages + n_micro - 1

    @torch.inference_mode()
    def step(m: StackedModel, tokens: torch.Tensor,
             caches: List[llama.KVCache]) -> torch.Tensor:
        from ..serving.engine import kernel_linear_impl
        B, S = tokens.shape
        Bm = B // n_micro
        dev = tokens.device
        out = torch.zeros((n_micro, Bm, cfg.vocab_size), dtype=torch.float32,
                          device=dev)
        x_in = torch.empty((Bm, S, cfg.hidden_size), dtype=compute_dtype,
                           device=dev)
        impl = kernel_linear_impl if use_kernels else None
        with linear_mod.kernel_linears(impl), \
                llama.forward_kernels(use_kernels):
            for t in range(n_ticks):
                mb = t - stage
                if not 0 <= mb < n_micro:
                    continue
                if stage == 0:
                    rows = tokens[mb * Bm:(mb + 1) * Bm]
                    x = m.embed[rows].to(compute_dtype)
                else:
                    x = comm.recv_(x_in, stage - 1, mesh.data_group)
                c = caches[mb]
                x, (k_app, v_app) = scan_layers(
                    m, scan_cfg, x, cache_kv=(c.k, c.v), offset=c.length,
                    compute_dtype=compute_dtype, tp_group=tp_group)
                pos = c.length + torch.arange(S, device=dev)
                c.k.index_copy_(3, pos, k_app)
                c.v.index_copy_(3, pos, v_app)
                c.length.add_(S)
                if stage < n_stages - 1:
                    comm.send(x, stage + 1, mesh.data_group)
                    continue
                h = llama.rms_norm(x[:, -1], m.final_norm, cfg.rms_norm_eps)
                head = m.lm_head if m.lm_head is not None else m.embed
                out[mb] = linear_mod.matmul_out_f32(h, head.T, compute_dtype)
        comm.broadcast_(out, n_stages - 1, mesh.data_group)
        return out.reshape(B, cfg.vocab_size)

    return step
