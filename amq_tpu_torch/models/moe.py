"""Sparse (Qwen2-MoE) models: dense random parameters, their packed
serving form, and the dense weights a packed model stands for.

The dense layout (``init_moe_params``, read by ``models.moe_reference``):
``embed [V, H]``, ``final_norm [H]``, ``lm_head [V, H]`` and per layer
``input_norm``, ``post_norm [H]``, each attention linear ``[out, in]``
under its reference name with ``<name>.bias`` for q/k/v, the router
``mlp.gate [E, H]``, ``mlp.shared_expert_gate [H]``, the shared expert's
``mlp.shared_expert.{gate,up,down}_proj`` and the routed experts'
``mlp.experts.{gate,up}_proj [E, I, H]`` and ``mlp.experts.down_proj
[E, H, I]``.

:func:`stack_moe` packs it as the serving stacks do: every linear of
layer i HQQ-quantized at ``layer_bits[i]`` (a layer's experts all at that
width: AMQ's search space is per (layer, site) here, not per expert),
fused q|k|v and gate|up (per expert for the routed ones), stacks per
container width holding exactly the layers of that width (``slots``), the
router and the shared expert's gate kept unquantized in float32 holding
their bf16 values, an optional 8-bit packed head.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.quantize import dequantize_kn, quantize, to_container
from .config import ModelConfig
from .stacked import (SERVE_CONTAINERS, StackedModel, StackedQuant,
                      _pick_lane_pad, quantize_head)

ATTN = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.o_proj")
SHARED = ("mlp.shared_expert.gate_proj", "mlp.shared_expert.up_proj",
          "mlp.shared_expert.down_proj")
EXPERTS = ("mlp.experts.gate_proj", "mlp.experts.up_proj",
           "mlp.experts.down_proj")


def init_moe_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cpu", router_rms: float = 1.0) -> Dict:
    """Random float32 parameters in the dense layout: every linear
    ``randn / sqrt(in)`` (unit-RMS outputs of unit-RMS inputs), the router
    scaled so its logits have RMS ``router_rms``, norms 1 plus noise,
    q/k/v biases ``0.02 randn``, an embedding of unit RMS rows and a head
    of RMS 1."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    E, I, S = (cfg.num_experts, cfg.moe_intermediate_size,
               cfg.shared_expert_intermediate_size)

    def randn(*size, gain=1.0):
        return (torch.randn(size, generator=generator, device=device)
                * (gain / math.sqrt(size[-1])))

    def norm():
        return 1.0 + 0.1 * torch.randn(H, generator=generator, device=device)

    layers = []
    for _ in range(L):
        lay = {"input_norm": norm(), "post_norm": norm()}
        for name in ATTN:
            out_f, in_f = cfg.linear_shape(name)
            lay[name] = randn(out_f, in_f)
        for name in ATTN[:3]:
            lay[name + ".bias"] = 0.02 * torch.randn(
                lay[name].shape[0], generator=generator, device=device)
        lay["mlp.gate"] = randn(E, H, gain=router_rms)
        lay["mlp.shared_expert_gate"] = randn(H)
        lay["mlp.shared_expert.gate_proj"] = randn(S, H)
        lay["mlp.shared_expert.up_proj"] = randn(S, H)
        lay["mlp.shared_expert.down_proj"] = randn(H, S)
        lay["mlp.experts.gate_proj"] = randn(E, I, H)
        lay["mlp.experts.up_proj"] = randn(E, I, H)
        lay["mlp.experts.down_proj"] = randn(E, H, I)
        layers.append(lay)
    return {"embed": randn(V, H, gain=math.sqrt(H)), "final_norm": norm(),
            "lm_head": randn(V, H), "layers": layers}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def stack_moe(params: Dict, cfg: ModelConfig, layer_bits: Sequence[int],
              container_bits: Optional[Dict[int, int]] = None,
              head_bits: Optional[int] = 8, group_size: int = 128,
              meta_dtype=torch.bfloat16) -> StackedModel:
    """The packed serving model of dense ``params`` (layer i at
    ``layer_bits[i]``); see the module docstring."""
    container_bits = (SERVE_CONTAINERS if container_bits is None
                      else container_bits)
    L, E = cfg.num_layers, cfg.num_experts
    widths = [container_bits.get(b, b) for b in layer_bits]
    conts = sorted(set(widths))
    layer_cont = [conts.index(w) for w in widths]
    members = [[i for i in range(L) if layer_cont[i] == c]
               for c in range(len(conts))]
    slots = [members[layer_cont[i]].index(i) for i in range(L)]
    lay = params["layers"]

    def packed(W, i, cont):
        return to_container(quantize(W, nbits=layer_bits[i],
                                     group_size=group_size,
                                     meta_dtype=meta_dtype), cont)

    def site(parts_of, lane_pad: bool) -> tuple:
        """Per container: the stack of every (layer, part list) that
        ``parts_of(i)`` gives for its layers, parts fused along out."""
        stacks = []
        for c, cont in enumerate(conts):
            rows = [[packed(W, i, cont) for W in parts]
                    for i in members[c] for parts in parts_of(i)]
            n_total = sum(q.shape[0] for q in rows[0])
            n_pad = _pick_lane_pad(n_total) if lane_pad else 0

            def stacked(field):
                return F.pad(torch.stack([torch.cat([getattr(q, field)
                                                     for q in qts], dim=1)
                                          for qts in rows]), (0, n_pad))

            q0 = rows[0][0]
            stacks.append(StackedQuant(
                packed=stacked("packed"), scale=stacked("scale"),
                zero=stacked("zero"), nbits=cont, group_size=group_size,
                shape=(n_total, q0.shape[1]), superblock=q0.superblock))
        return tuple(stacks)

    sites = {
        "self_attn.qkv_proj": site(lambda i: [[lay[i][n] for n in ATTN[:3]]],
                                   True),
        "self_attn.o_proj": site(lambda i: [[lay[i][ATTN[3]]]], True),
        "mlp.shared_expert.gateup_proj": site(
            lambda i: [[lay[i][SHARED[0]], lay[i][SHARED[1]]]], True),
        "mlp.shared_expert.down_proj": site(lambda i: [[lay[i][SHARED[2]]]],
                                            True),
    }
    experts = {
        "mlp.experts.gateup_proj": site(
            lambda i: [[lay[i][EXPERTS[0]][e], lay[i][EXPERTS[1]][e]]
                       for e in range(E)], False),
        "mlp.experts.down_proj": site(
            lambda i: [[lay[i][EXPERTS[2]][e]] for e in range(E)], False),
    }
    biases = {name: None for name in sites}
    biases["self_attn.qkv_proj"] = torch.stack([
        torch.cat([lay[i][n + ".bias"] for n in ATTN[:3]]) for i in range(L)])
    select = {name: list(layer_cont) for name in list(sites) + list(experts)}
    head_qt = (quantize_head(params["lm_head"], nbits=head_bits)
               if head_bits is not None else None)
    return StackedModel(
        embed=params["embed"], final_norm=params["final_norm"],
        lm_head=None if head_qt is not None else params["lm_head"],
        lm_head_qt=head_qt,
        input_norm=torch.stack([l["input_norm"] for l in lay]),
        post_norm=torch.stack([l["post_norm"] for l in lay]),
        sites=sites, biases=biases, select=select, bits_range=tuple(conts),
        num_layers=L, uniform_select=True, slots=slots,
        router=torch.stack([_bf16(l["mlp.gate"]) for l in lay]),
        shared_gate=torch.stack([_bf16(l["mlp.shared_expert_gate"])
                                 for l in lay]),
        experts=experts)


def _dense(stack: StackedQuant, j: int) -> torch.Tensor:
    """``[N, K]`` float32 weight of row ``j`` of a stack (no lane pad)."""
    return dequantize_kn(stack.layer(j), torch.float32).T


def dequantized_params(model: StackedModel, cfg: ModelConfig) -> Dict:
    """The dense layout of the float32 weights ``model`` serves: every
    packed linear dequantized (``(c - z) * s`` in float32), the router,
    gate, norms, biases, embedding and head (dequantized when packed) as
    they are."""
    L, E = cfg.num_layers, cfg.num_experts
    q, kv = cfg.q_dim, cfg.kv_dim
    S, I = cfg.shared_expert_intermediate_size, cfg.moe_intermediate_size
    layers: List[Dict] = []
    for i in range(L):
        c, j = model.select["self_attn.qkv_proj"][i], model.slots[i]
        st = {n: s[c] for n, s in model.sites.items()}
        ex = {n: s[c] for n, s in model.experts.items()}
        qkv = _dense(st["self_attn.qkv_proj"], j)
        gus = _dense(st["mlp.shared_expert.gateup_proj"], j)
        b = model.biases["self_attn.qkv_proj"][i].float()
        gu = [_dense(ex["mlp.experts.gateup_proj"], j * E + e)
              for e in range(E)]
        layers.append({
            "input_norm": model.input_norm[i].float(),
            "post_norm": model.post_norm[i].float(),
            "self_attn.q_proj": qkv[:q], "self_attn.k_proj": qkv[q:q + kv],
            "self_attn.v_proj": qkv[q + kv:],
            "self_attn.q_proj.bias": b[:q],
            "self_attn.k_proj.bias": b[q:q + kv],
            "self_attn.v_proj.bias": b[q + kv:],
            "self_attn.o_proj": _dense(st["self_attn.o_proj"], j),
            "mlp.gate": model.router[i].float(),
            "mlp.shared_expert_gate": model.shared_gate[i].float(),
            "mlp.shared_expert.gate_proj": gus[:S],
            "mlp.shared_expert.up_proj": gus[S:],
            "mlp.shared_expert.down_proj": _dense(
                st["mlp.shared_expert.down_proj"], j),
            "mlp.experts.gate_proj": torch.stack([w[:I] for w in gu]),
            "mlp.experts.up_proj": torch.stack([w[I:] for w in gu]),
            "mlp.experts.down_proj": torch.stack([
                _dense(ex["mlp.experts.down_proj"], j * E + e)
                for e in range(E)]),
        })
    head = (dequantize_kn(model.lm_head_qt, torch.float32).T
            if model.lm_head_qt is not None else model.lm_head.float())
    return {"embed": model.embed.float(), "final_norm": model.final_norm.float(),
            "lm_head": head, "layers": layers}


def with_dtype(model: StackedModel, dtype) -> StackedModel:
    """``model`` with its embedding and norms in ``dtype`` (the packed
    stacks, router and gate as they are)."""
    return dataclasses.replace(
        model, embed=model.embed.to(dtype),
        final_norm=model.final_norm.to(dtype),
        input_norm=model.input_norm.to(dtype),
        post_norm=model.post_norm.to(dtype))
