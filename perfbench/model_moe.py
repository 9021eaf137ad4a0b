"""Random packed serving weights of a sparse (Qwen2-MoE) model, made on
the device from the seed.

``perfbench.model``'s pattern for every packed site (layer i at
``bits[i % len(bits)]``, compact per-container stacks, bf16 scale and
zero from ``model._meta``, pads zeroed, an 8-bit head, bf16 embedding,
unit norms, float32 q/k/v bias), with the MLP replaced by the sparse
block: the shared expert as two ordinary fused sites (gate|up, down), the
routed experts as per-container stacks ``[layers * E, rows, N]`` with
gate|up fused per expert and no lane pad (row ``slot * E + e`` is expert
e of the layer in that slot), and the router and shared-expert gate
unquantized: bf16 values held in float32.  Words are drawn one layer at a
time, so the transient int64 draws stay near a gigabyte whatever the
model's size.

:func:`build` returns the port's ``StackedModel`` and :class:`MoeWeights`,
a plain description of the same tensors (views, no copies), which is all
``perfbench.reference.moe`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from perfbench import model
from perfbench.model import Packed
from perfbench.work import moe as work

#: the serving sites of a layer: fused name in the port -> reference key
SITES = {"qkv": "self_attn.qkv_proj", "o": "self_attn.o_proj",
         "shared_gateup": "mlp.shared_expert.gateup_proj",
         "shared_down": "mlp.shared_expert.down_proj"}
EXPERT_SITES = {"gateup": "mlp.experts.gateup_proj",
                "down": "mlp.experts.down_proj"}


@dataclasses.dataclass
class MoeWeights(model.Weights):
    """``model.Weights`` (``layers``: per layer the four dense sites of
    :data:`SITES`) plus the router ``[L, E, H]``, the shared-expert gate
    ``[L, H]`` and per layer its experts' ``gateup`` / ``down``: a
    ``Packed`` whose words, scale and zero lead with the expert."""

    router: torch.Tensor
    shared_gate: torch.Tensor
    experts: List[Dict[str, Packed]]


def _fill(words: torch.Tensor, bits: int, container: int, n: int, gen,
          device) -> None:
    """Random codes below ``2**bits`` into the int32 ``words`` ``[..., R,
    Np]``; lanes from ``n`` on zero."""
    w = model._words(tuple(words.shape), gen, device)
    if bits < container:
        w &= model._nibble_mask(bits, container)
    w[..., n:] = 0
    words.copy_(model._wrap(w))


def _site(n_layers, experts, N, K, container, bits_of, gen, device, group,
          lane_pad):
    """One site's stack ``[n_layers * experts, Kp * container / 32, Np]``
    and its bf16 scale and zero; layer j of the stack (its rows ``j *
    experts ..``) at ``bits_of[j]``."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.models.stacked import _pick_lane_pad
    sb, k_pad = pick_superblock_padded(K, group)
    Kp, Np = K + k_pad, N + (_pick_lane_pad(N) if lane_pad else 0)
    rows = n_layers * experts
    words = torch.empty((rows, Kp * container // 32, Np), dtype=torch.int32,
                        device=device)
    scale = torch.empty((rows, Kp // group, Np), dtype=torch.bfloat16,
                        device=device)
    zero = torch.empty_like(scale)
    for j, b in enumerate(bits_of):
        at = slice(j * experts, (j + 1) * experts)
        _fill(words[at], b, container, N, gen, device)
        s, z = model._meta((experts, Kp // group, Np), [b] * experts, K, 1.0,
                           gen, device)
        for meta in (s, z):
            meta[:, :, N:] = 0
            meta[:, K // group:] = 0
        scale[at], zero[at] = s, z
    return words, scale, zero, sb


def build(cfg, shape: dict, quant: dict, gen: torch.Generator, device):
    """``(StackedModel, MoeWeights)`` for the port's ``ModelConfig`` ``cfg``
    with the configuration file's ``shape`` and ``quant`` sections."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.models.stacked import StackedModel, StackedQuant
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    E = cfg.num_experts
    group = quant["group_size"]
    cycle = quant["layer_bits_cycle"]
    container = {int(k): v for k, v in quant["containers"].items()}
    layer_bits = [cycle[i % len(cycle)] for i in range(L)]
    conts = sorted({container.get(b, b) for b in layer_bits})
    layer_cont = [conts.index(container.get(b, b)) for b in layer_bits]
    members = [[i for i in range(L) if layer_cont[i] == c]
               for c in range(len(conts))]
    slots = [members[layer_cont[i]].index(i) for i in range(L)]
    shapes = work.products(shape)
    stacks: Dict[str, list] = {}
    layers: List[Dict[str, Packed]] = [{} for _ in range(L)]
    experts: List[Dict[str, Packed]] = [{} for _ in range(L)]
    for site, (N, K) in shapes.items():
        if site == "head":
            continue
        per = E if site in EXPERT_SITES else 1
        stacks[site] = []
        for c, w in enumerate(conts):
            bits = [layer_bits[i] for i in members[c]]
            packed, scale, zero, sb = _site(len(bits), per, N, K, w, bits,
                                            gen, device, group,
                                            site not in EXPERT_SITES)
            stacks[site].append(StackedQuant(packed, scale, zero, w, group,
                                             (N, K), sb))
            for i in members[c]:
                at = slice(slots[i] * per, (slots[i] + 1) * per)
                if site in EXPERT_SITES:
                    experts[i][site] = Packed(packed[at], scale[at],
                                              zero[at], w, group, sb, N, K)
                else:
                    j = slots[i]
                    layers[i][site] = Packed(packed[j], scale[j], zero[j], w,
                                             group, sb, N, K)
    hb = quant["head_bits"]
    Vp = V + (-V % 2048)
    hsb, h_pad = pick_superblock_padded(H, group)
    if h_pad:
        raise ValueError(f"hidden size {H} needs a padded head superblock")
    hw = torch.empty((H * hb // 32, Vp), dtype=torch.int32, device=device)
    _fill(hw, hb, hb, V, gen, device)
    hscale, hzero = model._meta((H // group, Vp), [hb], H, quant["logit_rms"],
                                gen, device)
    hscale[:, V:] = 0
    hzero[:, V:] = 0
    head = Packed(hw, hscale.to(torch.bfloat16), hzero.to(torch.bfloat16), hb,
                  group, hsb, V, H)
    head_qt = QuantizedTensor(packed=head.packed, scale=head.scale,
                              zero=head.zero, nbits=hb, group_size=group,
                              shape=(V, H), superblock=hsb)
    ones = torch.ones((L, H), dtype=torch.bfloat16, device=device)
    embed = (torch.randn((V, H), generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    bias = {s: None for s in SITES}
    if shape.get("qkv_bias"):
        bias["qkv"] = torch.randn((L, shapes["qkv"][0]), generator=gen,
                                  device=device) * 0.02

    def bf16_randn(*size, gain):
        t = torch.randn(size, generator=gen, device=device) * gain
        return t.to(torch.bfloat16).float()

    router = bf16_randn(L, E, H, gain=quant["router_logit_rms"] / H**0.5)
    shared_gate = bf16_randn(L, H, gain=1.0 / H**0.5)
    names = dict(SITES, **EXPERT_SITES)
    net = StackedModel(
        embed=embed, final_norm=ones[0].clone(), lm_head=None,
        input_norm=ones, post_norm=ones.clone(),
        sites={names[s]: tuple(stacks[s]) for s in SITES},
        biases={names[s]: b for s, b in bias.items()},
        select={names[s]: list(layer_cont) for s in names},
        bits_range=tuple(conts), num_layers=L, uniform_select=True,
        slots=slots, lm_head_qt=head_qt, router=router,
        shared_gate=shared_gate,
        experts={names[s]: tuple(stacks[s]) for s in EXPERT_SITES})
    weights = MoeWeights(embed=embed, input_norm=net.input_norm,
                         post_norm=net.post_norm, final_norm=net.final_norm,
                         layers=layers, bias=bias, head=head, router=router,
                         shared_gate=shared_gate, experts=experts)
    return net, weights
