"""Random packed serving weights, made on the device from the seed.

The pattern of the smoke run's 7B serving model: fused q/k/v and gate/up
sites, layer i at ``bits[i % len(bits)]``, compact per-container stacks
(3-bit codes in 4-bit containers by default), bf16 scale/zero, an 8-bit
packed head, bf16 embedding, unit norms, and a float32 q/k/v bias where
the configuration has one.  Words come from a ``torch.Generator`` on the
device in one call per site and container; a layer whose bits are below
its container's keeps its codes below ``2**bits``.  Rows padded to whole
superblocks carry zero scale and zero, lanes padded for the kernels'
tiles zero words too, so they add nothing.

:func:`build` returns the port's ``StackedModel`` and a plain description
of the same tensors (views, no copies), which is all the reference reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench import work
from perfbench.reference import quant
from perfbench.reference.llama import NAMES as LINEARS

#: fused serving sites in the reference's column order: q|k|v, gate|up
SITES = ("qkv", "o", "gateup", "down")


@dataclasses.dataclass
class Packed:
    """One packed ``[K, N]`` weight in the kernels' pair-planar layout:
    words ``[Kp * nbits / 32, Np]`` int32, scale / zero ``[Kp / group, Np]``;
    the logical weight is the first K rows and N columns."""

    packed: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    nbits: int
    group: int
    superblock: int
    n: int
    k: int


@dataclasses.dataclass
class Weights:
    """What the benchmark made, in plain form: per layer and site the
    packed weight it reads, the embedding, norms, biases and head."""

    embed: torch.Tensor                    # [V, H] bf16
    input_norm: torch.Tensor               # [L, H]
    post_norm: torch.Tensor                # [L, H]
    final_norm: torch.Tensor               # [H]
    layers: List[Dict[str, Packed]]
    bias: Dict[str, Optional[torch.Tensor]]  # site -> [L, N] float32 or None
    head: Packed


def _words(shape, gen, device) -> torch.Tensor:
    return torch.randint(0, 2**32, shape, dtype=torch.int64, device=device,
                         generator=gen)


def _wrap(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _nibble_mask(bits: int, container: int) -> int:
    """A 32-bit mask keeping each ``container``-bit field below 2**bits."""
    field = (1 << bits) - 1
    return sum(field << s for s in range(0, 32, container))


def _meta(shape, layer_bits, K, gain, gen, device):
    """Scale and zero ``shape`` (layer j's codes at ``layer_bits[j]``): zero
    at the codes' middle give or take half a code, scale in [0.5, 1.5) of
    ``gain / (sqrt(K) * std(codes))``, so a product of unit-RMS rows keeps
    about ``gain`` RMS, as a trained model's layers do; the residual
    stream then grows as the square root of depth and the logits stay
    finite and unequal."""
    mid = torch.tensor([(2**b - 1) / 2 for b in layer_bits], device=device)
    std = torch.tensor([math.sqrt((4**b - 1) / 12) for b in layer_bits],
                       device=device)
    view = (len(layer_bits),) + (1,) * (len(shape) - 1)
    scale = ((torch.rand(shape, generator=gen, device=device) + 0.5)
             * (gain / (math.sqrt(K) * std)).view(view))
    zero = (torch.rand(shape, generator=gen, device=device) - 0.5
            + mid.view(view))
    return scale, zero


def _stack(N, K, container, layer_bits, gen, device, group=128):
    """Packed stack ``[len(layer_bits), Kp * container / 32, Np]`` of random
    codes (layer j's below ``2**layer_bits[j]``) with :func:`_meta`'s bf16
    scale and zero, pads zeroed."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.models.stacked import _pick_lane_pad
    sb, k_pad = pick_superblock_padded(K, group)
    Kp, Np = K + k_pad, N + _pick_lane_pad(N)
    L = len(layer_bits)
    words = _words((L, Kp * container // 32, Np), gen, device)
    for j, b in enumerate(layer_bits):
        if b < container:
            words[j] &= _nibble_mask(b, container)
    words[:, :, N:] = 0
    # pad rows share words with real rows (pair-planar blocks); their
    # groups' zero scale makes them 0
    scale, zero = _meta((L, Kp // group, Np), layer_bits, K, 1.0, gen, device)
    for meta in (scale, zero):
        meta[:, :, N:] = 0
        meta[:, K // group:] = 0
    return _wrap(words), scale.to(torch.bfloat16), zero.to(torch.bfloat16), sb


def build(cfg, shape: dict, quant: dict, gen: torch.Generator, device):
    """``(StackedModel, Weights)`` for the port's ``ModelConfig`` ``cfg``,
    with the configuration file's ``shape`` and ``quant`` sections."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.models.stacked import StackedModel, StackedQuant
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    group = quant["group_size"]
    cycle = quant["layer_bits_cycle"]
    container = {int(k): v for k, v in quant["containers"].items()}
    layer_bits = [cycle[i % len(cycle)] for i in range(L)]
    conts = sorted({container.get(b, b) for b in layer_bits})
    layer_cont = [conts.index(container.get(b, b)) for b in layer_bits]
    members = [[i for i in range(L) if layer_cont[i] == c]
               for c in range(len(conts))]
    slots = [members[layer_cont[i]].index(i) for i in range(L)]
    shapes = {s: work.products(shape)[s] for s in SITES}
    names = {"qkv": "self_attn.qkv_proj", "o": "self_attn.o_proj",
             "gateup": "mlp.gateup_proj", "down": "mlp.down_proj"}
    stacks: Dict[str, list] = {}
    layers: List[Dict[str, Packed]] = [{} for _ in range(L)]
    for site, (N, K) in shapes.items():
        stacks[site] = []
        for c, w in enumerate(conts):
            packed, scale, zero, sb = _stack(
                N, K, w, [layer_bits[i] for i in members[c]], gen, device,
                group)
            stacks[site].append(StackedQuant(packed, scale, zero, w, group,
                                             (N, K), sb))
            for i in members[c]:
                j = slots[i]
                layers[i][site] = Packed(packed[j], scale[j], zero[j], w,
                                         group, sb, N, K)
    hb = quant["head_bits"]
    Vp = V + (-V % 2048)
    hsb, h_pad = pick_superblock_padded(H, group)
    if h_pad:
        raise ValueError(f"hidden size {H} needs a padded head superblock")
    hw = _words((H * hb // 32, Vp), gen, device)
    hw[:, V:] = 0
    hscale, hzero = _meta((H // group, Vp), [hb], H, quant["logit_rms"],
                          gen, device)
    hscale[:, V:] = 0
    hzero[:, V:] = 0
    head = Packed(_wrap(hw), hscale.to(torch.bfloat16),
                  hzero.to(torch.bfloat16), hb, group, hsb, V, H)
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
    model = StackedModel(
        embed=embed, final_norm=ones[0].clone(), lm_head=None,
        input_norm=ones, post_norm=ones.clone(),
        sites={names[s]: tuple(v) for s, v in stacks.items()},
        biases={names[s]: b for s, b in bias.items()},
        select={names[s]: list(layer_cont) for s in SITES},
        bits_range=tuple(conts), num_layers=L, uniform_select=True,
        slots=slots, lm_head_qt=head_qt)
    weights = Weights(embed=embed, input_norm=model.input_norm,
                      post_norm=model.post_norm, final_norm=model.final_norm,
                      layers=layers, bias=bias, head=head)
    return model, weights


def dense_shapes(shape: dict) -> Dict[str, tuple]:
    """``(out, in)`` of each dense linear of one layer."""
    p = work.products(shape)
    (H, q), (I2, _) = p["o"], p["gateup"]
    kv = (p["qkv"][0] - q) // 2
    return dict(zip(LINEARS, ((q, H), (kv, H), (kv, H), (H, q), (I2 // 2, H),
                              (I2 // 2, H), (H, I2 // 2))))


def build_dense(shape: dict, quant: dict, gen: torch.Generator, device):
    """A dense bf16 model in the port's ``init_params`` layout: each
    linear's layers from one ``randn`` call, scaled by ``1 / sqrt(in)`` so
    every product keeps unit RMS, the head to ``logit_rms``; unit norms,
    unit-normal embedding, q/k/v biases where the configuration has them."""
    from amq_tpu_torch.models.linear import DenseLinear
    L, H, V = (shape["num_hidden_layers"], shape["hidden_size"],
               shape["vocab_size"])

    def randn(*size, gain=1.0):
        t = torch.randn(size, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return t.mul_(gain / math.sqrt(size[-1]))

    stacks = {n: randn(L, o, i) for n, (o, i) in dense_shapes(shape).items()}
    bias = {n: None for n in LINEARS}
    if shape.get("qkv_bias"):
        for n in LINEARS[:3]:
            bias[n] = torch.randn((L, stacks[n].shape[1]), generator=gen,
                                  device=device).mul_(0.02).to(torch.bfloat16)
    ones = torch.ones((L, H), dtype=torch.bfloat16, device=device)
    layers = [dict({n: DenseLinear(weight=stacks[n][i],
                                   bias=None if bias[n] is None else bias[n][i])
                    for n in LINEARS},
                   input_norm=ones[i], post_norm=ones[i])
              for i in range(L)]
    return {"embed": randn(V, H, gain=math.sqrt(H)), "layers": layers,
            "final_norm": ones[0],
            "lm_head": DenseLinear(weight=randn(V, H, gain=quant["logit_rms"]))}


def rtn(weight: torch.Tensor, bits: int, group: int) -> Packed:
    """The round-to-nearest proxy of a dense ``[out, in]`` weight
    (``perfbench.reference.quant.rtn``), packed in the port's pair-planar
    layout at its padded superblock: made in set-up in place of the HQQ
    build, which is a stage of its own."""
    from amq_tpu_torch.core.bitpack import pack, pick_superblock_padded
    codes, scale, zero = quant.rtn(weight, bits, group)
    out_f, in_f = codes.shape
    sb, k_pad = pick_superblock_padded(in_f, group)
    codes_kn = F.pad(codes.T.to(torch.int64), (0, 0, 0, k_pad))
    meta = [F.pad(t.T, (0, 0, 0, k_pad // group)).contiguous()
            for t in (scale, zero)]
    return Packed(pack(codes_kn, bits, sb), meta[0], meta[1], bits, group,
                  sb, out_f, in_f)


def proxy(params: dict, bits: int, group: int) -> dict:
    """The dense model with every linear replaced by its :func:`rtn` proxy
    at ``bits``, in the layout ``quantize_model`` returns."""
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.models.linear import QuantLinear
    layers = []
    for lay in params["layers"]:
        new = dict(lay)
        for n in LINEARS:
            p = rtn(lay[n].weight, bits, group)
            new[n] = QuantLinear(qt=QuantizedTensor(
                packed=p.packed, scale=p.scale, zero=p.zero, nbits=bits,
                group_size=group, shape=(p.n, p.k), superblock=p.superblock),
                bias=lay[n].bias)
        layers.append(new)
    return dict(params, layers=layers)
