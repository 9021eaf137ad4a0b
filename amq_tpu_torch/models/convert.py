"""Carry the JAX package's parameters across to the port.

The input is framework-neutral: a flat ``{path: np.ndarray}`` dict plus a
dict of static fields, so the port never sees a JAX type.  Packed words
arrive as ``uint32`` and are held as ``int32`` with the same bits;
``bfloat16`` arrays (numpy's ml_dtypes type) keep their bits.

Dense ``init_params`` layout (:func:`params_from_flat`)::

    embed, final_norm, lm_head/weight (absent when tied)
    layers/<i>/input_norm, layers/<i>/post_norm
    layers/<i>/<site>/weight, layers/<i>/<site>/bias (optional)
    layers/<i>/<site>/qt/{packed,scale,zero} for a quantized linear, with
    static["layers/<i>/<site>/qt"] = {nbits, group_size, shape, superblock}
    layers/<i>/<site>/owq/qt/{packed,scale,zero}, .../owq/w_out for an OWQ
    packed linear, with static[".../owq/qt"] as above and
    static[".../owq"] = {segments, out_ids}

MLP surrogate (:func:`mlp_from_flax`): the flax ``params`` of the JAX
``predictor.mlp._Net`` as numpy, ``{"Dense_<i>": {"kernel": [in, out],
"bias": [out]}}``, the last Dense being the regressor.

Stacked serving model (:func:`stacked_from_flat`)::

    embed, final_norm, lm_head (optional), input_norm, post_norm
    sites/<site>/<j>/{packed,scale,zero}, biases/<site> (optional)
    lm_head_qt/{packed,scale,zero} (optional)
    static: sites {site: [{nbits, group_size, shape, superblock}, ...]},
            select {site: [int]*L}, slots ([int]*L or None), bits_range,
            num_layers, uniform_select, lm_head_qt ({...} or None)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..core.quantize import QuantizedTensor
from .config import LINEAR_NAMES
from .linear import DenseLinear, OWQLinear, QuantLinear
from .stacked import StackedModel, StackedQuant


def to_tensor(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> torch with the same bits (uint32 -> int32, bf16 kept)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32).copy())
    elif a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _qt(flat: Mapping[str, np.ndarray], static: Mapping[str, Any], key: str,
        device) -> QuantizedTensor:
    meta = static[key]
    return QuantizedTensor(
        packed=to_tensor(flat[f"{key}/packed"], device),
        scale=to_tensor(flat[f"{key}/scale"], device),
        zero=to_tensor(flat[f"{key}/zero"], device),
        nbits=int(meta["nbits"]), group_size=int(meta["group_size"]),
        shape=tuple(int(s) for s in meta["shape"]),
        superblock=int(meta["superblock"]))


def params_from_flat(flat: Mapping[str, np.ndarray],
                     static: Mapping[str, Any], num_layers: int,
                     device="cpu") -> Dict[str, Any]:
    """An ``init_params``-shaped dict (dense, quantized or OWQ-packed
    linears)."""
    def opt(key):
        return to_tensor(flat[key], device) if key in flat else None

    layers = []
    for i in range(num_layers):
        pre = f"layers/{i}"
        layer: Dict[str, Any] = {
            "input_norm": to_tensor(flat[f"{pre}/input_norm"], device),
            "post_norm": to_tensor(flat[f"{pre}/post_norm"], device),
        }
        for name in LINEAR_NAMES:
            bias = opt(f"{pre}/{name}/bias")
            if f"{pre}/{name}/owq" in static:
                from ..quantization.owq import OWQPacked
                key = f"{pre}/{name}/owq"
                layer[name] = OWQLinear(packed=OWQPacked.from_layout(
                    _qt(flat, static, f"{key}/qt", device),
                    to_tensor(flat[f"{key}/w_out"], device),
                    [tuple(s) for s in static[key]["segments"]],
                    static[key]["out_ids"]), bias=bias)
            elif f"{pre}/{name}/qt" in static:
                layer[name] = QuantLinear(
                    qt=_qt(flat, static, f"{pre}/{name}/qt", device), bias=bias)
            else:
                layer[name] = DenseLinear(
                    weight=to_tensor(flat[f"{pre}/{name}/weight"], device),
                    bias=bias)
        layers.append(layer)
    params: Dict[str, Any] = {
        "embed": to_tensor(flat["embed"], device),
        "final_norm": to_tensor(flat["final_norm"], device),
        "layers": layers,
    }
    if "lm_head/weight" in flat:
        params["lm_head"] = DenseLinear(
            weight=to_tensor(flat["lm_head/weight"], device))
    return params


def stacked_from_flat(flat: Mapping[str, np.ndarray],
                      static: Mapping[str, Any], device="cpu") -> StackedModel:
    """A :class:`StackedModel` with its per-bit stacks and packed head."""
    sites = {}
    for name, metas in static["sites"].items():
        sites[name] = tuple(
            StackedQuant(
                packed=to_tensor(flat[f"sites/{name}/{j}/packed"], device),
                scale=to_tensor(flat[f"sites/{name}/{j}/scale"], device),
                zero=to_tensor(flat[f"sites/{name}/{j}/zero"], device),
                nbits=int(m["nbits"]), group_size=int(m["group_size"]),
                shape=tuple(int(s) for s in m["shape"]),
                superblock=int(m["superblock"]))
            for j, m in enumerate(metas))
    biases = {name: (to_tensor(flat[f"biases/{name}"], device)
                     if f"biases/{name}" in flat else None)
              for name in sites}
    head_qt = (_qt(flat, static, "lm_head_qt", device)
               if static.get("lm_head_qt") else None)
    slots = static.get("slots")
    return StackedModel(
        embed=to_tensor(flat["embed"], device),
        final_norm=to_tensor(flat["final_norm"], device),
        lm_head=to_tensor(flat["lm_head"], device) if "lm_head" in flat else None,
        input_norm=to_tensor(flat["input_norm"], device),
        post_norm=to_tensor(flat["post_norm"], device),
        sites=sites, biases=biases,
        select={name: [int(s) for s in sel]
                for name, sel in static["select"].items()},
        bits_range=tuple(int(b) for b in static["bits_range"]),
        num_layers=int(static["num_layers"]),
        uniform_select=bool(static["uniform_select"]),
        slots=None if slots is None else [int(s) for s in slots],
        lm_head_qt=head_qt)


def mlp_from_flax(params: Mapping[str, Mapping[str, np.ndarray]]):
    """A fitted :class:`~amq_tpu_torch.predictor.mlp.MLP` whose network
    carries the flax Dense layers (kernels transposed to ``[out, in]``)."""
    from ..predictor.mlp import MLP, _Net

    dense = [params[f"Dense_{i}"] for i in range(len(params))]
    n_in, n_hidden = dense[0]["kernel"].shape
    net = _Net(n_in, n_hidden, n_layers=len(dense) - 2)
    with torch.no_grad():
        for lin, p in zip([*net.hidden, net.out], dense):
            lin.weight.copy_(to_tensor(p["kernel"]).T)
            lin.bias.copy_(to_tensor(p["bias"]))
    mlp = MLP(n_hidden=n_hidden)
    mlp.net = net
    return mlp
