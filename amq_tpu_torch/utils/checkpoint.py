"""Quantized-model serialization: ``qmodel.npz`` + ``manifest.json``.

The port of the JAX package's ``utils/checkpoint.py``, in its file
format, so that either package reads what the other wrote:

* ``qmodel.npz`` holds every array under a dotted key (``embed``,
  ``final_norm``, ``lm_head.weight``, ``layers.<i>.input_norm``,
  ``layers.<i>.<site>.{packed,scale,zero,weight,bias}``); packed words are
  ``uint32``,
* ``manifest.json`` holds the model name, one entry per layer and site
  (``{"kind": "quant", nbits, group_size, shape, superblock}`` or
  ``{"kind": "dense"}``, ``"bias": true`` where there is one) and
  ``nonnative_dtypes``: the keys of bfloat16 arrays, stored as their
  ``uint16`` bits (the ``.npy`` format has no bfloat16) and kept bf16 on
  load.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.quantize import QuantizedTensor
from ..models.config import LINEAR_NAMES, ModelConfig, get_config
from ..models.linear import DenseLinear, QuantLinear

_BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor, key: str, nonnative: Dict[str, str],
              packed: bool = False) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        nonnative[key] = _BF16
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(np.uint32) if packed else a


def save_quantized(params: Dict[str, Any], cfg: ModelConfig, path: str,
                   extra_meta: Optional[Dict] = None) -> None:
    """Write ``params`` (dense or packed linears) under ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"model": cfg.name, "layers": [],
                                "nonnative_dtypes": {}, **(extra_meta or {})}
    nonnative = manifest["nonnative_dtypes"]

    def put(key, t, packed=False):
        arrays[key] = _to_numpy(t, key, nonnative, packed)

    put("embed", params["embed"])
    put("final_norm", params["final_norm"])
    if "lm_head" in params:
        put("lm_head.weight", params["lm_head"].weight)
    for i, layer in enumerate(params["layers"]):
        lman: Dict[str, Any] = {}
        put(f"layers.{i}.input_norm", layer["input_norm"])
        put(f"layers.{i}.post_norm", layer["post_norm"])
        for name in LINEAR_NAMES:
            p = layer[name]
            base = f"layers.{i}.{name}"
            if isinstance(p, QuantLinear):
                put(f"{base}.packed", p.qt.packed, packed=True)
                put(f"{base}.scale", p.qt.scale)
                put(f"{base}.zero", p.qt.zero)
                lman[name] = {"kind": "quant", "nbits": p.qt.nbits,
                              "group_size": p.qt.group_size,
                              "shape": list(p.qt.shape),
                              "superblock": p.qt.superblock_}
            else:
                put(f"{base}.weight", p.weight)
                lman[name] = {"kind": "dense"}
            if p.bias is not None:
                put(f"{base}.bias", p.bias)
                lman[name]["bias"] = True
        manifest["layers"].append(lman)

    np.savez(os.path.join(path, "qmodel.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_quantized(path: str, dtype=torch.float32,
                   device="cpu") -> tuple[Dict[str, Any], ModelConfig]:
    """``(params, cfg)`` from ``path``, every array going straight to
    ``device``.  Float arrays become ``dtype``, except the bf16 ones named
    in ``nonnative_dtypes`` (narrow on purpose: serving metadata), which
    stay bf16; packed words are int32 with the stored bits."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    cfg = get_config(manifest["model"])
    nonnative = manifest.get("nonnative_dtypes", {})
    device = torch.device(device)

    with np.load(os.path.join(path, "qmodel.npz")) as blob:
        def get(key, cast=True):
            raw = blob[key]
            if key in nonnative:
                if nonnative[key] != _BF16:
                    raise ValueError(f"{key}: unknown stored dtype "
                                     f"{nonnative[key]!r}")
                t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
                return t.to(device)
            if raw.dtype == np.uint32:
                return torch.from_numpy(raw.view(np.int32)).to(device)
            t = torch.from_numpy(raw).to(device)
            return t.to(dtype) if cast and t.is_floating_point() else t

        params: Dict[str, Any] = {"embed": get("embed"),
                                  "final_norm": get("final_norm"),
                                  "layers": []}
        if "lm_head.weight" in blob.files:
            params["lm_head"] = DenseLinear(weight=get("lm_head.weight"))
        for i, lman in enumerate(manifest["layers"]):
            layer: Dict[str, Any] = {
                "input_norm": get(f"layers.{i}.input_norm"),
                "post_norm": get(f"layers.{i}.post_norm"),
            }
            for name in LINEAR_NAMES:
                base = f"layers.{i}.{name}"
                m = lman[name]
                bias = get(f"{base}.bias") if m.get("bias") else None
                if m["kind"] == "quant":
                    qt = QuantizedTensor(
                        packed=get(f"{base}.packed", cast=False),
                        scale=get(f"{base}.scale"), zero=get(f"{base}.zero"),
                        nbits=m["nbits"], group_size=m["group_size"],
                        shape=tuple(m["shape"]),
                        superblock=m.get("superblock", m["group_size"]))
                    layer[name] = QuantLinear(qt=qt, bias=bias)
                else:
                    layer[name] = DenseLinear(weight=get(f"{base}.weight"),
                                              bias=bias)
            params["layers"].append(layer)
    return params, cfg
