"""Whole-model quantization over ``init_params``-shaped parameter dicts.

:func:`quantize_model` builds the per-bit HQQ proxies the speed CLI
stacks; :func:`uniform_arch` is the all-one-width architecture.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..core import quantize as qcore
from .config import LINEAR_NAMES, ModelConfig
from .linear import DenseLinear, QuantLinear

Arch = Dict[str, Dict[str, List[int]]]  # {'linear': {site: [bits]*n_block}}


def uniform_arch(cfg: ModelConfig, bits: int) -> Arch:
    return {"linear": {l: [bits] * cfg.num_layers for l in LINEAR_NAMES}}


def quantize_model(params: Dict[str, Any], cfg: ModelConfig, arch_or_bits,
                   group_size: int = 128, meta_dtype=torch.float32,
                   optimize: bool = True,
                   superblock: Optional[int] = None) -> Dict[str, Any]:
    """Quantize every decoder linear; embeddings, norms and lm_head stay
    dense.  Each weight is quantized on the device it lives on;
    ``optimize=False`` skips the proximal zero-point solver;
    ``superblock`` fixes the packing block (default: the padded pick)."""
    arch = (uniform_arch(cfg, arch_or_bits)
            if isinstance(arch_or_bits, int) else arch_or_bits)
    out = dict(params)
    out_layers = []
    for i, layer in enumerate(params["layers"]):
        new_layer = dict(layer)
        for name in LINEAR_NAMES:
            p = layer[name]
            assert isinstance(p, DenseLinear), (name, type(p))
            qt = qcore.quantize(p.weight, nbits=int(arch["linear"][name][i]),
                                group_size=group_size, meta_dtype=meta_dtype,
                                optimize=optimize, superblock=superblock)
            new_layer[name] = QuantLinear(qt=qt, bias=p.bias)
        out_layers.append(new_layer)
    out["layers"] = out_layers
    return out
