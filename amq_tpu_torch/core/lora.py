"""Low-rank adapters over quantized linears.

The port of the JAX package's ``core/lora.py`` (HQQ's ``HQQLinearLoRA``
inference pieces): ``y = W_q(x) + scaling * (x @ A) @ B`` and merging an
adapter into the packed weight (dequantize, add, requantize).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.linear import QuantLinear, apply_linear
from . import quantize as qcore


@dataclasses.dataclass
class LoRAAdapter:
    A: torch.Tensor          # [in, r]
    B: torch.Tensor          # [r, out]
    scaling: float = 1.0


def init_adapter(generator: torch.Generator, in_features: int,
                 out_features: int, rank: int = 8, scaling: float = 1.0,
                 dtype=torch.float32, device="cpu") -> LoRAAdapter:
    """A drawn from ``generator`` (normal / sqrt(rank)), B zero: the
    adapter starts as the identity."""
    A = torch.randn((in_features, rank), generator=generator,
                    dtype=torch.float32, device=device) / math.sqrt(rank)
    B = torch.zeros((rank, out_features), dtype=dtype, device=device)
    return LoRAAdapter(A=A.to(dtype), B=B, scaling=scaling)


def apply_lora_linear(p: QuantLinear, adapter: Optional[LoRAAdapter],
                      x: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    y = apply_linear(p, x, compute_dtype)
    if adapter is not None:
        lo = x.to(compute_dtype) @ adapter.A.to(compute_dtype)
        lo = lo @ adapter.B.to(compute_dtype)
        y = y + adapter.scaling * lo.to(y.dtype)
    return y


def merge_adapter(p: QuantLinear, adapter: LoRAAdapter) -> QuantLinear:
    """Fold the adapter into the packed weight: dequantize, add
    ``scaling * (A @ B)^T``, requantize at the same configuration."""
    W = qcore.dequantize(p.qt)                           # [out, in]
    delta = (adapter.A @ adapter.B).T * adapter.scaling
    qt = qcore.quantize(W + delta.to(W.dtype), nbits=p.qt.nbits,
                        group_size=p.qt.group_size,
                        superblock=p.qt.superblock or None)
    return QuantLinear(qt=qt, bias=p.bias)
