"""Linear-layer application over interchangeable weight representations.

* :class:`DenseLinear` ``[out, in]`` -- plain matmul,
* :class:`QuantLinear` -- dequantize-then-matmul (the dequantization
  through :func:`dequantize_weight`), or the fused CUDA dequant-matmul
  (``ops.quant_matmul``) while :class:`kernel_linears` has installed a
  kernel implementation,
* :class:`ProxySwitch` -- per-bit proxies of one linear and the index of
  the one applied,
* :class:`OWQLinear` -- OWQ's packed serving form
  (``quantization.owq.owq_matmul``: the dequant-matmul over the compacted
  non-outlier columns, on the kernel while :class:`kernel_linears` is
  active, plus the float outlier tail).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from ..core.quantize import QuantizedTensor, dequantize_kn


@dataclasses.dataclass
class DenseLinear:
    weight: torch.Tensor                  # [out, in]
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class QuantLinear:
    qt: QuantizedTensor
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class OWQLinear:
    """One linear in OWQ packed serving form."""

    packed: "object"        # quantization.owq.OWQPacked
    bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ProxySwitch:
    """Per-bit proxy quantizations of one linear and the index of the one
    applied (the JAX package's switch leaf; ``select`` indexes
    ``proxies``, ordered by bits_range)."""

    proxies: Sequence[QuantLinear]
    select: int = 0


LinearParams = Union[DenseLinear, QuantLinear, OWQLinear, ProxySwitch]

# Optional fused-kernel implementation for QuantLinear application,
# installed by the serving engine for the duration of a forward.  None ->
# dequantize-then-matmul.
_KERNEL_IMPL = None

#: False inside ``llama.forward_kernels(False)``: the dequantize-then-matmul
#: routes take the plain dequantization
_DEQUANT_KERNEL = True


class kernel_linears:
    """Context manager routing QuantLinear matmuls through ``impl``."""

    def __init__(self, impl):
        self.impl = impl

    def __enter__(self):
        global _KERNEL_IMPL
        self._old = _KERNEL_IMPL
        _KERNEL_IMPL = self.impl
        return self

    def __exit__(self, *exc):
        global _KERNEL_IMPL
        _KERNEL_IMPL = self._old
        return False


def kernels_active() -> bool:
    return _KERNEL_IMPL is not None


def matmul_f32(x: torch.Tensor, wt: torch.Tensor, bias,
               compute_dtype) -> torch.Tensor:
    """``x @ wt (+ b)`` with inputs rounded to ``compute_dtype``, the
    product accumulated in float32 (the JAX ``preferred_element_type``)
    and rounded back to ``compute_dtype``.  Below float32 the library
    matmul takes the rounded inputs as they are (it accumulates in float32
    and rounds once; on the card that is the tensor-core path), and a bias
    joins after that rounding."""
    if compute_dtype != torch.float32:
        y = torch.matmul(x.to(compute_dtype), wt.to(compute_dtype))
        if bias is None:
            return y
        return (y.float() + bias.float()).to(compute_dtype)
    y = torch.matmul(x.float(), wt.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(compute_dtype)


def matmul_out_f32(x: torch.Tensor, wt: torch.Tensor,
                   compute_dtype) -> torch.Tensor:
    """``x @ wt`` -> float32 with both operands in ``compute_dtype``: the
    JAX ``jnp.dot(..., preferred_element_type=float32)`` of the logits
    (``x`` arrives in ``compute_dtype``).  A bf16 call on the card is one
    bf16 x bf16 product accumulated in f32 (``aten::mm.dtype``, the
    tensor-core route); float32 and the CPU (which has no ``mm.dtype``)
    take a float32 product of the same values (a bf16 product is exact in
    f32)."""
    if compute_dtype == torch.bfloat16 and x.device.type == "cuda":
        x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        y = torch.mm(x2, wt.to(torch.bfloat16), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], wt.shape[-1])
    return torch.matmul(x.float(), wt.to(compute_dtype).float())


def dequantize_weight(qt: QuantizedTensor, dtype) -> torch.Tensor:
    """``[in, out]`` weight of a dequantize-then-matmul route: the CUDA
    kernel (``ops.dequant``, plain on a CPU tensor) unless
    ``llama.forward_kernels(False)`` asks for the plain version."""
    if not _DEQUANT_KERNEL:
        return dequantize_kn(qt, dtype)
    from ..ops.dequant import dequantize_kn as kernel
    return kernel(qt, dtype)


def apply_linear(p: LinearParams, x: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ W.T (+ b)`` for any weight representation. x: [..., in]."""
    if isinstance(p, DenseLinear):
        return matmul_f32(x, p.weight.T, p.bias, compute_dtype)
    if isinstance(p, QuantLinear):
        if _KERNEL_IMPL is not None:
            return _KERNEL_IMPL(p, x, compute_dtype)
        wt = dequantize_weight(p.qt, compute_dtype)     # [in, out]
        return matmul_f32(x, wt, p.bias, compute_dtype)
    if isinstance(p, ProxySwitch):
        return apply_linear(p.proxies[int(p.select)], x, compute_dtype)
    if isinstance(p, OWQLinear):
        from ..quantization.owq import owq_matmul
        y = owq_matmul(x, p.packed, out_dtype=compute_dtype,
                       use_kernel=_KERNEL_IMPL is not None)
        if p.bias is not None:
            y = y + p.bias.to(y.dtype)
        return y
    raise TypeError(f"unsupported linear params: {type(p)}")
