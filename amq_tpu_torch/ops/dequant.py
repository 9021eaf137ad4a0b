"""Dequantization to the ``[in, out]`` layout: wrapper and plain version.

The JAX package dequantizes outside any Pallas kernel
(``core/quantize.py`` ``dequantize_kn``, one XLA fusion); the port's
dequantize-then-matmul routes (evaluation linears, prefill at M >= 256)
launch a hand-written one-pass kernel instead (``csrc/dequant.cu``: each
packed word read once, ``[K, N]`` written once in float32 or bfloat16,
the plain version's bits).  The plain version is
``core.quantize.dequantize_kn``, taken only for CPU tensors; a CUDA tensor
launches the kernel or raises.  ``dequantize_kn.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.quantize import QuantizedTensor
from ..core.quantize import dequantize_kn as dequantize_kn_plain
from . import _cuda


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("dequant").amq_dequant_kn
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, p, i, i, i, i, i, i, i, i, p]
    fn.restype = i
    return fn


def _dequant_cuda(qt: QuantizedTensor, dtype) -> torch.Tensor:
    K, N = qt.in_features, qt.out_features
    R, Np = qt.packed.shape
    sb, g = qt.superblock_, qt.group_size
    what = f"dequantize_kn ({qt.nbits}-bit, K={K}, N={N})"
    out_flag = _cuda.dtype_flag(torch.empty(0, dtype=dtype), what)
    if qt.packed.dtype != torch.int32:
        raise TypeError(f"{what}: packed words must be int32, got "
                        f"{qt.packed.dtype}")
    if qt.scale.dtype != qt.zero.dtype:
        raise TypeError(f"{what}: scale {qt.scale.dtype} vs zero "
                        f"{qt.zero.dtype}")
    if any(t.device != qt.packed.device for t in (qt.scale, qt.zero)):
        raise ValueError(f"{what}: tensors on different devices")
    if not all(t.is_contiguous() for t in (qt.packed, qt.scale, qt.zero)):
        raise ValueError(f"{what}: packed/scale/zero must be contiguous")
    Kp = R * 32 // qt.nbits
    if (Kp % sb or sb % g or K > Kp or N > Np
            or qt.scale.shape != (Kp // g, Np)
            or qt.zero.shape != qt.scale.shape):
        raise ValueError(f"{what}: packed {tuple(qt.packed.shape)}, scale "
                         f"{tuple(qt.scale.shape)}, superblock {sb}, group "
                         f"{g} do not fit")
    out = torch.empty((K, N), dtype=dtype, device=qt.packed.device)
    ptr = _cuda.ptr
    rc = _lib()(ptr(qt.packed), ptr(qt.scale), ptr(qt.zero),
                _cuda.dtype_flag(qt.scale, what), ptr(out), out_flag,
                K, N, Np, qt.nbits, g, sb, -(-K // sb), _cuda.stream())
    _cuda.check(rc, what)
    return out


def dequantize_kn(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """``core.quantize.dequantize_kn`` through ``csrc/dequant.cu`` on a
    CUDA tensor (every width of ``bitpack.SUPPORTED_BITS``; float32 or
    bfloat16 out); CPU tensors take the plain version."""
    if qt.packed.device.type == "cpu":
        return dequantize_kn_plain(qt, dtype)
    if qt.packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {qt.packed.device}")
    out = _dequant_cuda(qt, dtype)
    dequantize_kn.launches += 1
    return out


dequantize_kn.launches = 0
