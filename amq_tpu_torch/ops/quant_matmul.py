"""Fused unpack -> dequantize -> matmul: wrappers and plain versions.

Each public function here replaces one Pallas kernel of the JAX package's
``ops/quant_matmul.py`` and has three parts:

* the CUDA kernel (``csrc/quant_matmul.cu``, one template over nbits in
  {1, 2, 3, 4, 8}: a decode GEMV for M <= 8, a dequantize-tile GEMM above),
  launched for CUDA tensors,
* a plain PyTorch version of the same function (dequantize in float32,
  then a float32 product), taken only for CPU tensors,
* a launch counter (``<function>.launches``), raised where the kernel is
  launched and nowhere else.

A CUDA tensor never reaches the plain version: the wrapper launches the
kernel or raises.  The kernels read the JAX storage layout as is (see
``core/bitpack.py``), take the layer of a stacked buffer as a view (no copy
of the layer), zero x over the K pad, and return only the logical N
columns.  What bounds them on the H100 (bytes) and what the design does
about it is set out at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..core.quantize import QuantizedTensor, dequantize_kn
from . import _cuda

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("quant_matmul").amq_qmm
    fn.argtypes = [_c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int,
                   _c_ptr, _c_int, _c_ptr] + [_c_int] * 11 + [_c_ptr]
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(M: int, N: int, n_sb: int, device) -> tuple:
    """(splits, superblocks per split) of the K axis: whole superblocks
    per split, enough blocks for about two per SM (64-column tiles; the
    prefill GEMM also tiles M by 64)."""
    blocks = -(-N // 64) * (1 if M <= 8 else -(-M // 64))
    want = max(1, min(n_sb, -(-2 * _sm_count(device.index or 0) // blocks)))
    per = -(-n_sb // want)
    return -(-n_sb // per), per


# ---------------------------------------------------------------------------
# plain versions (the CPU path; also the reference the kernels are held to)

def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in float32, rounded to the input type."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def qmm_plain(x, packed, scale, zero, *, nbits, group_size, shape,
              superblock, out_dtype, up=None) -> torch.Tensor:
    """x [M, K] @ dequant(packed) (float32 dequantization and product) ->
    [M, N]; with ``up`` the activation is ``silu(x) * up``."""
    if up is not None:
        x = swiglu_plain(x, up)
    qt = QuantizedTensor(packed=packed, scale=scale, zero=zero, nbits=nbits,
                         group_size=group_size, shape=tuple(shape),
                         superblock=superblock)
    return torch.matmul(x.float(), dequantize_kn(qt, torch.float32)).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel launch

def _qmm_cuda(x, up, packed, scale, zero, *, nbits, group_size, shape,
              superblock, out_dtype) -> torch.Tensor:
    N, K = shape
    M = x.shape[0]
    rows, Np = packed.shape
    Kp = rows * 32 // nbits
    what = f"quant_matmul ({nbits}-bit, M={M}, N={N}, K={K})"
    if nbits not in (1, 2, 3, 4, 8):
        raise ValueError(f"{what}: no kernel for {nbits}-bit")
    tensors = [x, packed, scale, zero] + ([up] if up is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if packed.dtype != torch.int32:
        raise TypeError(f"{what}: packed words must be int32, got {packed.dtype}")
    if scale.dtype != zero.dtype:
        raise TypeError(f"{what}: scale {scale.dtype} vs zero {zero.dtype}")
    if x.dim() != 2 or x.shape[1] != K or x.stride(1) != 1:
        raise ValueError(f"{what}: x must be [M, K] with unit column stride, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    if up is not None and (up.shape != x.shape or up.stride() != x.stride()
                           or up.dtype != x.dtype):
        raise ValueError(f"{what}: up must match gate in shape, strides, dtype")
    if not (packed.is_contiguous() and scale.is_contiguous()
            and zero.is_contiguous()):
        raise ValueError(f"{what}: packed/scale/zero must be contiguous")
    if (Kp % superblock or superblock % 64 or superblock % group_size
            or superblock > 1024 or K > Kp or N > Np
            or scale.shape != (Kp // group_size, Np) or zero.shape != scale.shape):
        raise ValueError(f"{what}: packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)}, superblock {superblock}, "
                         f"group {group_size} do not fit")
    splits, per = _splits(M, N, Kp // superblock, x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    rc = _lib()(_cuda.ptr(x), _cuda.ptr(up), _cuda.dtype_flag(x, what),
                _cuda.ptr(packed), _cuda.ptr(scale), _cuda.ptr(zero),
                _cuda.dtype_flag(scale, what), _cuda.ptr(out),
                _cuda.dtype_flag(out, what), _cuda.ptr(partial),
                M, K, x.stride(0), Kp, N, Np, nbits, group_size, superblock,
                splits, per, _cuda.stream())
    _cuda.check(rc, what)
    return out


def _qmm(x, up, packed, scale, zero, *, out_dtype, counter, **static):
    if x.device.type == "cpu":
        return qmm_plain(x, packed, scale, zero, out_dtype=out_dtype, up=up,
                         **static)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _qmm_cuda(x, up, packed, scale, zero, out_dtype=out_dtype, **static)
    counter.launches += 1
    return out


# ---------------------------------------------------------------------------
# public API

def quant_matmul_indexed(x: torch.Tensor, packed_stack: torch.Tensor,
                         scale_stack: torch.Tensor, zero_stack: torch.Tensor,
                         layer: int, *, nbits: int, group_size: int, shape,
                         superblock: int, out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ dequant(packed_stack[layer])`` -> ``[M, N]``.

    Replaces ``quant_matmul_indexed`` (kernel ``_qmm_kernel_stacked``) of
    the JAX package's ``ops/quant_matmul.py``.  ``layer`` is a host int
    (the layer loop runs in Python); ``packed_stack[layer]`` is a view.
    """
    return _qmm(x, None, packed_stack[layer], scale_stack[layer],
                zero_stack[layer], nbits=nbits, group_size=group_size,
                shape=tuple(shape), superblock=superblock,
                out_dtype=out_dtype or x.dtype, counter=quant_matmul_indexed)


quant_matmul_indexed.launches = 0


def quant_matmul_swiglu_indexed(gate: torch.Tensor, up: torch.Tensor,
                                packed_stack: torch.Tensor,
                                scale_stack: torch.Tensor,
                                zero_stack: torch.Tensor, layer: int, *,
                                nbits: int, group_size: int, shape,
                                superblock: int, out_dtype=None) -> torch.Tensor:
    """``silu(gate) * up @ dequant(packed_stack[layer])`` with the SwiGLU
    computed in the kernel's prologue (f32, rounded to the input type).

    Replaces ``quant_matmul_swiglu_indexed`` (kernel ``_qmm_kernel_swiglu``)
    of the JAX package's ``ops/quant_matmul.py``.
    """
    return _qmm(gate, up, packed_stack[layer], scale_stack[layer],
                zero_stack[layer], nbits=nbits, group_size=group_size,
                shape=tuple(shape), superblock=superblock,
                out_dtype=out_dtype or gate.dtype,
                counter=quant_matmul_swiglu_indexed)


quant_matmul_swiglu_indexed.launches = 0


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                 out_dtype=None) -> torch.Tensor:
    """``x @ W_dequant.T`` with W packed.  x: [..., K] -> [..., N].

    Replaces ``quant_matmul`` (``_quant_matmul_packed``, kernel
    ``_qmm_kernel``) of the JAX package's ``ops/quant_matmul.py``.  5/6-bit
    take :func:`quant_matmul_reference`, as in the JAX package.
    """
    lead = x.shape[:-1]
    K = x.shape[-1]
    assert K == qt.in_features, (tuple(x.shape), qt.shape)
    if qt.nbits not in (1, 2, 3, 4, 8):
        return quant_matmul_reference(x, qt, out_dtype=out_dtype)
    out = _qmm(x.reshape(-1, K), None, qt.packed, qt.scale, qt.zero,
               nbits=qt.nbits, group_size=qt.group_size, shape=tuple(qt.shape),
               superblock=qt.superblock_, out_dtype=out_dtype or x.dtype,
               counter=quant_matmul)
    return out.reshape(*lead, qt.out_features)


quant_matmul.launches = 0


def quant_matmul_reference(x: torch.Tensor, qt: QuantizedTensor,
                           out_dtype=None) -> torch.Tensor:
    """Dequantize (in x's dtype) then matmul with float32 accumulation --
    the JAX package's non-kernel path."""
    wt = dequantize_kn(qt, dtype=x.dtype)
    out = torch.matmul(x.float(), wt.float())
    return out.to(out_dtype or x.dtype)

