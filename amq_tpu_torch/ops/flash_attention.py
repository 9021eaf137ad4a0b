"""Blockwise (flash) causal attention: wrapper and plain version.

Replaces ``flash_attention`` (kernel ``_flash_kernel``) of the JAX
package's ``ops/flash_attention.py``, with its layout: q ``[B, Hq, S, d]``,
k/v ``[B, Hkv, T, d]``, output ``[B, Hq, S, d]`` in q's dtype.  Query row
``i`` sits at absolute position ``offset + i`` and attends keys
``j <= offset + i`` (and ``j < T``); GQA maps query head ``h`` to KV head
``h // (Hq // Hkv)``.  The CUDA kernels (``csrc/flash_attention.cu``) run
for CUDA tensors, the plain version below for CPU tensors only.

On the H100 the kernel is bound by operations (hundreds of flops per byte
at the evaluation shape), so bf16 inputs run both products on the tensor
cores: warpgroup MMA (``wgmma``) over 128-query blocks, 64-key K/V tiles
streamed through a two-stage ``cp.async`` ring while the previous tile is
multiplied, the softmax in registers and P fed to the PV product from
registers.  Its scores are scaled in f32 after the product (the JAX kernel
scales q first).  f32 inputs (PTQ calibration, float32 evaluation) run
both products on the tensor cores in split TF32 (3xTF32, ``mma.sync``):
every operand is split into two TF32 values, hi and lo, and each product
is taken as lo*hi + hi*lo + hi*hi in f32.  One TF32 product would miss
the JAX suite's 2e-4 (about 1e-3 at S = T = 2048, d 128); the split
misses the f32 function by about 1e-6 there
(``tests/test_torch_flash_tf32.py`` emulates both).  The top of the CUDA
source sets the design out.  ``flash_attention.f32_launches`` counts the
f32 kernel's launches among ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("flash_attention").amq_flash_attention
    fn.argtypes = [_c_ptr] * 5 + [_c_int] * 8 + [_c_ptr]
    fn.restype = _c_int
    return fn


def flash_attention_plain(q, k, v, offset=None, causal: bool = True):
    """The kernel's function in plain PyTorch: f32 scores ``(q * scale) . k``,
    masked scores -1e30, softmax probabilities rounded to v's dtype before
    the PV product (the denominator sums them unrounded), ``l == 0 -> 1``."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(B, Hkv, G, S, d)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    k_pos = torch.arange(T, device=q.device)
    if causal:
        off = 0 if offset is None else torch.as_tensor(offset, device=q.device)
        q_pos = off + torch.arange(S, device=q.device)
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                        torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, Hq, S, d).to(q.dtype)


def _offset_tensor(offset, device) -> torch.Tensor:
    """``offset`` (None, int or a one-element tensor) as an int32 ``[1]``
    tensor on ``device``; a device tensor stays there (no host sync)."""
    if offset is None:
        return torch.zeros((1,), dtype=torch.int32, device=device)
    if isinstance(offset, int):
        return torch.full((1,), offset, dtype=torch.int32, device=device)
    if offset.numel() != 1:
        raise ValueError(f"flash_attention: offset must be a scalar, got "
                         f"shape {tuple(offset.shape)}")
    return offset.to(device=device, dtype=torch.int32).reshape(1).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    offset=None, *, causal: bool = True) -> torch.Tensor:
    """Blockwise attention -> ``[B, Hq, S, d]`` (see the module docstring).

    Call sites guarantee ``offset + S <= T`` for causal attention; keys at
    or beyond T are never attended."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, offset, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be 4-d")
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    what = f"flash_attention (B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, T={T}, d={d})"
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: tensors on different devices")
    if k.shape != (B, Hkv, T, d) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"{what}: k/v shapes do not fit q")
    if d not in (64, 128) or B * Hq > 65535:
        raise ValueError(f"{what}: the kernel takes d 64/128 and B*Hq <= 65535")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v dtypes must agree")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    # the kernels read 16-byte chunks: a misaligned view is copied
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    off = _offset_tensor(offset, q.device)
    out = torch.empty_like(q)
    rc = _lib()(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(off),
                _cuda.ptr(out), _cuda.dtype_flag(q, what), B, Hq, Hkv, S, T,
                d, int(causal), _cuda.stream())
    _cuda.check(rc, what)
    flash_attention.launches += 1
    if q.dtype == torch.float32:
        flash_attention.f32_launches += 1
    return out


flash_attention.launches = 0
flash_attention.f32_launches = 0
