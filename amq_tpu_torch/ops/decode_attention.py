"""Decode attention over the stacked KV cache: wrapper and plain version.

Replaces ``decode_attention_indexed`` (kernel ``_attn_kernel``) of the JAX
package's ``ops/decode_attention.py``.  Single-query attention for one
layer of the stacked ``[L, B, Hkv, T, hd]`` cache with per-row live
lengths ``offsets[B]`` (a device tensor, read inside the kernel), GQA, an
optional sliding window (keys with ``t > off - window``), and this step's
key/value as a final column -- the cache is read-only inside the layer
loop.  The CUDA kernel (``csrc/decode_attention.cu``) runs for CUDA
tensors, the plain version below for CPU tensors only.

On the H100 the kernel is bound by bytes, but at decode sizes (a few
hundred KB per call) latency sets its time: it is a warp-split
flash-decode, eight warps per (row, KV head) each taking a contiguous
share of the row's live keys (set by the row's own offset, so a row's
result does not depend on the batch), 16-byte loads all issued before
use, a warp-local online softmax, and one merge of the warps' states in
fixed order (deterministic, no atomics).  The top of the CUDA source sets
the design out.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _cuda

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("decode_attention").amq_decode_attention
    fn.argtypes = [_c_ptr] * 7 + [_c_int] * 9 + [_c_ptr]
    fn.restype = _c_int
    return fn


def decode_attention_plain(q, k_layer, v_layer, k_new, v_new, offsets,
                           window: Optional[int] = None,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """q [B, Hkv, G, hd]; k/v_layer [B, Hkv, T, hd]; k/v_new [B, Hkv, hd];
    offsets [B] -> [B, Hkv, G, hd].  Float32 softmax over the live cache
    positions plus the new column."""
    B, Hkv, G, hd = q.shape
    T = k_layer.shape[2]
    qf = q.float()
    inv = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bhgd,bhtd->bhgt", qf, k_layer.float()) * inv
    sn = torch.einsum("bhgd,bhd->bhg", qf, k_new.float())[..., None] * inv
    off = offsets.to(device=q.device, dtype=torch.int64).reshape(B, 1, 1, 1)
    t_pos = torch.arange(T, device=q.device).reshape(1, 1, 1, T)
    ok = t_pos < off
    if window is not None:
        ok = ok & (t_pos > off - window)
    sc = torch.where(ok, sc, torch.full_like(sc, -1e30))
    probs = torch.softmax(torch.cat([sc, sn], dim=-1), dim=-1)
    out = (torch.einsum("bhgt,bhtd->bhgd", probs[..., :T], v_layer.float())
           + probs[..., T:] * v_new.float()[:, :, None, :])
    return out.to(out_dtype)


def decode_attention_indexed(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, offsets: torch.Tensor,
                             layer: int, window: Optional[int] = None,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Decode attention for layer ``layer`` of a stacked cache ->
    ``[B, Hkv, G, hd]``.  ``k_cache[layer]`` is a view, not a copy."""
    k_layer, v_layer = k_cache[layer], v_cache[layer]
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_layer, v_layer, k_new, v_new,
                                      offsets, window, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Hkv, G, hd = q.shape
    T = k_layer.shape[2]
    what = f"decode_attention (B={B}, Hkv={Hkv}, G={G}, hd={hd}, T={T})"
    tensors = (q, k_cache, v_cache, k_new, v_new, offsets)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if not all(t.is_contiguous() for t in (q, k_layer, v_layer, k_new, v_new,
                                           offsets)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if (k_layer.shape != (B, Hkv, T, hd) or v_layer.shape != k_layer.shape
            or k_new.shape != (B, Hkv, hd) or v_new.shape != k_new.shape
            or offsets.shape != (B,) or offsets.dtype != torch.int32):
        raise ValueError(f"{what}: shapes or offsets dtype do not fit")
    if hd not in (64, 128) or not 1 <= G <= 16:
        raise ValueError(f"{what}: the kernel takes hd 64/128 and G <= 16")
    if (k_new.dtype != q.dtype or v_new.dtype != q.dtype
            or v_cache.dtype != k_cache.dtype):
        raise TypeError(f"{what}: q/k_new/v_new and k/v cache dtypes must agree")
    out = torch.empty((B, Hkv, G, hd), dtype=out_dtype, device=q.device)
    rc = _lib()(_cuda.ptr(q), _cuda.ptr(k_layer), _cuda.ptr(v_layer),
                _cuda.ptr(k_new), _cuda.ptr(v_new), _cuda.ptr(offsets),
                _cuda.ptr(out), _cuda.dtype_flag(q, what),
                _cuda.dtype_flag(k_cache, what), _cuda.dtype_flag(out, what),
                B, Hkv, G, T, hd, int(window or 0), _cuda.stream())
    _cuda.check(rc, what)
    decode_attention_indexed.launches += 1
    return out


decode_attention_indexed.launches = 0
