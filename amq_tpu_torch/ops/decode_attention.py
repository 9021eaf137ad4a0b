"""Decode attention over the stacked KV cache: wrapper and plain version.

Replaces ``decode_attention_indexed`` (kernel ``_attn_kernel``) of the JAX
package's ``ops/decode_attention.py``.  Single-query attention for one
layer of the stacked ``[L, B, Hkv, T, hd]`` cache with per-row live
lengths ``offsets[B]`` (a device tensor, read inside the kernel), GQA, an
optional sliding window (keys with ``t > off - window``), and this step's
key/value as a final column -- the cache is read-only inside the layer
loop.  The CUDA kernel (``csrc/decode_attention.cu``) runs for CUDA
tensors, the plain version below for CPU tensors only.

On the H100 the kernel is bound by bytes: each live key and value row is
read once per KV head, about 4 operations per byte.  It is a split
flash-decode: the grid is (split, row x KV head), a row's live keys cut
into splits of :func:`split_plan`'s length from the row's own window start
(so a row's result does not depend on the batch), the grid's split count
from the cache's capacity T (one launch shape for every offset, so a CUDA
graph replays it under changing device offsets); each block's eight warps
take contiguous shares with their own online softmax, merged in fixed warp
order; several splits leave their (max, sum, accumulator) states in scratch
that ``decode_attn_kernel_merge`` merges in split order (deterministic, no
atomics).  T within one split is the single-block route: one launch, no
scratch.  bf16 q and cache at G > 1 run on the tensor cores (``mma.sync``,
all G <= 8 heads of a KV head in one pass, p in two bf16 parts before PV,
so f32 accuracy); G = 1 and the f32 forms on the CUDA cores.  At the chat
cells' shapes a call reads 21-170 MB (6-51 us at 3.35 TB/s).  The top of
the CUDA source sets the design out; :func:`decode_attention_split_plain`
repeats its split-and-merge order.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch

from . import _cuda

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("decode_attention").amq_decode_attention
    fn.argtypes = [_c_ptr] * 8 + [_c_int] * 10 + [_c_ptr]
    fn.restype = _c_int
    return fn


#: K bytes a split holds per KV head of the model: span 64 Hkv keys at hd
#: 128 in bf16, so a row's Hkv heads spread its live keys over about
#: live / 64 blocks whatever Hkv is (~20 at ~1300 keys: B 8 gives ~190
#: live blocks, 1.5 an SM at two resident).  Tuned on the H100 at the chat
#: cells' shapes (B 8 / 32, offsets 700-1900, T 4096): spans of half and a
#: quarter this took 4-12 % longer, double it 5 % longer at Hkv 4.
_SPLIT_BYTES = 16384
#: at least one 16-key tensor-core step for each of a block's 8 warps; at
#: most 128 keys a warp, so B 1 at long contexts still spreads
_MIN_SPAN, _MAX_SPAN = 128, 1024


def split_plan(Hkv: int, hd: int, T: int, cache_bytes: int) -> Tuple[int, int]:
    """(keys a split holds, splits in the grid) of a call on a cache of
    capacity ``T`` in elements of ``cache_bytes``.  The split length comes
    from the model's shape alone (never B or the live lengths), a power of
    two; one split (``T <= span``) is the single-block route."""
    want = _SPLIT_BYTES * Hkv // (hd * cache_bytes)
    span = min(_MAX_SPAN, max(_MIN_SPAN, 1 << max(want - 1, 0).bit_length()))
    return span, -(-T // span)


def split_ranges(off: int, window: Optional[int], span: int,
                 T: int) -> List[Tuple[int, int]]:
    """The live splits of one row, in split order: ``[lo, hi)`` key ranges
    cut from the row's own ``[t_lo, off)`` (its offset, clipped to ``T``,
    and window) every ``span`` keys."""
    off = min(max(off, 0), T)
    t_lo = max(0, off - window + 1) if window else 0
    return [(lo, min(off, lo + span)) for lo in range(t_lo, off, span)]


def decode_attention_split_plain(q, k_layer, v_layer, k_new, v_new, offsets,
                                 window: Optional[int] = None,
                                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's split-and-merge order in plain float32 PyTorch (a test
    yardstick, not a route): each live split's (max, sum, accumulator),
    merged in split order, then the new column.  Same signature and
    result as :func:`decode_attention_plain` up to summation order."""
    B, Hkv, G, hd = q.shape
    T = k_layer.shape[2]
    span, _ = split_plan(Hkv, hd, T, k_layer.element_size())
    inv = 1.0 / math.sqrt(hd)
    out = torch.empty((B, Hkv, G, hd), dtype=torch.float32, device=q.device)
    for b in range(B):
        qb = q[b].float()                                   # [Hkv, G, hd]
        mw = torch.full((Hkv, G, 1), -1e30, device=q.device)
        lw = torch.zeros((Hkv, G, 1), device=q.device)
        aw = torch.zeros((Hkv, G, hd), device=q.device)
        for lo, hi in split_ranges(int(offsets[b]), window, span, T):
            s = torch.einsum("hgd,htd->hgt", qb,
                             k_layer[b, :, lo:hi].float()) * inv
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            a = torch.einsum("hgt,htd->hgd", p, v_layer[b, :, lo:hi].float())
            mx = torch.maximum(mw, m)
            fw, fs = torch.exp(mw - mx), torch.exp(m - mx)
            lw = lw * fw + p.sum(-1, keepdim=True) * fs
            aw = aw * fw + a * fs
            mw = mx
        s1 = torch.einsum("hgd,hd->hg", qb, k_new[b].float())[..., None] * inv
        mf = torch.maximum(mw, s1)
        corr, p1 = torch.exp(mw - mf), torch.exp(s1 - mf)
        out[b] = ((aw * corr + p1 * v_new[b].float()[:, None, :])
                  / (lw * corr + p1))
    return out.to(out_dtype)


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
    span, splits = split_plan(Hkv, hd, T, k_cache.element_size())
    out = torch.empty((B, Hkv, G, hd), dtype=out_dtype, device=q.device)
    # the splits' states; freed on return, so the layers of a step (and of
    # a captured graph) reuse one block of the allocator's
    part = (torch.empty((B * Hkv * splits * G * (hd + 2),),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    rc = _lib()(_cuda.ptr(q), _cuda.ptr(k_layer), _cuda.ptr(v_layer),
                _cuda.ptr(k_new), _cuda.ptr(v_new), _cuda.ptr(offsets),
                _cuda.ptr(out), _cuda.ptr(part), _cuda.dtype_flag(q, what),
                _cuda.dtype_flag(k_cache, what), _cuda.dtype_flag(out, what),
                B, Hkv, G, T, hd, int(window or 0), span, _cuda.stream())
    _cuda.check(rc, what)
    decode_attention_indexed.launches += 1
    decode_attention_indexed.split_launches += splits > 1
    return out


decode_attention_indexed.launches = 0
#: the calls that took the split route (several splits and the merge)
decode_attention_indexed.split_launches = 0
