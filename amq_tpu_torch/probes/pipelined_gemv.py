"""Extract-ahead decode GEMV on warpgroup MMA, against the production GEMV.

    python -m amq_tpu_torch.probes.pipelined_gemv [o|qkv|gu|down] [nbits...]

The counterpart of the JAX package's ``scripts/pipelined_gemv.py``.  Its
kernel (``csrc/gemv_extract_ahead.cu``) computes the TPU prototype's
grouped form

    y[n] = sum_g s_g * (x_g . (128 + c_g[:, n])) - s_g * (z_g + 128) * sum(x_g)

with an extractor warpgroup writing the bf16 codes (``(w >> s) & mask |
0x4300_4300``) of the next 64-row code stage into a shared-memory code
ring in wgmma's layout while a consumer warpgroup runs the current
stage's block-diagonal dot as ``wgmma`` m64n8k16 reading that ring, fed by
a producer warp's bulk copies.  K is split across blocks as the grouped
GEMV splits it.  M = 1; the output is ``[1, N]`` (the TPU kernel returns
an ``[8, N]`` tile whose rows 1-7 are zero).

For each width ``main`` first checks the kernel against its plain
version (:func:`extract_ahead_plain`) and against
``quant_matmul_reference`` on real ``core.quantize`` weights at the full
site shape, within the script's 2e-2 normalized limit, then chain-times
it and the production ``quant_matmul_indexed`` (``probes/chain.py``) over
a 40-layer random stack and prints both beside the byte bound.  On the
CPU (``device="cpu"``) only the checks run, on the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bitpack import unpack
from ..core.device import resolve_device
from ..core.quantize import quantize
from ..ops import _cuda
from ..ops import quant_matmul as qm
from . import chain

#: the script's limit: max |got - want| / max |want| (bf16 output, bf16
#: dot operands with f32 sums in another order)
TOL = 2e-2
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


def extract_ahead_plain(x, packed, scale, zero, *, nbits, group_size, shape,
                        superblock) -> torch.Tensor:
    """The grouped form on tensors: x rounded to bf16, codes + 128, f32 sums
    per group, then the correction; rounded to bf16 once.  ``[1, N]``."""
    N, K = shape
    Kp = packed.shape[0] * 32 // nbits
    G = Kp // group_size
    xb = F.pad(x[0].to(torch.bfloat16).float(), (0, Kp - K)).view(G, -1)
    codes = unpack(packed, nbits, superblock, dtype=torch.float32) + 128.0
    yp = torch.einsum("gk,gkn->gn", xb, codes.view(G, group_size, -1))
    s, z = scale.float(), zero.float()
    y = (s * yp - s * (z + 128.0) * xb.sum(1, keepdim=True)).sum(0)
    return y[None, :N].to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _cuda.library("gemv_extract_ahead").amq_gemv_extract_ahead
    fn.argtypes = [_c_ptr] * 6 + [_c_int] * 9 + [_c_ptr]
    fn.restype = _c_int
    return fn


#: K rows per code stage and columns per block (the kernel's kXK, kXBN)
STAGE_K = 64
BLOCK_N = 256


def _blocks(nbits: int, index: int) -> int:
    """Blocks of the kernel one SM holds."""
    fn = _cuda.library("gemv_extract_ahead").amq_gemv_extract_ahead_blocks
    fn.argtypes = [_c_int]
    fn.restype = _c_int
    with torch.cuda.device(index):
        return fn(nbits)


@functools.lru_cache(maxsize=None)
def _plan(N: int, Kp: int, nbits: int, index: int) -> tuple:
    """(splits, code stages per split): as many K splits as fit one wave
    of the kernel's blocks on the card (the grouped GEMV's rule, at code
    stage granularity), once per shape and card."""
    blocks = _blocks(nbits, index)
    if blocks < 1:
        raise RuntimeError(f"gemv_extract_ahead ({nbits}-bit): no block "
                           f"fits an SM ({blocks})")
    stages = Kp // STAGE_K
    want = max(1, min(stages, blocks * qm._sm_count(index)
                      // -(-N // BLOCK_N)))
    per = -(-stages // want)
    return -(-stages // per), per


def _extract_ahead_cuda(x, packed, scale, zero, *, nbits, group_size, shape,
                        superblock) -> torch.Tensor:
    N, K = shape
    rows, Np = packed.shape
    Kp = rows * 32 // nbits
    what = f"gemv_extract_ahead ({nbits}-bit, N={N}, K={K})"
    if nbits not in (2, 3, 4) or superblock != 1024 or group_size != 128:
        raise ValueError(f"{what}: the kernel takes widths 2-4, superblock "
                         f"1024, group 128 (got {nbits}, {superblock}, "
                         f"{group_size})")
    if any(t.device != x.device for t in (packed, scale, zero)):
        raise ValueError(f"{what}: tensors on different devices")
    if (x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16
            or zero.dtype != torch.bfloat16 or packed.dtype != torch.int32):
        raise TypeError(f"{what}: x, scale, zero bf16 and packed int32")
    if x.shape != (1, K) or not x.is_contiguous() or K % 8:
        raise ValueError(f"{what}: x must be a contiguous [1, K], K a "
                         f"multiple of 8, got {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in (packed, scale, zero)):
        raise ValueError(f"{what}: packed/scale/zero must be contiguous")
    if (Kp % superblock or K > Kp or N > Np or Np % 8
            or scale.shape != (Kp // group_size, Np)
            or zero.shape != scale.shape
            or any(t.data_ptr() % 16 for t in (x, packed, scale, zero))):
        raise ValueError(f"{what}: packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)} do not fit (Np % 8, "
                         f"16-byte aligned operands)")
    splits, per = _plan(N, Kp, nbits, x.device.index or 0)
    out = torch.empty((1, N), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    rc = _lib()(_cuda.ptr(x), _cuda.ptr(packed), _cuda.ptr(scale),
                _cuda.ptr(zero), _cuda.ptr(out), _cuda.ptr(partial), K, Kp, N,
                Np, nbits, group_size, superblock, splits, per,
                _cuda.stream())
    _cuda.check(rc, what)
    return out


def gemv_extract_ahead(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, zero: torch.Tensor, *,
                       nbits: int, group_size: int, shape,
                       superblock: int) -> torch.Tensor:
    """``x [1, K] @ dequant(packed)`` -> ``[1, N]`` bf16 in the grouped form,
    one layer: ``packed [Kp*b/32, Np]``, bf16 ``scale`` / ``zero
    [Kp/128, Np]``.

    Replaces the Pallas kernel of ``scripts/pipelined_gemv.py``
    (``_pipe_kernel``).  A CPU tensor takes :func:`extract_ahead_plain`; a
    CUDA tensor launches ``csrc/gemv_extract_ahead.cu`` or raises.
    """
    kw = dict(nbits=nbits, group_size=group_size, shape=tuple(shape),
              superblock=superblock)
    if x.device.type == "cpu":
        return extract_ahead_plain(x, packed, scale, zero, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _extract_ahead_cuda(x, packed, scale, zero, **kw)
    gemv_extract_ahead.launches += 1
    return out


gemv_extract_ahead.launches = 0

#: SASS opcodes sass_counts reports: warpgroup MMAs, the extraction's
#: logic and shifts, shared-memory stores and loads
SASS_OPS = ("HGMMA", "LOP3", "SHF", "STS", "LDS")


def sass_counts() -> list:
    """Per width of the built ``csrc/gemv_extract_ahead.cu``: the kernel's
    name and its :data:`SASS_OPS` counts (``cuobjdump -sass`` beside
    ``nvcc``)."""
    from .kernel_attrib import count_ops, kernel_names, sass_listing
    counts = count_ops(sass_listing("gemv_extract_ahead"),
                       "extract_ahead_kernel", SASS_OPS)
    names = kernel_names(counts)
    return [dict(kernel=names[sym], **c) for sym, c in sorted(counts.items())]


def check_parity(site: str, nbits: int, device) -> dict:
    """The kernel against its plain version and ``quant_matmul_reference``
    on ``core.quantize`` weights (bf16 meta) at the full site shape."""
    N, K = chain.SITES[site]
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = quantize(W.to(device), nbits=nbits, group_size=128,
                  meta_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(1, K)).astype(np.float32)).to(
        device).to(torch.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock)
    got = gemv_extract_ahead(x, qt.packed, qt.scale, qt.zero, **kw)
    plain = extract_ahead_plain(x, qt.packed, qt.scale, qt.zero, **kw)
    ref = qm.quant_matmul_reference(x, qt, out_dtype=torch.float32)
    rec = dict(rel_err_vs_plain=chain.rel_err(got, plain),
               rel_err_vs_reference=chain.rel_err(got, ref),
               max_abs_err=(got.float() - plain.float()).abs().max().item(),
               tol=TOL)
    rec["ok"] = (rec["rel_err_vs_plain"] <= TOL
                 and rec["rel_err_vs_reference"] <= TOL
                 and got.shape == (1, N))
    return rec


def probe_case(site: str, nbits: int, device) -> dict:
    """Parity, then (on a card) the extract-ahead kernel's and production's
    chain µs over a 40-layer random stack; prints a ``PIPE_PROBE`` line."""
    N, K = chain.SITES[site]
    rec = dict(site=site, N=N, K=K, nbits=nbits,
               **check_parity(site, nbits, device))
    if device.type == "cuda":
        gen = torch.Generator(device=device).manual_seed(0)
        L = max(chain.CHAIN_LENS)
        packed, scale, zero, sb = chain.random_stack(N, K, nbits, L, gen,
                                                     device)
        x = torch.randn((1, K), generator=gen, device=device).to(
            torch.bfloat16)
        kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb)
        rec["extract_ahead_us"] = chain.chain_us(
            lambda i: gemv_extract_ahead(x, packed[i], scale[i], zero[i],
                                         **kw))
        rec["production_us"] = chain.chain_us(
            lambda i: qm.quant_matmul_indexed(x, packed, scale, zero, i, **kw))
        rec["bound_us"] = chain.bound_us(packed, scale, N)
        del packed, scale, zero
    print("PIPE_PROBE " + json.dumps(rec), flush=True)
    return rec


def main(argv=None, device=None) -> list:
    """``[site] [nbits...]`` (default ``o 2 4``, the script's); returns
    the records.  Runs on the card unless ``device="cpu"`` is asked for."""
    argv = list(sys.argv[1:] if argv is None else argv)
    site = argv[0] if argv else "o"
    bits = [int(b) for b in argv[1:]] or [2, 4]
    if site not in chain.SITES:
        raise SystemExit(f"site {site!r}: one of {sorted(chain.SITES)}")
    return [probe_case(site, nb, resolve_device(device)) for nb in bits]


if __name__ == "__main__":
    main()
