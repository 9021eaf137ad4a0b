"""Ring-shape sweep of the grouped 8-bit tensor-core GEMV at the head shape.

The grouped GEMV (``csrc/quant_matmul.cu`` ``amq_qmm_grouped``, step in
``csrc/qmm_tile.cuh``) streams word rows through a ring of bulk copies;
its shape is three build-time constants: 16-column MMA tiles per consumer
warp (``AMQ_GTILES``, a block owns 128 x tiles columns), word rows per
stage (``AMQ_GSR``) and stages (``AMQ_GSTAGES``).  This probe builds one
library per shape in :data:`VARIANTS` (one nvcc each, all started
together), holds each to the grouped form's plain version at the 7B head
(M = 1, K 4096, N 32000 in Vp 32768, superblock 1024, bf16 meta, f32
out), and times each with the chain timer (:func:`chain.chain_us` over a
40-layer stack, so the words come from device memory) beside the shipped
kernel through ``ops.quant_matmul.quant_matmul``.  K is split as the
wrapper splits it, at the blocks per SM the variant's shared memory
allows (at most two, the kernel's launch bound).  One ``RING`` line per
variant; ``python -m amq_tpu_torch.probes.grouped_ring`` on the card.
"""

from __future__ import annotations

import ctypes
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.device import resolve_device
from ..core.quantize import QuantizedTensor
from ..ops import _cuda
from ..ops import quant_matmul as qm
from . import chain

#: (tiles per warp, word rows per stage, stages); the first is the
#: shipped kernel's (qmm_tile.cuh's defaults)
VARIANTS = ((2, 32, 2), (2, 32, 3), (2, 32, 4), (2, 32, 5), (2, 16, 2),
            (2, 16, 3), (2, 16, 4), (2, 16, 6), (2, 8, 4), (2, 8, 8),
            (1, 32, 2), (1, 32, 4), (4, 16, 2), (4, 8, 4))
HEAD = (32000, 4096)                  # (N, K) of the Llama-2-7B lm_head
SMEM_PER_SM = 228 * 1024              # H100: shared memory per SM
SMEM_PER_BLOCK = 227 * 1024           # H100: the most one block may take
TOL = 1e-4                            # f32 out: summation order only


def defines(tiles: int, rows: int, stages: int) -> tuple:
    return (f"AMQ_GTILES={tiles}", f"AMQ_GSR={rows}",
            f"AMQ_GSTAGES={stages}")


def smem_bytes(tiles: int, rows: int, stages: int,
               swiglu: bool = False) -> int:
    """Dynamic shared memory of one block, as ``launch_grouped`` sizes it
    (mirrors ``qmm_tile.cuh``'s ``grouped_stage_bytes`` at 8 bits): 128
    bytes of barriers, then per stage the word rows (128 x tiles + 4 words
    each), two meta rows per round (f32 room) and the activations (8 rows
    x 2 rounds x (2 x rows + 8) bf16), twice with the SwiGLU operand."""
    bn = 128 * tiles
    x = 8 * 2 * (2 * rows + 8) * 2
    stage = rows * (bn + 4) * 4 + 2 * 2 * bn * 4 + (2 if swiglu else 1) * x
    return 128 + stages * stage


def blocks_per_sm(tiles: int, rows: int, stages: int) -> int:
    """Blocks of the variant one SM holds by shared memory (each block
    also takes 1 KB of the runtime's), at most the launch bound's two; 0
    where the kernel's shared-memory attribute (sized for the SwiGLU
    ring) exceeds what one block may take."""
    if smem_bytes(tiles, rows, stages, swiglu=True) > SMEM_PER_BLOCK:
        return 0
    return min(2, SMEM_PER_SM // (smem_bytes(tiles, rows, stages) + 1024))


def _entry(var: tuple):
    fn = _cuda.library("quant_matmul", defines(*var)).amq_qmm_grouped
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def variant_call(var, x, packed, scale, zero, sb):
    """``call(i)``: the variant on layer ``i`` of the stack -> [M, N] f32,
    K split as the wrapper splits it at the variant's blocks per SM."""
    fn = _entry(var)
    N, K = HEAD
    M, Kp, Np = x.shape[0], packed.shape[1] * 4, packed.shape[2]
    n_sb = Kp // sb
    tiles = -(-N // (128 * var[0]))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    want = max(1, min(n_sb, blocks_per_sm(*var) * sms // tiles))
    per = -(-n_sb // want)
    splits = -(-n_sb // per)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    p = _cuda.ptr

    def call(i):
        rc = fn(p(x), p(None), 1, p(packed[i]), p(scale[i]), p(zero[i]), 1,
                p(out), 0, p(partial), M, K, x.stride(0), Kp, N, Np, 8, 128,
                sb, splits, per, _cuda.stream())
        _cuda.check(rc, f"grouped ring {var}")
        return out

    return call, splits


def main(argv=None, device=None) -> list:
    """Build every variant, check and time each; returns the records.
    Runs on the card; the kernels have no CPU mode, so ``device="cpu"``
    refuses.  ``argv`` is unused (the variants are :data:`VARIANTS`)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("grouped_ring: times kernels, so it needs the card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc each
        built = list(pool.map(
            lambda v: _cuda.build(["quant_matmul"], defines=defines(*v))
            if blocks_per_sm(*v) else 0.0, VARIANTS))
    print(f"grouped_ring: built {len(VARIANTS)} variants in "
          f"{max(built):.1f} s", flush=True)
    N, K = HEAD
    gen = torch.Generator(device=dev).manual_seed(0)
    L = max(chain.CHAIN_LENS)
    packed, scale, zero, sb = chain.random_stack(N, K, 8, L, gen, dev)
    x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(nbits=8, group_size=128, shape=(N, K), superblock=sb,
              out_dtype=torch.float32)
    want = qm.qmm_grouped_plain(x, packed[0], scale[0], zero[0], **kw)
    head = [QuantizedTensor(packed[i], scale[i], zero[i], 8, 128, (N, K), sb)
            for i in range(L)]
    shipped = qm.quant_matmul(x, head[0], out_dtype=torch.float32)
    shipped_us = chain.chain_us(
        lambda i: qm.quant_matmul(x, head[i], out_dtype=torch.float32))
    bound = chain.bound_us(packed, scale, N)
    recs = []
    for var in VARIANTS:
        rec = dict(tiles=var[0], columns=128 * var[0], rows_per_stage=var[1],
                   stages=var[2], smem_bytes=smem_bytes(*var),
                   blocks_per_sm=blocks_per_sm(*var), bound_us=bound,
                   shipped_us=shipped_us)
        if rec["blocks_per_sm"]:
            call, rec["splits"] = variant_call(var, x, packed, scale, zero,
                                               sb)
            got = call(0).clone()
            torch.cuda.synchronize()
            rec["rel_err"] = chain.rel_err(got, want)
            rec["equal_shipped"] = (bool(torch.equal(got, shipped))
                                    if var == VARIANTS[0] else None)
            rec["us"] = chain.chain_us(call)
            rec["share_of_bound"] = bound / rec["us"]
            rec["ok"] = (rec["rel_err"] <= TOL
                         and rec["equal_shipped"] is not False)
        else:
            rec["ok"] = None          # does not fit one block's shared memory
        print("RING " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    recs = main()
    if any(r["ok"] is False for r in recs):
        raise SystemExit("grouped_ring: a variant disagrees with the plain "
                         "version")
