"""Ring-shape sweep of the grouped tensor-core GEMV, per code width.

The grouped GEMV (``csrc/quant_matmul.cu`` ``amq_qmm_grouped``, steps in
``csrc/qmm_tile.cuh``) streams word rows through a ring of bulk copies;
its shape is three build-time constants: 16-column MMA tiles per consumer
warp (``AMQ_GTILES``, a block owns 128 x tiles columns), word rows per
stage (``AMQ_GSR``) and stages (``AMQ_GSTAGES``).  This probe builds one
library per shape in :data:`VARIANTS` (one nvcc each, all started
together) and, for each width asked for, holds each to the grouped form's
plain version at that width's site (:data:`SITES`: the 7B head at 8
bits, K 4096 x N 32000 in Vp 32768; the fused gateup at 1-4 bits, K 4096
x N 22016 in 22528; M = 1, superblock 1024, bf16 meta) and times each with
the chain timer (:func:`chain.chain_us` over a 40-layer stack, so the
words come from device memory) beside the shipped kernel through the
public wrapper.  K is split as the wrapper splits it, at the blocks per SM
the variant's own occupancy calculator reports.  One ``RING`` line per
width and variant:

    python -m amq_tpu_torch.probes.grouped_ring [WIDTH ...]   # default 2 4 8

on the card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.device import resolve_device
from ..core.quantize import QuantizedTensor
from ..ops import _cuda
from ..ops import quant_matmul as qm
from . import chain

#: (tiles per warp, word rows per stage, stages); the first is the
#: shipped kernel's (qmm_tile.cuh's defaults)
VARIANTS = ((2, 32, 2), (2, 32, 3), (2, 32, 4), (2, 16, 2), (2, 16, 3),
            (2, 16, 4), (2, 8, 4), (1, 32, 2), (1, 32, 4), (1, 64, 2),
            (4, 16, 2), (4, 8, 4))
#: the site each width is timed at, (N, K): the 8-bit head, else gateup
SITES = {8: (32000, 4096), 4: chain.SITES["gu"], 3: chain.SITES["gu"],
         2: chain.SITES["gu"], 1: chain.SITES["gu"]}
WIDTHS = (2, 4, 8)
TOL = 1e-4                            # f32 out: summation order only


def defines(tiles: int, rows: int, stages: int) -> tuple:
    return (f"AMQ_GTILES={tiles}", f"AMQ_GSR={rows}",
            f"AMQ_GSTAGES={stages}")


def _entry(var: tuple, name: str = "amq_qmm_grouped"):
    """An entry of the variant's library: the GEMV, or one of its shape
    queries (``amq_qmm_grouped_blocks``, ``amq_qmm_grouped_smem``)."""
    fn = getattr(_cuda.library("quant_matmul", defines(*var)), name)
    if name == "amq_qmm_grouped":
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p] + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    else:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = (ctypes.c_longlong if name == "amq_qmm_grouped_smem"
                      else ctypes.c_int)
    return fn


def variant_call(var, nbits, x, packed, scale, zero, sb):
    """``call(i)``: the variant on layer ``i`` of the stack -> [M, N] f32,
    K split as the wrapper splits it at the variant's blocks per SM."""
    fn = _entry(var)
    N, K = SITES[nbits]
    M, Np = x.shape[0], packed.shape[2]
    Kp = packed.shape[1] * 32 // nbits
    blocks = _entry(var, "amq_qmm_grouped_blocks")(nbits, 8, 0, 1, 128, sb)
    if blocks < 1:
        raise RuntimeError(f"grouped ring {var}: no block fits ({blocks})")
    splits, per = qm._grouped_splits(N, nbits, sb, Kp, blocks, x.device,
                                     rows=var[1], bn=128 * var[0])
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    p = _cuda.ptr

    def call(i):
        rc = fn(p(x), p(None), 1, p(packed[i]), p(scale[i]), p(zero[i]), 1,
                p(out), 0, p(partial), M, K, x.stride(0), Kp, N, Np, nbits,
                128, sb, splits, per, _cuda.stream())
        _cuda.check(rc, f"grouped ring {var}, {nbits}-bit")
        return out

    return call, splits, blocks


def sweep(nbits: int, dev, fits: dict) -> list:
    """Check and time every variant that fits at one width's site."""
    N, K = SITES[nbits]
    gen = torch.Generator(device=dev).manual_seed(nbits)
    L = max(chain.CHAIN_LENS)
    packed, scale, zero, sb = chain.random_stack(N, K, nbits, L, gen, dev)
    x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb,
              out_dtype=torch.float32)
    want = qm.qmm_grouped_plain(x, packed[0], scale[0], zero[0], **kw)
    if nbits == 8:
        layers = [QuantizedTensor(packed[i], scale[i], zero[i], 8, 128,
                                  (N, K), sb) for i in range(L)]

        def public(i):
            return qm.quant_matmul(x, layers[i], out_dtype=torch.float32)
    else:
        def public(i):
            return qm.quant_matmul_indexed(x, packed, scale, zero, i, **kw)
    shipped = public(0)
    shipped_us = chain.chain_us(public)
    bound = chain.bound_us(packed, scale, N)
    recs = []
    for var in VARIANTS:
        rec = dict(nbits=nbits, N=N, K=K, tiles=var[0], columns=128 * var[0],
                   rows_per_stage=var[1], stages=var[2],
                   smem_bytes=_entry(var, "amq_qmm_grouped_smem")(
                       nbits, 1, 0, 1, 128, sb),
                   bound_us=bound, shipped_us=shipped_us)
        if fits[var]:
            call, rec["splits"], rec["blocks_per_sm"] = variant_call(
                var, nbits, x, packed, scale, zero, sb)
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
    del packed, scale, zero
    torch.cuda.empty_cache()
    return recs


def main(argv=None, device=None) -> list:
    """Build every variant, check and time each at every width in ``argv``
    (default :data:`WIDTHS`); returns the records.  Runs on the card; the
    kernels have no CPU mode, so ``device="cpu"`` refuses."""
    widths = [int(a) for a in (argv or [])] or list(WIDTHS)
    if any(w not in SITES for w in widths):
        raise SystemExit(f"grouped_ring: widths are {sorted(SITES)}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("grouped_ring: times kernels, so it needs the card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc each
        times = list(pool.map(
            lambda v: _cuda.build(["quant_matmul"], defines=defines(*v)),
            VARIANTS))
    print(f"grouped_ring: built {len(VARIANTS)} variants in "
          f"{max(times):.1f} s", flush=True)
    # run a variant only where its stage divides every width's superblock
    # and a block of every width's largest call (M = 8, SwiGLU, f32 meta)
    # fits an SM, as its own library reckons it
    fits = {v: all(qm._grouped_round_rows(w, 1024)
                   % qm._grouped_stage_rows(w, v[1]) == 0
                   and _entry(v, "amq_qmm_grouped_blocks")(
                       w, 8, 1, 0, 128, 1024) >= 1
                   for w in widths) for v in VARIANTS}
    return [rec for w in widths for rec in sweep(w, dev, fits)]


if __name__ == "__main__":
    recs = main(sys.argv[1:])
    if any(r["ok"] is False for r in recs):
        raise SystemExit("grouped_ring: a variant disagrees with the plain "
                         "version")
