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

on the card.  With ``--owq`` the site is OWQ's compacted 7B down
projection instead (:data:`OWQ_SITE`: K 11008 in superblocks of 256 rows,
N 4096, f32 meta, widths 1-4, default 2 3), where the shipped ring fills
a stage with two superblocks below 4 bits (the spanning kernel) and a
ring of 16 or 8 rows a stage holds whole ones:

    python -m amq_tpu_torch.probes.grouped_ring --owq [WIDTH ...]
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.bitpack import wrap_int32
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
#: OWQ's down projection at 7B: (N, Kp, superblock), widths timed there
OWQ_SITE, OWQ_WIDTHS = (4096, 11008, 256), (2, 3)
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


def variant_call(var, nbits, x, packed, scale, zero, sb, N):
    """``call(i)``: the variant on layer ``i`` of the stack -> [M, N] f32,
    K split as the wrapper splits it at the variant's blocks per SM."""
    fn = _entry(var)
    M, K, Np = x.shape[0], x.shape[1], packed.shape[2]
    Kp = packed.shape[1] * 32 // nbits
    meta_bf16 = int(scale.dtype == torch.bfloat16)
    blocks = _entry(var, "amq_qmm_grouped_blocks")(nbits, 8, 0, meta_bf16,
                                                   128, sb)
    if blocks < 1:
        raise RuntimeError(f"grouped ring {var}: no block fits ({blocks})")
    splits, per = qm._grouped_splits(N, nbits, sb, Kp, blocks, x.device,
                                     rows=var[1], bn=128 * var[0])
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    p = _cuda.ptr

    def call(i):
        rc = fn(p(x), p(None), 1, p(packed[i]), p(scale[i]), p(zero[i]),
                meta_bf16, p(out), 0, p(partial), M, K, x.stride(0), Kp, N, Np, nbits,
                128, sb, splits, per, _cuda.stream())
        _cuda.check(rc, f"grouped ring {var}, {nbits}-bit")
        return out

    return call, splits, blocks


def owq_stack(nbits: int, L: int, gen, dev) -> tuple:
    """A random stack at :data:`OWQ_SITE` (f32 meta, as ``owq_pack`` writes
    it): ``(packed, scale, zero, superblock)``."""
    N, Kp, sb = OWQ_SITE
    packed = torch.empty((L, Kp * nbits // 32, N), dtype=torch.int32,
                         device=dev)
    for i in range(L):
        packed[i] = wrap_int32(torch.randint(
            0, 2**32, packed.shape[1:], dtype=torch.int64, device=dev,
            generator=gen))
    scale = torch.rand((L, Kp // 128, N), generator=gen, device=dev) * 0.02
    zero = torch.rand((L, Kp // 128, N), generator=gen,
                      device=dev) * (2**nbits - 1)
    return packed, scale, zero, sb


def sweep(nbits: int, dev, fits: dict, owq: bool = False) -> list:
    """Check and time every variant that fits at one width's site (OWQ's
    down projection with ``owq``)."""
    N, K = OWQ_SITE[:2] if owq else SITES[nbits]
    gen = torch.Generator(device=dev).manual_seed(nbits)
    L = max(chain.CHAIN_LENS)
    packed, scale, zero, sb = (owq_stack(nbits, L, gen, dev) if owq else
                               chain.random_stack(N, K, nbits, L, gen, dev))
    x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb,
              out_dtype=torch.float32)
    want = qm.qmm_grouped_plain(x, packed[0], scale[0], zero[0], **kw)
    if nbits == 8 or owq:
        layers = [QuantizedTensor(packed[i], scale[i], zero[i], nbits, 128,
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
        rec = dict(nbits=nbits, N=N, K=K, superblock=sb,
                   meta=str(scale.dtype).split(".")[-1], tiles=var[0],
                   columns=128 * var[0], rows_per_stage=var[1],
                   stages=var[2],
                   spanning=not qm._grouped_whole_stages(nbits, sb, var[1]),
                   smem_bytes=_entry(var, "amq_qmm_grouped_smem")(
                       nbits, 1, 0, int(scale.dtype == torch.bfloat16), 128,
                       sb),
                   bound_us=bound, shipped_us=shipped_us)
        if fits[var]:
            call, rec["splits"], rec["blocks_per_sm"] = variant_call(
                var, nbits, x, packed, scale, zero, sb, N)
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
    (default :data:`WIDTHS`; with ``--owq`` at :data:`OWQ_SITE`, default
    :data:`OWQ_WIDTHS`); returns the records.  Runs on the card; the
    kernels have no CPU mode, so ``device="cpu"`` refuses."""
    argv = list(argv or [])
    owq = "--owq" in argv
    widths = ([int(a) for a in argv if a != "--owq"]
              or list(OWQ_WIDTHS if owq else WIDTHS))
    allowed = (1, 2, 3, 4) if owq else sorted(SITES)
    if any(w not in allowed for w in widths):
        raise SystemExit(f"grouped_ring: widths are {allowed}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("grouped_ring: times kernels, so it needs the card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:      # one nvcc each
        times = list(pool.map(
            lambda v: _cuda.build(["quant_matmul"], defines=defines(*v)),
            VARIANTS))
    print(f"grouped_ring: built {len(VARIANTS)} variants in "
          f"{max(times):.1f} s", flush=True)
    # run a variant only where a block of every width's largest call (M =
    # 8, SwiGLU, f32 meta) fits an SM, as its own library reckons it, and
    # (at the 1024-row sites) its stage divides every width's superblock
    sb = OWQ_SITE[2] if owq else 1024
    fits = {v: all((owq or qm._grouped_whole_stages(w, sb, v[1]))
                   and _entry(v, "amq_qmm_grouped_blocks")(
                       w, 8, 1, 0, 128, sb) >= 1
                   for w in widths) for v in VARIANTS}
    return [rec for w in widths for rec in sweep(w, dev, fits, owq)]


if __name__ == "__main__":
    recs = main(sys.argv[1:])
    if any(r["ok"] is False for r in recs):
        raise SystemExit("grouped_ring: a variant disagrees with the plain "
                         "version")
