"""The routed experts' product alone, at Qwen2-57B-A14B's shapes, beside
the byte bound, the plain version and a loop of the existing kernels.

    python -m amq_tpu_torch.probes.moe_ab [--bits 2 4]

Per width (2- and 4-bit containers) and shape -- ``decode``: 8 rows of
top-8 over 64 experts (64 pairs, ~42 experts hit); ``prefill``: 1024 rows
(8192 pairs, ~128 rows an expert) -- one ``MOE_AB`` JSON line:

* ``kernel_us``: ``ops.moe.moe_experts`` (align, gate|up with SwiGLU,
  down), per call, from ``chain.chain_us`` (chains of calls captured in a
  CUDA graph, each call on the next of 4 layers' expert stacks, so no
  expert's words stay in the 50 MB L2 between calls);
* ``loop_us``: the same pairs through the existing kernels, one expert at
  a time (the grouped GEMV or the tile kernel for gate|up, then its
  SwiGLU-down form, on the expert's gathered rows), timed the same way;
* ``plain_ms``: ``ops.moe.experts_plain`` once on the card (events; it
  reads the routing back, so no graph);
* ``bound_us``: each hit expert's words and bf16 scale and zero read
  once, x in and the pair outputs out once, or the FLOPs at the bf16
  peak, whichever is larger (``bound``: which); ``share_of_bound``;
* ``rel_err``: the kernel against the plain version, normalized by the
  plain version's largest magnitude.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import moe
from ..ops import quant_matmul as qm
from .chain import HBM_BYTES_PER_S, chain_us, rel_err

H, I, E, K_TOP = 3584, 2560, 64, 8
LAYERS = 4
BF16_FLOPS = 989e12
SHAPES = (("decode", 8), ("prefill", 1024))


def _stack(n, K, N, nbits, gen, dev):
    words = torch.randint(-2**31, 2**31 - 1, (n, K * nbits // 32, N),
                          dtype=torch.int32, device=dev, generator=gen)
    std = ((4**nbits - 1) / 12) ** 0.5
    scale = ((torch.rand((n, K // 128, N), generator=gen, device=dev) + 0.5)
             / (K ** 0.5 * std)).to(torch.bfloat16)
    zero = (torch.rand((n, K // 128, N), generator=gen, device=dev) - 0.5
            + (2**nbits - 1) / 2).to(torch.bfloat16)
    return words, scale, zero


def bound(nbits: int, hits: int, pairs: int):
    per_expert = sum(n * k * nbits / 8 + 2 * 2 * (k // 128) * n
                     for n, k in ((2 * I, H), (H, I)))
    nbytes = hits * per_expert + pairs * 2 * 2 * H
    flops = 2.0 * pairs * 3 * H * I
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e6, "bytes" if t_b >= t_f else "flops"


def case(label: str, M: int, nbits: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(M + nbits)
    gu = _stack(LAYERS * E, H, 2 * I, nbits, gen, dev)
    dn = _stack(LAYERS * E, I, H, nbits, gen, dev)
    x = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.argsort(torch.rand((M, E), generator=gen, device=dev),
                        dim=1)[:, :K_TOP].contiguous()
    kw = dict(num_experts=E, nbits=nbits, group_size=128, gu_superblock=512,
              dn_superblock=512, out_dtype=torch.bfloat16)

    def kernel(i):
        return moe.moe_experts(x, ids, *gu, *dn, (i % LAYERS) * E, **kw)

    flat = ids.reshape(-1).cpu()
    hit = [(e, torch.nonzero(flat == e)[:, 0].to(dev)) for e in range(E)
           if (flat == e).any()]
    static = dict(nbits=nbits, group_size=128, superblock=512,
                  out_dtype=torch.bfloat16)

    def loop(i):
        first = (i % LAYERS) * E
        for e, pairs in hit:
            rows = x.index_select(0, pairs // K_TOP)
            g = qm.quant_matmul_indexed(rows, *gu, first + e,
                                        shape=(2 * I, H), **static)
            qm.quant_matmul_swiglu_indexed(g[:, :I], g[:, I:], *dn,
                                           first + e, shape=(H, I), **static)

    got = kernel(0)
    t0 = time.perf_counter()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = moe.experts_plain(x, ids, *gu, *dn, 0, **kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    rec = dict(shape=label, rows=M, pairs=M * K_TOP, nbits=nbits,
               experts_hit=len(hit), rel_err=rel_err(got, want),
               kernel_us=chain_us(kernel), loop_us=chain_us(loop),
               plain_ms=plain_ms, plain_wall_s=time.perf_counter() - t0)
    rec["bound_us"], rec["bound"] = bound(nbits, len(hit), M * K_TOP)
    rec["share_of_bound"] = rec["bound_us"] / rec["kernel_us"]
    rec["loop_share_of_bound"] = rec["bound_us"] / rec["loop_us"]
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bits", type=int, nargs="+", default=[2, 4])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_ab times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    print("DEVICE " + json.dumps(dict(name=torch.cuda.get_device_name(0))),
          flush=True)
    for nbits in args.bits:
        for label, M in SHAPES:
            print("MOE_AB " + json.dumps(case(label, M, nbits, dev)),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
