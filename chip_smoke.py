"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. environment: the card's name and power limit, torch / CUDA / Triton
   versions; TF32 off for float32 products, bf16 products reduced in f32.
2. build: compile the port's CUDA sources (amq_tpu_torch/csrc) with nvcc,
   one process per source, all started together; REGS (registers and
   spill bytes of the attention kernels, every width's grouped GEMV, its
   pipelined form and the one-launch MLP, the dequantization kernel, the
   attribution probe's grouped body, the extract-ahead GEMV and the
   multi-row tile kernel, from -Xptxas -v), SASS (HGMMA / HMMA / FFMA per
   flash kernel, TF32 HMMA / HGMMA per f32 flash kernel, and also LOP3 /
   SHF per grouped ring kernel and tile kernel, from cuobjdump -sass) and
   TILE_PTXAS (ptxas's wgmma notes on the tile kernel) lines; fails if
   the bf16 flash kernel holds no HGMMA, the f32 one (split TF32) no
   tensor-core product of TF32 type,
   a grouped ring kernel no HMMA or HGMMA, a tile kernel instantiation
   (the 4-row superblocks' pair forms among them) no HGMMA, ptxas
   serializes a tile kernel's wgmma, or a redesigned kernel spills.
3. kernels vs their plain PyTorch versions at the Llama-2-7B shapes:
   the dequant-matmuls (qkv / o / gateup / down sites, head) at M = 1 and
   64, widths 2, 3 (native planes) and 4, 8 on the head, bf16 and f32
   scale/zero, the four sites also at M = 4 and 8 and the head at M = 5
   and 8 (bf16 scale/zero); at M <= 8 the grouped tensor-core GEMV
   (route "grouped": held to the grouped form's plain version, its
   launches counted as grouped, its time beside the CUDA-core GEMV's in
   the same case, gemv_ms); at M = 64 the tile kernel on wgmma (route
   "tile": held to the bf16 multi-row form's plain version qmm_tile_plain,
   rel_err_vs_f32_plain beside it, its launches counted as tile, its time
   beside the CUDA-core GEMM's in the same case, gemm_ms); decode
   attention at the Llama-2-7B, GQA, hd-64 and sliding-window shapes;
   flash attention at the Llama-2-7B evaluation shape (bf16 and f32),
   prefill with a cache (unaligned T), the GQA Llama-3-8B shape and d 64,
   each also in f32 (the split-TF32 kernel, PTQ calibration's), and f32
   at AWQ's calibration length (S 512);
   decode attention at a 4000-key context (reported) and a float32 batch-
   independence case (each row of a B = 4 call torch.equal to the row
   alone).  One line per case: error vs tolerance, two calls torch.equal,
   kernel / plain / library times, the least time the card could take
   (bytes over 3.35 TB/s or operations over the peak for the inputs' type)
   and, for flash, the share of that peak (f32: of the split-TF32 rate,
   three TF32 products per product, with the CUDA-core bound beside it).
   The decode kernels of the JAX package's opt-in switches at the same
   shapes, both in the grouped form on the grouped GEMV's ring: the
   pipelined grouped GEMV (qkv / o / gateup, down with the SwiGLU
   prologue; M 1, 4, 8; widths 2, 3, 4) against its plain version and
   torch.equal to the grouped GEMV, and the one-launch decode MLP (M 1,
   4, 8; widths 2, 3, 4) against its plain version and torch.equal to the
   grouped gateup -> SwiGLU-down chain, two calls bit-identical; each
   timed beside the grouped route and the CUDA-core route (the switch
   kernels' earlier arithmetic) in the same call.  DEQUANT lines: the
   dequantization kernel at the 7B gateup shape for every packed width,
   and at the evaluation's own sites (o, gate/up, down with its K tail)
   for widths 2, 3, 4, torch.equal to its plain version in bf16 and f32,
   its time beside the byte bound.
3c. the decode-GEMV probes through their entry points
   (amq_tpu_torch.probes): kernel_attrib.main and pipelined_gemv.main at
   the qkv / o / gateup / down sites, widths 2, 3, 4 (ATTRIB lines: the
   attribution kernel's four variants in both bodies -- the grouped GEMV
   the decode path runs, its full torch.equal to quant_matmul_indexed,
   and the CUDA-core GEMV, its full torch.equal to that route -- each
   variant equal to its plain version, chain-timed; PIPE_PROBE lines: the
   extract-ahead GEMV on wgmma within 2e-2 of its plain version and of
   the reference, chain-timed beside production; every variant at full's
   blocks per SM, else the phase fails), kernel_roofline.main (ROOFLINE
   lines), a torch.profiler trace of one grouped attribution chain
   (chiprun_out/probe_trace/), the phase's Tracer summary, the chain
   timer against this script's time_ms (TIMER_CHECK lines, reported), the
   attribution kernels' FFMA / I2F / LDG / LDS / HMMA / LOP3 / SHF counts
   and the extract-ahead kernel's HGMMA / LOP3 / SHF / STS / LDS counts in
   their SASS (ATTRIB_SASS lines; fails if the extract-ahead kernel holds
   no HGMMA) and exact launch counts of the two probe kernels.
4. full-width Llama-2-7B decode (32 layers, random packed weights drawn
   on the card from a seeded generator, 2/3/4 bits per layer with 3-bit in
   4-bit containers, bf16 meta, 8-bit head) through Engine.generate and
   serving.benchmark.benchmark_speed (TPS / GEMV / GEMM / TTFT), with the
   kernels' launch counts checked over one generate (GROUPED_LAUNCHES:
   every decode GEMV of the layers, 96 + 32 per token, and the head took
   the grouped GEMV; TILE_LAUNCHES: the 64-token prefill's 96 + 32 + 1
   products took the tile kernel), PREFILL (prefill ms and TTFT),
   kernel-path vs plain-path prefill logits (float32 gated; the bf16 gap
   reported), and one generate from a 512-token prompt
   whose prefill runs the flash kernel once per layer and dequantizes
   once per site.
4b. serving breadth on the same model at full width and depth: generate
   with AMQ_PIPE, then with AMQ_PIPE and AMQ_MLP_KERNEL (exact launch
   counts, grouped ones too; token agreement and logit gap to the default kernels
   reported; SWITCHES_PROFILE: device ms per decode token of the default,
   pipe and pipe+mlp settings in one call); continuous batching
   (benchmark_continuous, 4 slots, 16 requests; default kernels, then
   both switches; exact launch counts, tile ones too);
   a float32 SlotEngine run token-exact against each request's generate;
   speculative decoding with the target as its own draft (bf16 rate and
   acceptance, with two witnesses of what that acceptance measures: the
   M = 1 vs M = 5 top-1 agreement and logit gap on the kernel and the
   plain path, SPEC_LAYER_GAP (per layer the M = 1 vs M = 5 gap of the
   qkv and attention outputs and the residual stream after attention and
   after the MLP, both paths, and the first layer and output where the
   kernel path's gap exceeds the plain path's by more than one bf16
   rounding), and the acceptance on the plain path; float32 tokens equal
   to generate's).
   Every serving loop of phases 4-7b runs as captured CUDA graphs
   (amq_tpu_torch/serving/graphs.py: the prefill per (B, S), one decode
   step replayed per token, the slot decode step and slot prefills, the
   speculative round), the launch counts adding each replay's launches.
4c. GRAPHS: the same model's serving loops as captured CUDA graphs
   against the eager loop (graphs=False) in one call.  Gates: float32
   generate, slot-batched decoding (decode chunks of 8, whole and chunked
   slot prefills) and speculative decoding (tokens, rounds, accepted)
   token-exact, graph against eager (GRAPH_F32); the bf16 first decode
   step's forward replayed, torch.equal to the same forward run eagerly
   (GRAPH_STEP_LOGITS, the gap beside the bf16 kernel tolerance
   reported); exact launch counts of one generate on each loop, replays
   included, and of a second one the grouped GEMV, tile and
   decode-attention kernels the profiler saw the card run, against the
   same reckoning (GRAPH_LAUNCHES).  Reported: GRAPH_AB (TPS, GEMV ms/token, GEMM
   prefill ms and TTFT in turns eager, graph, graph, eager; decode and
   prefill busy share from the profiler and from the eager loop's device
   time over the graph's wall; CONTINUOUS and SPECULATIVE tok/s and
   acceptance), GRAPH_PROFILE lines, GRAPH_CAPTURE (captures, replays,
   capture seconds, pool and reserved MB, peak memory).
4d. QWEN2: Qwen2-0.5B at full width and depth (24 layers, hidden 896,
   qkv bias, tied head as the 8-bit packed head; random packed weights,
   layer i at 2/3/4 bits, native 3-bit planes: its 3-bit q/k/v/o and
   gate/up at superblock 128, the pair forms), Engine.generate (prompt
   64, 32 tokens, graphs) in bf16 and in float32: exact launch counts
   per route (grouped, spanning, tile, pair), no CUDA-core launch,
   decode ms/token and prefill ms; QWEN2_GATES: float32 prefill logits
   within LOGIT_TOL of the plain path, float32 tokens on graphs equal to
   the eager loop's.
5. the speed CLI (HQQ proxies -> stack_proxies -> Engine) at full width:
   TPS and CONTINUOUS (4 slots, 16 requests).
6. the sensitivity CLI at full Llama-2-7B width and depth (2 samples of
   2048 synthetic tokens, bf16): a 224-entry table, flash and
   dequantization launches equal to the counts reckoned from the code;
   then one evaluator in f32 holding the kernel path's eval loss to the
   plain path's (einsum attention), and a profile of one bf16 search
   evaluation (EVAL_PROFILE: dequantization launches equal to the count
   reckoned, the loss with the bf16 tensor-core dense head within 1e-3 of
   the float32 head's, no float32 GEMM left).
7. the search CLI on that table with a small budget: the archive, finite
   losses and hypervolume.
7b. PTQ realization at full Llama-2-7B width (REALIZE_CUTS names every
   cut): a local HF checkpoint (2 layers, random bf16 weights) read with
   --model_path; the proxy CLI's 2/3/4-bit proxies read back with
   load_quantized torch.equal to quantize_model in memory (PROXY) and
   served by the speed CLI with --proxy_path; the quantize CLI on phase
   7's iter_2.stats with gptq, awq, hqq and fp16 at 32 layers and owq
   at 12 (REALIZE: seconds per stage, perplexity, flash (f32 ones apart)
   and dequantization launches equal to the counts reckoned, GPTQ's and
   OWQ's Hessian-
   weighted error tr((W-Q) H (W-Q)^T) below round-to-nearest's at layers
   0 and L-1); an f32 HQQ realization's perplexity on the kernel path
   within 1e-3 of the plain path (REALIZE_PARITY); OWQ packed serving
   through the speed CLI's --method owq (TPS, ms/token) and in-process
   (OWQ_SERVE: float32 greedy tokens on the kernel path equal to the
   plain path's, the bf16 logit gap, exact quant_matmul launches per
   token, grouped ones too).  The OWQ layouts of quant_matmul are CASE
   lines of phase 3 (M = 1 and 64; at 64 the tile kernel, its time beside
   the CUDA-core GEMM's; at OWQ's 31-group site, superblock 128, also M
   64 at 1-4 bits and float32 at M 1, 8 and 64 at 1 and 3 bits: the
   4-row superblocks' pair forms; every OWQ case on the grouped or tile
   route; rows 1 and 2 at K 896, superblock 128, 3-bit: bf16 M 64, f32 M
   1 and 64).  Phase 3's ROUTE_SWEEP: every layout the packers give at
   group 128 (superblocks 128-1024, widths 1/2/3/4/8, bf16 and f32 x, M
   1 / 8 / 9 / 64) on the grouped ring or the tile kernel within MM_TOL
   of its plain version, no CUDA-core launch.
8. PARALLEL: the parallel forms (amq_tpu_torch/parallel, serving/dp.py)
   as torch.distributed ranks spawned on the one card (they run after
   phase 2's builds, which they load).  (a) tp 2 at full Llama-2-7B width
   and depth, two ranks over gloo (named: NCCL refuses two ranks on one
   device), phase 4's layout from random seeded proxies cut with
   shard_proxy and stacked per rank, the 8-bit head vocab-sharded, on the
   TP engine (eager), against the single-card Engine on the unsharded
   stack: float32 greedy tokens equal and the prefill logits' gap, over
   the largest logit, within the larger of TP_TOL (2e-4) and twice the
   single card's own kernel-vs-plain gap measured in the same run (the
   JAX suite's elementwise 2e-4 reported beside it), the bf16 first
   divergence and logit gap reported (beside the single card's bf16
   kernel-vs-plain gap), every decode
   GEMV on the grouped route and the prefill on the tile kernel (wrapper
   counts and the profiler's kernels against phase 4's reckoning, per
   rank), decode ms/token, rank 0's device time by kernel and one
   host-staged all-reduce's microseconds (two ranks on one card: no
   scaling claim) (PARALLEL_TP2); (b) CASE lines at one tp-2 rank's shapes (qkv, o,
   gateup, down at 2/3/4 bits, the 16000-lane head at M 1 and 64, decode
   attention at 16 heads); (c) tp 1 on an NCCL group with captured graphs,
   tokens equal to the plain Engine's (on a one-rank group NCCL's
   all-reduce launches nothing, so the graphs hold no collective; the
   profiler's NCCL kernel count is reported)
   (PARALLEL_NCCL); (d) at 4 layers, two gloo ranks: the pipeline (2
   stages x 2 microbatches, float32) within 2e-4 of one process's
   forward, the data-parallel slots' tokens and the data-parallel
   evaluation's losses equal to one process's, tp 2 (prefill and a
   4-step chain, float32, kernels) within the larger of TP_TOL and twice
   the single card's kernel-vs-plain gap (PARALLEL_SMALL).  The
   PARALLEL line sums them up with the phase's seconds.
9. PROCESSES_LEFT: every process the run started (compilers, ranks,
   multiprocessing's resource tracker) has ended, or the run fails; then
   the kernels line (with an M = 64 entry per row 1, 2 and 4 for the
   tile kernel, `<name>_tile`, the pair forms `quant_matmul_tile_pair`,
   `quant_matmul_tile_f32_pair` and `quant_matmul_f32_pair` with phase
   4d's launches, and the float32 flash kernel,
   `flash_attention_f32`, launched by phase 7b's calibration; the flash
   entries name their design), the card line, and the last line
   {"ok": true, "device": {...}}.
"""

import dataclasses
import importlib.metadata
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12           # H100 SXM dense bf16, NVIDIA data sheet
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12           # H100 SXM dense TF32 tensor cores
OUT_DIR = "chiprun_out"


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops, peak=BF16_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak for the inputs' type (bf16 by default)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def weight_bytes(packed, scale, N):
    """Bytes of one layer's packed words and scale/zero over the N columns
    the kernels read: K padded to whole superblocks, while the lane pad
    past N is never fetched (every kernel launches ceil(N/64) column tiles,
    and N is a multiple of 64 at every site here)."""
    return (packed.shape[-2] * N * packed.element_size()
            + 2 * scale.shape[-2] * N * scale.element_size())


def time_ms(calls, iters=20):
    """Mean device ms per call: ``iters`` calls (cycling ``calls``, argument
    sets spread over more than the 50 MB L2 so weights come from device
    memory as on the decode path) captured in one CUDA graph, replayed
    between two events.  The graph keeps the host's dispatch cost out of
    the kernel's time."""
    calls[0]()                                   # first-call set-up
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            calls[i % len(calls)]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(call, n=200):
    """Host microseconds per eager call (dispatch cost, no sync inside)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions

def rand_words(shape, gen):
    from amq_tpu_torch.core.bitpack import wrap_int32
    return wrap_int32(torch.randint(0, 2**32, shape, dtype=torch.int64,
                                    device="cuda", generator=gen))


def rand_site(N, K, nbits, L, meta_dtype, gen, lane_pad=True):
    """Random packed stack [L, Kp*b/32, Np] with scale/zero, in the serving
    layout (K padded to whole superblocks, N to the lane tile; the
    evaluation's stacks, ``lane_pad=False``, keep N)."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.models.stacked import _pick_lane_pad
    sb, k_pad = pick_superblock_padded(K)
    Kp, Np = K + k_pad, N + (_pick_lane_pad(N) if lane_pad else 0)
    packed = rand_words((L, Kp * nbits // 32, Np), gen)
    scale = (torch.rand((L, Kp // 128, Np), generator=gen, device="cuda")
             * 0.02).to(meta_dtype)
    zero = (torch.rand((L, Kp // 128, Np), generator=gen, device="cuda")
            * (2**nbits - 1)).to(meta_dtype)
    return packed, scale, zero, sb


SITES_7B = {  # name -> (N, K, kernel)
    "qkv": (12288, 4096, "quant_matmul_indexed"),
    "o": (4096, 4096, "quant_matmul_indexed"),
    "gateup": (22016, 4096, "quant_matmul_indexed"),
    "down": (4096, 11008, "quant_matmul_swiglu_indexed"),
    "head": (32000, 4096, "quant_matmul"),
    # one rank's shard at tp 2 (phase 8): head-cut qkv, row-cut o, the
    # 43-group intermediate (gate/up lanes, down's K 5504 in superblocks
    # of 512), the 16000-lane vocab shard of the head
    "qkv_tp2": (6144, 4096, "quant_matmul_indexed"),
    "o_tp2": (4096, 2048, "quant_matmul_indexed"),
    "gateup_tp2": (11008, 4096, "quant_matmul_indexed"),
    "down_tp2": (4096, 5504, "quant_matmul_swiglu_indexed"),
    "head_tp2": (16000, 4096, "quant_matmul"),
}
#: rows 1 and 2 at K 896 (Qwen2-0.5B's hidden: superblocks of 128 rows,
#: at 3 bits the pair forms): Qwen2-0.5B's gate/up site, and the
#: SwiGLU-down wrapper at the same K
SITES_SB128 = {"qwen_gateup": (9728, 896, "quant_matmul_indexed"),
               "k896_swiglu": (896, 896, "quant_matmul_swiglu_indexed")}
#: max |kernel - plain| / max |plain|, by output dtype: a bf16 output
#: carries one rounding (2^-8 relative) on either side, an f32 output
#: differs only in summation order over K
MM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def check_matmul(site, nbits, M, meta_dtype, gen, x_dtype=torch.bfloat16):
    """One dequant-matmul case; returns its record.  ``x_dtype`` float32:
    the float32 forms (the grouped ring's at M <= 8, the tile kernel's
    above), f32 out, held to qmm_plain, timed beside the CUDA-core route
    and the float32 torch.matmul on the dense f32 weight (TF32 off), the
    bound three bf16 products' operations or the bytes."""
    from amq_tpu_torch.core.quantize import QuantizedTensor, dequantize_kn
    from amq_tpu_torch.ops import quant_matmul as qm
    N, K, kernel = {**SITES_7B, **SITES_SB128}[site]
    f32 = x_dtype == torch.float32
    out_dtype = (torch.float32 if f32 or site.startswith("head")
                 else torch.bfloat16)
    # enough layers that cycling through them overflows the L2
    L = max(2, min(24, math.ceil(200e6 / (N * K * nbits / 8))))
    packed, scale, zero, sb = rand_site(N, K, nbits, L, meta_dtype, gen)
    x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
    u = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb,
              out_dtype=out_dtype)

    def kernel_call(i):
        if kernel == "quant_matmul_indexed":
            return qm.quant_matmul_indexed(x, packed, scale, zero, i, **kw)
        if kernel == "quant_matmul_swiglu_indexed":
            return qm.quant_matmul_swiglu_indexed(x, u, packed, scale, zero, i,
                                                  **kw)
        qt = QuantizedTensor(packed[i], scale[i], zero[i], nbits, 128, (N, K),
                             sb)
        return qm.quant_matmul(x, qt, out_dtype=out_dtype)

    # the kernel's plain version: the grouped form where the grouped
    # tensor-core GEMV runs (bf16 x, M <= 8), the bf16 multi-row form where
    # the tile kernel runs (bf16 x, 8 < M), else (f32 x too) the f32 one
    up = u if "swiglu" in kernel else None
    grouped = qm._grouped_applies(x, packed[1], scale[1], zero[1], nbits, 128,
                                  sb, up)
    tile = qm._tile_applies(x, packed[1], scale[1], zero[1], nbits, 128, sb,
                            up)
    plain_fn = (qm.qmm_plain if f32 else qm.qmm_grouped_plain if grouped
                else qm.qmm_tile_plain if tile else qm.qmm_plain)

    def plain_call(i, fn=plain_fn):
        return fn(x, packed[i], scale[i], zero[i], up=up, **kw)

    counter = getattr(qm, kernel)
    before = (counter.grouped_launches, counter.tile_launches)
    got = kernel_call(1)
    again = kernel_call(1)
    took = (counter.grouped_launches - before[0],
            counter.tile_launches - before[1])
    want = plain_call(1)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    deterministic = bool(torch.equal(got, again))
    # against the f32 dequantize-then-multiply too (another rounding)
    rel_f32 = (rel_err(got, plain_call(1, qm.qmm_plain))[0]
               if (grouped or tile) and not f32 else rel)
    tol = MM_TOL[out_dtype]
    ms = time_ms([lambda i=i: kernel_call(i) for i in range(L)])
    # the CUDA-core GEMV (M <= 8) or GEMM (8 < M) in the same case (the
    # earlier design of the grouped and tile routes, through the
    # wrapper's private route)
    core_ms = (time_ms([lambda i=i: qm._qmm_cuda_core(
        x, packed[i], scale[i], zero[i], up=up, **kw) for i in range(L)])
        if grouped or tile else None)
    plain_ms = time_ms([lambda: plain_call(1)], iters=3)
    wrapper_us = host_us(lambda: kernel_call(1))
    # yardstick: a matmul against the dequantized dense weight, bf16 (a
    # different function) or, for f32 x, f32 (the same function; TF32 off)
    wt = dequantize_kn(QuantizedTensor(packed[1], scale[1], zero[1], nbits,
                                       128, (N, K), sb),
                       torch.float32).to(x_dtype).contiguous()
    xa = (qm.swiglu_plain(x, u) if "swiglu" in kernel else x)
    library_ms = time_ms([lambda: torch.matmul(xa, wt)])
    del wt
    nbytes = (weight_bytes(packed, scale, N)
              + (2 if "swiglu" in kernel else 1) * x.numel() * x.element_size()
              + M * N * (4 if out_dtype == torch.float32 else 2))
    # the float32 forms run three bf16 products (x's parts)
    b_ms, b_by = bound(nbytes, (3 if f32 else 1) * 2 * M * N * K)
    rec = dict(kernel=kernel, site=site, nbits=nbits, M=M,
               meta=str(meta_dtype).split(".")[-1],
               dtype=str(x_dtype).split(".")[-1],
               route=("grouped" if grouped else "tile" if tile
                      else "gemv" if M <= 8 else "gemm"),
               max_abs_err=err, rel_err=rel, rel_err_vs_f32_plain=rel_f32,
               tol=tol, deterministic=deterministic, ms=ms,
               gemv_ms=core_ms if grouped else None,
               gemm_ms=core_ms if tile else None,
               plain_ms=plain_ms, host_us=wrapper_us,
               library_ms=library_ms,
               library=("torch.matmul f32 x dense dequantized f32 weight "
                        "(TF32 off)" if f32 else "torch.matmul bf16 x dense "
                        "dequantized weight (different function)"),
               bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
               ok=(rel <= tol and deterministic
                   and took == (2 * grouped, 2 * tile)
                   and (grouped or tile
                        or not f32 and site not in SITES_SB128)))
    if f32:     # the f32 function on the CUDA cores, for scale
        rec["bound_f32_cores_ms"] = 2 * M * N * K / F32_FLOPS * 1e3
    print("CASE " + json.dumps(rec), flush=True)
    return rec


#: OWQ's packed 7B layouts (N, Kp, superblock): q/k/v/o and gate/up keep
#: Kp 4096 (superblock 1024); down's 10954 non-outlier columns pad to Kp
#: 11008 (superblock 256: below 4 bits two superblocks fill a ring stage)
OWQ_SITES_7B = {"owq_attn": (4096, 4096, 1024), "owq_gate": (11008, 4096, 1024),
                "owq_down": (4096, 11008, 256)}
#: the other small superblocks ``pick_superblock`` gives: a q/k/v/o site
#: whose outliers leave 31 groups (Kp 3968, superblock 128; timed at
#: 1-4 bits) and seven 512-row superblocks (Kp 3584; 1 bit, whose stage
#: holds 1024 rows)
OWQ_SMALL_SB = {"owq_sb128": (4096, 3968, 128), "owq_sb512": (4096, 3584, 512)}


def check_owq_matmul(site, nbits, M, gen, x_dtype=torch.bfloat16):
    """``quant_matmul`` at an OWQ-packed layout (3-bit in native planes,
    f32 scale/zero as ``owq_pack`` writes them, bf16 x and out) against
    its plain version (the grouped form at M <= 8, the tile form at 8 < M)
    and ``quant_matmul_reference``, the route (grouped -- on the spanning
    kernel where a stage holds several superblocks --, tile or CUDA-core)
    by name and held to ``_grouped_applies`` and ``_tile_applies``; the
    CUDA-core GEMV's (M <= 8) or GEMM's time beside it.  Every M <= 8
    call must take the grouped route and beat the CUDA-core GEMV, every
    M > 8 call the tile route (``owq_sb128``: the pair form).
    ``x_dtype`` float32: the float32 forms (grouped or tile), f32 out,
    held to qmm_plain at MM_TOL[float32] (its times reported, not
    gated)."""
    from amq_tpu_torch.core.quantize import QuantizedTensor, dequantize_kn
    from amq_tpu_torch.ops import quant_matmul as qm
    N, K, sb = {**OWQ_SITES_7B, **OWQ_SMALL_SB}[site]
    f32 = x_dtype == torch.float32
    out_dtype = torch.float32 if f32 else torch.bfloat16
    L = max(2, min(24, math.ceil(200e6 / (N * K * nbits / 8))))
    packed = rand_words((L, K * nbits // 32, N), gen)
    scale = torch.rand((L, K // 128, N), generator=gen, device="cuda") * 0.02
    zero = (torch.rand((L, K // 128, N), generator=gen, device="cuda")
            * (2**nbits - 1))
    qts = [QuantizedTensor(packed[i], scale[i], zero[i], nbits, 128, (N, K),
                           sb) for i in range(L)]
    x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
    grouped = qm._grouped_applies(x, packed[1], scale[1], zero[1], nbits, 128,
                                  sb)
    span = grouped and not qm._grouped_whole_stages(nbits, sb)
    tile = qm._tile_applies(x, packed[1], scale[1], zero[1], nbits, 128, sb)
    counter = qm.quant_matmul
    before = (counter.launches, counter.grouped_launches,
              counter.span_launches, counter.tile_launches)
    got = qm.quant_matmul(x, qts[1])
    again = qm.quant_matmul(x, qts[1])
    launched = (counter.launches - before[0],
                counter.grouped_launches - before[1],
                counter.span_launches - before[2],
                counter.tile_launches - before[3])
    reference = qm.quant_matmul_reference(x, qts[1])
    kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb,
              out_dtype=out_dtype)
    plain_fn = (qm.qmm_plain if f32 else qm.qmm_grouped_plain if grouped
                else qm.qmm_tile_plain if tile else None)
    want = (plain_fn(x, packed[1], scale[1], zero[1], **kw) if plain_fn
            else reference)
    torch.cuda.synchronize()
    rel, err = rel_err(got, want)
    rel_ref = rel_err(got, reference)[0]
    ms = time_ms([lambda i=i: qm.quant_matmul(x, qts[i]) for i in range(L)])
    core_ms = (time_ms([lambda i=i: qm._qmm_cuda_core(
        x, packed[i], scale[i], zero[i], **kw) for i in range(L)])
        if grouped or tile else None)
    plain_ms = time_ms([lambda: qm.quant_matmul_reference(x, qts[1])], iters=3)
    wt = dequantize_kn(qts[1], torch.float32).to(x_dtype).contiguous()
    library_ms = time_ms([lambda: torch.matmul(x, wt)])
    del wt
    b_ms, b_by = bound(weight_bytes(packed, scale, N)
                       + x.numel() * x.element_size()
                       + M * N * out_dtype.itemsize,
                       (3 if f32 else 1) * 2 * M * N * K)
    tol = MM_TOL[out_dtype]
    deterministic = bool(torch.equal(got, again))
    rec = dict(kernel="quant_matmul", site=site, nbits=nbits, M=M,
               superblock=sb, meta="float32", dtype=str(x_dtype).split(".")[-1],
               route=("grouped" if grouped else "tile" if tile
                      else "gemv" if M <= 8 else "gemm"),
               spanning=span, max_abs_err=err, rel_err=rel,
               rel_err_vs_reference=rel_ref, tol=tol,
               deterministic=deterministic, ms=ms,
               gemv_ms=core_ms if grouped else None,
               gemm_ms=core_ms if tile else None, plain_ms=plain_ms,
               library_ms=library_ms,
               library=("torch.matmul f32 x dense dequantized f32 weight "
                        "(TF32 off)" if f32 else "torch.matmul bf16 x dense "
                        "dequantized weight (different function)"),
               bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
               ok=(rel <= tol and rel_ref <= tol and deterministic
                   and launched == (2, 2 * int(grouped), 2 * int(span),
                                    2 * int(tile))
                   and (grouped or tile)
                   and (f32 or M > 8 or ms < core_ms)))
    print("CASE " + json.dumps(rec), flush=True)
    return rec


def route_sweep(gen):
    """Every layout the packers give at group 128 (``pick_superblock`` /
    ``pick_superblock_padded`` over K of 128 to 16384: superblocks of 128
    to 1024 rows) at widths 1, 2, 3, 4 and 8, bf16 and f32 x, M 1, 8, 9
    and 64: ``quant_matmul_indexed`` at N 256 and K of three superblocks,
    each call on the grouped ring (M <= 8) or the tile kernel (8 < M),
    within MM_TOL[float32] of its plain version (f32 out), no CUDA-core
    launch (core_launches 0).  A ROUTE_SWEEP line."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.core.bitpack import (pick_superblock,
                                            pick_superblock_padded)
    from amq_tpu_torch.ops import quant_matmul as qm
    t0 = time.perf_counter()
    sbs = sorted({pick_superblock(K) for K in range(128, 16385, 128)}
                 | {pick_superblock_padded(K)[0]
                    for K in range(128, 16385, 128)})
    N, tol = 256, MM_TOL[torch.float32]
    ops.reset_launch_counts()
    worst, bad, calls = 0.0, [], 0
    for nbits in (1, 2, 3, 4, 8):
        for sb in sbs:
            Kp = 3 * sb
            packed = rand_words((1, Kp * nbits // 32, N), gen)
            scale = torch.rand((1, Kp // 128, N), generator=gen,
                               device="cuda") * 0.02
            zero = (torch.rand((1, Kp // 128, N), generator=gen,
                               device="cuda") * (2**nbits - 1))
            kw = dict(nbits=nbits, group_size=128, shape=(N, Kp),
                      superblock=sb, out_dtype=torch.float32)
            for dtype in (torch.bfloat16, torch.float32):
                for M in (1, 8, 9, 64):
                    x = torch.randn((M, Kp), generator=gen,
                                    device="cuda").to(dtype)
                    got = qm.quant_matmul_indexed(x, packed, scale, zero, 0,
                                                  **kw)
                    plain = (qm.qmm_plain if dtype == torch.float32
                             else qm.qmm_grouped_plain if M <= 8
                             else qm.qmm_tile_plain)
                    rel = rel_err(got, plain(x, packed[0], scale[0], zero[0],
                                             **kw))[0]
                    calls += 1
                    worst = max(worst, rel)
                    if not rel <= tol:
                        bad.append((nbits, sb, str(dtype), M, rel))
    torch.cuda.synchronize()
    grouped = sum(ops.grouped_launch_counts().values())
    tile = sum(ops.tile_launch_counts().values())
    pair = [sum(v) for v in zip(*ops.pair_launch_counts().values())]
    rec = dict(superblocks=sbs, widths=[1, 2, 3, 4, 8], M=[1, 8, 9, 64],
               calls=calls, grouped=grouped, tile=tile, pair=pair,
               core=core_launches(), worst_rel_err=worst, tol=tol, bad=bad,
               seconds=time.perf_counter() - t0)
    # 4-row superblocks: 1 and 3 bits at 128 rows, two dtypes, two M each
    rec["ok"] = (not bad and rec["core"] == 0 and grouped + tile == calls
                 and grouped == tile == calls // 2
                 and pair == [8, 8] and sbs == [128, 256, 512, 1024])
    print("ROUTE_SWEEP " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        fail(f"routing sweep: {rec}")
    return rec


def dense_weight(packed, scale, zero, nbits, shape, sb):
    """The dequantized weight [K, N] in bf16 (a library yardstick's input)."""
    from amq_tpu_torch.core.quantize import QuantizedTensor, dequantize_kn
    return dequantize_kn(QuantizedTensor(packed, scale, zero, nbits, 128,
                                         shape, sb),
                         torch.float32).to(torch.bfloat16).contiguous()


def rel_err(got, want):
    """max |got - want| / max |want|, and max |got - want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30), err


#: the evaluation's dequantized sites at 7B (its stacks are unfused and
#: keep N): q/k/v/o, gate/up, and down (K 11008 in whole 1024-superblocks,
#: Kp 11264: the kernel's K tail)
EVAL_SITES_7B = {"o": (4096, 4096), "gate": (11008, 4096),
                 "down": (4096, 11008)}


def check_dequant(nbits, gen, site="gateup"):
    """The dequantization kernel at one 7B site (bf16 meta): the fused
    gateup of a long prefill (K 4096, N 22016 in the lane-padded serving
    layout) or one of the evaluation's own sites (``EVAL_SITES_7B``),
    torch.equal to its plain version in bf16 and f32 out; its time in bf16
    (the evaluation's compute type) beside the plain version's and the
    byte bound (packed words and meta read once, [K, N] written once).  No
    single PyTorch call unpacks the layout, so no library time."""
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.core.quantize import dequantize_kn as dequantize_kn_plain
    from amq_tpu_torch.ops.dequant import dequantize_kn
    serving = site == "gateup"
    N, K = SITES_7B[site][:2] if serving else EVAL_SITES_7B[site]
    packed, scale, zero, sb = rand_site(N, K, nbits, 2, torch.bfloat16, gen,
                                        lane_pad=serving)
    qts = [QuantizedTensor(packed[i], scale[i], zero[i], nbits, 128, (N, K),
                           sb) for i in range(2)]
    equal = {}
    for dt in (torch.bfloat16, torch.float32):
        got = dequantize_kn(qts[1], dt)
        want = dequantize_kn_plain(qts[1], dt)
        torch.cuda.synchronize()
        equal[str(dt).split(".")[-1]] = bool(torch.equal(got, want))
        err = (got.float() - want.float()).abs().max().item()
        del got, want
    ms = time_ms([lambda i=i: dequantize_kn(qts[i], torch.bfloat16)
                  for i in range(2)], iters=10)
    plain_ms = time_ms([lambda: dequantize_kn_plain(qts[1], torch.bfloat16)],
                       iters=3)
    nbytes = weight_bytes(packed, scale, N) + K * N * 2
    b_ms, b_by = bound(nbytes, 0)
    rec = dict(kernel="dequantize_kn", site=site, nbits=nbits, M=None,
               K=K, N=N, Kp=packed.shape[-2] * 32 // nbits,
               Np=packed.shape[-1], meta="bfloat16", out="bfloat16", equal=equal, max_abs_err=err,
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / ms,
               ok=all(equal.values()))
    print("DEQUANT " + json.dumps(rec), flush=True)
    return rec


#: the decode-switch kernels against their plain versions (the grouped
#: form): the JAX suite's normalized bf16 decode tolerance; against the
#: grouped GEMV and its chain (the same splits, products and sums in the
#: same order) they are held to torch.equal
PIPE_TOL = MLP_TOL = 2e-2


def check_pipe(site, nbits, Ms, gen):
    """The pipelined grouped GEMV at one 7B site and width, for each M:
    against its plain version (the grouped form), torch.equal to the
    grouped GEMV (the public wrapper without the switch), two calls
    bit-identical; its time beside the grouped GEMV's and the CUDA-core
    GEMV's (the arithmetic of the pipelined route's earlier design) in the
    same call."""
    from amq_tpu_torch.models.stacked import decode_switches
    from amq_tpu_torch.ops import quant_matmul as qm
    N, K, _ = SITES_7B[site]
    swiglu = site == "down"
    kernel = ("quant_matmul_swiglu_indexed_pipe" if swiglu
              else "quant_matmul_indexed_pipe")
    pipe_fn = getattr(qm, kernel)
    grouped_fn = (qm.quant_matmul_swiglu_indexed if swiglu
                  else qm.quant_matmul_indexed)

    def gemv_fn(x, *rest, **kw):
        *u, packed, scale, zero, i = rest
        return qm._qmm_cuda_core(x, packed[i], scale[i], zero[i],
                                 up=u[0] if u else None, **kw)
    L = max(2, min(24, math.ceil(200e6 / (N * K * nbits / 8))))
    packed, scale, zero, sb = rand_site(N, K, nbits, L, torch.bfloat16, gen)
    wt = dense_weight(packed[1], scale[1], zero[1], nbits, (N, K), sb)
    recs = []
    for M in Ms:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        u = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        act = (x, u) if swiglu else (x,)
        kw = dict(nbits=nbits, group_size=128, shape=(N, K), superblock=sb,
                  out_dtype=torch.bfloat16)

        def plain():
            return qm.qmm_grouped_plain(x, packed[1], scale[1], zero[1],
                                        up=u if swiglu else None, **kw)
        with decode_switches(pipe=False, mlp=False):
            before = pipe_fn.launches
            got = pipe_fn(*act, packed, scale, zero, 1, **kw)
            again = pipe_fn(*act, packed, scale, zero, 1, **kw)
            launched = pipe_fn.launches - before == 2
            grouped = grouped_fn(*act, packed, scale, zero, 1, **kw)
            want = plain()
            torch.cuda.synchronize()
            rel, err = rel_err(got, want)
            equal_grouped = bool(torch.equal(got, grouped))
            deterministic = bool(torch.equal(got, again))
            ms = time_ms([lambda i=i: pipe_fn(*act, packed, scale, zero, i,
                                              **kw) for i in range(L)])
            grouped_ms = time_ms([lambda i=i: grouped_fn(
                *act, packed, scale, zero, i, **kw) for i in range(L)])
            gemv_ms = time_ms([lambda i=i: gemv_fn(*act, packed, scale, zero,
                                                   i, **kw) for i in range(L)])
            plain_ms = time_ms([plain], iters=3)
            wrapper_us = host_us(lambda: pipe_fn(*act, packed, scale, zero, 1,
                                                 **kw))
        xa = qm.swiglu_plain(x, u) if swiglu else x
        library_ms = time_ms([lambda: torch.matmul(xa, wt)])
        nbytes = (weight_bytes(packed, scale, N)
                  + len(act) * x.numel() * 2 + M * N * 2)
        b_ms, b_by = bound(nbytes, 2 * M * N * K)
        rec = dict(kernel=kernel, site=site, nbits=nbits, M=M, meta="bfloat16",
                   route="pipe", max_abs_err=err, rel_err=rel, tol=PIPE_TOL,
                   equal_grouped=equal_grouped, deterministic=deterministic,
                   ms=ms, grouped_ms=grouped_ms, gemv_ms=gemv_ms,
                   plain_ms=plain_ms, host_us=wrapper_us,
                   library_ms=library_ms,
                   library="torch.matmul bf16 x dense dequantized weight "
                   "(different function)", bound_ms=b_ms, bound_by=b_by,
                   share_of_bound=b_ms / ms,
                   ok=(rel <= PIPE_TOL and equal_grouped and deterministic
                       and launched))
        print("CASE " + json.dumps(rec), flush=True)
        recs.append(rec)
    del wt, packed, scale, zero
    return recs


MLP_7B = ((22016, 4096), (4096, 11008))      # gateup, down (N, K)


def check_mlp(nbits, Ms, gen):
    """The one-launch decode MLP at the 7B shapes for each M: against its
    plain version (the grouped form), torch.equal to the public wrappers'
    separate gateup -> SwiGLU-down chain (the grouped GEMVs), two calls
    bit-identical; its time beside that chain's and the CUDA-core chain's
    (the arithmetic of the kernel's earlier design) in the same call."""
    from amq_tpu_torch.models.stacked import decode_switches
    from amq_tpu_torch.ops import quant_matmul as qm
    (Ngu, H), (Nd, I) = MLP_7B
    L = 3                               # > 50 MB of weights per call already
    gu = rand_site(Ngu, H, nbits, L, torch.bfloat16, gen)
    dn = rand_site(Nd, I, nbits, L, torch.bfloat16, gen)
    sb = gu[3]
    assert dn[3] == sb
    gu, dn = gu[:3], dn[:3]
    w_gu = dense_weight(*(t[1] for t in gu), nbits, (Ngu, H), sb)
    w_d = dense_weight(*(t[1] for t in dn), nbits, (Nd, I), sb)
    kw = dict(nbits=nbits, group_size=128, gu_shape=(Ngu, H), d_shape=(Nd, I),
              superblock=sb)
    recs = []
    for M in Ms:
        x = torch.randn((M, H), generator=gen, device="cuda").to(torch.bfloat16)

        def mlp(i, out_dtype=torch.bfloat16):
            return qm.quant_matmul_mlp_indexed(x, *gu, *dn, i,
                                               out_dtype=out_dtype, **kw)

        def chain(i, out_dtype=torch.bfloat16):
            # the public wrappers' chain: the grouped GEMVs
            g = qm.quant_matmul_indexed(x, *gu, i, nbits=nbits, group_size=128,
                                        shape=(Ngu, H), superblock=sb)
            return qm.quant_matmul_swiglu_indexed(
                g[:, :I], g[:, I:], *dn, i, nbits=nbits, group_size=128,
                shape=(Nd, I), superblock=sb, out_dtype=out_dtype)

        def core_chain(i):
            # the CUDA-core GEMV's chain, the kernel's earlier arithmetic
            g = qm._qmm_cuda_core(x, *(t[i] for t in gu), nbits=nbits,
                                  group_size=128, shape=(Ngu, H),
                                  superblock=sb, out_dtype=torch.bfloat16)
            return qm._qmm_cuda_core(
                g[:, :I], *(t[i] for t in dn), up=g[:, I:], nbits=nbits,
                group_size=128, shape=(Nd, I), superblock=sb,
                out_dtype=torch.bfloat16)

        def plain(out_dtype=torch.bfloat16):
            return qm.qmm_mlp_grouped_plain(
                x, *(t[1] for t in gu), *(t[1] for t in dn),
                out_dtype=out_dtype, **kw)

        def library():
            g = torch.matmul(x, w_gu)
            return torch.matmul(qm.swiglu_plain(g[:, :I], g[:, I:]), w_d)

        with decode_switches(pipe=False, mlp=False):
            before = qm.quant_matmul_mlp_indexed.launches
            got = mlp(1, torch.float32)
            again = mlp(1, torch.float32)
            launched = qm.quant_matmul_mlp_indexed.launches - before == 2
            sep = chain(1, torch.float32)
            want = plain(torch.float32)
            torch.cuda.synchronize()
            rel, err = rel_err(got, want)
            equal_chain = bool(torch.equal(got, sep))
            identical = bool(torch.equal(got, again))
            ms = time_ms([lambda i=i: mlp(i) for i in range(L)])
            chain_ms = time_ms([lambda i=i: chain(i) for i in range(L)])
            core_chain_ms = time_ms([lambda i=i: core_chain(i)
                                     for i in range(L)])
            plain_ms = time_ms([plain], iters=2)
            wrapper_us = host_us(lambda: mlp(1))
        library_ms = time_ms([library])
        nbytes = (weight_bytes(gu[0], gu[1], Ngu)
                  + weight_bytes(dn[0], dn[1], Nd) + M * (H + Nd) * 2)
        b_ms, b_by = bound(nbytes, 2 * M * (Ngu * H + Nd * I))
        rec = dict(kernel="quant_matmul_mlp_indexed", site="mlp", nbits=nbits,
                   M=M, meta="bfloat16", route="mlp", max_abs_err=err,
                   rel_err=rel, tol=MLP_TOL, equal_chain=equal_chain,
                   bit_identical=identical, ms=ms, chain_ms=chain_ms,
                   core_chain_ms=core_chain_ms, plain_ms=plain_ms,
                   host_us=wrapper_us, library_ms=library_ms,
                   library="bf16 torch.matmul -> silu*mul -> torch.matmul on "
                   "dense dequantized weights (different function)",
                   bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                   ok=(rel <= MLP_TOL and equal_chain and identical
                       and launched))
        print("CASE " + json.dumps(rec), flush=True)
        recs.append(rec)
    del w_gu, w_d, gu, dn
    return recs


def attn_inputs(B, Hkv, G, hd, T, offsets, gen, L=2):
    dtype = torch.bfloat16
    q = torch.randn((B, Hkv, G, hd), generator=gen, device="cuda").to(dtype)
    kc = torch.randn((L, B, Hkv, T, hd), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((L, B, Hkv, T, hd), generator=gen, device="cuda").to(dtype)
    kn = torch.randn((B, Hkv, hd), generator=gen, device="cuda").to(dtype)
    vn = torch.randn((B, Hkv, hd), generator=gen, device="cuda").to(dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    return q, kc, vc, kn, vn, offs


ATTN_TOL = 2e-4   # float32 outputs; sums in another order than torch's


def check_attention(label, B, Hkv, G, hd, T, offsets, gen, window=None):
    from amq_tpu_torch.ops import decode_attention as da
    q, kc, vc, kn, vn, offs = attn_inputs(B, Hkv, G, hd, T, offsets, gen)
    got = da.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                      window=window, out_dtype=torch.float32)
    again = da.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                        window=window, out_dtype=torch.float32)
    want = da.decode_attention_plain(q, kc[1], vc[1], kn, vn, offs, window,
                                     torch.float32)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    deterministic = bool(torch.equal(got, again))
    ms = time_ms([lambda: da.decode_attention_indexed(
        q, kc, vc, kn, vn, offs, 1, window=window, out_dtype=torch.bfloat16)],
        iters=50)
    wrapper_us = host_us(lambda: da.decode_attention_indexed(
        q, kc, vc, kn, vn, offs, 1, window=window, out_dtype=torch.bfloat16))
    plain_ms = time_ms([lambda: da.decode_attention_plain(
        q, kc[1], vc[1], kn, vn, offs, window, torch.bfloat16)], iters=10)
    # yardstick: SDPA over the cache plus the new column, live keys masked
    # (GQA keys repeated to the query heads)
    k_all = torch.cat([kc[1], kn[:, :, None]], dim=2)
    v_all = torch.cat([vc[1], vn[:, :, None]], dim=2)
    if G > 1:
        k_all = k_all.repeat_interleave(G, dim=1)
        v_all = v_all.repeat_interleave(G, dim=1)
    t = torch.arange(T + 1, device="cuda")
    off = offs.long()[:, None]
    ok = (t[None] < off) | (t[None] == T)
    if window:
        ok &= (t[None] > off - window) | (t[None] == T)
    mask = ok[:, None, None, :]
    qs = q.reshape(B, Hkv * G, 1, hd)
    library_ms = time_ms([lambda: F.scaled_dot_product_attention(
        qs, k_all, v_all, attn_mask=mask)], iters=50)
    t_lo = [max(0, o - window + 1) if window else 0 for o in offsets]
    live = sum(min(o, T) - lo for o, lo in zip(offsets, t_lo))
    nbytes = 2 * live * Hkv * hd * 2 + (2 * B * Hkv * G + 2 * B * Hkv) * hd * 2
    b_ms, b_by = bound(nbytes, 4 * live * Hkv * G * hd)
    rec = dict(kernel="decode_attention_indexed", case=label, B=B, Hkv=Hkv,
               G=G, hd=hd, T=T, offsets=list(offsets), window=window,
               max_abs_err=err, tol=ATTN_TOL, deterministic=deterministic,
               ms=ms, plain_ms=plain_ms, host_us=wrapper_us,
               library_ms=library_ms,
               library="scaled_dot_product_attention over the live keys",
               bound_ms=b_ms, bound_by=b_by,
               ok=err <= ATTN_TOL and deterministic)
    print("CASE " + json.dumps(rec), flush=True)
    return rec


def check_batch_independence(gen):
    """Each row of a float32 B = 4 decode-attention call (offsets 1, 63,
    64, 199) against the same row run alone at B = 1, torch.equal: the
    kernel's warp shares follow the row's own offset, never B (what the
    token-exact float32 slot-batched run of phase 4b rests on)."""
    from amq_tpu_torch.ops import decode_attention as da
    offsets = (1, 63, 64, 199)
    q, kc, vc, kn, vn, offs = (t.float() if t.is_floating_point() else t
                               for t in attn_inputs(4, 32, 1, 128, 200,
                                                    offsets, gen))
    full = da.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                       out_dtype=torch.float32)
    want = da.decode_attention_plain(q, kc[1], vc[1], kn, vn, offs, None,
                                     torch.float32)
    equal = []
    for b in range(len(offsets)):
        alone = da.decode_attention_indexed(
            q[b:b + 1].contiguous(), kc[:, b:b + 1].contiguous(),
            vc[:, b:b + 1].contiguous(), kn[b:b + 1].contiguous(),
            vn[b:b + 1].contiguous(), offs[b:b + 1].contiguous(), 1,
            out_dtype=torch.float32)
        equal.append(bool(torch.equal(full[b:b + 1], alone)))
    torch.cuda.synchronize()
    err = (full - want).abs().max().item()
    rec = dict(kernel="decode_attention_indexed", case="batch-independence",
               B=4, Hkv=32, G=1, hd=128, T=200, offsets=list(offsets),
               dtype="float32", rows_equal=equal, max_abs_err=err,
               tol=ATTN_TOL, ok=all(equal) and err <= ATTN_TOL)
    print("CASE " + json.dumps(rec), flush=True)
    return rec


#: flash attention cases: (label, B, Hq, Hkv, S, T, d, offset, dtype)
FLASH_CASES = (
    ("llama2-7b-eval-bf16", 2, 32, 32, 2048, 2048, 128, 0, torch.bfloat16),
    ("llama2-7b-eval-f32", 2, 32, 32, 2048, 2048, 128, 0, torch.float32),
    ("prefill-cache", 1, 32, 32, 512, 2056, 128, 1536, torch.bfloat16),
    ("gqa-llama3-8b", 2, 32, 8, 2048, 2048, 128, 0, torch.bfloat16),
    ("hd64", 2, 16, 2, 256, 256, 64, 0, torch.bfloat16),
    # f32 (the split-TF32 kernel): GQA, the prefill-cache offset, d 64 and
    # AWQ's calibration length (a batch of 8 samples)
    ("gqa-llama3-8b-f32", 2, 32, 8, 2048, 2048, 128, 0, torch.float32),
    ("prefill-cache-f32", 1, 32, 32, 512, 2056, 128, 1536, torch.float32),
    ("hd64-f32", 2, 16, 2, 256, 256, 64, 0, torch.float32),
    ("awq-calib-f32", 8, 32, 32, 512, 512, 128, 0, torch.float32),
)
#: the kernel each dtype takes
FLASH_DESIGN = {torch.bfloat16: "wgmma m64nNk16 bf16",
                torch.float32: "split TF32 (3xTF32) on mma.sync m16n8k8"}
#: f32: the JAX suite's absolute tolerance (sums in other orders); bf16:
#: max |kernel - plain| / max |plain| (one bf16 rounding of p and of the
#: output each, 2^-8 relative, p against a running vs the final max)
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


def check_flash(label, B, Hq, Hkv, S, T, d, offset, dtype, gen):
    from amq_tpu_torch.ops import flash_attention as fa
    q = torch.randn((B, Hq, S, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, T, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Hkv, T, d), generator=gen, device="cuda").to(dtype)
    off = torch.tensor(offset, dtype=torch.int32, device="cuda")
    got = fa.flash_attention(q, k, v, off)
    deterministic = bool(torch.equal(got, fa.flash_attention(q, k, v, off)))
    want = fa.flash_attention_plain(q, k, v, off)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    score = err if dtype == torch.float32 else err / want.float().abs().max().item()
    del want
    ms = time_ms([lambda: fa.flash_attention(q, k, v, off)], iters=5)
    plain_ms = time_ms([lambda: fa.flash_attention_plain(q, k, v, off)],
                       iters=2)
    wrapper_us = host_us(lambda: fa.flash_attention(q, k, v, off), n=20)
    # yardstick: SDPA on the same tensors (causal from the top-left corner
    # when there is no offset, else the same mask given explicitly)
    if offset == 0 and S == T:
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    else:
        mask = (torch.arange(T, device="cuda")[None, :]
                <= offset + torch.arange(S, device="cuda")[:, None])

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    library_ms = time_ms([sdpa], iters=5)
    # work this run's inputs need: each query row attends min(offset+i+1, T)
    # keys (4 d flops each: q.k and p.v); q and o once, the K/V rows any
    # query sees once per KV head
    keys = sum(min(offset + i + 1, T) for i in range(S))
    flops = 4 * d * keys * B * Hq
    live = min(offset + S, T)
    esize = q.element_size()
    nbytes = (2 * B * Hq * S * d + 2 * B * Hkv * live * d) * esize
    if dtype == torch.bfloat16:
        peak, ops_done = BF16_FLOPS, flops
    else:
        # split TF32: three tensor-core products per product; the CUDA
        # cores' bound beside it
        peak, ops_done = TF32_FLOPS, 3 * flops
    b_ms, b_by = bound(nbytes, ops_done, peak)
    rec = dict(kernel="flash_attention", case=label, B=B, Hq=Hq, Hkv=Hkv,
               S=S, T=T, d=d, offset=offset, dtype=str(dtype).split(".")[-1],
               max_abs_err=err, err_vs_tol=score, tol=FLASH_TOL[dtype],
               deterministic=deterministic, ms=ms, plain_ms=plain_ms,
               host_us=wrapper_us, library_ms=library_ms,
               library="scaled_dot_product_attention(enable_gqa=True)",
               tflops=flops / ms / 1e9,
               share_of_peak=ops_done / ms / 1e-3 / peak, bound_ms=b_ms,
               bound_by=b_by, design=FLASH_DESIGN[dtype],
               ok=score <= FLASH_TOL[dtype] and deterministic)
    if dtype == torch.float32:
        f32_ms, f32_by = bound(nbytes, flops, F32_FLOPS)
        rec.update(bound_f32_cores_ms=f32_ms, bound_f32_cores_by=f32_by,
                   share_of_f32_cores=flops / ms / 1e-3 / F32_FLOPS)
    print("CASE " + json.dumps(rec), flush=True)
    return rec


#: the bf16 flash kernel's symbol (tensor cores), the grouped ring's
#: kernels' (tensor cores, every width: the grouped GEMV -- whole stages,
#: and spanning ones, qmm_grouped_span_kernel --, its pipelined form, the
#: one-launch MLP), and the kernels whose registers and spills phase 2
#: reports (library -> symbol pattern)
WGMMA_FLASH = "flash_kernel_wgmma"
#: the f32 flash kernel's (split TF32 on mma.sync): its tensor-core
#: products of TF32 type, HMMA.1688.F32.TF32 (or HGMMA ... TF32)
TF32_FLASH = "flash_kernel_tf32x3"
TF32_MMA = r"HG?MMA\.\S*TF32"
GROUPED_GEMV = "qmm_grouped"
MLP_KERNEL = "qmm_mlp_kernel"
RING_KERNELS = {"quant_matmul": GROUPED_GEMV, "quant_matmul_pipe":
                GROUPED_GEMV, "quant_matmul_mlp": MLP_KERNEL,
                "quant_matmul_f32": GROUPED_GEMV}
#: instantiations per ring library: widths 1/2/3/4/8 and the spanning
#: kernel's eight superblock forms (1-bit 128 / 256 / 512, 2-bit 128 /
#: 256, 3-bit 128 / 256, 4-bit 128); the pipelined form 1-4; the float32
#: GEMV's widths 1/2/3/4/8 and the eight spanning forms (the 4-row ones,
#: 1 and 3 bits at 128 rows, too), each at one and three n8 column groups
RING_COUNTS = {"quant_matmul": 13, "quant_matmul_pipe": 4,
               "quant_matmul_mlp": 5, "quant_matmul_f32": 26}
#: the tile kernel on wgmma (the multi-row branch of rows 1, 2 and 4):
#: widths 1/2/3/4/8 times one, two or four 64-row M sub-tiles times stages
#: of 8, 16 or 32 word rows, and the pair form (1 and 3 bits, stages of 16
#: rows) at the three M shapes; its float32 form at one sub-tile and
#: stages of 8 or 16, and the pair form at 1 and 3 bits
TILE_KERNEL, TILE_COUNT = "qmm_tile_kernel", 51
TILE_F32_KERNEL, TILE_F32_COUNT = "qmm_tile_f32_kernel", 12
REPORT_KERNELS = {"flash_attention": "flash_kernel", "decode_attention":
                  "decode_attn_kernel", **RING_KERNELS,
                  "dequant": "dequant_kernel",
                  "gemv_attrib": "attrib_grouped_kernel",
                  "gemv_extract_ahead": "extract_ahead_kernel",
                  "quant_matmul_tile": "qmm_tile_"}


def build_report():
    """Phase 2's report on the redesigned kernels: a REGS line (per kernel
    instantiation of the attention kernels, the grouped ring's kernels --
    the grouped GEMV, its pipelined form, the one-launch MLP -- the
    dequantization kernel and the two probe kernels on the ring and on
    wgmma, its registers and local spill bytes, from nvcc's -Xptxas -v) and a SASS line (per flash kernel and ring kernel its
    HGMMA, HMMA and FFMA instructions, and the ring kernels' LOP3 and SHF,
    from cuobjdump -sass, and the f32 flash kernel's TF32 tensor-core
    products, TF32_MMA; the tile kernel's too, with its LDS, and
    ptxas's wgmma notes on it, TILE_PTXAS).  Fails if the bf16 flash
    kernel holds no HGMMA (warpgroup MMA), the f32 one (split TF32) no
    HMMA or HGMMA of TF32 type, a ring kernel (any width) no
    HMMA or HGMMA, a ring library lacks an instantiation, a tile kernel
    instantiation is missing or holds no HGMMA, or one of these kernels
    spills."""
    from amq_tpu_torch.ops import _cuda
    from amq_tpu_torch.probes import kernel_attrib as ka
    regs = {}
    for name, pattern in REPORT_KERNELS.items():
        if name not in _cuda.LOGS:          # built before this run: rebuild
            _cuda._lib_path(name).unlink()
            _cuda.build([name], verbose=True)
        usage = {sym: use for sym, use in
                 _cuda.ptxas_usage(_cuda.LOGS[name]).items()
                 if pattern in sym}
        names = ka.kernel_names(usage)
        regs[name] = {names[sym]: use for sym, use in usage.items()}
    print("REGS " + json.dumps(regs), flush=True)
    flash_sass = ka.sass_listing("flash_attention")
    counts = ka.count_ops(flash_sass, "flash_kernel", ("HGMMA", "HMMA", "FFMA"))
    tf32 = ka.count_forms(flash_sass, TF32_FLASH, {"TF32_MMA": TF32_MMA})
    for sym, c in tf32.items():
        counts[sym].update(c)
    ring = {}
    for lib, pattern in RING_KERNELS.items():
        # the ring kernels' extraction (LOP3, SHF) beside their MMAs
        found = ka.count_ops(ka.sass_listing(lib), pattern,
                             ("HGMMA", "HMMA", "FFMA", "LOP3", "SHF"))
        ring[lib] = len(found)
        counts.update(found)
    tile_sass = ka.sass_listing("quant_matmul_tile")
    tile = ka.count_ops(tile_sass, TILE_KERNEL,
                        ("HGMMA", "HMMA", "FFMA", "LOP3", "SHF", "LDS"))
    tile_f32 = ka.count_ops(tile_sass, TILE_F32_KERNEL,
                            ("HGMMA", "HMMA", "FFMA", "LOP3", "SHF", "LDS"))
    counts.update(tile)
    counts.update(tile_f32)
    names = ka.kernel_names(counts)
    sass = {names[sym]: c for sym, c in counts.items()}
    print("SASS " + json.dumps(sass), flush=True)
    # ptxas's notes on the tile kernel's wgmma pipeline (a serialized
    # wgmma waits for each product before the next extraction)
    notes = sorted({line.strip() for line in
                    _cuda.LOGS["quant_matmul_tile"].splitlines()
                    if "wgmma" in line.lower()})
    print("TILE_PTXAS " + json.dumps(notes), flush=True)
    if any("serializ" in n.lower() for n in notes):
        fail(f"ptxas serializes the tile kernel's wgmma: {notes}")
    if len(tile) != TILE_COUNT or not all(c["HGMMA"] > 0
                                          for c in tile.values()):
        fail(f"tile kernel instantiations {len(tile)} (want {TILE_COUNT}) "
             f"or one without HGMMA: {tile}")
    if len(tile_f32) != TILE_F32_COUNT or not all(
            c["HGMMA"] > 0 for c in tile_f32.values()):
        fail(f"float32 tile kernel instantiations {len(tile_f32)} (want "
             f"{TILE_F32_COUNT}) or one without HGMMA: {tile_f32}")
    wgmma = {sym: c for sym, c in sass.items() if WGMMA_FLASH in sym}
    if len(wgmma) != 2 or not all(c["HGMMA"] > 0 for c in wgmma.values()):
        fail(f"the bf16 flash kernels hold no HGMMA: {sass}")
    if len(tf32) != 2 or not all(c["TF32_MMA"] > 0 for c in tf32.values()):
        fail(f"the f32 flash kernels hold no TF32 tensor-core product: {sass}")
    if ring != RING_COUNTS:
        fail(f"ring kernel instantiations {ring} != {RING_COUNTS}")
    tensor = {sym: c for sym, c in sass.items()
              if GROUPED_GEMV in sym or MLP_KERNEL in sym}
    if not all(c["HMMA"] + c["HGMMA"] > 0 for c in tensor.values()):
        fail(f"a grouped ring kernel holds no HMMA or HGMMA: {sass}")
    spills = [sym for lib in regs.values() for sym, use in lib.items()
              if use["spill_stores"] + use["spill_loads"] > 0]
    if spills:
        fail(f"redesigned kernels spill: {spills}")
    return dict(regs=regs, sass=sass)


# ---------------------------------------------------------------------------
# phase 3c: the decode-GEMV probes

PROBE_SITES, PROBE_BITS = ("qkv", "o", "gu", "down"), (2, 3, 4)
TRACE_CALLS = 8       # eager attribution calls under the profiler
#: the chain timer and time_ms part by more than this: reported, not gated
TIMER_GAP = 0.10


def reckon_probe_launches():
    """Launches of the two probe kernels over phase 3c, reckoned from the
    code: per site and width, kernel_attrib runs both bodies' (grouped,
    gemv) four variants, each one checked call and one chain_us;
    pipelined_gemv one parity call and one chain_us; then one warm-up and
    TRACE_CALLS traced calls of the grouped body."""
    from amq_tpu_torch.probes.chain import CHAIN_LAUNCHES
    from amq_tpu_torch.probes.kernel_attrib import VARIANTS
    cases = len(PROBE_SITES) * len(PROBE_BITS)
    variants = sum(len(v) for v in VARIANTS.values())
    return {"gemv_attrib": (cases * variants * (1 + CHAIN_LAUNCHES)
                            + 1 + TRACE_CALLS),
            "gemv_extract_ahead": cases * (1 + CHAIN_LAUNCHES)}


def probe_launch_counts():
    from amq_tpu_torch.probes import kernel_attrib, pipelined_gemv
    return {"gemv_attrib": kernel_attrib.gemv_attrib.launches,
            "gemv_extract_ahead": pipelined_gemv.gemv_extract_ahead.launches}


def probe_stack(site, nbits, L):
    """The probes' stack and x at one case: chain.random_stack from a
    generator seeded 0, then x, as the probes draw them."""
    from amq_tpu_torch.probes import chain
    N, K = chain.SITES[site]
    gen = torch.Generator(device="cuda").manual_seed(0)
    packed, scale, zero, sb = chain.random_stack(N, K, nbits, L, gen, "cuda")
    x = torch.randn((1, K), generator=gen, device="cuda").to(torch.bfloat16)
    return packed, scale, zero, sb, x


def timer_check(rec):
    """time_ms (this script's mean over a captured graph) of the
    production GEMV at a PIPE_PROBE case, beside the chain timer's µs."""
    from amq_tpu_torch.ops import quant_matmul as qm
    from amq_tpu_torch.probes.chain import CHAIN_LENS
    L = max(CHAIN_LENS)
    packed, scale, zero, sb, x = probe_stack(rec["site"], rec["nbits"], L)
    kw = dict(nbits=rec["nbits"], group_size=128, shape=(rec["N"], rec["K"]),
              superblock=sb)
    us = 1e3 * time_ms([lambda i=i: qm.quant_matmul_indexed(
        x, packed, scale, zero, i, **kw) for i in range(L)], iters=L)
    gap = abs(us - rec["production_us"]) / us
    out = dict(site=rec["site"], nbits=rec["nbits"], time_ms_us=us,
               chain_us=rec["production_us"], rel_gap=gap,
               parted=gap > TIMER_GAP)
    print("TIMER_CHECK " + json.dumps(out), flush=True)
    return out


def trace_attrib_chain():
    """TRACE_CALLS eager calls of the attribution kernel (full, grouped
    body, gateup 4-bit) under amq_tpu_torch.utils.profiling.device_trace;
    the kernel's device µs per call as the trace counts it."""
    from amq_tpu_torch.probes import kernel_attrib
    from amq_tpu_torch.utils.profiling import device_trace
    packed, scale, zero, sb, x = probe_stack("gu", 4, TRACE_CALLS)
    kw = dict(nbits=4, group_size=128, shape=(22016, 4096), superblock=sb,
              body="grouped")
    kernel_attrib.gemv_attrib(x, packed[0], scale[0], zero[0], **kw)  # warm
    logdir = os.path.join(OUT_DIR, "probe_trace")
    with device_trace(logdir) as prof:
        for i in range(TRACE_CALLS):
            kernel_attrib.gemv_attrib(x, packed[i], scale[i], zero[i], **kw)
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if "attrib_grouped_kernel" in e.key)
    rec = dict(logdir=logdir, calls=TRACE_CALLS,
               trace_bytes=os.path.getsize(os.path.join(logdir, "trace.json")),
               device_us_per_call=dev_us / TRACE_CALLS)
    print("PROBE_TRACE " + json.dumps(rec), flush=True)
    return rec


def probe_headline(kind, attrib, pipe):
    """The kernels-line numbers of one probe kernel at gateup, 4-bit, M 1
    (the attribution kernel: its grouped body's full): time_ms over a
    40-layer stack (outside the counted phase), the plain version's time,
    the library yardstick (bf16 torch.matmul on the dense dequantized
    weight, a different function) and the bound (weights + x + output
    over 3.35 TB/s)."""
    from amq_tpu_torch.probes import kernel_attrib as ka
    from amq_tpu_torch.probes import pipelined_gemv as pg
    from amq_tpu_torch.probes.chain import CHAIN_LENS
    L = max(CHAIN_LENS)
    N, K = 22016, 4096
    packed, scale, zero, sb, x = probe_stack("gu", 4, L)
    kw = dict(nbits=4, group_size=128, shape=(N, K), superblock=sb)
    if kind == "gemv_attrib":
        rec = next(r for r in attrib if r["site"] == "gu" and r["nbits"] == 4
                   and r["body"] == "grouped")
        err = rec["checks"]["full"]["max_abs_err"]
        fn = lambda i: ka.gemv_attrib(x, packed[i], scale[i], zero[i],
                                      body="grouped", **kw)
        plain = lambda: ka.attrib_plain("full", x, packed[1], scale[1],
                                        zero[1], body="grouped", **kw)
    else:
        rec = next(r for r in pipe if r["site"] == "gu" and r["nbits"] == 4)
        err = rec["max_abs_err"]
        fn = lambda i: pg.gemv_extract_ahead(x, packed[i], scale[i], zero[i],
                                             **kw)
        plain = lambda: pg.extract_ahead_plain(x, packed[1], scale[1],
                                               zero[1], **kw)
    ms = time_ms([lambda i=i: fn(i) for i in range(L)], iters=L)
    plain_ms = time_ms([plain], iters=2)
    wt = dense_weight(packed[1], scale[1], zero[1], 4, (N, K), sb)
    library_ms = time_ms([lambda: torch.matmul(x, wt)])
    del wt
    b_ms, b_by = bound(weight_bytes(packed, scale, N) + K * 2 + N * 2,
                       2 * N * K)
    return dict(kernel=kind, site="gateup", nbits=4, M=1, meta="bfloat16",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def probes_phase():
    """Phase 3c; returns its records, the launch counts and the two
    headline records."""
    from amq_tpu_torch.probes import (kernel_attrib, kernel_roofline,
                                      pipelined_gemv)
    from amq_tpu_torch.utils.profiling import Tracer
    tracer = Tracer()
    bits = [str(b) for b in PROBE_BITS]
    kernel_attrib.gemv_attrib.launches = 0
    pipelined_gemv.gemv_extract_ahead.launches = 0
    attrib, pipe = [], []
    for site in PROBE_SITES:
        with tracer.span("kernel_attrib"):
            attrib += kernel_attrib.main([site, *bits])
        with tracer.span("pipelined_gemv"):
            pipe += pipelined_gemv.main([site, *bits])
        torch.cuda.empty_cache()
    with tracer.span("kernel_roofline"):
        roof = kernel_roofline.main([])
    with tracer.span("device_trace"):
        trace = trace_attrib_chain()
    counts = probe_launch_counts()
    want = reckon_probe_launches()
    with tracer.span("timer_check"):
        timers = [timer_check(r) for r in pipe]
    torch.cuda.empty_cache()
    with tracer.span("sass"):
        sass = kernel_attrib.sass_counts() + pipelined_gemv.sass_counts()
    for r in sass:
        print("ATTRIB_SASS " + json.dumps(r), flush=True)
    print("PROBE_TRACER " + json.dumps(tracer.summary()), flush=True)
    print(f"probe launches: {counts} (want {want})", flush=True)
    if counts != want:
        fail(f"probe launch counts {counts} != {want}")
    bad = [r for r in attrib + pipe + roof if not r["ok"]]
    if bad:
        fail(f"{len(bad)} probe cases failed their checks: {bad[:2]}")
    unpinned = [(r["site"], r["nbits"], r["body"], r["occupancy"])
                for r in attrib if not r["pinned"]]
    if unpinned:
        fail(f"attribution variants off full's blocks per SM: {unpinned}")
    wgmma = [r for r in sass if "extract_ahead_kernel" in r.get("kernel", "")]
    if len(wgmma) != len(PROBE_BITS) or not all(r["HGMMA"] > 0
                                                for r in wgmma):
        fail(f"the extract-ahead kernels hold no HGMMA: {wgmma}")
    heads = {k: probe_headline(k, attrib, pipe)
             for k in ("gemv_attrib", "gemv_extract_ahead")}
    for h in heads.values():
        print("PROBE_HEADLINE " + json.dumps(h), flush=True)
    return dict(attrib=attrib, pipe=pipe, roofline=roof, trace=trace,
                timer_check=timers, sass=sass, tracer=tracer.summary(),
                launches=counts, want=want, headline=heads)


# ---------------------------------------------------------------------------
# phase 4: full-width decode

BITS = (2, 3, 4)
CONTAINER = {2: 2, 3: 4, 4: 4}
PROMPT, GEN = 64, 128


def random_llama7b(cfg, gen, container=CONTAINER):
    """Llama-2-7B serving model with random packed weights, built on the
    card: fused qkv / gateup sites, every site of layer i at BITS[i % 3],
    compact per-container stacks (the merge_containers layout; the widths
    of ``container``, by default 3-bit codes in 4-bit containers), bf16
    scale/zero, 8-bit packed head.  Any stacked config: with qkv bias
    (phase 4d's Qwen2-0.5B) the qkv site gets a random f32 bias [L, N]."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.models.stacked import StackedModel, StackedQuant
    L, H = cfg.num_layers, cfg.hidden_size
    sites = {"self_attn.qkv_proj": (cfg.q_dim + 2 * cfg.kv_dim, H),
             "self_attn.o_proj": (H, cfg.q_dim),
             "mlp.gateup_proj": (2 * cfg.intermediate_size, H),
             "mlp.down_proj": (H, cfg.intermediate_size)}
    containers = sorted(set(container.values()))
    layer_cont = [containers.index(container[BITS[i % 3]]) for i in range(L)]
    slots, members = [], [[] for _ in containers]
    for i, c in enumerate(layer_cont):
        slots.append(len(members[c]))
        members[c].append(i)
    stacks = {}
    for name, (N, K) in sites.items():
        stacks[name] = []
        for ci, w in enumerate(containers):
            packed, scale, zero, sb = rand_site(N, K, w, len(members[ci]),
                                                torch.bfloat16, gen)
            stacks[name].append(StackedQuant(packed, scale, zero, w, 128,
                                             (N, K), sb))
        stacks[name] = tuple(stacks[name])
    Vp = cfg.vocab_size + (-cfg.vocab_size % 2048)
    hsb, _ = pick_superblock_padded(H)
    head = QuantizedTensor(
        packed=rand_words((H * 8 // 32, Vp), gen),
        scale=(torch.rand((H // 128, Vp), generator=gen, device="cuda")
               * 0.02).to(torch.bfloat16),
        zero=(torch.rand((H // 128, Vp), generator=gen, device="cuda")
              * 255).to(torch.bfloat16),
        nbits=8, group_size=128, shape=(cfg.vocab_size, H), superblock=hsb)
    ones = torch.ones((L, H), dtype=torch.bfloat16, device="cuda")
    embed = (torch.randn((cfg.vocab_size, H), generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
    biases = {n: None for n in sites}
    if cfg.qkv_bias:
        biases["self_attn.qkv_proj"] = torch.randn(
            (L, sites["self_attn.qkv_proj"][0]), generator=gen,
            device="cuda") * 0.02
    return StackedModel(
        embed=embed, final_norm=ones[0].clone(), lm_head=None,
        input_norm=ones, post_norm=ones.clone(), sites=stacks,
        biases=biases,
        select={n: list(layer_cont) for n in sites},
        bits_range=tuple(containers), num_layers=L, uniform_select=True,
        slots=slots, lm_head_qt=head)


def weight_bytes_per_token(model):
    """Packed weights + scale/zero the decode step must read once per
    token (the layers' selected stacks, the head), plus one embed row."""
    total = 0
    for name, stacks in model.sites.items():
        for i in range(model.num_layers):
            s = stacks[model.select[name][i]]
            total += weight_bytes(s.packed, s.scale, s.shape[0])
    qt = model.lm_head_qt
    total += weight_bytes(qt.packed, qt.scale, qt.shape[0])
    return total + model.embed.shape[1] * 2


#: kernel path vs plain path, last-position prefill logits normalized by
#: the largest plain logit, in float32 compute: the two paths differ only
#: in summation order, and 32 layers compound it
LOGIT_TOL = 1e-3


def logits_check(model, cfg, prompt, compute_dtype):
    """Kernel path vs plain path (dequantize, library matmul, split
    attention) on the same model and prompt.  Gated in float32; in
    bfloat16 both round the weights to bf16 (the plain path once, from
    f32; the tile kernel op by op, as the JAX package's multi-row
    kernels), and the gap there is reported, not gated."""
    from amq_tpu_torch.serving.engine import Engine
    outs = []
    for use_kernels in (True, False):
        eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + GEN + 8,
                     compute_dtype=compute_dtype, cache_dtype=compute_dtype,
                     use_kernels=use_kernels)
        last, _ = eng._prefill(model, eng.tokens_to_device(prompt),
                               eng.new_cache())
        outs.append(last.float())
    torch.cuda.synchronize()
    k, p = outs
    if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
        fail(f"non-finite logits ({compute_dtype})")
    rel = ((k - p).abs().max() / p.abs().max()).item()
    gated = compute_dtype == torch.float32
    rec = dict(compute=str(compute_dtype).split(".")[-1], rel_err=rel,
               tol=LOGIT_TOL if gated else None,
               top1_agree=bool((k.argmax(-1) == p.argmax(-1)).all()),
               ok=rel <= LOGIT_TOL if gated else True)
    print("LOGITS " + json.dumps(rec), flush=True)
    return rec


def device_profile(run, steps, top=8):
    """Device time by kernel per step over ``run()`` (which takes ``steps``
    decode steps; torch.profiler), the wall time of the same window and
    the card's busy share; the ``top`` kernels (all of them under
    ``kernels_ms_per_token`` with ``top=None``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device kernels only (aten:: rows and the port's record_function
    # spans repeat their kernels' time), names cut to 60 characters and
    # summed under the cut name
    by_name = {}
    for ev in prof.key_averages():
        if (ev.self_device_time_total > 0 and not ev.is_user_annotation
                and not ev.key.startswith("aten::")):
            key = ev.key[:60]
            by_name[key] = (by_name.get(key, 0.0)
                            + ev.self_device_time_total / steps / 1e3)
    device_ms = sum(by_name.values())
    rec = dict(steps=steps, wall_ms_per_token=wall_ms,
               device_ms_per_token=device_ms,
               device_busy_share=device_ms / wall_ms)
    if top is None:
        rec["kernels_ms_per_token"] = by_name
    else:
        rec["top_kernels_ms_per_token"] = dict(
            sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return rec


def profile_decode(eng, prompt, steps=8, tag="PROFILE"):
    """Device time by kernel over ``steps`` decode steps of one stream,
    printed as a ``tag`` line."""
    model = eng.params
    cache = eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt), cache)
    eng._decode_n(model, first, cache, n_steps=2)
    rec = device_profile(
        lambda: eng._decode_n(model, first, cache, n_steps=steps), steps)
    print(f"{tag} " + json.dumps(rec), flush=True)
    return rec


LONG_PROMPT, LONG_GEN = 512, 16


def long_prompt_generate(model, cfg):
    """One generate from a 512-token prompt: the prefill's attention runs
    the flash kernel once per layer (the decode steps take decode
    attention), and its linears dequantize once per site."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.serving.engine import Engine
    eng = Engine(model, cfg, batch_size=1, max_len=LONG_PROMPT + LONG_GEN + 8)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LONG_PROMPT)).astype(np.int32)
    eng.generate(prompt, max_new_tokens=2)                    # warm-up
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompt, max_new_tokens=LONG_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rec = dict(prompt=LONG_PROMPT, gen=LONG_GEN, wall_s=wall, launches=counts)
    print("LONG_PROMPT " + json.dumps(rec), flush=True)
    if counts["flash_attention"] != cfg.num_layers:
        fail(f"512-token prefill: {counts['flash_attention']} flash launches, "
             f"want {cfg.num_layers}")
    # M = 512 >= 256: the four fused sites of every layer and the packed
    # head dequantize (then a library matmul); the decode steps do not
    if counts["dequantize_kn"] != 4 * cfg.num_layers + 1:
        fail(f"512-token prefill: {counts['dequantize_kn']} dequantize_kn "
             f"launches, want {4 * cfg.num_layers + 1}")
    if toks.shape != (1, LONG_GEN) or not ((toks >= 0)
                                          & (toks < cfg.vocab_size)).all():
        fail(f"long-prompt tokens out of range: {toks.shape}")
    return rec


# ---------------------------------------------------------------------------
# phase 4b: serving breadth (decode switches, continuous batching,
# speculative decoding) at full width and depth

SWITCHES = {"default": (False, False), "pipe": (True, False),
            "pipe+mlp": (True, True)}
SLOTS, REQUESTS, CHUNK = 4, 16, 8


def reckon_decode(L, prefills, prefill_rows, steps, pipe, mlp):
    """Launches of ``prefills`` prefills of ``prefill_rows`` rows and
    ``steps`` decode steps of the fused, layer-uniform 7B model, reckoned
    from the code: per layer qkv, o and gateup GEMVs, the SwiGLU-down
    GEMV, decode attention; one head launch per forward.  Prefills take
    the non-pipelined kernels (M > 8); under AMQ_PIPE every decode GEMV
    (M = 1, bf16, T = 8, a layout the grouped ring takes) takes the
    pipelined grouped kernel; under AMQ_MLP_KERNEL too the gateup and down
    GEMVs become one MLP launch."""
    from amq_tpu_torch import ops
    want = {n: 0 for n in ops.launch_counts()}
    assert 8 < prefill_rows < 256
    gemv = "quant_matmul_indexed_pipe" if pipe else "quant_matmul_indexed"
    down = ("quant_matmul_swiglu_indexed_pipe" if pipe
            else "quant_matmul_swiglu_indexed")
    want["quant_matmul_indexed"] += 3 * L * prefills
    want["quant_matmul_swiglu_indexed"] += L * prefills
    want[gemv] += (2 if mlp else 3) * L * steps
    if mlp:
        want["quant_matmul_mlp_indexed"] += L * steps
    else:
        want[down] += L * steps
    want["decode_attention_indexed"] = L * steps
    want["quant_matmul"] = prefills + steps
    return want


def reckon_tile(L, prefills):
    """Launches that take the tile kernel on wgmma over ``prefills``
    bf16 prefills of 8 < M < 256 rows (reckon_decode's): per layer the
    qkv, o and gateup products and the SwiGLU-down product, and the head
    -- 96 + 32 + 1 per prefill of the 32-layer model.  Decode steps (M
    <= 8) take the grouped GEMV."""
    return {"quant_matmul_indexed": 3 * L * prefills,
            "quant_matmul_swiglu_indexed": L * prefills,
            "quant_matmul": prefills}


def reckon_grouped(L, steps, pipe):
    """Launches that take the grouped GEMV over ``steps`` decode steps (M
    <= 8, bf16) of the fused 7B model, reckoned from the code: per layer
    the qkv, o and gateup GEMVs and the SwiGLU-down GEMV (unless AMQ_PIPE
    sends them all to the pipelined grouped kernel, which counts on its
    own wrappers), and the head.  Prefills (M = 64, their head too) take
    the tile kernel (reckon_tile)."""
    return {"quant_matmul_indexed": 0 if pipe else 3 * L * steps,
            "quant_matmul_swiglu_indexed": 0 if pipe else L * steps,
            "quant_matmul": steps}


def core_launches():
    """Launches of rows 1, 2 and 4 since the counts were reset that took
    the CUDA-core GEMV or GEMM: each wrapper's launches that took neither
    the grouped ring (bf16 or its float32 form) nor the tile kernel."""
    from amq_tpu_torch import ops
    return sum(fn.launches - fn.grouped_launches - fn.tile_launches
               for fn in ops.GROUPED)


def f32_serve(model, cfg, prompt):
    """The float32 main path (phase 4): Engine.generate at compute dtype
    float32 on captured graphs, counted -- every decode GEMV of rows 1, 2
    and 4 and the head on the grouped ring's float32 form
    (reckon_grouped), every prefill product on the tile kernel's
    (reckon_tile), no CUDA-core launch -- then decode ms/token and the
    64-token prefill's ms (benchmark_speed).  An F32_SERVE line."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.serving.benchmark import benchmark_speed
    from amq_tpu_torch.serving.engine import Engine
    L = cfg.num_layers
    eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + GEN + 8,
                 compute_dtype=torch.float32, cache_dtype=torch.float32)
    ops.reset_launch_counts()
    toks = eng.generate(prompt, max_new_tokens=GEN)
    torch.cuda.synchronize()
    got = dict(launches=ops.launch_counts(),
               grouped=ops.grouped_launch_counts(),
               tile=ops.tile_launch_counts(), core=core_launches())
    want = dict(launches=reckon_decode(L, 1, PROMPT, GEN - 1, False, False),
                grouped=reckon_grouped(L, GEN - 1, False),
                tile=reckon_tile(L, 1), core=0)
    speed = {mode: benchmark_speed(eng, mode, prompt_len=PROMPT, gen_len=GEN)
             for mode in ("GEMV", "GEMM")}
    rec = dict(compute="float32", prompt=PROMPT, gen=GEN, **got,
               want=want, decode_ms_per_token=speed["GEMV"]["decode_token_ms"],
               prefill_ms=speed["GEMM"]["prefill_ms"],
               tokens_in_range=bool(toks.shape == (1, GEN) and (
                   (toks >= 0) & (toks < cfg.vocab_size)).all()),
               card=smi_line())
    print("F32_SERVE " + json.dumps(rec), flush=True)
    del eng
    torch.cuda.empty_cache()
    if got != want or not rec["tokens_in_range"]:
        fail(f"float32 serving launches {got} != {want}, or tokens out of "
             f"range")
    return rec


def first_step_logits(eng, model, prompt):
    """Logits [V] of the first decode step after the prompt's prefill."""
    cache = eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                      cache)
    with torch.inference_mode():
        logits, _ = eng._forward(model, first[:, None], cache)
    return logits[0, -1].float()


def switches_phase(eng, model, cfg, prompt, default_toks):
    """(a), (b): one generate under AMQ_PIPE, then under both switches:
    exact launch counts; tokens and first-step logits equal to the default
    kernels' (the switch kernels give the grouped GEMVs' bits).
    Then, in one call, the device time by kernel per decode token of the
    three settings (SWITCHES_PROFILE lines), and decode ms/token
    (benchmark_speed GEMV) of the three in turns, twice (ABCCBA)."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.models.stacked import decode_switches
    from amq_tpu_torch.serving.benchmark import benchmark_speed
    L = cfg.num_layers
    with decode_switches(pipe=False, mlp=False):
        base = first_step_logits(eng, model, prompt)
    recs = {}
    for label in ("pipe", "pipe+mlp"):
        pipe, mlp = SWITCHES[label]
        with decode_switches(pipe=pipe, mlp=mlp):
            ops.reset_launch_counts()
            toks = eng.generate(prompt, max_new_tokens=GEN)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            grouped = ops.grouped_launch_counts()
            tiles = ops.tile_launch_counts()
            logits = first_step_logits(eng, model, prompt)
        want = reckon_decode(L, 1, PROMPT, GEN - 1, pipe, mlp)
        want_grouped = reckon_grouped(L, GEN - 1, pipe)
        rec = dict(switches=label, launches=counts, want=want,
                   grouped_launches=grouped, want_grouped=want_grouped,
                   tile_launches=tiles,
                   token_agreement=float((toks == default_toks).mean()),
                   max_logit_diff=(logits - base).abs().max().item(),
                   logit_scale=base.abs().max().item())
        print("SWITCHES " + json.dumps(rec), flush=True)
        if counts != want:
            fail(f"{label}: launch counts {counts} != {want}")
        if grouped != want_grouped:
            fail(f"{label}: grouped launches {grouped} != {want_grouped}")
        if tiles != reckon_tile(L, 1):
            fail(f"{label}: tile launches {tiles} != {reckon_tile(L, 1)}")
        if toks.shape != (1, GEN) or not ((toks >= 0)
                                          & (toks < cfg.vocab_size)).all():
            fail(f"{label}: generated tokens out of range")
        if rec["token_agreement"] != 1.0 or rec["max_logit_diff"] != 0.0:
            fail(f"{label}: tokens or logits differ from the default "
                 f"kernels': {rec}")
        recs[label] = rec
    recs["profile"] = {}
    for label in SWITCHES:
        with decode_switches(*SWITCHES[label]):
            recs["profile"][label] = profile_decode(
                eng, prompt, tag=f"SWITCHES_PROFILE {label}")
    order = list(SWITCHES) + list(SWITCHES)[::-1]
    ms = {label: [] for label in SWITCHES}
    for label in order:
        with decode_switches(*SWITCHES[label]):
            ms[label].append(benchmark_speed(
                eng, "GEMV", prompt_len=PROMPT, gen_len=GEN)["decode_token_ms"])
    recs["decode_token_ms"] = ms
    print("SWITCHES_DECODE_MS " + json.dumps(ms), flush=True)
    return recs


def continuous_profile(model, cfg):
    """Where a slot-batched decode step's time goes: one chunk of 8 steps
    with all 4 slots decoding, for the default kernels and both
    switches."""
    from amq_tpu_torch.models.stacked import decode_switches
    from amq_tpu_torch.serving.batched import SlotEngine
    rng = np.random.default_rng(3)
    recs = {}
    for label in ("default", "pipe+mlp"):
        se = SlotEngine(model, cfg, n_slots=SLOTS, max_len=PROMPT + 3 * CHUNK,
                        prefill_buckets=(PROMPT,), chunk_steps=CHUNK)
        with decode_switches(*SWITCHES[label]):
            for slot in range(SLOTS):
                se.prefill(slot, rng.integers(0, cfg.vocab_size, PROMPT))
            active = np.ones(SLOTS, bool)
            se.step_chunk(active, CHUNK)                         # warm-up
            rec = device_profile(lambda: se.step_chunk(active, CHUNK), CHUNK)
        rec = dict(switches=label, slots=SLOTS, **rec)
        print("CONTINUOUS_PROFILE " + json.dumps(rec), flush=True)
        recs[label] = rec
        del se
    return recs


def continuous_phase(model, cfg):
    """(c): benchmark_continuous (4 slots, 16 requests, prompt 64, 128
    tokens, decode chunks of 8) with the default kernels, then with both
    switches; the launch counts of its two runs (warm-up and timed) equal
    twice the count reckoned for one."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.models.stacked import decode_switches
    from amq_tpu_torch.serving.benchmark import benchmark_continuous
    L = cfg.num_layers
    # every request has the same length, so the slots run in waves: per
    # wave one prefill per slot, then whole decode chunks until the
    # GEN - 1 decode tokens are in (the last chunk runs to its end)
    waves = math.ceil(REQUESTS / SLOTS)
    steps = waves * math.ceil((GEN - 1) / CHUNK) * CHUNK
    recs = {}
    for label in ("default", "pipe+mlp"):
        pipe, mlp = SWITCHES[label]
        with decode_switches(pipe=pipe, mlp=mlp):
            ops.reset_launch_counts()
            res = benchmark_continuous(
                model, cfg, n_slots=SLOTS, n_requests=REQUESTS,
                prompt_len=PROMPT, gen_len=GEN, max_len=PROMPT + GEN + 8,
                chunk_steps=CHUNK)
            counts = ops.launch_counts()
            grouped = ops.grouped_launch_counts()
            tiles = ops.tile_launch_counts()
        per_run = reckon_decode(L, REQUESTS, PROMPT, steps, pipe, mlp)
        want = {k: 2 * v for k, v in per_run.items()}
        want_grouped = {k: 2 * v for k, v in
                        reckon_grouped(L, steps, pipe).items()}
        rec = dict(switches=label, **res, launches_per_run={
            k: v / 2 for k, v in counts.items()}, want_per_run=per_run,
            grouped_per_run={k: v / 2 for k, v in grouped.items()},
            tile_per_run={k: v / 2 for k, v in tiles.items()})
        print("CONTINUOUS " + json.dumps(rec), flush=True)
        if counts != want:
            fail(f"continuous {label}: launch counts {counts} != {want}")
        want_tile = {k: 2 * v for k, v in reckon_tile(L, REQUESTS).items()}
        if tiles != want_tile:
            fail(f"continuous {label}: tile launches {tiles} != {want_tile}")
        if grouped != want_grouped:
            fail(f"continuous {label}: grouped launches {grouped} != "
                 f"{want_grouped}")
        if res["total_tokens"] != REQUESTS * GEN:
            fail(f"continuous {label}: {res['total_tokens']} tokens, want "
                 f"{REQUESTS * GEN}")
        recs[label] = rec
    return recs


def slot_f32_check(model, cfg):
    """(d): float32, kernels on: SlotEngine.run (2 slots, 4 requests of
    staggered prompt lengths, 16 tokens each) token-exact against each
    request's own Engine.generate."""
    from amq_tpu_torch.serving.batched import SlotEngine
    from amq_tpu_torch.serving.engine import ContinuousBatcher, Engine, Request
    lens, n_new = (64, 23, 40, 57), 16
    max_len = max(lens) + n_new + 8
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    from amq_tpu_torch import ops
    ops.reset_launch_counts()
    eng = Engine(model, cfg, batch_size=1, max_len=max_len,
                 compute_dtype=torch.float32, cache_dtype=torch.float32)
    want = {u: eng.generate(p[None], max_new_tokens=n_new)[0].tolist()
            for u, p in enumerate(prompts)}
    se = SlotEngine(model, cfg, n_slots=2, max_len=max_len,
                    compute_dtype=torch.float32, prefill_buckets=lens)
    batcher = ContinuousBatcher(n_slots=2, max_len=max_len)
    for u, p in enumerate(prompts):
        batcher.submit(Request(uid=u, prompt=p, max_new_tokens=n_new))
    got = se.run(batcher)
    agree = sum(got.get(u) == want[u] for u in want)
    torch.cuda.synchronize()
    rec = dict(prompts=list(lens), new_tokens=n_new, slots=2,
               requests_token_exact=agree, requests=len(want),
               grouped_launches=sum(ops.grouped_launch_counts().values()),
               tile_launches=sum(ops.tile_launch_counts().values()),
               core_launches=core_launches())
    print("SLOT_F32 " + json.dumps(rec), flush=True)
    if agree != len(want):
        fail(f"float32 SlotEngine differs from generate: {got} vs {want}")
    if rec["core_launches"] or not rec["grouped_launches"]:
        fail(f"float32 slots ran the CUDA-core GEMV / GEMM: {rec}")
    del se, eng
    torch.cuda.empty_cache()
    return rec


SPEC_GAMMA, SPEC_NEW, SPEC_PLAIN_NEW = 4, 64, 16
VERIFY_WINDOWS = 6


class LayerRecorder:
    """Sub-block outputs of every layer of each forward, recorded by
    wrapping the model's own functions (nothing in the model changes):
    the qkv product, the attention output, the o_proj and down outputs.
    ``take()`` returns one forward's lists (layer order) and clears."""

    SITES = ("self_attn.qkv_proj", "self_attn.o_proj")

    def __init__(self):
        self.rec = {"qkv": [], "attn": [], "o": [], "down": []}
        #: per layer, the largest |decode kernel - its plain version| on
        #: the same inputs (the kernel path's M = 1 attention)
        self.decode_vs_plain = {}

    def patches(self):
        from unittest import mock
        from amq_tpu_torch.models import llama, stacked
        from amq_tpu_torch.ops import decode_attention as da
        site, down = stacked._apply_site, stacked._apply_down_swiglu
        attn, dec = llama.attention_append, da.decode_attention_indexed

        def site_w(model, name, i, x, *a, **k):
            y = site(model, name, i, x, *a, **k)
            if name in self.SITES:
                self.rec["qkv" if "qkv" in name else "o"].append(y)
            return y

        def down_w(*a, **k):
            y = down(*a, **k)
            self.rec["down"].append(y)
            return y

        def attn_w(q, *a, **k):
            y = attn(q, *a, **k)
            self.rec["attn"].append(y.reshape(q.shape[0], q.shape[1], -1))
            return y

        def dec_w(q, kc, vc, kn, vn, offs, layer, window=None,
                  out_dtype=torch.bfloat16):
            # the wrapper counts on the module's function, here dec_w
            dec_w.launches = dec.launches
            y = dec(q, kc, vc, kn, vn, offs, layer, window=window,
                    out_dtype=out_dtype)
            dec.launches = dec_w.launches
            self.rec["attn"].append(y.reshape(q.shape[0], 1, -1))
            ref = da.decode_attention_plain(q, kc[layer], vc[layer], kn, vn,
                                            offs, window, out_dtype)
            err = (y.float() - ref.float()).abs().max().item()
            self.decode_vs_plain[layer] = max(
                err, self.decode_vs_plain.get(layer, 0.0))
            return y

        return (mock.patch.object(stacked, "_apply_site", site_w),
                mock.patch.object(stacked, "_apply_down_swiglu", down_w),
                mock.patch.object(llama, "attention_append", attn_w),
                mock.patch.object(da, "decode_attention_indexed", dec_w))

    def take(self):
        out = {k: list(v) for k, v in self.rec.items()}
        for v in self.rec.values():
            v.clear()
        return out


def layer_states(rec, x0):
    """Per layer [1, S, .] the qkv and attention outputs and the residual
    stream after attention and after the MLP, rebuilt from the recorded
    sub-block outputs with the model's own bf16 additions."""
    states = {"qkv": rec["qkv"], "attn": rec["attn"], "h_attn": [],
              "h_mlp": []}
    x = x0
    for o, d in zip(rec["o"], rec["down"]):
        x = x + o
        states["h_attn"].append(x)
        x = x + d
        states["h_mlp"].append(x)
    return states


def verify_gap(model, cfg, prompt, use_kernels):
    """A witness for the bf16 speculative acceptance, from one bf16
    engine: along the target's greedy chain, each window of gamma + 1
    tokens is fed one at a time (M = 1, the draft's pass), then the cache
    is rewound and the same tokens go through one M = 5 forward (the
    verify pass).  Returns the top-1 agreement of the two passes' logits
    and the largest logit gap.  With ``use_kernels`` the M = 1 pass takes
    the decode-attention kernel and the M = 5 pass the split attention;
    without, both take the split attention and the plain linears."""
    from amq_tpu_torch.models import llama
    from amq_tpu_torch.serving.engine import Engine
    W = SPEC_GAMMA + 1
    eng = Engine(model, cfg, batch_size=1,
                 max_len=PROMPT + VERIFY_WINDOWS * W + 8,
                 use_kernels=use_kernels)
    cache = eng.new_cache()
    tok, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                    cache)
    agree, gap, scale = 0, 0.0, 0.0
    kinds = ("qkv", "attn", "h_attn", "h_mlp")
    L = cfg.num_layers
    lgap = {k: [0.0] * L for k in kinds}
    lscale = {k: [0.0] * L for k in kinds}
    recorder = LayerRecorder()
    patches = recorder.patches()
    with torch.inference_mode(), patches[0], patches[1], patches[2], \
            patches[3]:
        for _ in range(VERIFY_WINDOWS):
            start, fed, seq, one = cache.length, [], [], []
            for _ in range(W):
                fed.append(tok)
                logits, cache = eng._forward(model, tok[:, None], cache)
                one.append(recorder.take())
                seq.append(logits[0, -1])
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            seq = torch.stack(seq)
            toks = torch.stack(fed, dim=1)
            ver, cache = eng._forward(
                model, toks, llama.KVCache(k=cache.k, v=cache.v, length=start))
            five = recorder.take()
            ver = ver[0]
            agree += int((ver.argmax(-1) == seq.argmax(-1)).sum())
            gap = max(gap, (ver - seq).abs().max().item())
            scale = max(scale, seq.abs().max().item())
            # per layer: the M = 1 pass's positions side by side against
            # the M = 5 pass
            x0 = model.embed[toks.long()].to(torch.bfloat16)
            m1 = layer_states({k: [torch.cat([r[k][i] for r in one], dim=1)
                                   for i in range(L)] for k in one[0]}, x0)
            m5 = layer_states(five, x0)
            for k in kinds:
                for i in range(L):
                    a, b = m1[k][i].float(), m5[k][i].float()
                    lgap[k][i] = max(lgap[k][i], (a - b).abs().max().item())
                    lscale[k][i] = max(lscale[k][i], b.abs().max().item())
    rec = dict(use_kernels=use_kernels, positions=VERIFY_WINDOWS * W,
               top1_agreement=agree / (VERIFY_WINDOWS * W),
               max_logit_gap=gap, logit_scale=scale)
    print("SPEC_VERIFY_GAP " + json.dumps(rec), flush=True)
    # half a bf16 unit in the last place at each output's largest value:
    # what one rounding of that output can move it
    half_ulp = {k: [2.0 ** (math.floor(math.log2(v)) - 8) if v > 0 else 0.0
                    for v in lscale[k]] for k in kinds}
    layers = dict(use_kernels=use_kernels, max_gap=lgap, max_abs=lscale,
                  half_ulp=half_ulp, decode_kernel_vs_plain=[
                      recorder.decode_vs_plain.get(i) for i in range(L)])
    del eng, cache
    return rec, layers


def spec_layer_gap(kern, plain):
    """SPEC_LAYER_GAP: per layer the largest |h(M = 1) - h(M = 5)| of the
    qkv and attention outputs and of the residual stream after attention
    and after the MLP, on the kernel and the plain path, and the first
    (layer, output) where the kernel path's gap exceeds the plain path's
    by more than one bf16 rounding of that output (half an ulp at its
    largest value): where the two paths first part.  Beside it, per layer,
    the decode-attention kernel against its plain version on the M = 1
    pass's own inputs, which tells a kernel fault from the two attention
    routes' own difference."""
    order = ("qkv", "attn", "h_attn", "h_mlp")
    first = None
    for i in range(len(kern["max_gap"]["qkv"])):
        for k in order:
            excess = kern["max_gap"][k][i] - plain["max_gap"][k][i]
            if first is None and excess > kern["half_ulp"][k][i]:
                first = dict(layer=i, output=k,
                             kernel_gap=kern["max_gap"][k][i],
                             plain_gap=plain["max_gap"][k][i],
                             half_ulp=kern["half_ulp"][k][i])
    rec = dict(kernel=kern, plain=plain, first_excess=first)
    print("SPEC_LAYER_GAP " + json.dumps(rec), flush=True)
    return rec


def speculative_phase(model, cfg, prompt):
    """(f): the target as its own draft (gamma 4): in bf16 the rate and
    the acceptance over 64 tokens, then, as witnesses of what that
    acceptance measures, the M = 1 vs M = 5 logit agreement on the kernel
    path and on the plain path and the acceptance of 16 tokens on the
    plain path (both passes through the split attention); in float32 the
    tokens equal to generate's."""
    from amq_tpu_torch.serving.engine import Engine
    from amq_tpu_torch.serving.speculative import SpeculativeEngine
    gaps = [verify_gap(model, cfg, prompt, k) for k in (True, False)]
    recs = {"verify_gap": [g[0] for g in gaps],
            "layer_gap": spec_layer_gap(gaps[0][1], gaps[1][1])}
    runs = (("bfloat16", torch.bfloat16, True, SPEC_NEW),
            ("bfloat16-plain", torch.bfloat16, False, SPEC_PLAIN_NEW),
            ("float32", torch.float32, True, SPEC_NEW))
    for label, dt, use_kernels, n_new in runs:
        eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + n_new + 8,
                     compute_dtype=dt, cache_dtype=dt, use_kernels=use_kernels)
        spec = SpeculativeEngine(eng, draft_params=model, gamma=SPEC_GAMMA)
        if use_kernels:
            spec.generate(prompt, max_new_tokens=8)             # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, stats = spec.generate(prompt, max_new_tokens=n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = eng.generate(prompt, max_new_tokens=n_new)
        rec = dict(compute=label, use_kernels=use_kernels, gamma=SPEC_GAMMA,
                   tokens=n_new, wall_s=wall, tokens_per_s=n_new / wall,
                   rounds=stats.rounds, accepted=stats.accepted,
                   acceptance_rate=stats.acceptance_rate,
                   token_agreement=float((toks == want).mean()))
        print("SPECULATIVE " + json.dumps(rec), flush=True)
        if dt == torch.float32 and not (toks == want).all():
            fail(f"float32 speculative tokens differ from generate: {rec}")
        recs[label] = rec
        del spec, eng
    return recs


# ---------------------------------------------------------------------------
# phase 4c: the serving loops as captured CUDA graphs against the eager loop

GRAPH_SLOT_LENS, GRAPH_SLOT_NEW, GRAPH_PREFILL_CHUNK = (64, 23, 40, 57), 16, 32


def graph_slot_run(model, cfg, graphs):
    """float32 SlotEngine.run (2 slots, phase 4b's four staggered prompts
    of 16 tokens each, decode chunks of 8, prompts over 32 tokens
    prefilled in chunks of 32): the results and the runner's counts."""
    from amq_tpu_torch.serving.batched import SlotEngine
    from amq_tpu_torch.serving.engine import ContinuousBatcher, Request
    max_len = max(GRAPH_SLOT_LENS) + GRAPH_SLOT_NEW + 8
    rng = np.random.default_rng(2)
    se = SlotEngine(model, cfg, n_slots=2, max_len=max_len,
                    compute_dtype=torch.float32,
                    prefill_buckets=GRAPH_SLOT_LENS, chunk_steps=CHUNK,
                    prefill_chunk_len=GRAPH_PREFILL_CHUNK, graphs=graphs)
    batcher = ContinuousBatcher(n_slots=2, max_len=max_len)
    for u, n in enumerate(GRAPH_SLOT_LENS):
        batcher.submit(Request(uid=u, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=GRAPH_SLOT_NEW))
    got = se.run(batcher)
    return got, se.runner.stats()


def graph_f32_gates(model, cfg, prompt):
    """float32, kernels on, each graph against the eager loop of the same
    setting: Engine.generate (64 tokens), the slot-batched run with its
    decode chunks and slot prefills (whole and chunked), and speculative
    decoding with the target as its own draft (64 tokens: tokens, rounds
    and accepted)."""
    from amq_tpu_torch.serving.engine import Engine
    from amq_tpu_torch.serving.speculative import SpeculativeEngine
    from amq_tpu_torch import ops
    f32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    gen, spec, slot, stats = {}, {}, {}, {}
    ops.reset_launch_counts()
    for label, graphs in (("eager", False), ("graph", True)):
        eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + SPEC_NEW + 8,
                     graphs=graphs, **f32)
        gen[label] = eng.generate(prompt, max_new_tokens=SPEC_NEW)
        sp = SpeculativeEngine(eng, draft_params=model, gamma=SPEC_GAMMA)
        toks, st = sp.generate(prompt, max_new_tokens=SPEC_NEW)
        spec[label] = dict(tokens=toks, rounds=st.rounds,
                           accepted=st.accepted)
        slot[label], slot_stats = graph_slot_run(model, cfg, graphs)
        stats[label] = dict(engine=eng.runner.stats(),
                            speculative=sp.runner.stats(), slot=slot_stats)
        del sp, eng
        torch.cuda.empty_cache()
    rec = dict(
        compute="float32", generate_tokens=SPEC_NEW,
        generate_equal=bool((gen["eager"] == gen["graph"]).all()),
        slot_requests=len(GRAPH_SLOT_LENS), slot_new=GRAPH_SLOT_NEW,
        slot_equal=slot["eager"] == slot["graph"],
        speculative_equal=bool((spec["eager"]["tokens"]
                                == spec["graph"]["tokens"]).all()),
        speculative_rounds={k: v["rounds"] for k, v in spec.items()},
        speculative_accepted={k: v["accepted"] for k, v in spec.items()},
        runners=stats,
        grouped_launches=sum(ops.grouped_launch_counts().values()),
        tile_launches=sum(ops.tile_launch_counts().values()),
        core_launches=core_launches())
    rec["ok"] = (rec["generate_equal"] and rec["slot_equal"]
                 and rec["speculative_equal"]
                 and rec["core_launches"] == 0
                 and spec["eager"]["rounds"] == spec["graph"]["rounds"]
                 and spec["eager"]["accepted"] == spec["graph"]["accepted"])
    print("GRAPH_F32 " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        fail(f"float32 graphs differ from the eager loop: {rec}")
    return rec


def graph_step_logits(eng, model, prompt):
    """bf16: after one prefill, the first decode step's forward replayed
    from its graph against the same forward run eagerly from the same
    cache state (the forward leaves the length as it found it).  The same
    kernels on the same inputs give the same bits, so the gate is
    equality (a replay of another route would differ by rounding); the
    largest gap normalized by the largest eager logit is reported beside
    the bf16 tolerance of the kernel cases."""
    cache = eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                      cache)
    with torch.inference_mode():
        want = eng._forward(model, first[:, None], cache)[0][0, -1].float()
    buf = eng.runner.buffers(("step_logits",), tok=((1,), torch.int32),
                             logits=((eng.cfg.vocab_size,), torch.float32))
    buf.tok.copy_(first)

    def body():
        logits, _ = eng._forward(model, buf.tok[:, None], cache)
        buf.logits.copy_(logits[0, -1])

    with torch.inference_mode():
        eng.runner.run(eng._key("step_logits", 1), body,
                       state=(cache.length,), binds=(model, cache))
    got = buf.logits.clone()
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    tol = MM_TOL[torch.bfloat16]
    equal = bool(torch.equal(got, want))
    rec = dict(compute="bfloat16", rel_err=rel, tol=tol, equal=equal,
               top1_agree=bool(got.argmax() == want.argmax()),
               ok=equal and bool(torch.isfinite(got).all()))
    print("GRAPH_STEP_LOGITS " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        fail(f"bf16 replayed step logits off the eager step's: {rec}")
    return rec


#: the name each kernel family carries on the card, as the profiler lists it
PROFILED_KERNELS = {"grouped": "qmm_grouped_kernel<", "tile": "qmm_tile_kernel<",
                    "decode_attention": "decode_attn_kernel<"}


#: idle seconds at each end of a counting session: without them a few
#: device records at a session's edge now and then went missing (a
#: short count with equal tokens); probes/profile_window.py runs the
#: count both ways
PROFILE_PAD_S = 0.05


def profiled_kernel_counts(run):
    """Kernels the profiler saw on the card over ``run()``, by family
    (PROFILED_KERNELS): counted from the device's own records, so graph
    replays count what they ran, not what the wrappers were credited."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    counts = {fam: 0 for fam in PROFILED_KERNELS}
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0 or ev.is_user_annotation:
            continue
        for fam, tag in PROFILED_KERNELS.items():
            if tag in ev.key:
                counts[fam] += ev.count
    return counts


PROFILE_CHUNK = 16


def profiled_generate(eng, prompt, n_new):
    """One greedy generate through the calls ``Engine.generate`` makes
    (the prefill, then ``_decode_n``, here in chunks of PROFILE_CHUNK
    steps), each call under a profiler session of its own: the kernels
    the card ran, by family, summed over the sessions, and the tokens.
    (Short sessions: over one 127-step run of back-to-back replays the
    profiler once lost a run of records.)"""
    model, cache = eng.params, eng.new_cache()
    counts = {fam: 0 for fam in PROFILED_KERNELS}
    out = {}

    def prefill():
        out["new"], _ = eng._prefill_token(
            model, eng.tokens_to_device(prompt), cache)

    def decode(tok, n):
        out["new"], _ = eng._decode_n(model, tok, cache, n_steps=n)

    toks, left = [], n_new
    for call in [prefill] + [None] * ((n_new - 2) // PROFILE_CHUNK + 1):
        n = min(PROFILE_CHUNK, left)
        run = call or (lambda tok=toks[-1][:, -1], n=n: decode(tok, n))
        for fam, c in profiled_kernel_counts(run).items():
            counts[fam] += c
        new = out["new"]
        toks.append(new if new.dim() == 2 else new[:, None])
        left -= toks[-1].shape[1]
    return torch.cat(toks, dim=1).cpu().numpy(), counts


def graph_counts(eng, cfg, prompt, label):
    """Exact launch counts of one bf16 generate (graph replays included)
    against the counts reckoned from the code, and the runner's replays
    over it (one prefill, GEN - 1 decode steps).  Then a second generate
    under the profiler (profiled_generate): the grouped GEMV, tile and
    decode-attention kernels the card ran, counted from its records,
    against the same reckoning (one per wrapper launch), and its tokens
    equal to the first's."""
    from amq_tpu_torch import ops
    L = cfg.num_layers
    before = eng.runner.replays
    ops.reset_launch_counts()
    toks = eng.generate(prompt, max_new_tokens=GEN)
    torch.cuda.synchronize()
    got = (ops.launch_counts(), ops.grouped_launch_counts(),
           ops.tile_launch_counts())
    want = (reckon_decode(L, 1, PROMPT, GEN - 1, False, False),
            reckon_grouped(L, GEN - 1, False), reckon_tile(L, 1))
    replays = eng.runner.replays - before
    again, seen = profiled_generate(eng, prompt, GEN)
    want_seen = dict(grouped=sum(want[1].values()), tile=sum(want[2].values()),
                     decode_attention=want[0]["decode_attention_indexed"])
    same = bool((again == toks).all())
    rec = dict(loop=label, launches=got[0], grouped=got[1], tile=got[2],
               replays=replays, profiled=seen, profiled_want=want_seen,
               profiled_tokens_equal=same,
               ok=(got == want and seen == want_seen and same
                   and replays == (GEN if eng.graphs else 0)))
    print("GRAPH_LAUNCHES " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        fail(f"{label} launch counts {got} != {want}, profiled {seen} != "
             f"{want_seen} or replays {replays}")
    return toks


def graphs_phase(model, cfg, prompt):
    """Phase 4c: the gates (float32 graph against eager token-exact for
    generate, slot-batched decoding with slot prefills and speculative
    decoding; the bf16 replayed step's logits; exact launch counts with
    replays), then eager and graph side by side in one call (GRAPH_AB):
    the SPEED modes in turns (eager, graph, graph, eager), the busy share
    of decode and of the prefill (torch.profiler; beside it the eager
    loop's device ms over the graph's wall ms), CONTINUOUS and
    SPECULATIVE; GRAPH_CAPTURE: the graph engines' captures, replays,
    capture seconds and pool memory beside peak memory."""
    from amq_tpu_torch.serving.benchmark import (PeakMemTracker,
                                                 benchmark_continuous,
                                                 benchmark_speed)
    from amq_tpu_torch.serving.engine import Engine
    from amq_tpu_torch.serving.speculative import SpeculativeEngine
    t0 = time.perf_counter()
    f32 = graph_f32_gates(model, cfg, prompt)
    engs = {label: Engine(model, cfg, batch_size=1, max_len=PROMPT + GEN + 8,
                          graphs=label == "graph")
            for label in ("eager", "graph")}
    toks = {label: graph_counts(eng, cfg, prompt, label)
            for label, eng in engs.items()}
    token_agreement = float((toks["eager"] == toks["graph"]).mean())
    step = graph_step_logits(engs["graph"], model, prompt)
    modes = (("TPS", "tokens_per_s"), ("GEMV", "decode_token_ms"),
             ("GEMM", "prefill_ms"), ("TTFT", "ttft_ms"))
    speed = {label: {m: [] for m, _ in modes} for label in engs}
    mem = PeakMemTracker("cuda")
    for label in ("eager", "graph", "graph", "eager"):
        for mode, key in modes:
            speed[label][mode].append(benchmark_speed(
                engs[label], mode, prompt_len=PROMPT, gen_len=GEN)[key])
    peak_gib, _ = mem.result()
    prof, pre = {}, {}
    for label, eng in engs.items():
        prof[label] = profile_decode(eng, prompt, tag=f"GRAPH_PROFILE {label}")
        toks_dev = eng.tokens_to_device(prompt)
        eng._prefill_token(model, toks_dev, eng.new_cache())
        pre[label] = device_profile(
            lambda: eng._prefill_token(model, toks_dev, eng.new_cache()), 1)
    cont, spec = {}, {}
    for label in engs:
        cont[label] = benchmark_continuous(
            model, cfg, n_slots=SLOTS, n_requests=REQUESTS, prompt_len=PROMPT,
            gen_len=GEN, max_len=PROMPT + GEN + 8, chunk_steps=CHUNK,
            graphs=label == "graph")
        eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + SPEC_NEW + 8,
                     graphs=label == "graph")
        sp = SpeculativeEngine(eng, draft_params=model, gamma=SPEC_GAMMA)
        sp.generate(prompt, max_new_tokens=8)                    # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, st = sp.generate(prompt, max_new_tokens=SPEC_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        spec[label] = dict(tokens_per_s=SPEC_NEW / wall, rounds=st.rounds,
                           accepted=st.accepted,
                           acceptance_rate=st.acceptance_rate,
                           runner=sp.runner.stats())
        del sp, eng
        torch.cuda.empty_cache()

    def mean(xs):
        return sum(xs) / len(xs)

    ab = {}
    for label in engs:
        gemv = speed[label]["GEMV"]
        ab[label] = dict(
            tps=speed[label]["TPS"], gemv_ms_per_token=gemv,
            ttft_ms=speed[label]["TTFT"], gemm_prefill_ms=speed[label]["GEMM"],
            decode_busy_share=prof[label]["device_busy_share"],
            decode_device_ms_per_token=prof[label]["device_ms_per_token"],
            decode_profile_wall_ms=prof[label]["wall_ms_per_token"],
            # the eager loop's device time over this loop's unprofiled wall
            decode_busy_from_eager_device=(
                prof["eager"]["device_ms_per_token"] / mean(gemv)),
            prefill_busy_share=pre[label]["device_busy_share"],
            prefill_device_ms=pre[label]["device_ms_per_token"],
            prefill_busy_from_eager_device=(
                pre["eager"]["device_ms_per_token"]
                / mean(speed[label]["GEMM"])),
            continuous_tokens_per_s=cont[label]["tokens_per_s"],
            speculative_tokens_per_s=spec[label]["tokens_per_s"],
            speculative_acceptance=spec[label]["acceptance_rate"],
            speculative_rounds=spec[label]["rounds"])
    ab["order"] = "eager, graph, graph, eager (SPEED modes)"
    ab["generate_token_agreement"] = token_agreement
    ab["card"] = smi_line()
    print("GRAPH_AB " + json.dumps(ab), flush=True)
    graph_runners = dict(engine=engs["graph"].runner.stats(),
                         continuous=cont["graph"]["graphs"],
                         speculative=spec["graph"]["runner"])
    capture = dict(
        captures=sum(r["captures"] for r in graph_runners.values()),
        replays=sum(r["replays"] for r in graph_runners.values()),
        capture_s=sum(r["capture_s"] for r in graph_runners.values()),
        pool_mb=sum(r["pool_mb"] for r in graph_runners.values()),
        reserved_mb=sum(r["reserved_mb"] for r in graph_runners.values()),
        peak_mem_gib_speed_modes=peak_gib, runners=graph_runners)
    print("GRAPH_CAPTURE " + json.dumps(capture), flush=True)
    for label in engs:
        if not (mean(speed[label]["TPS"]) > 0
                and cont[label]["total_tokens"] == REQUESTS * GEN):
            fail(f"GRAPH_AB {label}: no rate or a short continuous run")
    del engs
    torch.cuda.empty_cache()
    print(f"graphs phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(f32=f32, step_logits=step, ab=ab, capture=capture)


# ---------------------------------------------------------------------------
# phase 4d: Qwen2-0.5B at full width and depth with native 3-bit planes

QWEN_MODEL, QWEN_GEN = "Qwen2-0.5B", 32
#: every width in its own planes (the speed CLI's --native_pack): the
#: 3-bit q/k/v/o and gate/up (K 896) sit at superblocks of 128 rows, the
#: kernels' 4-row superblocks; down (K 4864) pads to 1024
QWEN_CONTAINER = {2: 2, 3: 3, 4: 4}


def reckon_pair(L, prefills, steps):
    """(grouped, tile) launches at 4-row superblocks over ``prefills``
    prefills and ``steps`` decode steps of the Qwen2-0.5B model, per
    wrapper: the qkv, o and gateup products of the 3-bit layers (every
    third, BITS[i % 3]); down (superblock 1024) and the 8-bit head never."""
    L3 = sum(1 for i in range(L) if BITS[i % 3] == 3)
    return {"quant_matmul_indexed": (3 * L3 * steps, 3 * L3 * prefills),
            "quant_matmul_swiglu_indexed": (0, 0), "quant_matmul": (0, 0)}


def qwen2_phase(gen):
    """Qwen2-0.5B served on the card at full width and depth (24 layers,
    hidden 896, tied head as the 8-bit packed head, qkv bias, head dim 64;
    random packed weights from the seeded generator, layer i at BITS[i %
    3], native 3-bit planes, bf16 meta): Engine.generate (prompt 64, 32
    tokens, batch 1, captured graphs) in bf16 and in float32, each counted
    -- every product on the grouped ring (decode) or the tile kernel
    (prefill), the 3-bit layers' q/k/v/o and gate/up on the pair forms
    (reckon_pair), no CUDA-core launch -- and timed (decode ms/token, the
    64-token prefill's ms, a QWEN2_PROFILE_<dtype> line of device ms by
    kernel over 8 decode steps); in float32 the prefill logits within LOGIT_TOL
    of the plain path (Engine(use_kernels=False)) and the tokens on graphs
    equal to the eager loop's.  A QWEN2 line per dtype, QWEN2_GATES."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.serving.benchmark import benchmark_speed
    from amq_tpu_torch.serving.engine import Engine
    t0 = time.perf_counter()
    cfg = get_config(QWEN_MODEL)
    model = random_llama7b(cfg, gen, QWEN_CONTAINER)
    L = cfg.num_layers
    sbs = {name: sorted({s.superblock for s in stacks if s.nbits == 3})
           for name, stacks in model.sites.items()}
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
    recs, toks = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        label = str(dtype).split(".")[-1]
        eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + QWEN_GEN + 8,
                     compute_dtype=dtype, cache_dtype=dtype)
        ops.reset_launch_counts()
        toks[label] = eng.generate(prompt, max_new_tokens=QWEN_GEN)
        torch.cuda.synchronize()
        got = dict(grouped=ops.grouped_launch_counts(),
                   span=ops.span_launch_counts(),
                   tile=ops.tile_launch_counts(),
                   pair={k: list(v) for k, v in
                         ops.pair_launch_counts().items()},
                   core=core_launches())
        steps = QWEN_GEN - 1
        want = dict(grouped=reckon_grouped(L, steps, False),
                    span={"quant_matmul_indexed": 3 * L * steps,
                          "quant_matmul_swiglu_indexed": 0,
                          "quant_matmul": 0},
                    tile=reckon_tile(L, 1),
                    pair={k: list(v) for k, v in
                          reckon_pair(L, 1, steps).items()},
                    core=0)
        speed = {mode: benchmark_speed(eng, mode, prompt_len=PROMPT,
                                       gen_len=QWEN_GEN)
                 for mode in ("GEMV", "GEMM")}
        profile = profile_decode(eng, prompt, tag=f"QWEN2_PROFILE_{label}")
        rec = dict(model=QWEN_MODEL, compute=label, layers=L,
                   prompt=PROMPT, gen=QWEN_GEN, three_bit_superblocks=sbs,
                   **got, want=want,
                   per_token={k: v / steps for k, v in got["grouped"].items()},
                   pair_per_token=sum(v[0] for v in got["pair"].values())
                   / steps,
                   pair_per_prefill=sum(v[1] for v in got["pair"].values()),
                   decode_ms_per_token=speed["GEMV"]["decode_token_ms"],
                   prefill_ms=speed["GEMM"]["prefill_ms"],
                   device_ms_per_token=profile["device_ms_per_token"],
                   device_busy_share=profile["device_busy_share"],
                   tokens_in_range=bool(toks[label].shape == (1, QWEN_GEN) and (
                       (toks[label] >= 0)
                       & (toks[label] < cfg.vocab_size)).all()),
                   card=smi_line())
        rec["ok"] = got == want and rec["tokens_in_range"]
        print("QWEN2 " + json.dumps(rec), flush=True)
        recs[label] = rec
        del eng
        torch.cuda.empty_cache()
    # float32: the kernel path against the plain path, and the graphs
    # against the eager loop
    logits = logits_check(model, cfg, prompt, torch.float32)
    logits_bf16 = logits_check(model, cfg, prompt, torch.bfloat16)
    eager = Engine(model, cfg, batch_size=1, max_len=PROMPT + QWEN_GEN + 8,
                   compute_dtype=torch.float32, cache_dtype=torch.float32,
                   graphs=False).generate(prompt, max_new_tokens=QWEN_GEN)
    gates = dict(f32_logits_rel_err=logits["rel_err"], tol=LOGIT_TOL,
                 bf16_logits_rel_err=logits_bf16["rel_err"],
                 f32_graph_equals_eager=bool(
                     (eager == toks["float32"]).all()),
                 phase_s=time.perf_counter() - t0)
    gates["ok"] = (logits["ok"] and gates["f32_graph_equals_eager"]
                   and all(r["ok"] for r in recs.values()))
    print("QWEN2_GATES " + json.dumps(gates), flush=True)
    del model
    torch.cuda.empty_cache()
    if not gates["ok"]:
        fail(f"Qwen2-0.5B phase: {gates}; {[r for r in recs.values()]}")
    return dict(runs=recs, gates=gates)


EVAL_MODEL, SENS_N, SENS_SEQ, SENS_BATCH = "Llama-2-7b-hf", 2, 2048, 2
EVAL_ARGS = ["--model_name", EVAL_MODEL, "--synthetic",
             "--n_sample", str(SENS_N), "--seqlen", str(SENS_SEQ),
             "--batch_size", str(SENS_BATCH), "--compute_dtype", "bfloat16"]


def loss_batches(cfg, n, seqlen, batch):
    """Loss batches of one pass over n samples: the evaluator's rule (the
    batch capped when one f32 [B, S, V] exceeds 1 GiB)."""
    row_gib = seqlen * cfg.vocab_size * 4 / 2**30
    loss_batch = (min(batch, max(1, int(1.0 // row_gib)))
                  if batch * row_gib > 1.0 else batch)
    return math.ceil(n / loss_batch)


def reckon_sensitivity(cfg, n, seqlen, batch):
    """Flash and dequantization launches of one sensitivity run, reckoned
    from the code: the dense pass (flash once per layer per dense batch of
    <= 4; dense linears, no dequantization), then per loss batch the
    baseline's advances through blocks 0..L-2 and every probe's suffix (7
    probes at block b run blocks b..L-1), each block one flash launch and
    one dequantization per site (7 unfused sites)."""
    L, P = cfg.num_layers, 7
    dense = L * math.ceil(n / min(batch, 4))
    blocks = ((L - 1) + sum(P * (L - b) for b in range(L))) * loss_batches(
        cfg, n, seqlen, batch)
    return {"flash_attention": dense + blocks, "dequantize_kn": 7 * blocks}


def sensitivity_phase():
    from amq_tpu_torch import ops
    from amq_tpu_torch.cli import sensitivity
    from amq_tpu_torch.models.config import get_config
    cfg = get_config(EVAL_MODEL)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sensitivity.main(EVAL_ARGS + ["--save_path",
                                        os.path.join(OUT_DIR, "sensitivity")])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = list(out["table"]["loss"].values())
    want = reckon_sensitivity(cfg, SENS_N, SENS_SEQ, SENS_BATCH)
    rec = dict(path=out["path"], wall_s=wall, proxies_s=out["proxies"],
               dense_logits_s=out["dense_logits"], probes_s=out["probes_s"],
               s_per_probe=out["probes_s"] / max(len(losses), 1),
               n_entries=len(losses), loss_min=min(losses),
               loss_median=float(np.median(losses)), loss_max=max(losses),
               launches=counts, reckoned=want,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print("SENSITIVITY " + json.dumps(rec), flush=True)
    if len(losses) != cfg.num_layers * 7 or not all(
            math.isfinite(v) and v >= 0 for v in losses):
        fail(f"sensitivity table: {len(losses)} entries, want "
             f"{cfg.num_layers * 7} finite non-negative")
    for name, n in want.items():
        if counts[name] != n:
            fail(f"sensitivity {name} launches {counts[name]} != reckoned {n}")
    torch.cuda.empty_cache()
    return {**rec, "table": out["table"]}


#: kernel path vs plain path (einsum attention), f32 compute, relative to
#: the plain loss: the two differ only in summation order over 32 layers
EVAL_TOL = 1e-3


def eval_parity_phase():
    """One f32 evaluator at full width; for the all-4 and the cycled arch,
    the eval loss with the flash kernel against the einsum attention."""
    from amq_tpu_torch.cli.common import base_parser, load_model, load_tokens
    from amq_tpu_torch.evaluation import Evaluator
    from amq_tpu_torch.models.config import cycled_arch
    from amq_tpu_torch.models.transform import uniform_arch
    args = base_parser("eval parity").parse_args(EVAL_ARGS)
    cfg, params = load_model(args)
    tokens = load_tokens(args, cfg)
    ev = Evaluator(cfg, dense_params=params, datasets={"synthetic": tokens},
                   batch_size=SENS_BATCH, compute_dtype=torch.float32)
    del params
    recs = []
    for label, arch in (("all4", uniform_arch(cfg, 4)),
                        ("cycled", cycled_arch(cfg.num_layers, (2, 3, 4)))):
        got = {}
        for use_kernels in (True, False):
            ev.use_kernels = use_kernels
            t0 = time.perf_counter()
            got[use_kernels] = ev.eval(arch)[0]["synthetic"]
            got[f"s_{use_kernels}"] = time.perf_counter() - t0
        rel = abs(got[True] - got[False]) / abs(got[False])
        rec = dict(arch=label, kernel_loss=got[True], plain_loss=got[False],
                   kernel_s=got["s_True"], plain_s=got["s_False"], rel_err=rel,
                   tol=EVAL_TOL, ok=rel <= EVAL_TOL and math.isfinite(got[True]))
        print("EVAL_PARITY " + json.dumps(rec), flush=True)
        recs.append(rec)
    del ev
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in recs):
        fail(f"kernel-path eval loss differs from the plain path: {recs}")
    return recs


#: bf16 evaluation loss with the bf16 x bf16 (f32-accumulated) dense head
#: against the float32 head product of the same values, relative: the two
#: differ only in summation order
HEAD_TOL = 1e-3


def f32_head(x, wt, compute_dtype):
    """The dense head as a float32 product of the compute-type operands
    (the port's route before the bf16 tensor-core head)."""
    return torch.matmul(x.float(), wt.to(compute_dtype).float())


def profile_eval_phase():
    """Where one search evaluation's time goes: a bf16 evaluator at full
    width (the CLIs' settings), one warm eval of the cycled arch under
    torch.profiler; device time by kernel, grouped, and the busy share.
    A sensitivity probe runs the same per-block program over L - b
    blocks, so its time splits the same way.  Also: the dequantization
    launches of one evaluation equal to the count reckoned (one per site,
    layer and loss batch), the loss with the bf16 dense head within
    HEAD_TOL of the float32 head's, and no float32 GEMM left in the
    profile."""
    from unittest import mock
    from torch.profiler import ProfilerActivity, profile
    from amq_tpu_torch import ops
    from amq_tpu_torch.cli.common import base_parser, load_model, load_tokens
    from amq_tpu_torch.evaluation import Evaluator
    from amq_tpu_torch.models import linear as linear_mod
    from amq_tpu_torch.models.config import cycled_arch
    args = base_parser("eval profile").parse_args(EVAL_ARGS)
    cfg, params = load_model(args)
    ev = Evaluator(cfg, dense_params=params,
                   datasets={"synthetic": load_tokens(args, cfg)},
                   batch_size=SENS_BATCH, compute_dtype=torch.bfloat16)
    del params
    arch = cycled_arch(cfg.num_layers, (2, 3, 4))
    ev.eval(arch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = ev.eval(arch)[0]["synthetic"]
    unprofiled_s = time.perf_counter() - t0
    dequant = ops.launch_counts()["dequantize_kn"]
    dequant_want = 7 * cfg.num_layers * loss_batches(cfg, SENS_N, SENS_SEQ,
                                                     SENS_BATCH)
    with mock.patch.object(linear_mod, "matmul_out_f32", f32_head):
        loss_f32_head = ev.eval(arch)[0]["synthetic"]
    head_rel = abs(loss - loss_f32_head) / abs(loss_f32_head)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.eval(arch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    other = "elementwise and copies (norms, rope, JSD)"
    groups = {"flash_attention": 0.0, "matmul (cuBLAS)": 0.0,
              "dequantize_kn": 0.0, other: 0.0}
    by_name = {}
    for e in prof.key_averages():
        # device kernels only: aten:: rows and the port's record_function
        # spans repeat their kernels' time, and "Command Buffer Full" is a
        # runtime stall, not a kernel
        if (e.self_device_time_total <= 0 or e.is_user_annotation
                or e.key.startswith("aten::")
                or e.key.startswith("Command Buffer")):
            continue
        ms = e.self_device_time_total / 1e3
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + ms
        if "flash_kernel" in e.key:
            groups["flash_attention"] += ms
        elif "dequant_kernel" in e.key:
            groups["dequantize_kn"] += ms
        elif any(t in e.key.lower() for t in ("gemm", "xmma", "nvjet",
                                                "cutlass", "cublas")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups[other] += ms
    device_ms = sum(by_name.values())
    # a GEMM of f32 operands (cuBLAS names it ..._gemm_f32f32_...)
    f32_gemm_ms = sum(ms for k, ms in by_name.items() if "gemm_f32f32" in k)
    dequant_ms = sum(ms for k, ms in by_name.items() if "dequant_kernel" in k)
    rec = dict(arch="cycled", compute="bfloat16", samples=SENS_N,
               seqlen=SENS_SEQ, unprofiled_s=unprofiled_s,
               profiled_wall_s=wall_s, device_ms=device_ms,
               device_busy_share=device_ms / (wall_s * 1e3),
               groups_ms=groups, dequant_kernel_ms=dequant_ms,
               dequant_share=dequant_ms / device_ms,
               f32_gemm_ms=f32_gemm_ms, dequant_launches=dequant,
               dequant_reckoned=dequant_want, loss=loss,
               loss_f32_head=loss_f32_head, head_rel_err=head_rel,
               head_tol=HEAD_TOL,
               top_kernels_ms=dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:10]))
    print("EVAL_PROFILE " + json.dumps(rec), flush=True)
    del ev
    torch.cuda.empty_cache()
    if dequant != dequant_want:
        fail(f"one evaluation: {dequant} dequantize_kn launches, reckoned "
             f"{dequant_want}")
    if not (math.isfinite(loss) and head_rel <= HEAD_TOL):
        fail(f"bf16 head loss {loss} vs float32 head {loss_f32_head}")
    if f32_gemm_ms > 0:
        fail(f"a float32 GEMM is left in the evaluation: {rec}")
    return rec


SEARCH_ITERS = 2


def search_phase(sens_path):
    from amq_tpu_torch import ops
    from amq_tpu_torch.cli import search
    save = os.path.join(OUT_DIR, "search_out")
    n_doe, n_iter, iters = 16, 8, SEARCH_ITERS
    ops.reset_launch_counts()
    out = search.main(EVAL_ARGS + [
        "--sensitivity_json", sens_path, "--iterations", str(iters),
        "--n_doe", str(n_doe), "--n_iter", str(n_iter), "--ga_pop_size", "40",
        "--subset_pop_size", "20", "--save_iter", "1", "--save_path", save])
    with open(os.path.join(save, f"iter_{iters}.stats")) as f:
        blob = json.load(f)
    archive = out["archive"]
    losses = [m for _, m, _ in archive]
    rec = dict(n_archive=len(archive), n_evaluated=out["n_evaluated"],
               setup_s=out["setup_s"], search_s=out["search_s"],
               eval_s=out["eval_s"],
               s_per_arch=out["eval_s"] / max(out["n_evaluated"], 1),
               hv=blob["hv"], loss_min=min(losses), loss_max=max(losses),
               bits_min=min(b for _, _, b in archive),
               bits_max=max(b for _, _, b in archive),
               launches=ops.launch_counts())
    print("SEARCH " + json.dumps(rec), flush=True)
    if not (n_doe < len(archive) <= n_doe + iters * n_iter
            and len(archive) == out["n_evaluated"]
            and len(blob["archive"]) + len(blob["candidates"]) == len(archive)):
        fail(f"search archive size {len(archive)} (evaluated "
             f"{out['n_evaluated']})")
    if not (all(math.isfinite(m) for m in losses)
            and math.isfinite(blob["hv"]) and 0 < blob["hv"] <= 1):
        fail(f"search losses or hypervolume not finite: hv {blob['hv']}")
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 7b: PTQ realization at full Llama-2-7B width

#: scratch directory of the phase (HF checkpoint, proxies), inside the
#: checkout and ignored by git; removed when the phase ends
REAL_DIR = "_realize"
#: calibration and perplexity samples of 2048 tokens (the reference
#: calibrates on 128)
REAL_N, REAL_SEQ, REAL_BATCH = 2, 2048, 2
#: depth of the local HF checkpoint behind the proxy round trip and OWQ
#: serving (keeps the files small)
HF_DEPTH = 2
#: OWQ's depth in the quantize CLI: its MSE-grid refreshes take about 4.7
#: s a layer at full width on an H100, so all 32 layers take the phase to
#: about 280 s; 12 keep it near 180 s (GPTQ, AWQ, HQQ, fp16: all 32), and
#: the whole run near 950 s with phase 4d
OWQ_DEPTH = 12
#: kernel-path vs plain-path perplexity in f32, relative
PPL_TOL = 1e-3
#: generated tokens of the OWQ serving checks
OWQ_GEN = 32


def cut_model(depth):
    """Llama-2-7B at full width and ``depth`` layers, registered by name."""
    import dataclasses
    from amq_tpu_torch.models.config import get_config, register
    return register(dataclasses.replace(
        get_config(EVAL_MODEL), name=f"{EVAL_MODEL}-{depth}L",
        num_layers=depth))


def cut_archive(src, cfg, dst):
    """A search archive with every arch cut to ``cfg``'s depth and its bits
    usage taken again at that depth."""
    from amq_tpu_torch.evaluation.metrics import get_bits_usage
    with open(src) as f:
        blob = json.load(f)
    out = {}
    for key in ("archive", "candidates"):
        out[key] = []
        for arch, metric, _ in blob[key]:
            a = {"linear": {k: v[:cfg.num_layers]
                            for k, v in arch["linear"].items()}}
            out[key].append([a, metric, get_bits_usage(a, cfg.topology())])
    with open(dst, "w") as f:
        json.dump(out, f)
    return dst


def write_hf_dir(depth):
    """A local HF checkpoint of random bf16 weights (seeded) at full
    Llama-2-7B width and ``depth`` layers."""
    from amq_tpu_torch.models.hf import save_hf_checkpoint
    from amq_tpu_torch.models.llama import init_params
    cfg = cut_model(depth)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    path = os.path.join(REAL_DIR, cfg.name)
    save_hf_checkpoint(params, cfg, path, dtype=torch.bfloat16)
    del params
    return path


def tree_equal(got, want, path="params"):
    """Every tensor and field of two parameter trees equal (dtype too)."""
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got, want)) or [path]
    if isinstance(want, dict):
        bad = [] if set(got) == set(want) else [path + ": keys"]
        for k in want:
            if k in got:
                r = tree_equal(got[k], want[k], f"{path}.{k}")
                bad += [] if r is True else r
        return bad or True
    if isinstance(want, (list, tuple)):
        bad = [] if len(got) == len(want) else [path + ": length"]
        for i, (g, w) in enumerate(zip(got, want)):
            r = tree_equal(g, w, f"{path}[{i}]")
            bad += [] if r is True else r
        return bad or True
    if hasattr(want, "__dataclass_fields__"):
        return tree_equal(vars(got), vars(want), path)
    return got == want or [path]


def proxy_round_trip(hf_path):
    """The proxy CLI on the local checkpoint (--model_path); each proxy
    read back with load_quantized equal to quantize_model in memory; the
    speed CLI serving them (--proxy_path)."""
    from amq_tpu_torch.cli import proxy, speed_benchmark
    from amq_tpu_torch.cli.common import base_parser, load_model
    from amq_tpu_torch.models.transform import quantize_model
    from amq_tpu_torch.utils.checkpoint import load_quantized
    px = os.path.join(REAL_DIR, "proxies")
    t0 = time.perf_counter()
    out = proxy.main(["--model_path", hf_path, "--save_path", px])
    write_s = time.perf_counter() - t0
    cfg, params = load_model(base_parser("p").parse_args(
        ["--model_path", hf_path]))
    equal, nbytes = {}, 0
    for b, path in zip((2, 3, 4), out["paths"]):
        got, _ = load_quantized(path, dtype=torch.bfloat16, device="cuda")
        want = quantize_model(params, cfg, b, meta_dtype=torch.bfloat16)
        equal[b] = tree_equal(got, want)
        nbytes += sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        del got, want
    del params
    torch.cuda.empty_cache()
    cli = speed_benchmark.main(["--model_path", hf_path, "--proxy_path", px,
                                "--modes", "TPS", "--save_path", OUT_DIR])
    rec = dict(model=cfg.name, depth=cfg.num_layers, write_s=write_s,
               bytes=nbytes, equal={b: v is True for b, v in equal.items()},
               tps=cli["TPS"]["tokens_per_s"],
               setup_s=cli["setup_s"])
    print("PROXY " + json.dumps(rec), flush=True)
    bad = {b: v for b, v in equal.items() if v is not True}
    if bad:
        fail(f"proxies read back differ from quantize_model: {bad}")
    if not rec["tps"] > 0:
        fail("speed CLI on --proxy_path gave no rate")
    torch.cuda.empty_cache()
    return rec


def rtn_loss(W, H, bits):
    """tr((W - Q) H (W - Q)^T) of round-to-nearest with per-group min/max
    parameters (the baseline tests/test_ptq.py holds GPTQ and OWQ under)."""
    from amq_tpu_torch.core.pseudo import find_params_minmax, quantize_affine
    rows, cols = W.shape
    Wg = W.float().reshape(rows * cols // 128, 128)
    p = find_params_minmax(Wg, bits)
    Q = quantize_affine(Wg, p.scale, p.zero, 2**bits - 1).reshape(rows, cols)
    return hessian_loss(W, Q, H)


def hessian_loss(W, Q, H):
    D = W.double() - Q.double()
    return float(((D @ H.double()) * D).sum())


def hessian_probe(module, fn_name, last_layer,
                  sites=("self_attn.q_proj", "mlp.down_proj")):
    """(patch, records): while the patch is active, ``module.fn_name``'s
    calls at layers 0 and ``last_layer`` (``sites``) record the Hessian
    metric of their result and of round-to-nearest at the same bits."""
    from unittest import mock
    from amq_tpu_torch.models.config import LINEAR_NAMES
    orig = getattr(module, fn_name)
    calls, recs = [0], []

    def wrapped(W, H, bits, *a, **k):
        li, si = divmod(calls[0], len(LINEAR_NAMES))
        calls[0] += 1
        Q = orig(W, H, bits, *a, **k)
        if li in (0, last_layer) and LINEAR_NAMES[si] in sites:
            loss, rtn = hessian_loss(W, Q, H), rtn_loss(W, H, bits)
            recs.append(dict(layer=li, site=LINEAR_NAMES[si], bits=bits,
                             loss=loss, rtn=rtn, ok=loss < rtn))
        return Q
    return mock.patch.object(module, fn_name, wrapped), recs


def reckon_realize(method, L):
    """Flash and dequantization launches of one quantize-CLI run, reckoned
    from the code: per layer one flash launch per calibration batch to
    capture (GPTQ / OWQ also one to propagate through the quantized
    block; AWQ propagates in the capture and runs the attention 1 + 20
    times in its scale search), then one per layer and perplexity batch;
    HQQ dequantizes each of its 7 L linears once before the pass.  The
    calibration's launches are float32 (``flash_f32``, the split-TF32
    kernel), the perplexity's bf16."""
    calib = math.ceil(REAL_N / 8)           # *_quantize_model's batch 8
    ppl = math.ceil(REAL_N / min(REAL_BATCH, 4))
    per_layer = {"gptq": 2 * calib, "owq": 2 * calib,
                 "awq": calib + 1 + 20}.get(method, 0)
    return {"flash_attention": L * (per_layer + ppl),
            "dequantize_kn": 7 * L if method == "hqq" else 0,
            "flash_f32": L * per_layer}


def realize_phase(stats_path):
    """The quantize CLI on the search archive at full width: GPTQ, AWQ,
    HQQ and fp16 at 32 layers, OWQ at OWQ_DEPTH; REALIZE
    lines (seconds per stage, perplexity, launches against the reckoned
    counts, the Hessian metric against round-to-nearest at two layers)."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.cli import quantize
    from contextlib import nullcontext
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.ops import flash_attention as fa
    from amq_tpu_torch.quantization import gptq, owq
    card = smi_line()
    owq_cfg = cut_model(OWQ_DEPTH)
    owq_stats = cut_archive(stats_path, owq_cfg,
                            os.path.join(REAL_DIR, "owq_cut.stats"))
    recs = []
    for method in ("gptq", "awq", "owq", "hqq", "fp16"):
        cfg, stats = ((owq_cfg, owq_stats) if method == "owq"
                      else (get_config(EVAL_MODEL), stats_path))
        with open(stats) as f:
            blob = json.load(f)
        bits = sorted(b for _, _, b in blob["archive"] + blob["candidates"])
        target = bits[len(bits) // 2] + (0.1 if method == "owq" else 0.0)
        probe = {"gptq": (gptq, "gptq_quantize_weight"),
                 "owq": (owq, "owq_quantize_weight")}.get(method)
        patch, hrecs = (hessian_probe(*probe, cfg.num_layers - 1) if probe
                        else (nullcontext(), []))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        args = ["--model_name", cfg.name, "--synthetic", "--load", stats,
                "--method", method, "--target_bits", str(target),
                "--target_bits_offset", "0.5", "--eval_dataset", "synthetic",
                "--n_sample", str(REAL_N), "--seqlen", str(REAL_SEQ),
                "--batch_size", str(REAL_BATCH),
                "--save_path", os.path.join(OUT_DIR, "quantize_out")]
        with patch:
            res = quantize.main(args)
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts(),
                      flash_f32=fa.flash_attention.f32_launches)
        want = {k: 0 for k in counts}
        want.update(reckon_realize(method, cfg.num_layers))
        r = res[0]
        rec = dict(method=method, model=cfg.name, depth=cfg.num_layers,
                   bits=r["bits"], ppl=r["ppl"]["synthetic"],
                   stage_s=r["stage_s"], wall_s=wall, launches=counts,
                   reckoned=want, hessian=hrecs, card=card)
        print("REALIZE " + json.dumps(rec), flush=True)
        recs.append(rec)
        torch.cuda.empty_cache()
        if not math.isfinite(rec["ppl"]):
            fail(f"{method} perplexity not finite: {rec['ppl']}")
        if counts != want:
            fail(f"{method} launches {counts} != reckoned {want}")
        if probe and (len(hrecs) != 4 or not all(h["ok"] for h in hrecs)):
            fail(f"{method} not below round-to-nearest on the Hessian "
                 f"metric: {hrecs}")
    return recs


def realize_parity_phase():
    """One f32 HQQ realization at full width and depth: its perplexity on
    the kernel path (flash, the dequantization kernel) against the plain
    path (einsum attention, plain dequantization), with exact launches."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.cli.common import base_parser, load_model, load_tokens
    from amq_tpu_torch.evaluation import Evaluator
    from amq_tpu_torch.models.config import cycled_arch
    from amq_tpu_torch.ops import flash_attention as fa
    from amq_tpu_torch.quantization import get_quantized_params
    args = base_parser("realize parity").parse_args(
        ["--model_name", "Llama-2-7b-hf", "--synthetic", "--n_sample",
         str(REAL_N), "--seqlen", str(REAL_SEQ)])
    cfg, params = load_model(args)
    toks = load_tokens(args, cfg, train=False)
    arch = cycled_arch(cfg.num_layers, (2, 3, 4))
    qp = get_quantized_params(params, cfg, "hqq", arch)
    ev = Evaluator(cfg, dense_params=params, datasets={"synthetic": toks},
                   search=False, batch_size=REAL_BATCH,
                   compute_dtype=torch.float32, quantize_fn=lambda *a: qp)
    del params
    got = {}
    for use_kernels in (True, False):
        ev.use_kernels = use_kernels
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got[use_kernels] = ev.eval_ppl(qp, toks)
        got[f"s_{use_kernels}"] = time.perf_counter() - t0
        got[f"launches_{use_kernels}"] = dict(
            ops.launch_counts(), flash_f32=fa.flash_attention.f32_launches)
    L = cfg.num_layers
    want = {k: 0 for k in got["launches_True"]}
    want_k = dict(want, flash_attention=L, flash_f32=L, dequantize_kn=7 * L)
    rel = abs(got[True] - got[False]) / abs(got[False])
    rec = dict(method="hqq", compute="float32", kernel_ppl=got[True],
               plain_ppl=got[False], rel_err=rel, tol=PPL_TOL,
               kernel_s=got["s_True"], plain_s=got["s_False"],
               launches=got["launches_True"], reckoned=want_k,
               plain_launches=got["launches_False"])
    print("REALIZE_PARITY " + json.dumps(rec), flush=True)
    del ev, qp
    torch.cuda.empty_cache()
    if not (rel <= PPL_TOL and math.isfinite(got[True])):
        fail(f"f32 kernel-path perplexity differs from the plain path: {rec}")
    if got["launches_True"] != want_k or got["launches_False"] != want:
        fail(f"perplexity launches {rec['launches']} / "
             f"{rec['plain_launches']} != {want_k} / {want}")
    return rec


def reckon_owq_grouped(L, steps):
    """Grouped GEMV launches of an OWQ-served bf16 generate, reckoned: per
    decode token (M = 1) all seven sites of every layer at every width --
    q/k/v/o and gate/up (Kp 4096, superblock 1024) in whole ring stages,
    down (Kp 11008, superblock 256) too, two superblocks a stage below 4
    bits; the 64-token prefill runs none."""
    return 7 * L * steps


#: per width, the smallest superblock of whole ring stages (32 word rows
#: of the round plane; 16 at 3 bits)
WHOLE_STAGE_SB = {1: 1024, 2: 512, 3: 512, 4: 256}


def reckon_owq_span(params, steps):
    """... of them on the spanning kernel: every OWQ linear whose
    superblock is smaller than a ring stage at its width (at 7B: down,
    Kp 11008 in superblocks of 256, below 4 bits)."""
    return sum(lay[name].packed.qt.superblock
               < WHOLE_STAGE_SB[lay[name].packed.qt.nbits]
               for lay in params["layers"] for name in lay
               if hasattr(lay[name], "packed")) * steps


def owq_serving_phase(hf_path):
    """OWQ packed serving at full width: the speed CLI's --method owq
    (TPS and ms/token); then the same realization in-process: float32
    greedy tokens on the kernel path (quant_matmul) equal to the plain
    path's (quant_matmul_reference), bf16 logit gap reported, exact
    quant_matmul launches per token."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.cli import speed_benchmark
    from amq_tpu_torch.cli.common import base_parser, load_model
    from amq_tpu_torch.models.config import cycled_arch
    from amq_tpu_torch.quantization import get_quantized_params
    from amq_tpu_torch.serving.engine import Engine
    cli = speed_benchmark.main([
        "--model_path", hf_path, "--synthetic", "--method", "owq", "--modes",
        "TPS", "GEMV", "--n_sample", str(REAL_N), "--save_path", OUT_DIR])
    cfg, params = load_model(base_parser("owq").parse_args(
        ["--model_path", hf_path]))
    L = cfg.num_layers
    arch = cycled_arch(L)
    t0 = time.perf_counter()
    qp = get_quantized_params(params, cfg, "owq", arch, avg_bits=3.0,
                              synthetic_calib=True, n_samples=REAL_N,
                              packed=True)
    realize_s = time.perf_counter() - t0
    del params
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
    toks, logits, counts = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        for use_kernels in (True, False):
            eng = Engine(qp, cfg, batch_size=1, max_len=PROMPT + OWQ_GEN + 8,
                         compute_dtype=dt, use_kernels=use_kernels)
            ops.reset_launch_counts()
            key = (str(dt).split(".")[-1], use_kernels)
            toks[key] = eng.generate(prompt, max_new_tokens=OWQ_GEN)
            torch.cuda.synchronize()
            counts[key] = (ops.launch_counts(), ops.grouped_launch_counts(),
                           core_launches())
            logits[key] = eng._prefill(qp, eng.tokens_to_device(prompt),
                                       eng.new_cache())[0].float()
    zero = {k: 0 for k in counts[("float32", True)][0]}
    want = dict(zero, quant_matmul=7 * L * OWQ_GEN)
    want_grouped = reckon_owq_grouped(L, OWQ_GEN - 1)
    gap = (logits[("bfloat16", True)] - logits[("bfloat16", False)]).abs()
    rec = dict(
        model=cfg.name, depth=L, realize_s=realize_s,
        tps=cli["TPS"]["tokens_per_s"],
        ms_per_token=cli["GEMV"]["decode_token_ms"],
        f32_tokens_equal=bool((toks[("float32", True)]
                               == toks[("float32", False)]).all()),
        bf16_token_agreement=float((toks[("bfloat16", True)]
                                    == toks[("bfloat16", False)]).mean()),
        bf16_logit_gap=gap.max().item(),
        f32_logit_gap=(logits[("float32", True)]
                       - logits[("float32", False)]).abs().max().item(),
        launches={f"{k[0]}_{k[1]}": v[0] for k, v in counts.items()},
        f32_core_launches=counts[("float32", True)][2],
        grouped={f"{k[0]}_{k[1]}": v[1]["quant_matmul"]
                 for k, v in counts.items()},
        want_launches=want, want_grouped_bf16=want_grouped,
        quant_matmul_per_token=7 * L, card=smi_line())
    print("OWQ_SERVE " + json.dumps(rec), flush=True)
    del qp
    torch.cuda.empty_cache()
    if not (rec["tps"] > 0 and rec["ms_per_token"] > 0):
        fail(f"OWQ speed CLI gave no rate: {cli}")
    if not rec["f32_tokens_equal"]:
        fail(f"OWQ f32 kernel-path tokens differ from the plain path: {rec}")
    for key, (c, g, _) in counts.items():
        w = want if key[1] else zero
        if c != w:
            fail(f"OWQ serving launches {key}: {c} != {w}")
    if rec["f32_core_launches"]:
        fail(f"OWQ f32 serving ran the CUDA-core GEMV / GEMM: {rec}")
    if counts[("bfloat16", True)][1]["quant_matmul"] != want_grouped:
        fail(f"OWQ grouped launches {rec['grouped']} != {want_grouped}")
    return rec


def realization_phases(stats_path):
    """Phase 7b: its cuts on a line of their own, then the proxy round
    trip, the quantize CLI per method, the f32 parity and OWQ serving."""
    import shutil
    t0 = time.perf_counter()
    print("REALIZE_CUTS " + json.dumps(dict(
        width="Llama-2-7b-hf (full)",
        calibration=f"{REAL_N} synthetic samples (the reference: 128)",
        perplexity=f"{REAL_N} x {REAL_SEQ} synthetic tokens",
        depth={"gptq": 32, "awq": 32, "owq": OWQ_DEPTH, "hqq": 32,
               "fp16": 32},
        proxy_and_owq_serving_depth=HF_DEPTH)), flush=True)
    os.makedirs(REAL_DIR, exist_ok=True)
    try:
        hf_path = write_hf_dir(HF_DEPTH)
        proxy_rec = proxy_round_trip(hf_path)
        recs = realize_phase(stats_path)
        parity = realize_parity_phase()
        serve = owq_serving_phase(hf_path)
    finally:
        shutil.rmtree(REAL_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"realization: {wall:.1f} s", flush=True)
    return dict(proxy=proxy_rec, methods=recs, parity=parity, owq_serve=serve,
                wall_s=wall)


# ---------------------------------------------------------------------------
# phase 7c: OWQ packed serving at full Llama-2-7B width and depth

#: seed of the random OWQ model; float32 tokens checked over this many
OWQ_SEED, OWQ_F32_GEN = 11, 8
#: the device kernels of one OWQ decode step, by route (the profiler's
#: names)
OWQ_ROUTES = {"grouped": ("qmm_grouped_kernel<", "qmm_grouped_span_kernel<"),
              "cuda_core": ("qmm_gemv_kernel<",),
              "split_sums": ("reduce_splits_kernel",)}


def random_owq_model(cfg, gen):
    """Llama-2-7B in OWQ's packed serving form from random codes (seeded;
    OWQ's calibration is not run): per linear at ``cycled_arch``'s bits,
    ``compute_n_out``'s outlier columns at 3.0 bits drawn at random and
    kept as bf16 columns, the other columns' codes in order, padded to
    whole groups with zero codes and packed in the superblock ``owq_pack``
    picks, f32 scale and zero as ``owq_pack`` writes them (scaled so that
    each weight column has unit-variance fan-in); unit norms, a random
    bf16 embedding and head."""
    import dataclasses
    from amq_tpu_torch.core import bitpack
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.models.config import LINEAR_NAMES, cycled_arch
    from amq_tpu_torch.models.linear import OWQLinear
    from amq_tpu_torch.models.llama import init_params
    from amq_tpu_torch.quantization.owq import (OWQPacked, compute_n_out,
                                                outlier_segments)
    L, h = cfg.num_layers, cfg.hidden_size
    arch = cycled_arch(L)
    n_out = compute_n_out(cfg, 3.0, 128)
    params = init_params(dataclasses.replace(cfg, num_layers=0), gen,
                         dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(OWQ_SEED)
    layers = []
    for li in range(L):
        layer = {"input_norm": torch.ones(h, dtype=torch.bfloat16,
                                          device="cuda"),
                 "post_norm": torch.ones(h, dtype=torch.bfloat16,
                                         device="cuda")}
        for name in LINEAR_NAMES:
            bits = int(round(arch["linear"][name][li]))
            N, K = cfg.linear_shape(name)
            out_ids = sorted(rng.choice(K, n_out[name], replace=False).tolist())
            keep = K - len(out_ids)
            Kp = -(-keep // 128) * 128
            sb = bitpack.pick_superblock(Kp, 128)
            codes = torch.randint(0, 2**bits, (Kp, N), generator=gen,
                                  device="cuda")
            codes[keep:] = 0
            step = math.sqrt(12.0 / K) / 2**bits
            scale = step * (0.5 + torch.rand((Kp // 128, N), generator=gen,
                                             device="cuda"))
            zero = (2**bits - 1) / 2 + 0.5 * (
                torch.rand((Kp // 128, N), generator=gen, device="cuda") - 0.5)
            qt = QuantizedTensor(packed=bitpack.pack(codes, bits, sb),
                                 scale=scale, zero=zero, nbits=bits,
                                 group_size=128, shape=(N, Kp), superblock=sb)
            del codes
            w_out = (torch.randn((len(out_ids), N), generator=gen,
                                 device="cuda") / math.sqrt(K)).to(
                                     torch.bfloat16)
            layer[name] = OWQLinear(packed=OWQPacked.from_layout(
                qt, w_out, outlier_segments(out_ids, K), out_ids))
        layers.append(layer)
    params["layers"] = layers
    return params


def route_ms(prof_rec):
    """Device ms per token by route (OWQ_ROUTES) from a device_profile
    record's kernels."""
    out = {route: 0.0 for route in OWQ_ROUTES}
    for name, ms in prof_rec["kernels_ms_per_token"].items():
        for route, tags in OWQ_ROUTES.items():
            if any(t in name for t in tags):
                out[route] += ms
    out["other"] = prof_rec["device_ms_per_token"] - sum(out.values())
    return out


def owq_decode_phase(gate=True):
    """Phase 7c: OWQ packed serving at full Llama-2-7B width and all 32
    layers (random codes at OWQ's packed layouts, ``random_owq_model``),
    bf16 on captured graphs, prompt 64 -> 128, batch 1: decode ms/token,
    TTFT, device ms per token by kernel and by route (profiler, 16 decode
    steps), an ``OWQ_DECODE`` line with the card's.  Gated (``gate``):
    ``quant_matmul`` launches 7 x 32 per token, every decode launch on the
    grouped route (down below 4 bits on the spanning kernel), and float32
    greedy tokens over OWQ_F32_GEN equal to the plain path's.  Without
    ``gate`` (an older checkout's package, for a before figure) the same
    numbers are reported, not gated."""
    from amq_tpu_torch import ops
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.serving.benchmark import benchmark_speed
    from amq_tpu_torch.serving.engine import Engine
    t0 = time.perf_counter()
    cfg = get_config("Llama-2-7b-hf")
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(OWQ_SEED)
    qp = random_owq_model(cfg, gen)
    down = {(lay["mlp.down_proj"].packed.qt.nbits,
             lay["mlp.down_proj"].packed.qt.superblock)
            for lay in qp["layers"]}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompt = np.random.default_rng(OWQ_SEED).integers(
        0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
    eng = Engine(qp, cfg, batch_size=1, max_len=PROMPT + GEN + 8)
    ops.reset_launch_counts()
    toks = eng.generate(prompt, max_new_tokens=GEN)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["quant_matmul"]
    grouped = ops.grouped_launch_counts()["quant_matmul"]
    span = (ops.span_launch_counts()["quant_matmul"]
            if hasattr(ops, "span_launch_counts") else None)
    speed = {mode: benchmark_speed(eng, mode, prompt_len=PROMPT, gen_len=GEN)
             for mode in ("GEMV", "TTFT")}
    model, cache = eng.params, eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                      cache)
    eng._decode_n(model, first, cache, n_steps=2)
    prof = device_profile(
        lambda: eng._decode_n(model, first, cache, n_steps=16), 16,
        top=None)
    del eng
    torch.cuda.empty_cache()
    # float32: the kernel path (CUDA-core GEMV: f32 activations) against
    # the plain path (quant_matmul_reference) over a short generate
    f32 = {}
    for use_kernels in (True, False):
        e = Engine(qp, cfg, batch_size=1, max_len=PROMPT + OWQ_F32_GEN + 8,
                   compute_dtype=torch.float32, use_kernels=use_kernels)
        ops.reset_launch_counts()
        f32[use_kernels] = e.generate(prompt, max_new_tokens=OWQ_F32_GEN)
        torch.cuda.synchronize()
        if use_kernels:
            f32_routes = dict(grouped=ops.grouped_launch_counts()[
                "quant_matmul"], span=ops.span_launch_counts()["quant_matmul"],
                tile=ops.tile_launch_counts()["quant_matmul"],
                core=core_launches())
        del e
        torch.cuda.empty_cache()
    want_grouped = reckon_owq_grouped(L, GEN - 1)
    want_span = reckon_owq_span(qp, GEN - 1)
    rec = dict(
        model=cfg.name, depth=L, bits="cycled_arch (2/3/4)",
        down_layouts=sorted(down), prompt=PROMPT, gen=GEN,
        decode_ms_per_token=speed["GEMV"]["decode_token_ms"],
        ttft_ms=speed["TTFT"]["ttft_ms"],
        device_ms_per_token=prof["device_ms_per_token"],
        device_busy_share=prof["device_busy_share"],
        route_ms_per_token=route_ms(prof),
        kernels_ms_per_token=prof["kernels_ms_per_token"],
        quant_matmul_launches=launches, want_launches=7 * L * GEN,
        grouped_launches=grouped, want_grouped=want_grouped,
        span_launches=span, want_span=want_span,
        f32_tokens_equal=bool((f32[True] == f32[False]).all()),
        f32_routes=f32_routes,
        tokens_in_range=bool(toks.shape == (1, GEN) and (
            (toks >= 0) & (toks < cfg.vocab_size)).all()),
        build_s=build_s, gated=gate, card=smi_line(),
        phase_s=time.perf_counter() - t0)
    print("OWQ_DECODE " + json.dumps(rec), flush=True)
    del qp
    torch.cuda.empty_cache()
    if gate:
        if not rec["tokens_in_range"]:
            fail(f"OWQ decode tokens out of range: {toks.shape}")
        if (launches, grouped, span) != (7 * L * GEN, want_grouped,
                                         want_span):
            fail(f"OWQ decode launches {(launches, grouped, span)} != "
                 f"{(7 * L * GEN, want_grouped, want_span)}")
        if rec["route_ms_per_token"]["cuda_core"] > 0:
            fail(f"OWQ decode ran the CUDA-core GEMV: {rec}")
        if not rec["f32_tokens_equal"]:
            fail(f"OWQ f32 kernel-path tokens differ from the plain path: "
                 f"{f32}")
        if f32_routes["core"] or not f32_routes["span"]:
            fail(f"OWQ f32 decode ran the CUDA-core GEMV / GEMM or no "
                 f"spanning launch: {f32_routes}")
    return rec


# ---------------------------------------------------------------------------
# phase 8: parallel forms as torch.distributed ranks on the one card

PAR_PROMPT, PAR_GEN, PAR_SEED = 64, 32, 7
#: depth of the pipeline, data-parallel slot and evaluation paths (8d)
PAR_SMALL_LAYERS = 4
#: the JAX suite's TP tolerances (tests/test_tp_stacked.py: prefill,
#: decode chain), elementwise, set at graft-tp's widths (hidden 512),
#: where the CPU tests hold them.  At 7B width the card's own float32
#: kernel-vs-plain gap on one card can exceed them (2.8e-4 of the
#: largest logit at 32 layers on an H100), so phase 8 reports them and
#: gates the TP logits' gap over the largest logit on tp_tol(): TP_TOL,
#: or twice the single card's kernel-vs-plain gap of the same run where
#: that is larger (PARALLEL_* ``*_control_rel``).  The pipeline's logits
#: stay gated at TP_TOL of the largest logit
TP_TOL, TP_CHAIN_TOL = 2e-4, 3e-4


def tp_tol(control_rel):
    """The TP logit gate: a sharding fault must show above both the JAX
    suite's tolerance and the summation-order gap one card shows alone."""
    return max(TP_TOL, 2.0 * control_rel)


def numerics():
    """Phase 1's settings, in a rank process: float32 products in full
    float32, bf16 products reduced in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def par_config(layers):
    import dataclasses
    from amq_tpu_torch.models.config import get_config
    cfg = get_config("Llama-2-7b-hf")
    return cfg if layers == cfg.num_layers else dataclasses.replace(
        cfg, num_layers=layers)


def par_arch(cfg):
    """Every site of layer i at BITS[i % 3] (phase 4's layout)."""
    from amq_tpu_torch.models.config import LINEAR_NAMES
    return {"linear": {n: [BITS[i % 3] for i in range(cfg.num_layers)]
                       for n in LINEAR_NAMES}}


def random_proxy(cfg, nbits):
    """A ``quantize_model``-layout proxy of ``cfg`` at ``nbits`` with random
    packed codes, bf16 scale/zero (zero in the K pad groups, as quantize
    leaves them) and random bf16 dense parts, drawn on the card from
    generators seeded with PAR_SEED: every rank and the reference draw
    the same tensors."""
    from amq_tpu_torch.core.bitpack import pick_superblock_padded
    from amq_tpu_torch.core.quantize import QuantizedTensor
    from amq_tpu_torch.models.config import LINEAR_NAMES
    from amq_tpu_torch.models.linear import DenseLinear, QuantLinear
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED * 16 + nbits)
    H, V = cfg.hidden_size, cfg.vocab_size
    ones = torch.ones(H, dtype=torch.bfloat16, device="cuda")
    layers = []
    for _ in range(cfg.num_layers):
        layer = {"input_norm": ones, "post_norm": ones}
        for name in LINEAR_NAMES:
            N, K = cfg.linear_shape(name)
            sb, k_pad = pick_superblock_padded(K)
            G, Gp = K // 128, (K + k_pad) // 128
            meta = torch.zeros((2, Gp, N), dtype=torch.bfloat16,
                               device="cuda")
            meta[0, :G] = (torch.rand((G, N), generator=gen, device="cuda")
                           * 0.02).to(torch.bfloat16)
            meta[1, :G] = (torch.rand((G, N), generator=gen, device="cuda")
                           * (2**nbits - 1)).to(torch.bfloat16)
            layer[name] = QuantLinear(qt=QuantizedTensor(
                packed=rand_words(((K + k_pad) * nbits // 32, N), gen),
                scale=meta[0], zero=meta[1], nbits=nbits, group_size=128,
                shape=(N, K), superblock=sb))
        layers.append(layer)
    dense = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    embed, head = ((torch.randn((V, H), generator=dense, device="cuda")
                    * 0.02).to(torch.bfloat16) for _ in range(2))
    return {"embed": embed, "final_norm": ones, "layers": layers,
            "lm_head": DenseLinear(weight=head)}


def par_proxies(cfg):
    return [lambda b=b: random_proxy(cfg, b) for b in BITS]


def tp_stack_kw(cfg):
    """Phase 4's layout: fused qkv / gateup (layer-uniform widths), 3-bit
    in 4-bit containers, merged stacks; the 8-bit head vocab-sharded."""
    from amq_tpu_torch.models.stacked import SERVE_CONTAINERS
    return dict(arch=par_arch(cfg), container_bits=SERVE_CONTAINERS,
                merge=True, head_bits=8)


def tp_model(cfg, tp, rank):
    """Shard ``rank`` of the tp-way serving model (tp_stack_kw)."""
    from amq_tpu_torch.parallel import tp_stacked as tps
    return tps.stack_proxies_tp(par_proxies(cfg), BITS, cfg, tp, rank,
                                **tp_stack_kw(cfg))


def tp_reference_model(cfg, tp):
    """The unsharded stack of the same proxies, its 8-bit head the ``tp``
    vocab shards' quantizations side by side (HQQ's zero refinement stops
    on a whole-tensor error, so quantizing the whole head at once could
    stop elsewhere: the reference holds the forward, not the quantizer)."""
    import torch.nn.functional as F
    from amq_tpu_torch.models.stacked import (SERVE_CONTAINERS,
                                              merge_containers, quantize_head,
                                              stack_proxies)
    m = merge_containers(stack_proxies(par_proxies(cfg), BITS,
                                       arch=par_arch(cfg),
                                       container_bits=SERVE_CONTAINERS))
    V, v_loc = cfg.vocab_size, -(-cfg.vocab_size // tp)
    shards = []
    for s in range(tp):
        rows = m.lm_head[s * v_loc:(s + 1) * v_loc]
        shards.append(quantize_head(F.pad(rows, (0, 0, 0, v_loc - len(rows))),
                                    nbits=8))

    def lanes(f):
        x = torch.cat([getattr(q, f)[:, :v_loc] for q in shards], dim=1)[:, :V]
        return F.pad(x, (0, -V % 2048))

    head = dataclasses.replace(shards[0], packed=lanes("packed"),
                               scale=lanes("scale"), zero=lanes("zero"),
                               shape=(V, cfg.hidden_size))
    return dataclasses.replace(m, lm_head=None, lm_head_qt=head)


def tp_rank(rank, world, prompt):
    """Phase 8a on one rank: the tp-way model at full width and depth on
    the TP engine (eager, the rank's gloo group): float32 prefill logits
    and greedy tokens, bf16 tokens; rank 0 also the launch counts of one
    bf16 generate, the kernels the profiler saw on the card over another,
    and decode ms/token."""
    import torch.distributed as dist
    from amq_tpu_torch import ops
    from amq_tpu_torch.parallel import comm
    from amq_tpu_torch.parallel import tp_stacked as tps
    numerics()
    cfg = par_config(32)
    t0 = time.perf_counter()
    model = tp_model(cfg, world, rank)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0,
               backend=comm.backend(dist.group.WORLD),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    for dt in (torch.float32, torch.bfloat16):
        eng = tps.make_tp_engine(cfg, dist.group.WORLD, world, model,
                                 batch_size=1,
                                 max_len=PAR_PROMPT + PAR_GEN + 8,
                                 compute_dtype=dt, cache_dtype=dt,
                                 graphs=False)
        ops.reset_launch_counts()
        last, _ = eng._prefill(model, eng.tokens_to_device(prompt),
                               eng.new_cache())
        toks = eng.generate(prompt, max_new_tokens=PAR_GEN)
        torch.cuda.synchronize()
        out[str(dt).split(".")[-1]] = dict(logits=last.float().cpu().numpy(),
                                           tokens=toks,
                                           core_launches=core_launches())
    # eng: the bf16 engine.  Launch counts over one generate, every rank
    ops.reset_launch_counts()
    eng.generate(prompt, max_new_tokens=PAR_GEN)
    torch.cuda.synchronize()
    out["launches"] = (ops.launch_counts(), ops.grouped_launch_counts(),
                       ops.tile_launch_counts())
    # the kernels rank 0's card ran over another (rank 1 runs it alike)
    if rank == 0:
        out["profiled"] = profiled_kernel_counts(
            lambda: eng.generate(prompt, max_new_tokens=PAR_GEN))
    else:
        eng.generate(prompt, max_new_tokens=PAR_GEN)
    cache = eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                      cache)
    length = cache.length.clone()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    eng._decode_n(model, first, cache, n_steps=PAR_GEN)
    torch.cuda.synchronize()
    out["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / PAR_GEN
    # where a token's time goes: the card's time by kernel over 8 steps
    # (rank 0's profiler), and one rank's host-staged all-reduce of a
    # decode step's [1, 1, H] bf16 partial sum, alone
    cache.length.copy_(length)
    dist.barrier()
    if rank == 0:
        out["decode_profile"] = device_profile(
            lambda: eng._decode_n(model, first, cache, n_steps=8), 8)
    else:
        eng._decode_n(model, first, cache, n_steps=8)
    x = torch.ones((1, 1, cfg.hidden_size), dtype=torch.bfloat16,
                   device="cuda")
    n = 2 * cfg.num_layers
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        comm.all_reduce_(x, dist.group.WORLD)
    torch.cuda.synchronize()
    out["all_reduce_us"] = (time.perf_counter() - t0) * 1e6 / n
    return out


def nccl_rank(rank, world, prompt):
    """Phase 8c: the tp = 1 engine on an NCCL group with captured graphs
    against the plain Engine on the same model, bf16, at PAR_SMALL_LAYERS
    layers.  The all-reduces are called inside the captures, but on one
    rank NCCL launches no kernel for them (``nccl_kernels_8_steps``)."""
    import torch.distributed as dist
    from amq_tpu_torch.parallel import comm
    from amq_tpu_torch.parallel import tp_stacked as tps
    from amq_tpu_torch.serving.engine import Engine
    numerics()
    cfg = par_config(PAR_SMALL_LAYERS)
    model = tp_model(cfg, 1, 0)
    max_len = PAR_PROMPT + PAR_GEN + 8
    eng = tps.make_tp_engine(cfg, dist.group.WORLD, 1, model, batch_size=1,
                             max_len=max_len)
    got = eng.generate(prompt, max_new_tokens=PAR_GEN)
    want = Engine(model, cfg, batch_size=1, max_len=max_len).generate(
        prompt, max_new_tokens=PAR_GEN)
    # what the card ran over 8 replayed decode steps: NCCL kernels too
    cache = eng.new_cache()
    first, cache = eng._prefill_token(model, eng.tokens_to_device(prompt),
                                      cache)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng._decode_n(model, first, cache, n_steps=8)
        torch.cuda.synchronize()
    nccl = sum(ev.count for ev in prof.key_averages()
               if "nccl" in ev.key.lower() and ev.self_device_time_total > 0)
    return dict(backend=comm.backend(dist.group.WORLD),
                tokens_equal=bool((got == want).all()),
                runner=eng.runner.stats(), nccl_kernels_8_steps=nccl,
                all_reduces_8_steps=2 * cfg.num_layers * 8)


def small_model(cfg):
    from amq_tpu_torch.models.stacked import stack_proxies
    return stack_proxies(par_proxies(cfg), BITS, arch=par_arch(cfg))


def small_inputs(cfg):
    rng = np.random.default_rng(PAR_SEED)
    return dict(
        prompt=rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64),
        steps=rng.integers(0, cfg.vocab_size, (2, 4, 1)).astype(np.int64),
        requests=[rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                  for n in (12, 30, 7, 21)],
        eval=rng.integers(0, cfg.vocab_size, (3, 512)).astype(np.int32),
        tp_prompt=rng.integers(0, cfg.vocab_size, (1, PAR_PROMPT)).astype(
            np.int64))


def eval_setup(cfg):
    from amq_tpu_torch.models.llama import init_params
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    return params, [par_arch(cfg), {"linear": {
        n: [4] * cfg.num_layers for n in par_arch(cfg)["linear"]}}]


def small_rank(rank, world):
    """Phase 8d on one rank, PAR_SMALL_LAYERS layers at full width: the
    pipeline (2 stages, 2 microbatches, batch 4, float32, kernels on), the
    data-parallel slots (one each, float32, captured graphs) and the
    data-parallel evaluation (JSD of two archs, bf16, samples 2 + 1)."""
    from amq_tpu_torch.parallel import launch
    numerics()
    cfg = par_config(PAR_SMALL_LAYERS)
    model, inp = small_model(cfg), small_inputs(cfg)
    pp = launch.pp_run(rank, world, model, cfg, inp["prompt"], inp["steps"],
                       n_micro=2, max_len=64, device="cuda", use_kernels=True)
    dp = launch.dp_serving_run(rank, world, model, cfg, inp["requests"], 16,
                               chunk_steps=4, prefill_buckets=(16, 32),
                               max_len=64, device="cuda", use_kernels=True)
    params, archs = eval_setup(cfg)
    ev = launch.dp_eval_run(rank, world, cfg, params, {"s": inp["eval"]},
                            archs, compute_dtype=torch.bfloat16,
                            device="cuda")
    del model, params
    torch.cuda.empty_cache()
    # tp 2 at this depth, float32, with the kernels
    tp = launch.tp_stacked_run(
        rank, world, par_proxies(cfg), BITS, cfg, inp["tp_prompt"], steps=4,
        stack_kw=tp_stack_kw(cfg), max_len=PAR_PROMPT + 8, device="cuda",
        use_kernels=True)
    return dict(pp=pp, dp=dp, eval=ev, tp=tp[2])


def small_references():
    """One process's answers to small_rank's three paths."""
    from amq_tpu_torch.evaluation.evaluator import Evaluator
    from amq_tpu_torch.models import linear as linear_mod
    from amq_tpu_torch.models import llama
    from amq_tpu_torch.models.stacked import forward_stacked
    from amq_tpu_torch.serving.batched import SlotEngine
    from amq_tpu_torch.serving.engine import (ContinuousBatcher, Request,
                                              kernel_linear_impl)
    cfg = par_config(PAR_SMALL_LAYERS)
    model, inp = small_model(cfg), small_inputs(cfg)
    cache = llama.KVCache.create(cfg, 4, 64, dtype=torch.float32,
                                 device="cuda")
    pp = []
    with torch.inference_mode(), linear_mod.kernel_linears(
            kernel_linear_impl), llama.forward_kernels(True):
        for t in [inp["prompt"], *inp["steps"]]:
            logits, cache = forward_stacked(
                model, cfg, torch.as_tensor(t, device="cuda"), cache=cache,
                compute_dtype=torch.float32)
            pp.append(logits[:, -1].cpu().numpy())
    se = SlotEngine(model, cfg, n_slots=2, max_len=64,
                    compute_dtype=torch.float32, prefill_buckets=(16, 32),
                    chunk_steps=4)
    batcher = ContinuousBatcher(n_slots=2, max_len=64)
    for i, p in enumerate(inp["requests"]):
        batcher.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    dp = se.run(batcher)
    del se, model
    params, archs = eval_setup(cfg)
    ev = Evaluator(cfg, dense_params=params, datasets={"s": inp["eval"]},
                   batch_size=2, compute_dtype=torch.bfloat16)
    evals = [ev.eval(a) for a in archs]
    del ev, params
    ref = tp_reference_model(cfg, 2)
    tp = {}
    for use_kernels in (True, False):
        # the kernel path is the reference; the plain path (dequantize,
        # library matmul) on the same tokens is the control: a gap that is
        # rounding alone at this depth and width
        cache = llama.KVCache.create(cfg, 1, PAR_PROMPT + 8,
                                     dtype=torch.float32, device="cuda")
        calls = tp.setdefault(use_kernels, [])
        impl = kernel_linear_impl if use_kernels else None
        with torch.inference_mode(), linear_mod.kernel_linears(impl), \
                llama.forward_kernels(use_kernels):
            toks = torch.as_tensor(inp["tp_prompt"], device="cuda")
            for i in range(5):
                logits, cache = forward_stacked(ref, cfg, toks, cache=cache,
                                                compute_dtype=torch.float32)
                calls.append(logits.cpu().numpy())
                toks = (torch.as_tensor(np.argmax(tp[True][i][:, -1], -1),
                                        device="cuda")[:, None])
    return dict(pp=pp, dp=dp, eval=evals, tp=tp[True], tp_control=tp[False])


def first_divergence(a, b):
    diff = np.nonzero(np.ravel(a) != np.ravel(b))[0]
    return int(diff[0]) if diff.size else None


def parallel_phase(cases, gen):
    """Phase 8: PARALLEL.  (a) tp 2 at full Llama-2-7B width and depth, two
    ranks on the one card over gloo (NCCL refuses two ranks on one
    device), against the single-card Engine on the unsharded stack;
    (b) the kernels at one tp-2 rank's shapes (CASE lines, into
    ``cases``); (c) tp 1 on an NCCL group with captured graphs; (d) the
    pipeline, the data-parallel slots and the data-parallel evaluation
    on two gloo ranks at PAR_SMALL_LAYERS layers against one process.
    Fails unless every gate holds."""
    from amq_tpu_torch.parallel import launch
    from amq_tpu_torch.serving.engine import Engine
    t_start = time.perf_counter()
    rec = {"card": smi_line(), "note": "ranks share one card: times say "
           "nothing about scaling across cards"}
    cfg = par_config(32)
    L = cfg.num_layers
    prompt = np.random.default_rng(PAR_SEED).integers(
        0, cfg.vocab_size, (1, PAR_PROMPT)).astype(np.int32)

    # (a)
    t0 = time.perf_counter()
    ranks = launch.spawn(tp_rank, 2, prompt, backend="gloo", timeout=600)
    tp_s = time.perf_counter() - t0
    ref_model = tp_reference_model(cfg, 2)
    ref, control = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[-1]
        for use_kernels in (True, False):
            eng = Engine(ref_model, cfg, batch_size=1,
                         max_len=PAR_PROMPT + PAR_GEN + 8, compute_dtype=dt,
                         cache_dtype=dt, use_kernels=use_kernels)
            last, _ = eng._prefill(ref_model, eng.tokens_to_device(prompt),
                                   eng.new_cache())
            last = last.float().cpu().numpy()
            if use_kernels:
                ref[key] = dict(logits=last, tokens=eng.generate(
                    prompt, max_new_tokens=PAR_GEN))
            else:
                # the same model on one card by another summation order
                # (dequantize, library matmul): the size of a gap that is
                # rounding alone at this depth
                control[key] = float(np.abs(last - ref[key]["logits"]).max()
                                     / np.abs(ref[key]["logits"]).max())
            del eng
    del ref_model
    torch.cuda.empty_cache()
    r0 = ranks[0]
    f32_logits, f32_ref = r0["float32"]["logits"], ref["float32"]["logits"]
    bf_logits, bf_ref = r0["bfloat16"]["logits"], ref["bfloat16"]["logits"]
    want = (reckon_decode(L, 1, PAR_PROMPT, PAR_GEN - 1, False, False),
            reckon_grouped(L, PAR_GEN - 1, False), reckon_tile(L, 1))
    want_seen = dict(grouped=sum(want[1].values()), tile=sum(want[2].values()),
                     decode_attention=want[0]["decode_attention_indexed"])
    a = dict(
        tp=2, backend=r0["backend"], layers=L, prompt=PAR_PROMPT,
        gen=PAR_GEN, build_s=[r["build_s"] for r in ranks],
        rank_peak_gib=[r["peak_gib"] for r in ranks], spawn_s=tp_s,
        ranks_agree=all(np.array_equal(r["float32"]["tokens"],
                                       r0["float32"]["tokens"])
                        and np.array_equal(r["bfloat16"]["tokens"],
                                           r0["bfloat16"]["tokens"])
                        for r in ranks),
        f32_tokens_equal=bool(np.array_equal(r0["float32"]["tokens"],
                                             ref["float32"]["tokens"])),
        f32_logits_jax_tol=bool(np.allclose(f32_logits, f32_ref, rtol=TP_TOL,
                                            atol=TP_TOL)),
        f32_logits_max_abs=float(np.abs(f32_logits - f32_ref).max()),
        f32_logits_rel=float(np.abs(f32_logits - f32_ref).max()
                             / np.abs(f32_ref).max()),
        f32_ref_logit_max=float(np.abs(f32_ref).max()),
        tol=tp_tol(control["float32"]), f32_control_rel=control["float32"],
        bf16_control_rel=control["bfloat16"],
        bf16_first_divergence=first_divergence(r0["bfloat16"]["tokens"],
                                               ref["bfloat16"]["tokens"]),
        bf16_logits_rel=float(np.abs(bf_logits - bf_ref).max()
                              / np.abs(bf_ref).max()),
        bf16_top1_agree=bool(bf_logits.argmax() == bf_ref.argmax()),
        f32_core_launches=[r["float32"]["core_launches"] for r in ranks],
        launches=[r["launches"] for r in ranks], launches_want=want,
        profiled_rank0=r0["profiled"], profiled_want=want_seen,
        decode_ms_per_token=[r["decode_ms_per_token"] for r in ranks],
        all_reduce_us=[r["all_reduce_us"] for r in ranks],
        decode_profile_rank0=r0["decode_profile"])
    a["routes_ok"] = (all(tuple(r["launches"]) == want for r in ranks)
                      and r0["profiled"] == want_seen
                      and not any(a["f32_core_launches"]))
    a["ok"] = (a["ranks_agree"] and a["f32_tokens_equal"]
               and a["f32_logits_rel"] <= a["tol"] and a["routes_ok"]
               and a["backend"] == "gloo")
    rec["tp2"] = a
    print("PARALLEL_TP2 " + json.dumps({k: v for k, v in a.items()
                                        if k not in ("launches",
                                                     "launches_want")}),
          flush=True)

    # (b)
    n0 = len(cases)
    for site in ("qkv_tp2", "o_tp2", "gateup_tp2", "down_tp2"):
        for nbits in (2, 3, 4):
            cases.append(check_matmul(site, nbits, 1, torch.bfloat16, gen))
    for M in (1, PAR_PROMPT):
        cases.append(check_matmul("head_tp2", 8, M, torch.bfloat16, gen))
    cases.append(check_attention("tp2-decode", 1, 16, 1, 128, 200, (128,),
                                 gen))
    torch.cuda.empty_cache()
    shard = cases[n0:]
    rec["shard_cases"] = dict(
        n=len(shard), ok=all(c["ok"] for c in shard),
        routes={f"{c.get('site', c.get('case'))}/{c.get('nbits', '')}/"
                f"{c.get('M', '')}": c.get("route", "attention")
                for c in shard})

    # (c)
    t0 = time.perf_counter()
    c = launch.spawn(nccl_rank, 1, prompt, backend="nccl", timeout=300)[0]
    c["spawn_s"] = time.perf_counter() - t0
    c["ok"] = (c["tokens_equal"] and c["backend"] == "nccl"
               and c["runner"]["captures"] >= 2
               and c["runner"]["replays"] >= PAR_GEN)
    rec["nccl_graphs"] = c
    print("PARALLEL_NCCL " + json.dumps(c), flush=True)

    # (d)
    t0 = time.perf_counter()
    got = launch.spawn(small_rank, 2, backend="gloo", timeout=600)
    d_s = time.perf_counter() - t0
    want = small_references()
    pp_err = max(float(np.abs(g - w).max() / np.abs(w).max())
                 for g, w in zip(got[0]["pp"], want["pp"]))
    d = dict(
        layers=PAR_SMALL_LAYERS, spawn_s=d_s,
        pp_rel_err=pp_err, pp_ranks_agree=all(
            all(np.array_equal(x, y) for x, y in zip(r["pp"], got[0]["pp"]))
            for r in got),
        dp_equal=all(r["dp"] == want["dp"] for r in got),
        dp_requests=len(want["dp"]),
        eval_losses=[[e[0]["s"] for e in r["eval"]] for r in got],
        eval_want=[e[0]["s"] for e in want["eval"]])
    d["eval_equal"] = all(
        abs(g - w) <= 1e-6 * abs(w)
        for losses in d["eval_losses"] for g, w in zip(losses, d["eval_want"]))
    d["tp2_jax_tol"] = all(
        np.allclose(g, w, rtol=tol, atol=tol)
        for g, w, tol in zip(got[0]["tp"], want["tp"],
                             [TP_TOL] + [TP_CHAIN_TOL] * 4))
    d["tp2_ranks_agree"] = all(
        all(np.array_equal(x, y) for x, y in zip(r["tp"], got[0]["tp"]))
        for r in got)
    d["tp2_max_abs"] = max(float(np.abs(g - w).max())
                           for g, w in zip(got[0]["tp"], want["tp"]))
    d["tp2_rel"] = max(float(np.abs(g - w).max() / np.abs(w).max())
                       for g, w in zip(got[0]["tp"], want["tp"]))
    d["tp2_control_rel"] = max(
        float(np.abs(c - w).max() / np.abs(w).max())
        for c, w in zip(want["tp_control"], want["tp"]))
    d["tp2_tol"] = tp_tol(d["tp2_control_rel"])
    d["ok"] = (pp_err <= TP_TOL and d["pp_ranks_agree"] and d["dp_equal"]
               and d["eval_equal"] and d["tp2_rel"] <= d["tp2_tol"]
               and d["tp2_ranks_agree"])
    rec["small"] = d
    print("PARALLEL_SMALL " + json.dumps(d), flush=True)

    rec["seconds"] = time.perf_counter() - t_start
    rec["ok"] = (a["ok"] and rec["shard_cases"]["ok"] and c["ok"]
                 and d["ok"])
    print("PARALLEL " + json.dumps(dict(
        ok=rec["ok"], seconds=rec["seconds"], card=rec["card"],
        note=rec["note"], tp2_ok=a["ok"], tp2_f32_tokens_equal=a[
            "f32_tokens_equal"], tp2_routes_ok=a["routes_ok"],
        tp2_decode_ms_per_token=a["decode_ms_per_token"],
        shard_cases=rec["shard_cases"], nccl_graphs_ok=c["ok"],
        small_ok=d["ok"])), flush=True)
    if not rec["ok"]:
        fail(f"parallel phase: {json.dumps(rec, default=str)[:2000]}")
    return rec



def main():
    # -- phase 1: environment ------------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    card = smi_line()
    print(f"card: {card}", flush=True)
    try:
        triton_v = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_v = "not installed"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
          f"{triton_v} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    os.makedirs(OUT_DIR, exist_ok=True)

    from amq_tpu_torch import ops
    from amq_tpu_torch.models.config import get_config
    from amq_tpu_torch.ops import _cuda
    from amq_tpu_torch.parallel import launch
    from amq_tpu_torch.serving.benchmark import PeakMemTracker, benchmark_speed
    from amq_tpu_torch.serving.engine import Engine

    # -- phase 2: build -------------------------------------------------------
    build_s = _cuda.build(verbose=True)
    print(f"build: {build_s:.1f} s ({', '.join(_cuda.SOURCES)})", flush=True)
    build_rec = build_report()

    # -- phase 3: kernels vs plain versions ----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for meta in (torch.bfloat16, torch.float32):
        for M in (1, PROMPT):
            for site in ("qkv", "o", "gateup", "down"):
                for nbits in (2, 3, 4):
                    cases.append(check_matmul(site, nbits, M, meta, gen))
            cases.append(check_matmul("head", 8, M, meta, gen))
    # the grouped GEMV at continuous batching's 4 rows and its largest M
    for M in (4, 8):
        for site in ("qkv", "o", "gateup", "down"):
            for nbits in (2, 3, 4):
                cases.append(check_matmul(site, nbits, M, torch.bfloat16, gen))
    # width 1 (on no 7B path) on both routes, at the largest and smallest
    # decode sites
    for site in ("gateup", "o"):
        cases.append(check_matmul(site, 1, 1, torch.bfloat16, gen))
    # the head's speculative-verify row counts (gamma + 1) and the
    # grouped GEMV's largest M
    for M in (5, 8):
        cases.append(check_matmul("head", 8, M, torch.bfloat16, gen))
    cases.append(check_attention("llama2-7b", 4, 32, 1, 128, 200,
                                 (1, 63, 64, 199), gen))
    cases.append(check_attention("llama2-7b-decode", 1, 32, 1, 128, 200,
                                 (128,), gen))
    cases.append(check_attention("gqa-llama3-8b", 4, 8, 4, 128, 200,
                                 (1, 63, 64, 199), gen))
    cases.append(check_attention("hd64", 4, 16, 2, 64, 200,
                                 (1, 63, 64, 199), gen))
    cases.append(check_attention("window16", 4, 32, 1, 128, 200,
                                 (1, 63, 64, 199), gen, window=16))
    # reported: one row's context across one block (the evidence for a
    # cross-block split)
    cases.append(check_attention("long-context", 1, 32, 1, 128, 4096,
                                 (4000,), gen))
    # the float32 forms (f32 x): the grouped ring's at M <= 8, the tile
    # kernel's at 64, every one on its route, held to qmm_plain
    for M in (1, 8, PROMPT):
        for site in ("qkv", "o", "gateup", "down"):
            for nbits in (2, 3, 4):
                cases.append(check_matmul(site, nbits, M, torch.bfloat16, gen,
                                          torch.float32))
        cases.append(check_matmul("head", 8, M, torch.bfloat16, gen,
                                  torch.float32))
        torch.cuda.empty_cache()
    for nbits in (2, 3):                # OWQ's down, on the spanning kernel
        for M in (1, PROMPT):
            cases.append(check_owq_matmul("owq_down", nbits, M, gen,
                                          torch.float32))
    torch.cuda.empty_cache()
    cases.append(check_batch_independence(gen))
    for fc in FLASH_CASES:
        cases.append(check_flash(*fc, gen))
        torch.cuda.empty_cache()
    for site in ("qkv", "o", "gateup", "down"):
        for nbits in (2, 3, 4):
            cases += check_pipe(site, nbits, (1, 4, 8), gen)
            torch.cuda.empty_cache()
    for nbits in (2, 3, 4):
        cases += check_mlp(nbits, (1, 4, 8), gen)
        torch.cuda.empty_cache()
    for nbits in (1, 2, 3, 4, 5, 6, 8):
        cases.append(check_dequant(nbits, gen))
        torch.cuda.empty_cache()
    for site in EVAL_SITES_7B:          # the sensitivity run's widths
        for nbits in (2, 3, 4):
            cases.append(check_dequant(nbits, gen, site))
            torch.cuda.empty_cache()
    for site in OWQ_SITES_7B:           # OWQ packed serving's layouts
        for nbits in (2, 3, 4):
            for M in (1, PROMPT):
                cases.append(check_owq_matmul(site, nbits, M, gen))
        torch.cuda.empty_cache()
    # the other superblocks smaller than a ring stage (spanning stages);
    # at 128 rows the prefill too (at 1 and 3 bits the tile kernel's pair
    # form), and the float32 forms at 1 and 3 bits (the pair forms: the
    # ring's at M <= 8, the tile kernel's above)
    for nbits in (1, 2, 3, 4):
        for M in (1, PROMPT):
            cases.append(check_owq_matmul("owq_sb128", nbits, M, gen))
    for nbits in (1, 3):
        for M in (1, 8, PROMPT):
            cases.append(check_owq_matmul("owq_sb128", nbits, M, gen,
                                          torch.float32))
    cases.append(check_owq_matmul("owq_sb512", 1, 1, gen))
    for site in SITES_SB128:            # rows 1 and 2 on the pair forms
        cases.append(check_matmul(site, 3, PROMPT, torch.bfloat16, gen))
        for M in (1, PROMPT):
            cases.append(check_matmul(site, 3, M, torch.bfloat16, gen,
                                      torch.float32))
    torch.cuda.empty_cache()
    sweep = route_sweep(gen)
    torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel cases outside tolerance: {bad[:3]}")
    print(f"kernels vs plain: {len(cases)} cases within tolerance", flush=True)
    torch.cuda.empty_cache()

    # -- phase 3c: the decode-GEMV probes ------------------------------------
    t0 = time.perf_counter()
    probes = probes_phase()
    print(f"probes: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # -- phase 4: full-width decode ------------------------------------------
    cfg = get_config("Llama-2-7b-hf")
    t0 = time.perf_counter()
    model = random_llama7b(cfg, gen)
    torch.cuda.synchronize()
    wbytes = weight_bytes_per_token(model)
    b_ms = wbytes / HBM_BYTES_PER_S * 1e3
    print(f"model: Llama-2-7b-hf 32 layers built in "
          f"{time.perf_counter() - t0:.1f} s; {wbytes / 1e9:.3f} GB of packed "
          f"weights + meta per decode token -> byte bound {b_ms:.3f} ms/token "
          f"({1e3 / b_ms:.0f} tok/s) at 3.35 TB/s", flush=True)
    eng = Engine(model, cfg, batch_size=1, max_len=PROMPT + GEN + 8)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)

    ops.reset_launch_counts()
    toks = eng.generate(prompt, max_new_tokens=GEN)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    grouped_counts = ops.grouped_launch_counts()
    tile_counts = ops.tile_launch_counts()
    L = cfg.num_layers
    want = reckon_decode(L, 1, PROMPT, GEN - 1, pipe=False, mlp=False)
    want_grouped = reckon_grouped(L, GEN - 1, pipe=False)
    want_tile = reckon_tile(L, 1)
    print(f"launches over one generate: {counts} (want {want})", flush=True)
    # every decode GEMV of rows 1 and 2 (96 + 32 per token) and the head
    # took the grouped GEMV: no condition sent one back to the CUDA cores
    print("GROUPED_LAUNCHES " + json.dumps(dict(
        launches=grouped_counts, want=want_grouped, decode_tokens=GEN - 1,
        per_token={k: v / (GEN - 1) for k, v in grouped_counts.items()})),
        flush=True)
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    if grouped_counts != want_grouped:
        fail(f"grouped launches {grouped_counts} != {want_grouped}")
    # every prefill product of the layers (96 + 32) and the head took the
    # tile kernel
    print("TILE_LAUNCHES " + json.dumps(dict(launches=tile_counts,
                                             want=want_tile, prefills=1)),
          flush=True)
    if tile_counts != want_tile:
        fail(f"tile launches {tile_counts} != {want_tile}")
    if toks.shape != (1, GEN) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"generated tokens out of range: {toks.shape}")

    mem = PeakMemTracker("cuda")
    speed = {mode: benchmark_speed(eng, mode, prompt_len=PROMPT, gen_len=GEN)
             for mode in ("TPS", "GEMV", "GEMM", "TTFT")}
    peak, _ = mem.result()
    speed["peak_mem_gib"] = peak
    speed["byte_bound_ms_per_token"] = b_ms
    print("SPEED " + json.dumps(speed), flush=True)
    # the prefill of the 64-token prompt (the tile kernel's main path)
    print("PREFILL " + json.dumps(dict(
        prompt=PROMPT, prefill_ms=speed["GEMM"]["prefill_ms"],
        ttft_ms=speed["TTFT"]["ttft_ms"], tile_launches=tile_counts)),
        flush=True)
    for mode in ("TPS", "GEMV"):
        if not speed[mode]["tokens_per_s"] > 0:
            fail(f"{mode} gave no rate")

    prof = profile_decode(eng, prompt)
    f32_rec = f32_serve(model, cfg, prompt)
    logit_recs = [logits_check(model, cfg, prompt, dt)
                  for dt in (torch.float32, torch.bfloat16)]
    if not all(r["ok"] for r in logit_recs):
        fail(f"kernel-path logits differ from the plain path: {logit_recs}")
    long_rec = long_prompt_generate(model, cfg)

    # -- phase 4b: serving breadth -------------------------------------------
    switch_recs = switches_phase(eng, model, cfg, prompt, toks)
    cont_recs = continuous_phase(model, cfg)
    cont_recs["profile"] = continuous_profile(model, cfg)
    slot_rec = slot_f32_check(model, cfg)
    spec_recs = speculative_phase(model, cfg, prompt)

    # -- phase 4c: the serving loops as captured CUDA graphs -----------------
    graph_recs = graphs_phase(model, cfg, prompt)
    del eng, model
    torch.cuda.empty_cache()

    # -- phase 4d: Qwen2-0.5B, native 3-bit planes ---------------------------
    qwen = qwen2_phase(gen)

    # -- phase 5: the speed CLI ----------------------------------------------
    from amq_tpu_torch.cli import speed_benchmark
    ops.reset_launch_counts()
    cli = speed_benchmark.main([
        "--model_name", "Llama-2-7b-hf", "--synthetic", "--modes", "TPS",
        "CONTINUOUS", "--n_slots", str(SLOTS), "--n_requests", str(REQUESTS),
        "--save_path", OUT_DIR])
    print(f"CLI: setup {cli['setup_s']:.1f} s, TPS "
          f"{cli['TPS']['tokens_per_s']:.2f} tok/s, CONTINUOUS "
          f"{cli['CONTINUOUS']['tokens_per_s']:.2f} tok/s, launches "
          f"{ops.launch_counts()}", flush=True)
    if not cli["TPS"]["tokens_per_s"] > 0:
        fail("CLI TPS gave no rate")
    if not (cli["CONTINUOUS"]["tokens_per_s"] > 0
            and cli["CONTINUOUS"]["total_tokens"] == REQUESTS * GEN):
        fail(f"CLI CONTINUOUS: {cli['CONTINUOUS']}")

    torch.cuda.empty_cache()

    # -- phase 6: the sensitivity CLI at full width and depth ----------------
    sens = sensitivity_phase()
    eval_recs = eval_parity_phase()
    eval_prof = profile_eval_phase()

    # -- phase 7: the search CLI ---------------------------------------------
    search_rec = search_phase(sens["path"])

    # -- phase 7b: PTQ realization -------------------------------------------
    realize = realization_phases(
        os.path.join(OUT_DIR, "search_out", f"iter_{SEARCH_ITERS}.stats"))

    # -- phase 7c: OWQ packed serving at full width and depth ---------------
    owq_decode = owq_decode_phase()

    # -- phase 8: parallel forms on torch.distributed ranks -----------------
    par = parallel_phase(cases, gen)

    # -- phase 9: kernels line and last line ---------------------------------
    def pick(kernel, **match):
        return next(c for c in cases if c["kernel"] == kernel
                    and all(c.get(k) == v for k, v in match.items()))

    headline = {
        "quant_matmul_indexed": (pick("quant_matmul_indexed", site="gateup",
                                      nbits=4, M=1, meta="bfloat16",
                                      dtype="bfloat16"),
                                 "amq_tpu_torch/csrc/quant_matmul.cu",
                                 "amq_tpu/ops/quant_matmul.py:730"),
        "quant_matmul_swiglu_indexed": (
            pick("quant_matmul_swiglu_indexed", site="down", nbits=4, M=1,
                 meta="bfloat16", dtype="bfloat16"),
            "amq_tpu_torch/csrc/quant_matmul.cu",
            "amq_tpu/ops/quant_matmul.py:927"),
        "decode_attention_indexed": (
            pick("decode_attention_indexed", case="llama2-7b-decode"),
            "amq_tpu_torch/csrc/decode_attention.cu",
            "amq_tpu/ops/decode_attention.py:201"),
        "quant_matmul": (pick("quant_matmul", site="head", M=1,
                              meta="bfloat16", dtype="bfloat16"),
                         "amq_tpu_torch/csrc/quant_matmul.cu",
                         "amq_tpu/ops/quant_matmul.py:458"),
        "flash_attention": (pick("flash_attention",
                                 case="llama2-7b-eval-bf16"),
                            "amq_tpu_torch/csrc/flash_attention.cu",
                            "amq_tpu/ops/flash_attention.py:157"),
        # its float32 form (PTQ calibration): split TF32 on mma.sync
        "flash_attention_f32": (pick("flash_attention",
                                     case="llama2-7b-eval-f32"),
                                "amq_tpu_torch/csrc/flash_attention.cu",
                                "amq_tpu/ops/flash_attention.py:157"),
        "quant_matmul_indexed_pipe": (
            pick("quant_matmul_indexed_pipe", site="gateup", nbits=4, M=1),
            "amq_tpu_torch/csrc/quant_matmul_pipe.cu",
            "amq_tpu/ops/quant_matmul.py:671"),
        "quant_matmul_swiglu_indexed_pipe": (
            pick("quant_matmul_swiglu_indexed_pipe", site="down", nbits=4,
                 M=1),
            "amq_tpu_torch/csrc/quant_matmul_pipe.cu",
            "amq_tpu/ops/quant_matmul.py:869"),
        "quant_matmul_mlp_indexed": (
            pick("quant_matmul_mlp_indexed", nbits=4, M=1),
            "amq_tpu_torch/csrc/quant_matmul_mlp.cu",
            "amq_tpu/ops/quant_matmul.py:1112"),
        # the multi-row (prefill) branch of rows 1, 2 and 4: the tile
        # kernel on wgmma
        "quant_matmul_indexed_tile": (
            pick("quant_matmul_indexed", site="gateup", nbits=4, M=PROMPT,
                 meta="bfloat16", dtype="bfloat16"),
            "amq_tpu_torch/csrc/quant_matmul_tile.cu",
            "amq_tpu/ops/quant_matmul.py:730"),
        "quant_matmul_swiglu_indexed_tile": (
            pick("quant_matmul_swiglu_indexed", site="down", nbits=4,
                 M=PROMPT, meta="bfloat16", dtype="bfloat16"),
            "amq_tpu_torch/csrc/quant_matmul_tile.cu",
            "amq_tpu/ops/quant_matmul.py:927"),
        "quant_matmul_tile": (pick("quant_matmul", site="head", M=PROMPT,
                                   meta="bfloat16", dtype="bfloat16"),
                              "amq_tpu_torch/csrc/quant_matmul_tile.cu",
                              "amq_tpu/ops/quant_matmul.py:458"),
        # row 4's decode GEMV at superblocks smaller than a ring stage
        # (OWQ's down at 3 bits): the grouped GEMV's spanning kernel
        "quant_matmul_span": (pick("quant_matmul", site="owq_down", nbits=3,
                                   M=1, dtype="bfloat16"),
                              "amq_tpu_torch/csrc/qmm_grouped.cuh",
                              "amq_tpu/ops/quant_matmul.py:458"),
        # the float32 forms of rows 1, 2 and 4 (f32 activations): the
        # grouped ring's float32 GEMV and the tile kernel's float32 form
        "quant_matmul_indexed_f32": (
            pick("quant_matmul_indexed", site="gateup", nbits=4, M=1,
                 dtype="float32"),
            "amq_tpu_torch/csrc/quant_matmul_f32.cu",
            "amq_tpu/ops/quant_matmul.py:730"),
        "quant_matmul_swiglu_indexed_f32": (
            pick("quant_matmul_swiglu_indexed", site="down", nbits=4, M=1,
                 dtype="float32"),
            "amq_tpu_torch/csrc/quant_matmul_f32.cu",
            "amq_tpu/ops/quant_matmul.py:927"),
        "quant_matmul_f32": (pick("quant_matmul", site="head", M=1,
                                  dtype="float32"),
                             "amq_tpu_torch/csrc/quant_matmul_f32.cu",
                             "amq_tpu/ops/quant_matmul.py:458"),
        "quant_matmul_indexed_tile_f32": (
            pick("quant_matmul_indexed", site="gateup", nbits=4, M=PROMPT,
                 dtype="float32"),
            "amq_tpu_torch/csrc/quant_matmul_tile.cu",
            "amq_tpu/ops/quant_matmul.py:730"),
        "quant_matmul_swiglu_indexed_tile_f32": (
            pick("quant_matmul_swiglu_indexed", site="down", nbits=4,
                 M=PROMPT, dtype="float32"),
            "amq_tpu_torch/csrc/quant_matmul_tile.cu",
            "amq_tpu/ops/quant_matmul.py:927"),
        "quant_matmul_tile_f32": (pick("quant_matmul", site="head", M=PROMPT,
                                       dtype="float32"),
                                  "amq_tpu_torch/csrc/quant_matmul_tile.cu",
                                  "amq_tpu/ops/quant_matmul.py:458"),
        # the 4-row superblocks' pair forms (1 and 3 bits at 128 rows:
        # OWQ's 31-group q/k/v/o site, Qwen2-0.5B's 3-bit layers): the tile
        # kernel's (bf16 and float32) and the float32 grouped GEMV's
        "quant_matmul_tile_pair": (pick("quant_matmul", site="owq_sb128",
                                        nbits=3, M=PROMPT,
                                        dtype="bfloat16"),
                                   "amq_tpu_torch/csrc/quant_matmul_tile.cu",
                                   "amq_tpu/ops/quant_matmul.py:458"),
        "quant_matmul_tile_f32_pair": (
            pick("quant_matmul", site="owq_sb128", nbits=3, M=PROMPT,
                 dtype="float32"),
            "amq_tpu_torch/csrc/quant_matmul_tile.cu",
            "amq_tpu/ops/quant_matmul.py:458"),
        "quant_matmul_f32_pair": (pick("quant_matmul", site="owq_sb128",
                                       nbits=3, M=1, dtype="float32"),
                                  "amq_tpu_torch/csrc/quant_matmul_f32.cu",
                                  "amq_tpu/ops/quant_matmul.py:458"),
        # no Pallas kernel: the JAX package's XLA dequantization
        "dequantize_kn": (pick("dequantize_kn", site="gate", nbits=4),
                          "amq_tpu_torch/csrc/dequant.cu",
                          "amq_tpu/core/quantize.py:227"),
    }
    # launches on each kernel's main path: the decode generate for the
    # serving kernels (under AMQ_PIPE for the pipelined GEMVs, under both
    # switches for the MLP kernel), the sensitivity CLI for flash attention
    # and the dequantization, phase 7b's PTQ calibration for the float32
    # flash kernel
    pipe_counts = switch_recs["pipe"]["launches"]
    main_counts = {**counts,
                   "flash_attention": sens["launches"]["flash_attention"],
                   "quant_matmul_indexed_pipe":
                       pipe_counts["quant_matmul_indexed_pipe"],
                   "quant_matmul_swiglu_indexed_pipe":
                       pipe_counts["quant_matmul_swiglu_indexed_pipe"],
                   "quant_matmul_mlp_indexed": switch_recs["pipe+mlp"][
                       "launches"]["quant_matmul_mlp_indexed"],
                   "dequantize_kn": sens["launches"]["dequantize_kn"],
                   "flash_attention_f32": sum(r["launches"]["flash_f32"]
                                              for r in realize["methods"]),
                   "quant_matmul_span": owq_decode["span_launches"],
                   **{f"{k}_tile": v for k, v in tile_counts.items()},
                   # the float32 main path's generate (phase 4, F32_SERVE)
                   **{f"{k}_f32": v for k, v in f32_rec["grouped"].items()},
                   **{f"{k}_tile_f32": v for k, v in f32_rec["tile"].items()},
                   # the pair forms on phase 4d's generates (every wrapper)
                   "quant_matmul_tile_pair": sum(
                       v[1] for v in qwen["runs"]["bfloat16"]["pair"].values()),
                   "quant_matmul_tile_f32_pair": sum(
                       v[1] for v in qwen["runs"]["float32"]["pair"].values()),
                   "quant_matmul_f32_pair": sum(
                       v[0] for v in qwen["runs"]["float32"]["pair"].values())}
    def pair_case(name, x):
        """Is case x one of the pair form ``name``'s (1 and 3 bits at
        128-row superblocks, on its route and dtype)?"""
        route = "grouped" if name == "quant_matmul_f32_pair" else "tile"
        return (name.endswith("_pair") and x.get("superblock") == 128
                and x.get("nbits") in (1, 3) and x.get("route") == route
                and (x.get("dtype") == "float32") == ("f32" in name))

    kernels = []
    for name, (c, src, rep) in headline.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_counts[name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            **({"design": c["design"]} if "design" in c else {}),
            "case": {k: c[k] for k in ("site", "nbits", "M", "meta", "case")
                     if k in c},
            "cases_checked": sum(1 for x in cases if x["kernel"] == name
                                 or f"{x['kernel']}_tile" == name
                                 and x.get("route") == "tile"
                                 and x.get("dtype") != "float32"
                                 or f"{x['kernel']}_tile_f32" == name
                                 and x.get("route") == "tile"
                                 and x.get("dtype") == "float32"
                                 or f"{x['kernel']}_span" == name
                                 and x.get("spanning")
                                 or f"{x['kernel']}_f32" == name
                                 and x.get("dtype") == "float32"
                                 or pair_case(name, x))})
    # the probe kernels: launches over phase 3c, numbers of its gateup case
    for name, src, rep, checked in (
            ("gemv_attrib", "amq_tpu_torch/csrc/gemv_attrib.cu",
             "scripts/kernel_attrib.py:108", len(probes["attrib"]) * 4),
            ("gemv_extract_ahead", "amq_tpu_torch/csrc/gemv_extract_ahead.cu",
             "scripts/pipelined_gemv.py:129", len(probes["pipe"]))):
        c = probes["headline"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": probes["launches"][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "case": {k: c[k] for k in ("site", "nbits", "M", "meta")},
            "cases_checked": checked})
    # launches over phase 7b's realization runs, beside the main path's
    real_counts = {
        "flash_attention": sum(r["launches"]["flash_attention"]
                               for r in realize["methods"]),
        "dequantize_kn": sum(r["launches"]["dequantize_kn"]
                             for r in realize["methods"]),
        "quant_matmul": realize["owq_serve"]["launches"][
            "bfloat16_True"]["quant_matmul"],
        "decode_attention_indexed": realize["owq_serve"]["launches"][
            "bfloat16_True"]["decode_attention_indexed"]}
    for k in kernels:
        if k["name"] in real_counts:
            k["realize_launches"] = real_counts[k["name"]]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "cases": cases, "speed": speed,
                   "logits": logit_recs, "launches": counts,
                   "grouped_launches": grouped_counts,
                   "tile_launches": tile_counts, "profile": prof,
                   "f32_serve": f32_rec,
                   "long_prompt": long_rec, "switches": switch_recs,
                   "continuous": cont_recs, "slot_f32": slot_rec,
                   "speculative": spec_recs, "graphs": graph_recs,
                   "cli": cli, "build_s": build_s,
                   "sensitivity": {k: v for k, v in sens.items()
                                   if k != "table"},
                   "eval_parity": eval_recs, "eval_profile": eval_prof,
                   "search": search_rec, "probes": probes,
                   "realize": realize, "owq_decode": owq_decode,
                   "route_sweep": sweep, "qwen2": qwen,
                   "parallel": par,
                   "build_report": build_rec},
                  f, indent=1)
    # every process this run started (compilers, ranks, multiprocessing's
    # resource tracker) has ended before the result is printed
    left = launch.descendants()
    print(f"PROCESSES_LEFT {json.dumps(left)}", flush=True)
    if left:
        fail(f"processes left running: {left}")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
