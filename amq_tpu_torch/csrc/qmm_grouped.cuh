// The grouped GEMV's ring: one producer warp streaming words, meta and
// activations by bulk copies through full / empty mbarriers to kGWarps
// consumer warps that run the grouped form on tensor cores (qmm_tile.cuh's
// grouped_step, grouped_stage_low, grouped_stage_pipe).
//
// One copy of the ring serves five kernels: quant_matmul.cu's grouped
// GEMV (qmm_grouped_kernel<BITS, false>; below 8 bits, at superblocks
// smaller than a stage, qmm_grouped_span_kernel, whose stages span several
// superblocks: "Spanning stages" below), quant_matmul_pipe.cu's pipelined
// one (qmm_grouped_kernel<BITS, true>: the same ring, the pipelined
// consumer) and quant_matmul_mlp.cu's one-launch MLP, whose blocks walk
// many (column tile, K split) items through one ring (the stage count runs
// on across items, so the barriers re-arm) and may issue a stage's weights
// ahead of its activations (grouped_issue's parts); quant_matmul_f32.cu's
// float32 GEMV stages the split pass's three bf16 parts of f32 x as 3M
// activation rows (the producer's and the layout's EXACT form).
//
// The design (bound: bytes).  A block owns kGBN = 256 columns: kGWarps = 8
// consumer warps of kGTiles = 2 16-column MMA tiles each, every warp over
// all of its split's K, so no cross-warp sum; the tiles share the
// activation fragments and the xsum MMA.  The producer issues a stage as
// one copy per 1 KB word row, meta row and activation row and round,
// completing on the slot's full mbarrier; each consumer warp waits on it,
// computes, and releases the slot on its empty mbarrier.  No barrier of
// the whole block sits in the loop: with one per stage, copies and
// products took turns on the H100 (the time of both added up).  A stage is
// kGSR = 32 word rows (48 at 3 bits: 16 of the 1-bit plane, 32 of the
// 2-bit one) and the ring two stages; among the ring shapes tried at 8, 4
// and 2 bits (one to four tiles per warp, 8 to 64 rows per stage, two to
// five stages; probes/grouped_ring.py) this one ran fastest.  Under SwiGLU
// the consumer warps apply silu(x) * u to the stage's activations once, in
// place, behind a barrier of their own.  K is split across blocks as far
// as the blocks one SM holds (the occupancy of an M = 8 call, so every M
// splits alike and row m has the same bits at any M) fill one wave: at
// whole superblocks at 8 bits, at any stage below; the splits are summed
// in fixed order by reduce_splits_kernel, so two calls give the same bits.

#pragma once

#include "qmm_tile.cuh"

namespace amq {

// What grouped_issue issues of one stage: its words and meta (after
// waiting for the slot), its activation rows (with the barrier's arrival),
// or both.
constexpr int kIssueWeights = 1;
constexpr int kIssueActs = 2;
constexpr int kIssueAll = kIssueWeights | kIssueActs;

// A block's ring in its dynamic shared memory: per slot a full and an
// empty barrier (the first 128 bytes), then kGStages stages of `lay`.
// The kernels reach it through this symbol, so that the compiler
// addresses the ring at constant offsets in shared space (no pointer
// registers).
extern __shared__ __align__(16) unsigned char ring_smem[];

struct GroupedRing {
  GroupedLayout lay;
  int slots, es;            // meta slots per stage, bytes per meta value
};

__device__ __forceinline__ uint64_t* ring_full(int j) {
  return reinterpret_cast<uint64_t*>(ring_smem) + j % kGStages;
}

__device__ __forceinline__ uint64_t* ring_empty(int j) {
  return reinterpret_cast<uint64_t*>(ring_smem) + kGStages + j % kGStages;
}

// The slot of the block's j-th stage.
__device__ __forceinline__ unsigned char* ring_stage(const GroupedRing& r,
                                                     int j) {
  return ring_smem + 128 + (j % kGStages) * r.lay.stage;
}

// The ring of a call shaped like `a` (`span` superblocks a stage: each
// brings its meta slots; EXACT the float32 form's, qmm_tile.cuh); with
// `init` (once per kernel, every thread of the block) its barriers are set
// up.
template <int BITS, bool EXACT = false>
__device__ GroupedRing grouped_ring(const GemvArgs& a, bool init,
                                    int span = 1) {
  const int es = a.w.meta_bf16 ? 2 : 4;
  const int slots =
      span * grouped_meta_slots(BITS, a.w.superblock, a.w.group_size);
  const GroupedRing r{grouped_layout<BITS>(a.op.M, a.op.u != nullptr, es,
                                           slots, EXACT),
                      slots, es};
  if (init) {
    if (threadIdx.x < kGStages) {
      mbar_init(ring_full(threadIdx.x), 1);
      mbar_init(ring_empty(threadIdx.x), kGWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }
  return r;
}

// Ring stages per superblock (of the round plane's word rows).
template <int BITS>
__device__ __forceinline__ int grouped_spb(int sb) {
  return grouped_round_rows(BITS, sb) / GroupedForm<BITS>::n;
}

// Stages of the split that starts at stage st_lo.
template <int BITS>
__device__ __forceinline__ int grouped_stages(const GemvArgs& a, int st_lo) {
  const int n_st = a.Kp / a.w.superblock * grouped_spb<BITS>(a.w.superblock);
  return max(0, min(n_st, st_lo + a.sb_per_split) - st_lo);
}

// Producer (one warp): stage js of the weight's K (columns col0 ..) into
// ring slot j % kGStages, the block's j-th stage.  Activation rows past M
// are not copied (they only reach unwritten outputs); rows past K are
// zeros, written before the barrier's arrival so that its completion
// publishes them.  EXACT (the float32 form): the activation operand's 3M
// rows (the parts), and at 8 bits every stage's meta, in its own type.
template <int BITS, bool EXACT = false>
__device__ void grouped_issue(const GemvArgs& a, const GroupedRing& r,
                              int col0, int js, int j, int lane, int parts) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  const int sb = a.w.superblock, gs = a.w.group_size, Np = a.w.Np;
  const int M = EXACT ? 3 * a.op.M : a.op.M;
  const bool swiglu = a.op.u != nullptr;
  const int R = sb * BITS / 32;                    // word rows per superblock
  const int Rg = grouped_round_rows(BITS, sb);     // ... of a round plane
  const int spb = Rg / F::n;
  const int cols = min(kGBN, Np - col0);           // a multiple of 8
  const int sbi = js / spb, row0 = (js % spb) * F::n;
  const int k0 = sbi * sb + 2 * row0;              // round 0's first row
  unsigned char* st = ring_stage(r, j);
  uint64_t* bar = ring_full(j);
  if (parts & kIssueWeights) {
    // 8-bit: a group's rows in one round (its whole superblock when the
    // group spans rounds): the stage ending them carries the meta
    const int span = min(gs / 2, R);
    const bool meta = BITS != 8 || EXACT || (row0 + kGSR) % span == 0;
    if (j >= kGStages)
      mbar_wait(ring_empty(j), (j / kGStages - 1) & 1);
    if (lane == 0)
      mbar_expect_tx(bar, F::wrows * cols * 4 +
                              (meta ? 2 * r.slots * cols * r.es : 0));
    __syncwarp();
    for (int i = lane; i < F::wrows; i += 32) {
      // 3-bit: 2-bit rows [row0, +n) and [Rg + row0, +n), then 1-bit
      // rows [row0, +n) of the plane after the 2-bit plane's 2 Rg rows
      const int pl = i / F::n, rr = row0 + i - pl * F::n;
      const int src = BITS == 3 ? (pl == 2 ? 2 * Rg : pl * Rg) + rr
                                : row0 + i;
      bulk_g2s(st + i * kGWordStride * 4,
               a.w.packed + (static_cast<size_t>(sbi) * R + src) * Np + col0,
               cols * 4, bar);
    }
    if (meta && lane < 2 * r.slots) {   // row 2i scale, 2i + 1 zero of slot i
      const int grp =
          (k0 + (lane >> 1) * (P / r.slots) * 2 * Rg) / gs;
      const unsigned char* base = static_cast<const unsigned char*>(
          (lane & 1) ? a.w.zero : a.w.scale);
      bulk_g2s(st + r.lay.meta_off +
                   lane * kGBN * (BITS == 8 && !EXACT ? 4 : r.es),
               base + (static_cast<size_t>(grp) * Np + col0) * r.es,
               cols * r.es, bar);
    }
  }
  if (parts & kIssueActs) {
    const int nx = (swiglu ? 2 : 1) * M * P;        // activation rows
    int xbytes = 0;
    for (int p = 0; p < P; ++p)
      xbytes += 2 * max(0, min(F::part, a.op.K - (k0 + p * 2 * Rg)));
    for (int i = lane; i < nx; i += 32) {
      const int which = i / (M * P), mp = i - which * M * P;
      const int len = max(0, min(F::part, a.op.K - (k0 + (mp % P) * 2 * Rg)));
      __nv_bfloat16* xdst = reinterpret_cast<__nv_bfloat16*>(
          st + (which ? r.lay.u_off : r.lay.x_off)) + mp * F::xstride;
      for (int c = len; c < F::part; ++c) xdst[c] = __float2bfloat16(0.f);
    }
    // this lane's generic writes to the ring come before the copies'
    // (async proxy) writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0)
      mbar_arrive_expect_tx(bar, (swiglu ? 2 : 1) * M * xbytes);
    __syncwarp();
    for (int i = lane; i < nx; i += 32) {
      const int which = i / (M * P), mp = i - which * M * P;
      const int m = mp / P, k = k0 + (mp - m * P) * 2 * Rg;
      const int len = max(0, min(F::part, a.op.K - k));
      if (len > 0)
        bulk_g2s(st + (which ? r.lay.u_off : r.lay.x_off) +
                     mp * F::xstride * 2,
                 static_cast<const __nv_bfloat16*>(which ? a.op.u : a.op.x) +
                     static_cast<size_t>(m) * a.op.ldx + k,
                 len * 2, bar);
    }
  }
}

// Consumer warps: the S stages of the split from stage st_lo, the block's
// stages `count` onwards (count advances past them), into tot.
template <int BITS, bool PIPE>
__device__ void grouped_consume(const GemvArgs& a, const GroupedRing& r,
                                int st_lo, int S, int& count,
                                float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  const int sb = a.w.superblock, gs = a.w.group_size, M = a.op.M;
  const bool swiglu = a.op.u != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wcol = warp * 16 * kGTiles;
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[ct][i] = 0.f;
  if constexpr (BITS == 8) {
    const int spb = grouped_spb<BITS>(sb);
    const int span = min(gs / 2, sb * BITS / 32);
    GroupedAcc<BITS> acc;
    GroupedXAcc<BITS> xacc;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xacc[p][i] = 0.f;
#pragma unroll
        for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
          for (int q = 0; q < F::planes; ++q) acc[ct][p][q][i] = 0.f;
      }
    for (int s = 0; s < S; ++s, ++count) {
      mbar_wait(ring_full(count), (count / kGStages) & 1);
      const unsigned char* st = ring_stage(r, count);
      grouped_step<BITS>(
          reinterpret_cast<const uint32_t*>(st),
          reinterpret_cast<const __nv_bfloat16*>(st + r.lay.x_off),
          swiglu ? reinterpret_cast<const __nv_bfloat16*>(st + r.lay.u_off)
                 : nullptr,
          wcol, lane, acc, xacc);
      if ((((st_lo + s) % spb) * kGSR + kGSR) % span == 0)
        grouped_correct<BITS>(st + r.lay.meta_off, a.w.meta_bf16, wcol, lane,
                              acc, xacc, tot);
      __syncwarp();                  // the warp is done with the slot
      if (lane == 0) mbar_arrive(ring_empty(count));
    }
  } else {
    const int lg_share = __ffs(P / r.slots) - 1;     // rounds per slot: 2^lg
    // B rows past M read row M - 1 (their products reach no output)
    const int xrow = min(lane >> 2, M - 1);
    for (int s = 0; s < S; ++s, ++count) {
      mbar_wait(ring_full(count), (count / kGStages) & 1);
      unsigned char* st = ring_stage(r, count);
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + r.lay.x_off);
      if (swiglu) {
        // silu(x) * u once per stage, in place, by all consumer threads
        // (not per warp and fragment: each warp reads every activation),
        // then a barrier of the consumer warps only
        const __nv_bfloat16* us =
            reinterpret_cast<const __nv_bfloat16*>(st + r.lay.u_off);
        for (int i = tid; i < M * P * F::part / 2; i += kGWarps * 32) {
          const int row = i / (F::part / 2);
          const int o = row * F::xstride + 2 * (i - row * (F::part / 2));
          uint32_t* xp = reinterpret_cast<uint32_t*>(xs + o);
          *xp = swiglu_pair(*xp, *reinterpret_cast<const uint32_t*>(us + o));
        }
        // these generic writes come before the async-proxy copies that
        // refill the slot
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kGWarps * 32) : "memory");
      }
      const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
      const __nv_bfloat16* xr = xs + xrow * P * F::xstride;
      if constexpr (PIPE)
        grouped_stage_pipe<BITS>(ws, xr, st + r.lay.meta_off, r.es, lg_share,
                                 wcol, lane, tot);
      else
        grouped_stage_low<BITS>(ws, xr, st + r.lay.meta_off, r.es, lg_share,
                                wcol, lane, tot);
      __syncwarp();                  // the warp is done with the slot
      if (lane == 0) mbar_arrive(ring_empty(count));
    }
  }
}

// Consumer warps: tot into out [M, N] (split < 0) or into split's f32
// partials [splits, M, N].
__device__ __forceinline__ void grouped_store(const GemvArgs& a,
                                              const float (&tot)[kGTiles][4],
                                              int col0, int split) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp * 16 * kGTiles;
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 2 * t + (i & 1);
      const int n = col0 + wcol + 16 * ct + 2 * g + (i >> 1);
      if (m >= a.op.M || n >= a.N) continue;
      if (split < 0) {
        store_f(a.out, static_cast<size_t>(m) * a.N + n, tot[ct][i],
                a.out_bf16);
      } else {
        a.partial[(static_cast<size_t>(split) * a.op.M + m) * a.N + n] =
            tot[ct][i];
      }
    }
}

// The grouped GEMV: grid (ceil(N / kGBN), splits), each split a run of
// `sb_per_split` ring stages (8-bit: whole superblocks, since it corrects
// at group ends); PIPE takes the pipelined consumer (1/2/3/4-bit).
template <int BITS, bool PIPE>
__global__ void __launch_bounds__((kGWarps + 1) * 32, 2)
    qmm_grouped_kernel(GemvArgs a) {
  static_assert(!PIPE || BITS != 8, "the pipelined consumer is 1-4 bits");
  const GroupedRing r = grouped_ring<BITS>(a, true);
  const int col0 = blockIdx.x * kGBN;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = grouped_stages<BITS>(a, st_lo);
  int count = 0;
  if (threadIdx.x >> 5 == kGWarps) {
    for (int j = 0; j < S; ++j)
      grouped_issue<BITS>(a, r, col0, st_lo + j, count++, threadIdx.x & 31,
                          kIssueAll);
    return;
  }
  float tot[kGTiles][4];
  grouped_consume<BITS, PIPE>(a, r, st_lo, S, count, tot);
  grouped_store(a, tot, col0, gridDim.y == 1 ? -1 : blockIdx.y);
}

// ---------------------------------------------------------------------------
// Spanning stages: superblocks smaller than one ring stage.
//
// Below 8 bits a superblock whose round plane has Rg < n word rows (every
// width's 128-row superblock; OWQ's compacted down projection, Kp 11008 in
// superblocks of 256 rows, at 2 and 3 bits) fills a stage with span = n /
// Rg whole superblocks, so that a stage moves as many bytes as one of a
// large superblock: the stage's word row i of each plane block is
// superblock i / Rg's row i % Rg (3-bit: its 2-bit rows [0, Rg), then
// [Rg, 2 Rg), then its 1-bit rows), its meta slots are each superblock's
// in turn, and each activation row holds each superblock's sb activations
// in turn (one copy per row and superblock).  The consumer corrects every
// round once per superblock (span_stage_low; span_stage_pair for 4-row
// superblocks, whose two rounds share an MMA step).  The last stage of K
// may hold fewer superblocks: only those are copied and consumed.  Splits
// end at stages.  Its own kernel, one per superblock form (SPS, see
// span_superblock: every offset a constant), so that the whole-stage
// kernel keeps its code.

// Stages of the split that starts at stage st_lo (ceil(superblocks / span)
// stages in K).
__device__ __forceinline__ int span_stages(const GemvArgs& a, int span,
                                           int st_lo) {
  const int n_st = (a.Kp / a.w.superblock + span - 1) / span;
  return max(0, min(n_st, st_lo + a.sb_per_split) - st_lo);
}

// Producer (one warp): spanning stage js into ring slot j % kGStages, the
// block's j-th stage: its superblocks' words, meta slots and activation
// rows (rows past K zeros, written before the barrier's arrival; EXACT:
// the 3M rows of the float32 form's parts).
template <int BITS, bool EXACT = false>
__device__ void span_issue(const GemvArgs& a, const GroupedRing& r, int span,
                           int col0, int js, int j, int lane) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  const int sb = a.w.superblock, gs = a.w.group_size, Np = a.w.Np;
  const int M = EXACT ? 3 * a.op.M : a.op.M;
  const bool swiglu = a.op.u != nullptr;
  const int R = sb * BITS / 32;                    // word rows per superblock
  const int Rg = grouped_round_rows(BITS, sb);     // ... of a round plane
  const int sb0 = js * span;
  const int parts = min(span, a.Kp / sb - sb0);    // superblocks present
  const int per_sb = r.slots / span;               // meta slots of each
  const int cols = min(kGBN, Np - col0);
  const int xrow = P * F::xstride;                 // bf16 per activation row
  unsigned char* st = ring_stage(r, j);
  uint64_t* bar = ring_full(j);
  if (j >= kGStages) mbar_wait(ring_empty(j), (j / kGStages - 1) & 1);
  const int nx = (swiglu ? 2 : 1) * M * parts;     // activation copies
  int xbytes = 0;
  for (int q = 0; q < parts; ++q)
    xbytes += 2 * max(0, min(sb, a.op.K - (sb0 + q) * sb));
  for (int i = lane; i < nx; i += 32) {
    const int which = i / (M * parts), mq = i - which * M * parts;
    const int q = mq % parts;
    const int len = max(0, min(sb, a.op.K - (sb0 + q) * sb));
    __nv_bfloat16* xdst = reinterpret_cast<__nv_bfloat16*>(
        st + (which ? r.lay.u_off : r.lay.x_off)) + (mq / parts) * xrow +
        q * sb;
    for (int c = len; c < sb; ++c) xdst[c] = __float2bfloat16(0.f);
  }
  // this lane's generic writes to the ring come before the copies' (async
  // proxy) writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0)
    mbar_arrive_expect_tx(bar, F::wrows / span * parts * cols * 4 +
                                   2 * per_sb * parts * cols * r.es +
                                   (swiglu ? 2 : 1) * M * xbytes);
  __syncwarp();
  for (int i = lane; i < F::wrows; i += 32) {
    const int pl = i / F::n, q = (i - pl * F::n) / Rg;
    const int rr = i - pl * F::n - q * Rg;
    if (q >= parts) continue;
    const int src = BITS == 3 ? (pl == 2 ? 2 * Rg : pl * Rg) + rr : rr;
    bulk_g2s(st + i * kGWordStride * 4,
             a.w.packed + (static_cast<size_t>(sb0 + q) * R + src) * Np + col0,
             cols * 4, bar);
  }
  for (int i = lane; i < 2 * per_sb * parts; i += 32) {
    // row 2i scale, 2i + 1 zero of slot i; superblock q's slot s covers
    // its rounds from s * P / per_sb
    const int slot = i >> 1, q = slot / per_sb, s = slot - q * per_sb;
    const int grp = ((sb0 + q) * sb + s * (P / per_sb) * 2 * Rg) / gs;
    const unsigned char* base =
        static_cast<const unsigned char*>((i & 1) ? a.w.zero : a.w.scale);
    bulk_g2s(st + r.lay.meta_off + i * kGBN * r.es,
             base + (static_cast<size_t>(grp) * Np + col0) * r.es,
             cols * r.es, bar);
  }
  for (int i = lane; i < nx; i += 32) {
    const int which = i / (M * parts), mq = i - which * M * parts;
    const int m = mq / parts, q = mq - m * parts;
    const int len = max(0, min(sb, a.op.K - (sb0 + q) * sb));
    if (len > 0)
      bulk_g2s(st + (which ? r.lay.u_off : r.lay.x_off) +
                   (m * xrow + q * sb) * 2,
               static_cast<const __nv_bfloat16*>(which ? a.op.u : a.op.x) +
                   static_cast<size_t>(m) * a.op.ldx + (sb0 + q) * sb,
               len * 2, bar);
  }
}

// Consumer warps: the S spanning stages of the split from stage st_lo
// into tot, superblocks of SPS 8-row steps (0: 4-row superblocks).
template <int BITS, int SPS>
__device__ void span_consume(const GemvArgs& a, const GroupedRing& r,
                             int span, int st_lo, int S,
                             float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  constexpr int sb = span_superblock<BITS, SPS>();
  const int M = a.op.M;
  const bool swiglu = a.op.u != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wcol = warp * 16 * kGTiles;
  const int per_sb = r.slots / span;
  const int lg_share = __ffs(P / per_sb) - 1;       // rounds per slot: 2^lg
  const int sb_meta = 2 * per_sb * kGBN * r.es;     // meta bytes of each
  const int xrow = P * F::xstride;
  // B rows past M read row M - 1 (their products reach no output)
  const int xm = min(lane >> 2, M - 1);
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[ct][i] = 0.f;
  for (int s = 0; s < S; ++s) {
    mbar_wait(ring_full(s), (s / kGStages) & 1);
    unsigned char* st = ring_stage(r, s);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + r.lay.x_off);
    const int parts = min(span, a.Kp / sb - (st_lo + s) * span);
    if (swiglu) {
      // silu(x) * u once per stage, in place (as grouped_consume)
      const __nv_bfloat16* us =
          reinterpret_cast<const __nv_bfloat16*>(st + r.lay.u_off);
      const int half = parts * sb / 2;
      for (int i = tid; i < M * half; i += kGWarps * 32) {
        const int row = i / half;
        const int o = row * xrow + 2 * (i - row * half);
        uint32_t* xp = reinterpret_cast<uint32_t*>(xs + o);
        *xp = swiglu_pair(*xp, *reinterpret_cast<const uint32_t*>(us + o));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kGWarps * 32) : "memory");
    }
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const __nv_bfloat16* xr = xs + xm * xrow;
    const unsigned char* meta = st + r.lay.meta_off;
    // every stage but K's last holds `span` superblocks
    if constexpr (SPS == 0) {
      if (parts == span)
        span_stage_pair<BITS, true>(ws, xr, meta, r.es, lg_share, sb_meta,
                                    parts, wcol, lane, tot);
      else
        span_stage_pair<BITS, false>(ws, xr, meta, r.es, lg_share, sb_meta,
                                     parts, wcol, lane, tot);
    } else {
      if (parts == span)
        span_stage_low<BITS, SPS, true>(ws, xr, meta, r.es, lg_share,
                                        sb_meta, parts, wcol, lane, tot);
      else
        span_stage_low<BITS, SPS, false>(ws, xr, meta, r.es, lg_share,
                                         sb_meta, parts, wcol, lane, tot);
    }
    __syncwarp();                  // the warp is done with the slot
    if (lane == 0) mbar_arrive(ring_empty(s));
  }
}

// The grouped GEMV at spanning layouts of SPS-step superblocks (the
// superblock span_superblock<BITS, SPS>): grid (ceil(N / kGBN), splits),
// each split a run of `sb_per_split` spanning stages.
template <int BITS, int SPS>
__global__ void __launch_bounds__((kGWarps + 1) * 32, 2)
    qmm_grouped_span_kernel(GemvArgs a) {
  static_assert(BITS != 8, "8-bit superblocks hold whole stages");
  constexpr int span = GroupedForm<BITS>::n / (SPS == 0 ? 4 : 8 * SPS);
  const GroupedRing r = grouped_ring<BITS>(a, true, span);
  const int col0 = blockIdx.x * kGBN;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = span_stages(a, span, st_lo);
  if (threadIdx.x >> 5 == kGWarps) {
    for (int j = 0; j < S; ++j)
      span_issue<BITS>(a, r, span, col0, st_lo + j, j, threadIdx.x & 31);
    return;
  }
  float tot[kGTiles][4];
  span_consume<BITS, SPS>(a, r, span, st_lo, S, tot);
  grouped_store(a, tot, col0, gridDim.y == 1 ? -1 : blockIdx.y);
}

// Dynamic shared memory of one grouped block: barriers, then the ring
// (whole stages, or spanning ones; `exact` the float32 form's).
template <int BITS>
size_t grouped_smem(int M, bool swiglu, int meta_bf16, int sb, int gs,
                    bool exact = false) {
  const int span =
      grouped_whole_stages(BITS, sb) ? 1 : grouped_span(BITS, sb);
  return 128 + static_cast<size_t>(kGStages) *
                   grouped_layout<BITS>(M, swiglu, meta_bf16 ? 2 : 4,
                                        span * grouped_meta_slots(BITS, sb, gs),
                                        exact)
                       .stage;
}

// Let `kernel` take `smem` bytes of dynamic shared memory (raising the
// attribute as larger calls come; `allowed` is the kernel's own record),
// with the largest carveout, so that two blocks share an SM where their
// rings fit.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <int BITS, bool PIPE>
static cudaError_t grouped_allow(size_t smem) {
  static size_t allowed = 0;
  return allow_smem(qmm_grouped_kernel<BITS, PIPE>, smem, allowed);
}

template <int BITS, bool PIPE>
cudaError_t launch_grouped(const GemvArgs& a, int splits, cudaStream_t stream) {
  const size_t smem = grouped_smem<BITS>(a.op.M, a.op.u != nullptr,
                                         a.w.meta_bf16, a.w.superblock,
                                         a.w.group_size);
  cudaError_t e = grouped_allow<BITS, PIPE>(smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + kGBN - 1) / kGBN, splits);
  qmm_grouped_kernel<BITS, PIPE><<<grid, (kGWarps + 1) * 32, smem, stream>>>(
      a);
  return cudaGetLastError();
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int BITS, int SPS>
static cudaError_t span_allow(size_t smem) {
  static size_t allowed = 0;
  return allow_smem(qmm_grouped_span_kernel<BITS, SPS>, smem, allowed);
}

// The spanning kernels each width has: superblocks of 8-row steps SPS =
// sb / (16 P) (1 or 2; the superblocks of 128 rows and up smaller than a
// stage), and at 1 and 3 bits SPS = 0 (4-row superblocks of 128 rows).
template <int BITS, int SPS>
constexpr bool span_form() {
  return BITS != 8 && span_superblock<BITS, SPS>() >= 128 &&
         (SPS > 0 || BITS == 1 || BITS == 3) &&
         grouped_round_rows(BITS, span_superblock<BITS, SPS>()) <
             GroupedForm<BITS>::n;
}

// f(kernel, allow) with the spanning kernel of superblock `sb` and its
// shared-memory setter; cudaErrorInvalidValue where the width has none.
template <int BITS, class Fn>
cudaError_t with_span_kernel(int sb, Fn f) {
  if constexpr (span_form<BITS, 0>())
    if (sb == span_superblock<BITS, 0>())
      return f(qmm_grouped_span_kernel<BITS, 0>, span_allow<BITS, 0>);
  if constexpr (span_form<BITS, 1>())
    if (sb == span_superblock<BITS, 1>())
      return f(qmm_grouped_span_kernel<BITS, 1>, span_allow<BITS, 1>);
  if constexpr (span_form<BITS, 2>())
    if (sb == span_superblock<BITS, 2>())
      return f(qmm_grouped_span_kernel<BITS, 2>, span_allow<BITS, 2>);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t launch_span(const GemvArgs& a, int splits, cudaStream_t stream) {
  const size_t smem = grouped_smem<BITS>(a.op.M, a.op.u != nullptr,
                                         a.w.meta_bf16, a.w.superblock,
                                         a.w.group_size);
  return with_span_kernel<BITS>(
      a.w.superblock, [&](auto kernel, auto allow) {
        cudaError_t e = allow(smem);
        if (e != cudaSuccess) return e;
        dim3 grid((a.N + kGBN - 1) / kGBN, splits);
        kernel<<<grid, (kGWarps + 1) * 32, smem, stream>>>(a);
        return cudaGetLastError();
      });
}

// Does a width have a spanning kernel for superblock sb?  (The forms of
// with_span_kernel, without instantiating its kernels: the pipelined
// GEMV, the MLP and the attribution probe ask too.)
template <int BITS>
bool span_has(int sb) {
  return (span_form<BITS, 0>() && sb == span_superblock<BITS, 0>()) ||
         (span_form<BITS, 1>() && sb == span_superblock<BITS, 1>()) ||
         (span_form<BITS, 2>() && sb == span_superblock<BITS, 2>());
}

inline bool span_takes(int nbits, int sb) {
  switch (nbits) {
    case 1: return span_has<1>(sb);
    case 2: return span_has<2>(sb);
    case 3: return span_has<3>(sb);
    case 4: return span_has<4>(sb);
    default: return false;
  }
}

// The calls the ring takes (the wrapper's _grouped_applies, at the default
// ring shape): bf16 activations, 1 <= M <= 8, Np, K and the row stride of
// x multiples of 8 and 16-byte aligned activations, words and meta
// (16-byte bulk copies), a superblock of at most 1024 rows that holds
// whole groups, groups of a multiple of 2 * kGSR rows (64: a stage's rows
// of one round lie in one group); 8-bit: rounds that nest with the groups
// (the correction at group ends) and whole ring stages (a superblock of a
// multiple of 128 rows); 1/2/3/4-bit: power-of-two groups and superblock
// (the meta slots a stage's rounds share), whole stages (256 rows at 4
// bits, 512 at 3 and 2, 1024 at 1) or, with `spanning` (the grouped GEMV's
// spanning kernel; its pipelined form, the MLP and the attribution probe
// take whole stages only), any superblock of 128 rows and up.
inline bool grouped_takes(const void* x, const void* u, int x_bf16,
                          const int32_t* packed, const void* scale,
                          const void* zero, int M, int K, int ldx, int Kp,
                          int Np, int nbits, int gs, int sb,
                          bool spanning = false) {
  if (nbits != 1 && nbits != 2 && nbits != 3 && nbits != 4 && nbits != 8)
    return false;
  return x_bf16 && M >= 1 && M <= 8 && gs > 0 && gs % (2 * kGSR) == 0 &&
         sb % gs == 0 && Kp % sb == 0 && sb <= 1024 && Np % 8 == 0 &&
         K % 8 == 0 && ldx % 8 == 0 && aligned16(x) &&
         (u == nullptr || aligned16(u)) && aligned16(packed) &&
         aligned16(scale) && aligned16(zero) &&
         (nbits == 8 ? rounds_nest_groups(nbits, sb, gs) &&
                           grouped_whole_stages(nbits, sb)
                     : pow2(gs) && pow2(sb) &&
                           (grouped_whole_stages(nbits, sb) ||
                            (spanning && span_takes(nbits, sb))));
}

// Sum the K splits' partials into out (fixed order), after a split launch.
inline int finish_splits(cudaError_t e, float* partial, void* out, int MN,
                         int splits, int out_bf16, cudaStream_t s) {
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  reduce_splits_kernel<<<(MN + 255) / 256, 256, 0, s>>>(partial, out, MN,
                                                        splits, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace amq
