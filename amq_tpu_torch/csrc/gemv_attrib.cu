// Attribution probe of the decode GEMV: the production body with parts
// taken out.
//
// Replaces the Pallas kernel of scripts/kernel_attrib.py (`_kernel`,
// launched by the `pl.pallas_call` of its `build`), which times the TPU
// GEMV body (the production grouped form, _gemv_blockdiag) with the
// extraction, the dot or both removed.  Here a body per production decode
// GEMV, templated on <NB, VARIANT>, wraps that GEMV's launch shape, shared
// memory and loop:
//
//   kGemv     qmm_gemv_kernel (quant_matmul.cu), the CUDA-core per-weight
//             form that f32 activations and the layouts the grouped ring
//             refuses take: words straight from device memory into
//             registers, activation and meta staged in shared memory once
//             per superblock, qmm_tile.cuh's superblock_fma per superblock;
//   kGrouped  qmm_grouped_kernel<NB, false> (qmm_grouped.cuh), the grouped
//             form every bf16 decode GEMV at M <= 8 runs: its ring, its
//             producer warp (grouped_issue), its mbarriers, 256-column
//             blocks, splits, launch bounds and shared memory; only the
//             consumer warps' step changes with the variant.
//
// Every variant loads the same bytes as production (the activation, every
// scale/zero, every packed word); they differ only in what they do with
// them.  GEMV body:
//
//   kFull     the production arithmetic (superblock_fma, sum_slices,
//             write_cols, reduce_splits_kernel themselves), so its output
//             equals the CUDA-core GEMV's bit for bit;
//   kFmaOnly  no extraction: every code is 129.0f, built as
//             (word & zmask_h) | bits(129.0f) with zmask_h run-time zeros
//             that differ for the two halves h of a word, so the compiler
//             can neither fold the code nor merge the two dequantizing
//             fmafs of a word (the rounds p differ in their scale): the
//             same fmaf count per weight as kFull.  The words are
//             XOR-folded per column (xr) as well;
//   kExtOnly  kFull's shift, mask and int->float conversion, no FMA
//             against x: the codes are summed per column in f32 (cs;
//             integers below 2^24, so exact) in one chain, as kFull's dot
//             is one chain of fmafs, and the meta values XOR-folded into
//             xr;
//   kLoadOnly words and meta XOR-folded per column into xr.
//
// Grouped body (the JAX script's full / dot_only / ext_only / dma_only):
//
//   kFull     grouped_consume and grouped_store themselves, the grouped
//             GEMV's splits and reduce_splits_kernel: its output equals the
//             grouped GEMV's bit for bit;
//   kMmaOnly  (index kFmaOnly) the same MMAs -- the codes' and the xsum's --
//             and corrections, but every code fragment reads code 1 in the
//             round's field, 128 + 2^o (129 where the field sits at bit 0),
//             built as (word & zmask) | that constant with zmask a
//             run-time zero, so the compiler can neither fold the
//             fragments nor drop a load; the SwiGLU prologue runs as in
//             production.  The stage's words are XOR-folded per column
//             (xr);
//   kExtOnly  the extraction into A fragments (low_frag, low_shift), each
//             fragment XOR-folded into its column's xr in place of the
//             MMAs; no correction;
//   kLoadOnly wait on the stage's full barrier, XOR-fold its words into
//             xr, and the meta of each group once (in the stage where the
//             group's rows begin), release the slot.
//
// xr and cs combine over threads, warps and K splits with atomicXor /
// atomicAdd, both order-free here (XOR; integer-valued f32 sums below
// 2^24), so every output is a deterministic function with a plain
// PyTorch version (probes/kernel_attrib.py).
//
// Every variant runs with as many blocks resident per SM as kFull in the
// same body and width, so that a time tracking kFull's says what kFull's
// critical path is and not how many loads each variant keeps in flight.  A
// stripped variant is compiled for kFull's blocks per SM (GEMV body:
// min_blocks below, from kFull's registers; grouped body: the ring's own
// __launch_bounds__(288, 2)), which caps its registers; where it would
// still fit more blocks, its launch pads the dynamic shared memory until
// it fits as many (plan).  amq_gemv_attrib_occupancy reports the blocks,
// registers, local bytes and shared memory each variant launches with.
//
// Bound on the H100: bytes, as the production GEMV (every word and meta
// value read once per call, a few operations per weight).  The question
// the probe answers is which of loads, extraction and products sets the
// production time: the variant whose time tracks kFull's is on the
// critical path.

#include <algorithm>

#include "qmm_grouped.cuh"

using namespace amq;

namespace {

enum Body { kGemv = 0, kGrouped = 1 };
enum Variant { kFull = 0, kFmaOnly = 1, kExtOnly = 2, kLoadOnly = 3 };
constexpr int kMmaOnly = kFmaOnly;     // the grouped body's index 1
constexpr int kGThreads = (kGWarps + 1) * 32;

// Blocks of the GEMV body's kFull per SM at 512 threads, from its
// registers per thread on sm_90a (65536 per SM; the production kernel's
// own): 64, 89, 40 at 2, 3, 4 bits.  The stripped variants are compiled
// to fit as many (their kernels *_pinned).  kFull keeps production's bare
// __launch_bounds__(kThreads): a minimum of even one block per SM changes
// how ptxas allocates its registers.
constexpr int min_blocks(int nb) { return nb == 3 ? 1 : nb == 4 ? 3 : 2; }

// Outputs of the stripped variants, folded into (XOR, add): zeroed by the
// caller for a fresh result.
struct Probe {
  uint32_t* xr;     // [N] XOR fold
  float* cs;        // [N] code sums
  uint32_t zmask;   // 0 at run time
};

constexpr uint32_t kBits129 = 0x43010000u;   // 129.0f

// One pair-planar plane of a stripped GEMV-body variant, with plane_fma's
// loop structure and word / meta access (qmm_tile.cuh).
template <int BITS, bool ZERO, int MT, int VARIANT, class Word, class Meta>
__device__ __forceinline__ void plane_probe(Word word, Meta meta, int R,
                                            float cmul, const float* xs,
                                            int sb, int gs, int ty,
                                            uint32_t zmask, float (&acc)[MT],
                                            uint32_t& xr, float& cs) {
  constexpr int P = 16 / BITS;
  constexpr uint32_t mask = (1u << BITS) - 1u;
  const int rc = R < gs / 2 ? R : gs / 2;
  const uint32_t zlo = zmask, zhi = zmask >> 1;
  for (int r0 = 0; r0 < R; r0 += rc) {
    float s[P], b[P];
    if constexpr (VARIANT == kFmaOnly) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float2 sz = meta((p * 2 * R + 2 * r0) / gs);
        s[p] = sz.x * cmul;
        b[p] = ZERO ? sz.y : 0.f;
      }
    }
#pragma unroll 2
    for (int r = r0 + ty; r < r0 + rc; r += kKS) {
      const uint32_t wd = word(r);
      if constexpr (VARIANT == kFmaOnly || VARIANT == kLoadOnly) xr ^= wd;
      if constexpr (VARIANT == kFmaOnly) {
        const float c0 = __uint_as_float((wd & zlo) | kBits129);
        const float c1 = __uint_as_float((wd & zhi) | kBits129);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float w0 = fmaf(c0, s[p], b[p]);
          const float w1 = fmaf(c1, s[p], b[p]);
          const int k = p * 2 * R + 2 * r;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float2 xv =
                *reinterpret_cast<const float2*>(xs + m * sb + k);
            acc[m] = fmaf(xv.x, w0, fmaf(xv.y, w1, acc[m]));
          }
        }
      } else if constexpr (VARIANT == kExtOnly) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          cs += static_cast<float>((wd >> (BITS * p)) & mask);
          cs += static_cast<float>((wd >> (16 + BITS * p)) & mask);
        }
      }
    }
  }
}

// One staged superblock of a stripped GEMV-body variant: superblock_fma's
// plane split (qmm_tile.cuh) over plane_probe, with `meta(g)` the column's
// {scale, -zero*scale}, then (kExtOnly, kLoadOnly) the XOR fold of
// `raw(g)`, the column's staged meta values.
template <int NB, int MT, int VARIANT, class Word, class Meta, class Raw>
__device__ __forceinline__ void probe_step(Word word, Meta meta, Raw raw,
                                           const float* xs, int sb, int gs,
                                           int ty, uint32_t zmask,
                                           float (&acc)[MT], uint32_t& xr,
                                           float& cs) {
  if constexpr (NB == 3) {
    const int R2 = sb / 16;
    plane_probe<2, false, MT, VARIANT>(word, meta, R2, 2.f, xs, sb, gs, ty,
                                       zmask, acc, xr, cs);
    plane_probe<1, true, MT, VARIANT>([&](int r) { return word(R2 + r); },
                                      meta, sb / 32, 1.f, xs, sb, gs, ty,
                                      zmask, acc, xr, cs);
  } else {
    plane_probe<NB, true, MT, VARIANT>(word, meta, sb * NB / 32, 1.f, xs, sb,
                                       gs, ty, zmask, acc, xr, cs);
  }
  if constexpr (VARIANT == kExtOnly || VARIANT == kLoadOnly) {
    if (ty == 0) {
      for (int g = 0; g < sb / gs; ++g) {
        const float2 v = raw(g);
        xr ^= __float_as_uint(v.x) ^ __float_as_uint(v.y);
      }
    }
  }
}

// The stripped variants' column totals: xr and cs of this thread's row
// slice into the column's outputs.
template <int VARIANT>
__device__ __forceinline__ void fold_out(const Probe& pr, int n, int N,
                                         uint32_t xr, float cs) {
  if (n >= N) return;
  if constexpr (VARIANT != kFull) {
    if (xr) atomicXor(pr.xr + n, xr);
  }
  if constexpr (VARIANT == kExtOnly) atomicAdd(pr.cs + n, cs);
}

// BODY kGemv: qmm_gemv_kernel's launch shape, shared memory and staging.
// Block (kBN, kKS); grid (ceil(N/kBN), splits).
template <int NB, int MT, int VARIANT>
__device__ __forceinline__ void gemv_body(GemvArgs a, Probe pr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = a.w.superblock, gs = a.w.group_size, T = sb / gs;
  const int Np = a.w.Np;
  float* xs = reinterpret_cast<float*>(smem);   // [MT][sb]
  float* ss = xs + MT * sb;          // [T][kBN] scale
  float* bs = ss + T * kBN;          // [T][kBN] -zero*scale (kFull, kFmaOnly)
                                     //          or zero (the others)
  float* red = bs + T * kBN;         // [kKS][MT][kBN]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBN + tx;
  const int n = blockIdx.x * kBN + tx;
  const int n_sb = a.Kp / sb;
  const int sb_lo = blockIdx.y * a.sb_per_split;
  const int sb_hi = min(n_sb, sb_lo + a.sb_per_split);
  const int rows_sb = sb * NB / 32;
  constexpr bool kFmaMeta = VARIANT == kFull || VARIANT == kFmaOnly;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  uint32_t xr = 0;
  float cs = 0.f;

  for (int sbi = sb_lo; sbi < sb_hi; ++sbi) {
    __syncthreads();
    for (int i = tid; i < MT * sb; i += kThreads) {
      const int m = i / sb;
      xs[i] = act_at(a.op, m, sbi * sb + (i - m * sb));
    }
    for (int i = tid; i < T * kBN; i += kThreads) {
      const int t = i / kBN;
      const int c = blockIdx.x * kBN + (i - t * kBN);
      float s = 0.f, z = 0.f;
      if (c < Np) {
        const size_t j = static_cast<size_t>(sbi * T + t) * Np + c;
        s = load_f(a.w.scale, j, a.w.meta_bf16);
        z = load_f(a.w.zero, j, a.w.meta_bf16);
      }
      ss[i] = s;
      bs[i] = kFmaMeta ? -z * s : z;
    }
    __syncthreads();
    if (n < a.N) {
      const uint32_t* w =
          a.w.packed + static_cast<size_t>(sbi) * rows_sb * Np + n;
      auto word = [=](int r) { return __ldg(w + static_cast<size_t>(r) * Np); };
      auto meta = [=](int g) {
        return make_float2(ss[g * kBN + tx], bs[g * kBN + tx]);
      };
      if constexpr (VARIANT == kFull) {
        superblock_fma<NB, MT>(word, meta, xs, sb, gs, ty, acc);
      } else {
        probe_step<NB, MT, VARIANT>(word, meta, meta, xs, sb, gs, ty,
                                    pr.zmask, acc, xr, cs);
      }
    }
  }
  if constexpr (kFmaMeta) {
    sum_slices<MT>(acc, red);
    write_cols<MT>(a, acc, n);
  }
  fold_out<VARIANT>(pr, n, a.N, xr, cs);
}

// --- grouped body: stripped consumers on the grouped ring ------------------

// mma_only's round p of a low-width stage: low_round's MMAs, xsum MMA and
// correction (qmm_tile.cuh), with every fragment register code 1 in the
// round's field (128 + 2^o) through the run-time zero mask; no shift.
template <int BITS, int S, int W>
__device__ __forceinline__ void mma_round(const uint32_t (&w)[S][kGTiles][W][4],
                                          int p, const __nv_bfloat16* xr,
                                          const unsigned char* meta,
                                          int meta_es, int lg_share, int c0,
                                          uint32_t zmask,
                                          float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
  const uint32_t code = 0x43004300u | (0x00010001u << low_offset<BITS>(p));
  const int t = (threadIdx.x & 31) & 3;
  float acc[kGTiles][4], xa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[ct][i] = 0.f;
#pragma unroll
  for (int st = 0; st < S; ++st) {
    const uint2 b = *reinterpret_cast<const uint2*>(
        xr + p * F::xstride + 16 * st + 4 * t);
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct) {
      const uint32_t(&v)[4] = w[st][ct][0];
      mma16816_bf16(acc[ct], (v[0] & zmask) | code, (v[1] & zmask) | code,
                    (v[2] & zmask) | code, (v[3] & zmask) | code, b.x, b.y);
    }
    mma16816_bf16(xa, kOnes, kOnes, kOnes, kOnes, b.x, b.y);
  }
  low_correct<BITS>(acc, xa, p, meta, meta_es, lg_share, c0, tot);
}

// ext_only's round p: the fragments low_round extracts, XOR-folded per
// column (registers 0, 2: column 2g; 1, 3: column 2g + 1), then the shift.
template <int BITS, int S, int W>
__device__ __forceinline__ void ext_round(uint32_t (&w)[S][kGTiles][W][4],
                                          int p, uint32_t (&xr)[kGTiles][2]) {
#pragma unroll
  for (int st = 0; st < S; ++st)
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct) {
      uint32_t a[4];
      low_frag<BITS>(w[st][ct], p, a);
      xr[ct][0] ^= a[0] ^ a[2];
      xr[ct][1] ^= a[1] ^ a[3];
    }
  low_shift<BITS>(w, p);
}

// The bits a column's meta value folds with: a float's own, a bf16's as the
// float it widens to.
__device__ __forceinline__ uint32_t meta_bits(const unsigned char* row, int c,
                                              int es) {
  return es == 2
             ? static_cast<uint32_t>(
                   reinterpret_cast<const uint16_t*>(row)[c]) << 16
             : reinterpret_cast<const uint32_t*>(row)[c];
}

// A stripped variant's consumer warps on the grouped ring: the S stages of
// the split from stage st_lo, as grouped_consume walks them (1/2/3/4-bit:
// the attribution's widths), then the outputs: mma_only's y through
// grouped_store, every variant's xr folded across the lanes of a column
// and into the column's output.
template <int BITS, int VARIANT>
__device__ void probe_consume(const GemvArgs& a, const GroupedRing& r,
                              const Probe& pr, int col0, int st_lo, int S) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  constexpr int SS = F::n / 8;                   // 8-row MMA steps
  constexpr int W = BITS == 3 ? 3 : 1;           // word rows per K row pair
  const int sb = a.w.superblock, gs = a.w.group_size, M = a.op.M;
  const bool swiglu = a.op.u != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp * 16 * kGTiles;
  const int c0 = wcol + 2 * g;
  const int spb = grouped_spb<BITS>(sb);
  const int lg_share = __ffs(P / r.slots) - 1;
  const int xrow = min(g, M - 1);
  float tot[kGTiles][4];
  uint32_t xr[kGTiles][2];
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct) {
    xr[ct][0] = xr[ct][1] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[ct][i] = 0.f;
  }
  for (int s = 0; s < S; ++s) {
    mbar_wait(ring_full(s), (s / kGStages) & 1);
    unsigned char* st = ring_stage(r, s);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const unsigned char* meta = st + r.lay.meta_off;
    uint32_t w[SS][kGTiles][W][4];
    low_load<BITS>(ws, wcol, lane, w);
    if constexpr (VARIANT != kExtOnly) {
      // the words as loaded, per column
#pragma unroll
      for (int k = 0; k < SS; ++k)
#pragma unroll
        for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
          for (int pl = 0; pl < W; ++pl) {
            xr[ct][0] ^= w[k][ct][pl][0] ^ w[k][ct][pl][2];
            xr[ct][1] ^= w[k][ct][pl][1] ^ w[k][ct][pl][3];
          }
    }
    if constexpr (VARIANT == kLoadOnly) {
      // each group's meta once: in the stage where its rows begin (every
      // slot of a stage starts its group there or nowhere)
      if (2 * ((st_lo + s) % spb) * F::n % gs == 0) {
        for (int i = t; i < r.slots; i += 4) {
          const unsigned char* ms = meta + 2 * i * kGBN * r.es;
          const unsigned char* mz = ms + kGBN * r.es;
#pragma unroll
          for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + 16 * ct + e;
              xr[ct][e] ^= meta_bits(ms, c, r.es) ^ meta_bits(mz, c, r.es);
            }
        }
      }
    } else if constexpr (VARIANT == kMmaOnly) {
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + r.lay.x_off);
      if (swiglu) {          // grouped_consume's prologue, as is
        const __nv_bfloat16* us =
            reinterpret_cast<const __nv_bfloat16*>(st + r.lay.u_off);
        for (int i = tid; i < M * P * F::part / 2; i += kGWarps * 32) {
          const int row = i / (F::part / 2);
          const int o = row * F::xstride + 2 * (i - row * (F::part / 2));
          uint32_t* xp = reinterpret_cast<uint32_t*>(xs + o);
          *xp = swiglu_pair(*xp, *reinterpret_cast<const uint32_t*>(us + o));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kGWarps * 32) : "memory");
      }
      const __nv_bfloat16* xrw = xs + xrow * P * F::xstride;
      if constexpr (BITS == 4) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          mma_round<BITS>(w, p, xrw, meta, r.es, lg_share, c0, pr.zmask,
                          tot);
      } else {
#pragma unroll 1
        for (int p = 0; p < P; ++p)
          mma_round<BITS>(w, p, xrw, meta, r.es, lg_share, c0, pr.zmask,
                          tot);
      }
    } else {                   // kExtOnly
      if constexpr (BITS == 4) {
#pragma unroll
        for (int p = 0; p < P; ++p) ext_round<BITS>(w, p, xr);
      } else {
#pragma unroll 1
        for (int p = 0; p < P; ++p) ext_round<BITS>(w, p, xr);
      }
    }
    __syncwarp();                  // the warp is done with the slot
    if (lane == 0) mbar_arrive(ring_empty(s));
  }
  if constexpr (VARIANT == kMmaOnly)
    grouped_store(a, tot, col0, gridDim.y == 1 ? -1 : blockIdx.y);
  // a column's words sit in the four lanes of its g
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t v = xr[ct][e];
      v ^= __shfl_xor_sync(0xffffffffu, v, 1);
      v ^= __shfl_xor_sync(0xffffffffu, v, 2);
      const int n = col0 + c0 + 16 * ct + e;
      if (t == 0 && n < a.N && v) atomicXor(pr.xr + n, v);
    }
}

// BODY kGrouped: qmm_grouped_kernel<NB, false>'s grid (ceil(N / kGBN),
// splits), ring, producer and launch bounds; kFull its consumer and store.
template <int NB, int VARIANT>
__device__ __forceinline__ void grouped_body(const GemvArgs& a,
                                             const Probe& pr) {
  const GroupedRing r = grouped_ring<NB>(a, true);
  const int col0 = blockIdx.x * kGBN;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = grouped_stages<NB>(a, st_lo);
  if (threadIdx.x >> 5 == kGWarps) {
    for (int j = 0; j < S; ++j)
      grouped_issue<NB>(a, r, col0, st_lo + j, j, threadIdx.x & 31,
                        kIssueAll);
    return;
  }
  if constexpr (VARIANT == kFull) {
    int count = 0;
    float tot[kGTiles][4];
    grouped_consume<NB, false>(a, r, st_lo, S, count, tot);
    grouped_store(a, tot, col0, gridDim.y == 1 ? -1 : blockIdx.y);
  } else {
    probe_consume<NB, VARIANT>(a, r, pr, col0, st_lo, S);
  }
}

// The kernels: the GEMV body's kFull under production's launch bounds,
// its stripped variants compiled for kFull's blocks per SM; the grouped
// body under the ring's.
template <int NB, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    attrib_gemv_kernel(GemvArgs a, Probe pr) {
  gemv_body<NB, 1, VARIANT>(a, pr);
}

template <int NB, int VARIANT>
__global__ void __launch_bounds__(kThreads, min_blocks(NB))
    attrib_gemv_pinned(GemvArgs a, Probe pr) {
  gemv_body<NB, 1, VARIANT>(a, pr);
}

template <int NB, int VARIANT>
__global__ void __launch_bounds__(kGThreads, 2)
    attrib_grouped_kernel(GemvArgs a, Probe pr) {
  grouped_body<NB, VARIANT>(a, pr);
}

// The kernel of one body and variant (M = 1).
template <int NB, int VARIANT>
auto kernel_of(int body) {
  void (*gemv)(GemvArgs, Probe);
  if constexpr (VARIANT == kFull)
    gemv = attrib_gemv_kernel<NB, VARIANT>;
  else
    gemv = attrib_gemv_pinned<NB, VARIANT>;
  return body == kGrouped ? attrib_grouped_kernel<NB, VARIANT> : gemv;
}

int threads_of(int body) { return body == kGemv ? kThreads : kGThreads; }

// How one variant launches at one layout: its kernel, its dynamic shared
// memory (the body's own, or padded) and the blocks per SM that follow.
struct Plan {
  const void* fn;
  int smem;
  int blocks;
};

template <int NB>
int own_smem(int body, int sb, int gs, int meta_bf16, bool swiglu) {
  if (body == kGemv)   // quant_matmul.cu's launch_gemv, M = 1
    return static_cast<int>(sizeof(float) *
                            (sb + 2 * (sb / gs) * kBN + kKS * kBN));
  return static_cast<int>(grouped_smem<NB>(1, swiglu, meta_bf16, sb, gs));
}

cudaError_t blocks_per_sm(const void* fn, int body, int smem, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                       threads_of(body), smem);
}

// The variant's plan, worked out at its first launch per body and layout:
// kFull's own; a stripped variant that would fit more blocks per SM than
// kFull gets more dynamic shared memory until it fits as many.  The
// grouped body takes the ring's carveout (as launch_grouped does).
template <int NB, int VARIANT>
cudaError_t plan(int body, int sb, int gs, int meta_bf16, bool swiglu,
                 Plan* out) {
  static Plan cached[2];
  static int cached_own[2] = {-1, -1};
  const int own = own_smem<NB>(body, sb, gs, meta_bf16, swiglu);
  if (cached_own[body] == own) {
    *out = cached[body];
    return cudaSuccess;
  }
  const void* fn = reinterpret_cast<const void*>(kernel_of<NB, VARIANT>(body));
  int dev = 0, per_sm = 0, reserved = 0, optin = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess && body == kGrouped)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int smem = own;
  if (e == cudaSuccess) e = blocks_per_sm(fn, body, smem, &blocks);
  if constexpr (VARIANT != kFull) {
    Plan full{};
    if (e == cudaSuccess)
      e = plan<NB, kFull>(body, sb, gs, meta_bf16, swiglu, &full);
    if (e == cudaSuccess && blocks > full.blocks) {
      // too large for one block more than kFull fits
      smem = std::max(own, per_sm / (full.blocks + 1) - reserved + 128);
      e = blocks_per_sm(fn, body, smem, &blocks);
      while (e == cudaSuccess && blocks > full.blocks && smem + 128 <= optin) {
        smem += 128;
        e = blocks_per_sm(fn, body, smem, &blocks);
      }
    }
  }
  if (e != cudaSuccess) return e;
  *out = Plan{fn, smem, blocks};
  cached[body] = *out;
  cached_own[body] = own;
  return cudaSuccess;
}

// M = 1 (the decode probe's case).
template <int NB, int VARIANT>
cudaError_t launch(const GemvArgs& a, const Probe& pr, int body, int splits,
                   cudaStream_t stream) {
  Plan p{};
  cudaError_t e = plan<NB, VARIANT>(body, a.w.superblock, a.w.group_size,
                                    a.w.meta_bf16, a.op.u != nullptr, &p);
  if (e != cudaSuccess) return e;
  const int bn = body == kGemv ? kBN : kGBN;
  const dim3 grid((a.N + bn - 1) / bn, splits);
  const dim3 block = body == kGemv ? dim3(kBN, kKS) : dim3(kGThreads);
  kernel_of<NB, VARIANT>(body)<<<grid, block, p.smem, stream>>>(a, pr);
  return cudaGetLastError();
}

template <int NB, int VARIANT>
struct Tag {
  static constexpr int nb = NB, variant = VARIANT;
};

template <int NB, class F>
cudaError_t visit_variant(int variant, F f) {
  switch (variant) {
    case kFull: return f(Tag<NB, kFull>{});
    case kFmaOnly: return f(Tag<NB, kFmaOnly>{});
    case kExtOnly: return f(Tag<NB, kExtOnly>{});
    default: return f(Tag<NB, kLoadOnly>{});
  }
}

// f(Tag<nbits, variant>) for nbits 2-4 and the four variants.
template <class F>
cudaError_t visit(int nbits, int variant, F f) {
  switch (nbits) {
    case 2: return visit_variant<2>(variant, f);
    case 3: return visit_variant<3>(variant, f);
    default: return visit_variant<4>(variant, f);
  }
}

bool takes(int nbits, int body, int variant) {
  return nbits >= 2 && nbits <= 4 && (body == kGemv || body == kGrouped) &&
         variant >= kFull && variant <= kLoadOnly;
}

}  // namespace

// The arguments of amq_qmm (quant_matmul.cu) for M = 1, plus the stripped
// variants' outputs xr [N] (int32 bits) and cs [N] (f32), which the kernel
// folds into (XOR, add), `body` (0 CUDA-core GEMV, 1 grouped GEMV),
// `variant` (0 full, 1 fma_only / mma_only, 2 ext_only, 3 load_only) and
// `zmask` (pass 0).  For the grouped body, `sb_per_split` counts ring
// stages and the call must be one the grouped ring takes (grouped_takes).
// Returns 0 or the launch's cudaError_t; -1 for arguments the kernels do
// not take.
extern "C" int amq_gemv_attrib(const void* x, const void* u, int x_bf16,
                               const int32_t* packed, const void* scale,
                               const void* zero, int meta_bf16, void* out,
                               int out_bf16, float* partial, int32_t* xr,
                               float* cs, int M, int K, int ldx, int Kp, int N,
                               int Np, int nbits, int group_size,
                               int superblock, int splits, int sb_per_split,
                               int body, int variant, unsigned zmask,
                               void* stream) {
  const bool has_y = variant == kFull || variant == kFmaOnly;
  if (M != 1 || superblock % 64 || superblock % group_size ||
      Kp % superblock || superblock > 1024 || splits < 1 ||
      sb_per_split < 1 || !takes(nbits, body, variant) ||
      (splits > 1 && has_y && partial == nullptr))
    return -1;
  if (body == kGrouped &&
      !grouped_takes(x, u, x_bf16, packed, scale, zero, M, K, ldx, Kp, Np,
                     nbits, group_size, superblock))
    return -1;
  GemvArgs a{Operand{x, u, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  Probe pr{reinterpret_cast<uint32_t*>(xr), cs, zmask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = visit(nbits, variant, [&](auto t) {
    return launch<decltype(t)::nb, decltype(t)::variant>(a, pr, body, splits,
                                                         s);
  });
  if (e != cudaSuccess || splits == 1 || !has_y) return static_cast<int>(e);
  const int MN = M * N;
  reduce_splits_kernel<<<(MN + 255) / 256, 256, 0, s>>>(partial, out, MN,
                                                        splits, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

// How one variant launches at a layout (superblock, group size, meta
// type, SwiGLU prologue): out[0] blocks per SM, out[1] registers per
// thread, out[2] local (spill) bytes per thread, out[3] dynamic shared
// memory bytes.  Returns 0, a cudaError_t, or -1 for arguments the kernels
// do not take.
extern "C" int amq_gemv_attrib_occupancy(int nbits, int body, int variant,
                                         int superblock, int group_size,
                                         int meta_bf16, int swiglu, int* out) {
  if (!takes(nbits, body, variant) || superblock % group_size) return -1;
  return static_cast<int>(visit(nbits, variant, [&](auto t) {
    Plan p{};
    cudaError_t e = plan<decltype(t)::nb, decltype(t)::variant>(
        body, superblock, group_size, meta_bf16, swiglu != 0, &p);
    cudaFuncAttributes fa{};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, p.fn);
    if (e != cudaSuccess) return e;
    out[0] = p.blocks;
    out[1] = fa.numRegs;
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = p.smem;
    return cudaSuccess;
  }));
}
