// The decode-GEMV arithmetic over pair-planar packed weights: the CUDA-core
// per-weight form and the steps of the grouped form on tensor cores.
//
// The CUDA-core form serves quant_matmul.cu's decode GEMV (the calls
// neither grouped form takes; loads go straight from device memory into
// registers) and the attribution probe's
// `gemv` body (gemv_attrib.cu).  Both take their extraction and fma order
// from superblock_fma, their row-slice sum from sum_slices and their
// split-K sum from reduce_splits_kernel, so they give the same bits.  The
// grouped form's steps (grouped_step, grouped_stage_low,
// grouped_stage_pipe; for f32 activations exact_stage, exact_span_stage)
// run in the ring of qmm_grouped.cuh.
//
// A block of kBN columns x kKS row slices (512 threads) accumulates x[M, K]
// @ dequant(W)[K, col0:col0+kBN].
//
// Storage is the JAX package's (see quant_matmul.cu): per superblock of sb
// K-rows, R = sb*b/32 rows of 32-bit words [R, Np]; the code at block row
// k = p*2R + 2r + h sits in word row r at bit 16h + b*p; 3-bit is a 2-bit
// plane followed by a 1-bit plane; w = (c - z) * s per group of gs rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One named namespace and no anonymous one: nvcc names every anonymous
// namespace of a file alike in its host stubs, so a second one (the
// including file's) would make the kernels' stub names ambiguous.
namespace amq {

constexpr int kBN = 64;                // columns per block
constexpr int kKS = 8;                 // row slices per block
constexpr int kThreads = kBN * kKS;

// Activation operand: x [M, K] (row stride ldx), zero past M and K; with
// `u` set, the SwiGLU prologue silu(x) * u.
struct Operand {
  const void* x;
  const void* u;
  int x_bf16;
  int M, K, ldx;
};

// One layer's packed weight: words [Kp*b/32, Np], scale/zero [Kp/gs, Np].
struct Weights {
  const uint32_t* packed;
  const void* scale;
  const void* zero;
  int meta_bf16;
  int Np, group_size, superblock;
};

// One dequant-matmul call: out [M, N], or f32 partials [splits, M, N] when
// K is split over blocks (sb_per_split superblocks each).
struct GemvArgs {
  Operand op;
  Weights w;
  void* out;
  int out_bf16;
  float* partial;
  int N, Kp, sb_per_split;
};

__device__ __forceinline__ float load_f(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// x[m, k] (or silu(x) * u in f32, rounded to the input type, as the plain
// version does); zero past M and past K (the K pad is never read).
__device__ __forceinline__ float act_at(const Operand& a, int m, int k) {
  if (m >= a.M || k >= a.K) return 0.f;
  const size_t i = static_cast<size_t>(m) * a.ldx + k;
  float v = load_f(a.x, i, a.x_bf16);
  if (a.u != nullptr) {
    v = v / (1.f + expf(-v)) * load_f(a.u, i, a.x_bf16);
    if (a.x_bf16) v = round_bf16(v);
  }
  return v;
}

// One pair-planar plane of BITS-wide fields for this thread's column:
// `word(r)` is the plane's word row r, `meta(g)` the column's {scale,
// -zero*scale} of group g.  Within a chunk of rc rows, round p reads only
// group (p*2R + 2*r0) / gs, so its scale and zero sit in registers.
template <int BITS, bool ZERO, int MT, class Word, class Meta>
__device__ __forceinline__ void plane_fma(Word word, Meta meta, int R,
                                          float cmul, const float* xs, int sb,
                                          int gs, int ty, float (&acc)[MT]) {
  constexpr int P = 16 / BITS;
  constexpr uint32_t mask = (1u << BITS) - 1u;
  const int rc = R < gs / 2 ? R : gs / 2;
  for (int r0 = 0; r0 < R; r0 += rc) {
    float s[P], b[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float2 sz = meta((p * 2 * R + 2 * r0) / gs);
      s[p] = sz.x * cmul;
      b[p] = ZERO ? sz.y : 0.f;
    }
#pragma unroll 2
    for (int r = r0 + ty; r < r0 + rc; r += kKS) {
      const uint32_t wd = word(r);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float w0 = fmaf(static_cast<float>((wd >> (BITS * p)) & mask),
                              s[p], b[p]);
        const float w1 = fmaf(
            static_cast<float>((wd >> (16 + BITS * p)) & mask), s[p], b[p]);
        const int k = p * 2 * R + 2 * r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xv = *reinterpret_cast<const float2*>(xs + m * sb + k);
          acc[m] = fmaf(xv.x, w0, fmaf(xv.y, w1, acc[m]));
        }
      }
    }
  }
}

// acc[m] += this thread's row slice of one superblock: xs [MT][sb] (f32
// activations) times the column whose word row r is `word(r)`.
template <int NB, int MT, class Word, class Meta>
__device__ __forceinline__ void superblock_fma(Word word, Meta meta,
                                               const float* xs, int sb, int gs,
                                               int ty, float (&acc)[MT]) {
  if constexpr (NB == 3) {
    // (2*hi + lo - z) * s: the hi plane carries 2*s, the lo plane the zero
    const int R2 = sb / 16;
    plane_fma<2, false, MT>(word, meta, R2, 2.f, xs, sb, gs, ty, acc);
    plane_fma<1, true, MT>([&](int r) { return word(R2 + r); }, meta, sb / 32,
                           1.f, xs, sb, gs, ty, acc);
  } else {
    plane_fma<NB, true, MT>(word, meta, sb * NB / 32, 1.f, xs, sb, gs, ty,
                            acc);
  }
}

// The GEMVs take one group's meta per extraction round of a plane
// (plane_fma, grouped_step): a round of a `field`-bit plane spans
// sb * field / 16 K rows of its superblock, and that span and the group
// must nest.  Power-of-two superblocks and groups always do; the JAX
// layout allows others (a 384-row superblock of 128-row groups), which
// the GEMV entry points refuse.
__host__ __device__ inline bool rounds_nest_groups(int nbits, int sb, int gs) {
  const int hi = nbits == 3 ? 2 : nbits, lo = nbits == 3 ? 1 : nbits;
  const int a = sb * hi / 16, b = sb * lo / 16;
  return (a % gs == 0 || gs % a == 0) && (b % gs == 0 || gs % b == 0);
}

// Sum the kKS row slices: afterwards the threads of slice 0 hold their
// column's totals in acc (`red`: [kKS][MT][kBN] floats of shared memory).
template <int MT>
__device__ __forceinline__ void sum_slices(float (&acc)[MT], float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(ty * MT + m) * kBN + tx] = acc[m];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < kKS; ++s) v += red[(s * MT + m) * kBN + tx];
      acc[m] = v;
    }
  }
  __syncthreads();
}

// After sum_slices: slice 0 writes its column n of the output (rounded
// once), or of split blockIdx.y's partials when K is split.
template <int MT>
__device__ __forceinline__ void write_cols(const GemvArgs& a,
                                           const float (&acc)[MT], int n) {
  if (threadIdx.y != 0 || n >= a.N) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= a.op.M) break;
    if (gridDim.y == 1) {
      store_f(a.out, static_cast<size_t>(m) * a.N + n, acc[m], a.out_bf16);
    } else {
      a.partial[(static_cast<size_t>(blockIdx.y) * a.op.M + m) * a.N + n] =
          acc[m];
    }
  }
}

// out[i] = sum over splits of partial[s, i], rounded once.
__global__ void reduce_splits_kernel(const float* partial, void* out, int MN,
                                     int splits, int out_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[static_cast<size_t>(s) * MN + i];
  store_f(out, i, v, out_bf16);
}

// ---------------------------------------------------------------------------
// The grouped form on tensor cores (the JAX package's _gemv_blockdiag).
//
// Codes become exact bf16 values 128 + c: a packed word's two 16-bit halves
// hold K rows 2r and 2r+1 of one column, so ((w >> s) & F | F << 16) |
// 0x43004300 is one bf16x2 register (128 + field at row 2r, at row 2r+1),
// one shift and one LOP3 per two codes.  A width-b plane (b <= 4) is one
// field per extraction round p (shift b*p); an 8-bit code is two 4-bit
// nibble planes q (shift 8p + 4q) weighted 1 and 16, so 128 * 17 is added
// per code.  Per quantization group g (its rows in round p):
//   y = sum_q 2^(4q) * sum_k x_k (128 + field_q(k))        (f32, mma.sync)
//   tot += s_g * y - xsum * ((z_g + zoff) * s_g)
// where xsum, the f32 sum of the same bf16 x the products read, is one
// more MMA of x against an A of ones.
//
// Operand mapping (mma.sync.m16n8k16, bf16 in, f32 accumulate): weight
// columns are the A side's 16 rows, the <= 8 activation rows are B's n8
// (columns of B past M hold whatever the buffer held, or a copy of row
// M - 1: they only reach output columns that are never written).  A row i
// is tile column 2i (i < 8) or 2(i-8)+1, and A's k-pair j is word row 2j
// (j < 4) or 2(j-4)+1 of an 8-row step, so a lane's four A registers come
// from two 8-byte loads (word rows r0+2t and r0+2t+1, columns 2g and
// 2g+1; g = lane/4, t = lane%4) and its two B registers from one 8-byte
// load of x row g at offset 16*step + 4t.  An accumulator's registers are
// (col 2g, row 2t), (2g, 2t+1), (2g+1, 2t), (2g+1, 2t+1).
//
// Two consumers of one ring.  8-bit (grouped_step, grouped_correct): the
// step loops over the stage's 8-row steps and keeps per tile, round and
// plane an accumulator until the group ends, where it corrects.  2/3/4-bit
// and 1-bit (grouped_stage_low): up to 16 rounds per word, so accumulators
// kept per round would not fit in registers; instead each lane loads its
// share of the stage's words into registers once, runs the rounds as the
// outer loop (one accumulator per tile, live for one round) and corrects
// every round at the end of every stage with the meta of the round's group
// there.  The correction is linear in y and xsum, so correcting a group
// piecewise, stage by stage, computes the same function (the f32 sums in
// another order).  Field extraction folds shifts into masks where the
// value stays exact: a field at bit offset o <= 7 - b of a half-word is
// read in place as 128 + 2^o c (the mantissa's unit is 1 at 128), and the
// correction scales y by 2^-o and the offset to 128 * 2^-o (powers of two:
// exact).  So at 2 bits one shift serves three rounds, at 1 bit seven.
// 3-bit is the 2-bit plane (c >> 1) and the 1-bit plane (c & 1) of the
// layout, recombined at extraction as the reference does: word row r of
// the 1-bit plane (16 rounds q) pairs with 2-bit row r (q even) or r + sb/32
// (q odd) at round q/2, giving the exact bf16 128 + 2 c_hi + c_lo of one
// plane (zoff 128).  A 3-bit stage holds 1-bit rows [r0, r0+n) and 2-bit
// rows [r0, r0+n) and [r0+sb/32, r0+sb/32+n), so every word crosses the
// memory bus once.
//
// The pipelined consumer (grouped_stage_pipe, the JAX package's AMQ_PIPE
// kernel, which extracts tile k into a code slab while the matrix unit
// dots tile k-1) keeps the codes in registers: before it issues the MMAs
// of one (round, step) it has already extracted the A fragments and loaded
// the x fragment of the next one -- across the round's end too, where the
// words first shift to the next round's fields -- so the tensor-core work
// of a step sits under the integer work of the next.  It double-buffers
// one step's fragments (kGTiles x 4 registers beside the stage's words:
// the words of a whole round's fragments twice over would not fit the
// launch bound's registers) and never stores codes to shared memory.  Its
// products, sums and corrections are grouped_stage_low's, in the same
// order, so the two give the same bits.

// The ring's shape can be set at build time (-DAMQ_GTILES=...,
// -DAMQ_GSR=..., -DAMQ_GSTAGES=...) for the ring-shape sweep
// (probes/grouped_ring.py); the defaults are the shipped kernel's.
#ifndef AMQ_GTILES
#define AMQ_GTILES 2
#endif
#ifndef AMQ_GSR
#define AMQ_GSR 32
#endif
#ifndef AMQ_GSTAGES
#define AMQ_GSTAGES 2
#endif
constexpr int kGWarps = 8;             // grouped GEMV: consumer warps
constexpr int kGTiles = AMQ_GTILES;    // 16-column MMA tiles per warp
constexpr int kGBN = kGWarps * 16 * kGTiles;   // columns per block
constexpr int kGSR = AMQ_GSR;          // word rows per ring stage
constexpr int kGStages = AMQ_GSTAGES;
static_assert(kGSR % 8 == 0 && kGStages >= 1, "grouped ring shape");
constexpr int kGWordStride = kGBN + 4; // words per staged row (no conflicts)

template <int BITS>
struct GroupedForm {
  static constexpr int field = BITS < 4 ? BITS : 4;
  static constexpr int planes = BITS / field;     // 1, or 2 for 8-bit
  static constexpr int rounds = BITS == 3 ? 16 : 16 / BITS;   // P
  static constexpr uint32_t pair_mask =
      ((1u << field) - 1u) | (((1u << field) - 1u) << 16);
  static constexpr float zoff = BITS == 8 ? 128.f * 17.f : 128.f;
  // word rows of one round plane per stage (3-bit: of the 1-bit plane,
  // with twice as many 2-bit rows beside them), the stage's word rows, K
  // rows per stage and round, bf16 per staged x row (no bank conflicts)
  static constexpr int n = BITS == 3 && kGSR >= 16 ? kGSR / 2 : kGSR;
  static constexpr int wrows = BITS == 3 ? 3 * n : kGSR;
  static constexpr int part = 2 * n;
  static constexpr int xstride = part + 8;
  // 1/2/4-bit: rounds whose fields one shift brings within bits 0..7-b
  static constexpr int per_shift = BITS < 4 ? (7 - BITS) / BITS + 1 : 1;
};

// Word rows per superblock of the round plane (the 1-bit plane at 3 bits):
// a round spans twice as many K rows.
__host__ __device__ constexpr int grouped_round_rows(int bits, int sb) {
  return bits == 3 ? sb / 32 : sb * bits / 32;
}

// 2/3/4-bit and 1-bit: meta slots per stage, one per group its rounds
// touch (rounds sharing a group share a slot: gs / (2 * round rows) of
// them when a round spans less than a group); 8-bit: one per round.
__host__ __device__ inline int grouped_meta_slots(int bits, int sb, int gs) {
  const int P = bits == 3 ? 16 : 16 / bits;
  if (bits == 8) return P;
  const int span = 2 * grouped_round_rows(bits, sb);
  return span >= gs ? P : P / (gs / span);
}

// Superblocks per ring stage: 1 where a superblock holds whole stages,
// else the n / Rg whole superblocks a spanning stage takes (below 8 bits,
// superblocks of 128 rows and up: qmm_grouped.cuh's spanning kernel).
__host__ __device__ inline int grouped_span(int bits, int sb) {
  const int n = bits == 3 ? GroupedForm<3>::n : GroupedForm<1>::n;
  const int rg = grouped_round_rows(bits, sb);
  return rg < n ? n / rg : 1;
}

// Does a superblock hold whole ring stages?  The layouts of the ring's
// first kernel (qmm_grouped_kernel: the grouped GEMV, its pipelined
// form, the one-launch MLP and the attribution probe).
__host__ __device__ inline bool grouped_whole_stages(int bits, int sb) {
  const int n = bits == 8   ? GroupedForm<8>::n
                : bits == 3 ? GroupedForm<3>::n
                            : GroupedForm<1>::n;
  return grouped_round_rows(bits, sb) % n == 0;
}

// One grouped ring stage, in bytes: the word rows of kGBN columns; two
// meta rows (scale, zero) per slot, f32-wide at 8 bits, else in the meta's
// own type; the activations of the stage's rows, bf16 [rows][P][xstride]
// (8 rows at 8 bits, M below); and, with the SwiGLU prologue, as much
// again for its second operand.
struct GroupedLayout {
  int meta_off, x_off, u_off, stage;
};

// (`exact`, the float32 form: 3M activation rows, the parts, at every
// width, and meta in its own type at 8 bits too.)
template <int BITS>
__host__ __device__ inline GroupedLayout grouped_layout(int M, bool swiglu,
                                                        int meta_es,
                                                        int slots,
                                                        bool exact = false) {
  using F = GroupedForm<BITS>;
  const int words = F::wrows * kGWordStride * 4;
  const int meta = 2 * slots * kGBN * (BITS == 8 && !exact ? 4 : meta_es);
  const int x = (exact ? 3 * M : BITS == 8 ? 8 : M) * F::rounds *
                F::xstride * 2;
  return GroupedLayout{words, words + meta, words + meta + x,
                       words + meta + (swiglu ? 2 : 1) * x};
}

// The accumulators of the group in progress (8-bit): per tile, round and
// plane (`acc`), and per round the activations against ones (`xacc`, the
// group's xsum, shared by the tiles).
template <int BITS>
using GroupedAcc = float[kGTiles][GroupedForm<BITS>::rounds]
                        [GroupedForm<BITS>::planes][4];
template <int BITS>
using GroupedXAcc = float[GroupedForm<BITS>::rounds][4];

__device__ __forceinline__ void mma16816_bf16(float (&c)[4], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int BITS>
__device__ __forceinline__ uint32_t code_pair_bf16(uint32_t w, int shift) {
  return ((w >> shift) & GroupedForm<BITS>::pair_mask) | 0x43004300u;
}

// silu(g) * u in f32 (before its rounding to bf16): the SwiGLU of the
// plain version, shared by the grouped GEMV's prologue and the one-launch
// MLP so that the two give the same bits.
__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// silu(x) * u in f32, rounded to bf16: the SwiGLU prologue of the plain
// version.
__device__ __forceinline__ uint32_t swiglu_pair(uint32_t x, uint32_t u) {
  const float2 xf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  const float2 uf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  __nv_bfloat162 r = __floats2bfloat162_rn(silu_mul(xf.x, uf.x),
                                           silu_mul(xf.y, uf.y));
  return *reinterpret_cast<uint32_t*>(&r);
}

// One warp's products over one 8-bit stage: `ws` the stage's words
// [kGSR][kGWordStride], `xs` its activations [8][P][xstride] (with `us`,
// the SwiGLU operand beside them, silu(x) * u, applied as the B fragment
// is read), the warp's kGTiles tiles of 16 columns from wcol; added to acc
// and xacc.
template <int BITS>
__device__ __forceinline__ void grouped_step(const uint32_t* ws,
                                             const __nv_bfloat16* xs,
                                             const __nv_bfloat16* us,
                                             int wcol, int lane,
                                             GroupedAcc<BITS>& acc,
                                             GroupedXAcc<BITS>& xacc) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int st = 0; st < kGSR / 8; ++st) {
    uint2 w0[kGTiles], w1[kGTiles];
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct) {
      const uint32_t* wr =
          ws + (st * 8 + 2 * t) * kGWordStride + wcol + 16 * ct + 2 * g;
      w0[ct] = *reinterpret_cast<const uint2*>(wr);
      w1[ct] = *reinterpret_cast<const uint2*>(wr + kGWordStride);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int xo = (g * P + p) * F::xstride + 16 * st + 4 * t;
      uint2 b = *reinterpret_cast<const uint2*>(xs + xo);
      if (us != nullptr) {
        const uint2 u = *reinterpret_cast<const uint2*>(us + xo);
        b = make_uint2(swiglu_pair(b.x, u.x), swiglu_pair(b.y, u.y));
      }
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
        for (int q = 0; q < F::planes; ++q) {
          const int sh = BITS * p + F::field * q;
          mma16816_bf16(acc[ct][p][q], code_pair_bf16<BITS>(w0[ct].x, sh),
                        code_pair_bf16<BITS>(w0[ct].y, sh),
                        code_pair_bf16<BITS>(w1[ct].x, sh),
                        code_pair_bf16<BITS>(w1[ct].y, sh), b.x, b.y);
        }
      mma16816_bf16(xacc[p], kOnes, kOnes, kOnes, kOnes, b.x, b.y);
    }
  }
}

// The correction at a group's end (8-bit): `meta` holds per round p the
// scale row (2p) and zero row (2p + 1) of round p's group over the block's
// kGBN columns; tot += s * y - xsum * ((z + zoff) * s) per tile, the
// accumulators cleared.
template <int BITS>
__device__ __forceinline__ void grouped_correct(const unsigned char* meta,
                                                int meta_bf16, int wcol,
                                                int lane,
                                                GroupedAcc<BITS>& acc,
                                                GroupedXAcc<BITS>& xacc,
                                                float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
  for (int p = 0; p < F::rounds; ++p) {
    const int c0 = wcol + 16 * ct + 2 * (lane >> 2);
    float s[2], z[2];
    const unsigned char* ms = meta + 2 * p * kGBN * 4;
    const unsigned char* mz = ms + kGBN * 4;
    if (meta_bf16) {
      const __nv_bfloat162 sv =
          reinterpret_cast<const __nv_bfloat162*>(ms)[c0 / 2];
      const __nv_bfloat162 zv =
          reinterpret_cast<const __nv_bfloat162*>(mz)[c0 / 2];
      s[0] = __low2float(sv); s[1] = __high2float(sv);
      z[0] = __low2float(zv); z[1] = __high2float(zv);
    } else {
      const float2 sv = reinterpret_cast<const float2*>(ms)[c0 / 2];
      const float2 zv = reinterpret_cast<const float2*>(mz)[c0 / 2];
      s[0] = sv.x; s[1] = sv.y;
      z[0] = zv.x; z[1] = zv.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = i >> 1;
      const float xsum = xacc[p][i & 1];
      float y = acc[ct][p][0][i];
#pragma unroll
      for (int q = 1; q < F::planes; ++q)
        y = static_cast<float>(1 << (F::field * q)) * acc[ct][p][q][i] + y;
      const float corr = (z[c] + F::zoff) * s[c];
      tot[ct][i] += s[c] * y - xsum * corr;
    }
#pragma unroll
    for (int q = 0; q < F::planes; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ct][p][q][i] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < F::rounds; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) xacc[p][i] = 0.f;
}

// Round p's A register from word registers that low_shift has shifted to
// the round's fields: 1/2/4-bit, the field at offset o of each half-word
// (`mask` = the pair mask << o), read in place as exact bf16 128 + 2^o c;
// 3-bit, the 2-bit word wh's field at bits 0..1 and the 1-bit word wl's at
// bit 0, combined as 128 + 2 c_hi + c_lo.
template <int BITS>
__device__ __forceinline__ uint32_t low_pair(uint32_t w, uint32_t wl,
                                             uint32_t mask) {
  if constexpr (BITS == 3)
    return ((w << 1) & 0x00060006u) | (wl & 0x00010001u) | 0x43004300u;
  else
    return (w & mask) | 0x43004300u;
}

// Round p's field offset o in a half-word (1/2/4-bit: the shifts folded
// into masks; 3-bit: 0).
template <int BITS>
__device__ __forceinline__ int low_offset(int p) {
  return BITS == 3 ? 0 : p % GroupedForm<BITS>::per_shift * BITS;
}

// One tile's four A registers of round p at one step, from its words `v`
// (3-bit: the 2-bit rows of p's parity beside the 1-bit rows).
template <int BITS, int W>
__device__ __forceinline__ void low_frag(const uint32_t (&v)[W][4], int p,
                                         uint32_t (&a)[4]) {
  const uint32_t mask = GroupedForm<BITS>::pair_mask << low_offset<BITS>(p);
  const bool odd = p & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = low_pair<BITS>(BITS == 3 && odd ? v[W > 1][i] : v[0][i],
                          v[W - 1][i], mask);
}

// After round p, the words shift in place to round p + 1's fields
// (1/2/4-bit: once per per_shift rounds; 3-bit: the 1-bit words every
// round, the 2-bit words every second), so that no shifted copy is live
// beside them.
template <int BITS, int S, int W>
__device__ __forceinline__ void low_shift(uint32_t (&w)[S][kGTiles][W][4],
                                          int p) {
  using F = GroupedForm<BITS>;
  const bool odd = p & 1;
  const bool shift = BITS == 3 || (p + 1) % F::per_shift == 0;
#pragma unroll
  for (int st = 0; st < S; ++st)
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (BITS == 3) {
          w[st][ct][W - 1][i] >>= 1;
          if (odd) {
            w[st][ct][0][i] >>= 2;
            w[st][ct][W > 1][i] >>= 2;
          }
        } else if (shift) {
          w[st][ct][0][i] >>= F::per_shift * BITS;
        }
      }
}

// The correction of products `acc` and x sums `xa` of fields weighing
// 1 / inv with the meta slot at `ms` (scale row, then zero row), into tot
// (EXACT: fields read without the code offset, the float32 form below).
template <int BITS, bool EXACT = false>
__device__ __forceinline__ void low_correct_at(
    const float (&acc)[kGTiles][4], const float (&xa)[4], float inv,
    const unsigned char* ms, int meta_es, int c0, float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr float zoff = EXACT ? 0.f : F::zoff;
  const unsigned char* mz = ms + kGBN * meta_es;
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct) {
    const int c = c0 + 16 * ct;
    float s[2], z[2];
    if (meta_es == 2) {
      const __nv_bfloat162 sv =
          reinterpret_cast<const __nv_bfloat162*>(ms)[c / 2];
      const __nv_bfloat162 zv =
          reinterpret_cast<const __nv_bfloat162*>(mz)[c / 2];
      s[0] = __low2float(sv); s[1] = __high2float(sv);
      z[0] = __low2float(zv); z[1] = __high2float(zv);
    } else {
      const float2 sv = reinterpret_cast<const float2*>(ms)[c / 2];
      const float2 zv = reinterpret_cast<const float2*>(mz)[c / 2];
      s[0] = sv.x; s[1] = sv.y;
      z[0] = zv.x; z[1] = zv.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cc = i >> 1;
      const float corr = (z[cc] + zoff * inv) * s[cc];
      tot[ct][i] = fmaf(-xa[i & 1], corr, fmaf(s[cc] * inv, acc[ct][i],
                                                tot[ct][i]));
    }
  }
}

// The correction of round p's products `acc` and x sums `xa` with slot
// (p >> lg_share)'s meta, into tot (the field at offset o weighs 2^o).
template <int BITS, bool EXACT = false>
__device__ __forceinline__ void low_correct(const float (&acc)[kGTiles][4],
                                            const float (&xa)[4], int p,
                                            const unsigned char* meta,
                                            int meta_es, int lg_share, int c0,
                                            float (&tot)[kGTiles][4]) {
  low_correct_at<BITS, EXACT>(acc, xa,
                       __int_as_float((127 - low_offset<BITS>(p)) << 23),
                       meta + 2 * (p >> lg_share) * kGBN * meta_es, meta_es,
                       c0, tot);
}

// One round p of a low-width stage: products of the warp's tiles (words in
// registers) with x round p over the stage's steps, the xsum MMA beside
// them; then the words shift to the next round's fields and the round is
// corrected.
template <int BITS, int S, int W>
__device__ __forceinline__ void low_round(uint32_t (&w)[S][kGTiles][W][4],
                                          int p, const __nv_bfloat16* xr,
                                          const unsigned char* meta,
                                          int meta_es, int lg_share, int c0,
                                          float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
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
      uint32_t a[4];
      low_frag<BITS>(w[st][ct], p, a);
      mma16816_bf16(acc[ct], a[0], a[1], a[2], a[3], b.x, b.y);
    }
    mma16816_bf16(xa, kOnes, kOnes, kOnes, kOnes, b.x, b.y);
  }
  low_shift<BITS>(w, p);
  low_correct<BITS>(acc, xa, p, meta, meta_es, lg_share, c0, tot);
}

// The stage's words of this lane in registers: per 8-row step, tile and
// plane row (3-bit: two 2-bit rows and a 1-bit row) the four A words.
template <int BITS, int S, int W>
__device__ __forceinline__ void low_load(const uint32_t* ws, int wcol,
                                         int lane,
                                         uint32_t (&w)[S][kGTiles][W][4]) {
  using F = GroupedForm<BITS>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int st = 0; st < S; ++st)
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int pl = 0; pl < W; ++pl) {
        const uint32_t* wr = ws + (pl * F::n + st * 8 + 2 * t) * kGWordStride +
                             wcol + 16 * ct + 2 * g;
        const uint2 a = *reinterpret_cast<const uint2*>(wr);
        const uint2 b = *reinterpret_cast<const uint2*>(wr + kGWordStride);
        w[st][ct][pl][0] = a.x; w[st][ct][pl][1] = a.y;
        w[st][ct][pl][2] = b.x; w[st][ct][pl][3] = b.y;
      }
}

// One warp's share of a 1/2/3/4-bit stage: `ws` the stage's words
// [wrows][kGWordStride], `xr` x row g's rounds [P][xstride] (silu(x) * u
// already, under SwiGLU), `meta` the stage's slots (scale row 2i, zero row
// 2i + 1, kGBN values each of meta_es bytes); the warp's kGTiles tiles of
// 16 columns from wcol, corrected into tot.
template <int BITS>
__device__ __forceinline__ void grouped_stage_low(const uint32_t* ws,
                                                  const __nv_bfloat16* xr,
                                                  const unsigned char* meta,
                                                  int meta_es, int lg_share,
                                                  int wcol, int lane,
                                                  float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 8;                    // 8-row MMA steps
  constexpr int W = BITS == 3 ? 3 : 1;           // word rows per K row pair
  uint32_t w[S][kGTiles][W][4];
  low_load<BITS>(ws, wcol, lane, w);
  const int c0 = wcol + 2 * (lane >> 2);
  // 4-bit: four rounds, unrolled; below, rounds in a loop (unrolled, the
  // compiler interleaved rounds past the register budget and spilled)
  if constexpr (BITS == 4) {
#pragma unroll
    for (int p = 0; p < F::rounds; ++p)
      low_round<BITS>(w, p, xr, meta, meta_es, lg_share, c0, tot);
  } else {
#pragma unroll 1
    for (int p = 0; p < F::rounds; ++p)
      low_round<BITS>(w, p, xr, meta, meta_es, lg_share, c0, tot);
  }
}

// grouped_stage_low with the extraction one step ahead of the MMAs (the
// pipelined consumer; see the top of this section).  Rounds run in a loop
// at every width, so that the double buffer stays within the registers.
template <int BITS>
__device__ __forceinline__ void grouped_stage_pipe(const uint32_t* ws,
                                                   const __nv_bfloat16* xr,
                                                   const unsigned char* meta,
                                                   int meta_es, int lg_share,
                                                   int wcol, int lane,
                                                   float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 8;
  constexpr int W = BITS == 3 ? 3 : 1;
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
  const int t = lane & 3;
  uint32_t w[S][kGTiles][W][4];
  low_load<BITS>(ws, wcol, lane, w);
  const int c0 = wcol + 2 * (lane >> 2);
  // the fragments of (round 0, step 0)
  uint32_t cur[kGTiles][4];
#pragma unroll
  for (int ct = 0; ct < kGTiles; ++ct) low_frag<BITS>(w[0][ct], 0, cur[ct]);
  uint2 b = *reinterpret_cast<const uint2*>(xr + 4 * t);
#pragma unroll 1
  for (int p = 0; p < F::rounds; ++p) {
    float acc[kGTiles][4], xa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ct][i] = 0.f;
#pragma unroll
    for (int st = 0; st < S; ++st) {
      // the next (round, step)'s fragments first: step st + 1 of round p,
      // or, after the last step, step 0 of round p + 1 (past the last
      // round these are extracted and never used)
      uint32_t nxt[kGTiles][4];
      uint2 bn;
      if (st + 1 < S) {
#pragma unroll
        for (int ct = 0; ct < kGTiles; ++ct)
          low_frag<BITS>(w[st + 1][ct], p, nxt[ct]);
        bn = *reinterpret_cast<const uint2*>(xr + p * F::xstride +
                                             16 * (st + 1) + 4 * t);
      } else {
        low_shift<BITS>(w, p);
#pragma unroll
        for (int ct = 0; ct < kGTiles; ++ct)
          low_frag<BITS>(w[0][ct], p + 1, nxt[ct]);
        bn = *reinterpret_cast<const uint2*>(
            xr + (p + 1 < F::rounds ? p + 1 : p) * F::xstride + 4 * t);
      }
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
        mma16816_bf16(acc[ct], cur[ct][0], cur[ct][1], cur[ct][2], cur[ct][3],
                      b.x, b.y);
      mma16816_bf16(xa, kOnes, kOnes, kOnes, kOnes, b.x, b.y);
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[ct][i] = nxt[ct][i];
      b = bn;
    }
    low_correct<BITS>(acc, xa, p, meta, meta_es, lg_share, c0, tot);
  }
}

// Spanning stages (qmm_grouped.cuh's spanning kernel) come in three
// forms by a superblock's round-plane word rows Rg: SPS = Rg / 8 whole
// 8-row MMA steps (1 or 2), or SPS = 0 for 4-row superblocks (1 and 3
// bits at 128 rows), whose steps take two rounds.  The form fixes the
// superblock, sb = P * 16 * SPS K rows (128 for SPS = 0), so every offset
// below is a constant.
template <int BITS, int SPS>
__host__ __device__ constexpr int span_superblock() {
  return SPS == 0 ? 128 : GroupedForm<BITS>::rounds * 16 * SPS;
}

// One warp's share of a spanning 1/2/3/4-bit stage of SPS-step
// superblocks: grouped_stage_low's rounds, but each round corrected per
// superblock j with its own slots (meta + j * sb_meta), and x row g
// holding each superblock's sb activations in turn (superblock j's round
// p at j * sb + p * 2 Rg).  Without FULL (the tail of K) superblocks past
// `parts` are skipped: their words and meta were never copied.
template <int BITS, int SPS, bool FULL>
__device__ __forceinline__ void span_stage_low(
    const uint32_t* ws, const __nv_bfloat16* xr, const unsigned char* meta,
    int meta_es, int lg_share, int sb_meta, int parts, int wcol, int lane,
    float (&tot)[kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 8;
  constexpr int W = BITS == 3 ? 3 : 1;
  constexpr int sb = span_superblock<BITS, SPS>();
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
  static_assert(SPS == 1 || SPS == 2, "8-row steps per superblock");
  const int t = lane & 3;
  uint32_t w[S][kGTiles][W][4];
  low_load<BITS>(ws, wcol, lane, w);
  const int c0 = wcol + 2 * (lane >> 2);
#pragma unroll 1
  for (int p = 0; p < F::rounds; ++p) {
    const __nv_bfloat16* xp = xr + p * 16 * SPS + 4 * t;
    float acc[kGTiles][4], xa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ct][i] = 0.f;
#pragma unroll
    for (int st = 0; st < S; ++st) {
      const int j = st / SPS, sj = st % SPS;
      if (!FULL && j >= parts) break;
      const uint2 b =
          *reinterpret_cast<const uint2*>(xp + j * sb + 16 * sj);
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct) {
        uint32_t a[4];
        low_frag<BITS>(w[st][ct], p, a);
        mma16816_bf16(acc[ct], a[0], a[1], a[2], a[3], b.x, b.y);
      }
      mma16816_bf16(xa, kOnes, kOnes, kOnes, kOnes, b.x, b.y);
      if (sj == SPS - 1) {                       // superblock j's last step
        low_correct<BITS>(acc, xa, p, meta + j * sb_meta, meta_es, lg_share,
                          c0, tot);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xa[i] = 0.f;
#pragma unroll
          for (int ct = 0; ct < kGTiles; ++ct) acc[ct][i] = 0.f;
        }
      }
    }
    low_shift<BITS>(w, p);
  }
}

// One warp's share of a spanning stage of 4-row superblocks (SPS = 0: 1
// and 3 bits at 128 rows, where an 8-row MMA step would straddle two
// superblocks' groups).  A step is one superblock and two rounds: the A
// fragment's k-pairs t take word row t at round 2q, its k-pairs t + 4 the
// same row at round 2q + 1, against x rows 16q + 2t and 16q + 8 + 2t (the
// two rounds' K rows: adjacent, in one group), so a lane holds one word
// row per column and each superblock's round pair is corrected once.
// Fields are read at bit 0 (2 shifts a pair; 3-bit: the even round's
// 2-bit row t, the odd one's row Rg + t, beside 1-bit row t).  FULL as in
// span_stage_low.
template <int BITS, bool FULL>
__device__ __forceinline__ void span_stage_pair(
    const uint32_t* ws, const __nv_bfloat16* xr, const unsigned char* meta,
    int meta_es, int lg_share, int sb_meta, int parts, int wcol, int lane,
    float (&tot)[kGTiles][4]) {
  static_assert(BITS == 1 || BITS == 3, "4-row superblocks: 1 and 3 bits");
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 4;                    // superblocks per stage
  constexpr int W = BITS == 3 ? 3 : 1;
  constexpr int sb = span_superblock<BITS, 0>();
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
  const int g = lane >> 2, t = lane & 3;
  uint32_t w[S][kGTiles][W][2];
#pragma unroll
  for (int st = 0; st < S; ++st)
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int pl = 0; pl < W; ++pl) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            ws + (pl * F::n + 4 * st + t) * kGWordStride + wcol + 16 * ct +
            2 * g);
        w[st][ct][pl][0] = v.x;
        w[st][ct][pl][1] = v.y;
      }
  const int c0 = wcol + 2 * g;
#pragma unroll 1
  for (int q = 0; q < F::rounds / 2; ++q) {
    const unsigned char* slot = meta + 2 * ((2 * q) >> lg_share) * kGBN *
                                           meta_es;
    const __nv_bfloat16* xq = xr + 16 * q + 2 * t;
#pragma unroll
    for (int st = 0; st < S; ++st) {
      if (!FULL && st >= parts) break;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xq + st * sb);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(xq + st * sb + 8);
      float acc[kGTiles][4], xa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {           // columns 2g, 2g + 1
          const uint32_t* v = w[st][ct][0];
          if constexpr (BITS == 3) {
            a[h] = low_pair<3>(v[h], w[st][ct][2][h], 0u);
            a[2 + h] = low_pair<3>(w[st][ct][1][h], w[st][ct][2][h] >> 1, 0u);
          } else {
            a[h] = (v[h] & F::pair_mask) | 0x43004300u;
            a[2 + h] = ((v[h] >> 1) & F::pair_mask) | 0x43004300u;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[ct][i] = 0.f;
        mma16816_bf16(acc[ct], a[0], a[1], a[2], a[3], b0, b1);
      }
      mma16816_bf16(xa, kOnes, kOnes, kOnes, kOnes, b0, b1);
      low_correct_at<BITS>(acc, xa, 1.f, slot + st * sb_meta, meta_es, c0,
                           tot);
    }
#pragma unroll
    for (int st = 0; st < S; ++st)
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
        for (int pl = 0; pl < W; ++pl) {
          w[st][ct][pl][0] >>= 2;
          w[st][ct][pl][1] >>= 2;
        }
  }
}

// ---------------------------------------------------------------------------
// The float32 form on tensor cores: float32 activations, the JAX package's
// f32 function (_dequant_tile in f32, then an f32 dot), on the grouped
// ring (quant_matmul_f32.cu's kernels).
//
// Codes are small integers and exact in bf16; only x needs more bits than
// bf16 has.  A pass before the ring (quant_matmul_f32.cu's split kernel)
// splits each f32 activation once into three bf16 parts, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference exact in
// f32; together they hold x's 24 bits), rows 3m + q of a bf16 operand that
// the ring stages as it stages bf16 x.  The products take exact codes: a
// field read in place as 128 + 2^o c, minus 128 in bf16 (exact; 8 bits:
// the nibbles as 128 + lo and 2048 + 16 hi, minus their offsets, both into
// one accumulator), so no 128 * xsum term sits in the f32 sums to cancel
// (summed in f32 it would cost about 7 of x's bits).  Per round and stage,
// as grouped_stage_low corrects,
//   tot += s 2^-o y - (z s) xsum
// with y = sum c part and xsum = sum part (the ones MMA) per B column.  The
// B side holds the parts as columns: column c = 3m + q of J n8 groups (J =
// 1 up to M = 2, 3 up to M = 8), each column with its own accumulator and
// correction, so row m's bits do not depend on M; the store sums row m's
// three columns in part order.  Splits, ring and stage plan are the bf16
// GEMV's, the 4-row superblocks' round pairs too (exact_span_pair_stage).

constexpr uint32_t kBias128 = 0x43004300u;     // bf16 (128, 128)
constexpr uint32_t kBias2048 = 0x45004500u;    // bf16 (2048, 2048)

// a - b per bf16 half (exact for the small integers here)
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A fragments of exact codes per round step (8 bits: 16 hi and lo).
template <int BITS>
__host__ __device__ constexpr int exact_frags() {
  return BITS == 8 ? 2 : 1;
}

// One tile's exact-code A registers of round p at one step, from its words
// `v` shifted to the round (low_shift): low_frag's 128 + 2^o c minus 128;
// at 8 bits the round's byte as lo nibble and 16 x hi nibble.
template <int BITS, int W>
__device__ __forceinline__ void exact_frag(const uint32_t (&v)[W][4], int p,
                                           uint32_t (&a)[exact_frags<BITS>()][4]) {
  if constexpr (BITS == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[0][i] = bf2_sub((v[0][i] & 0x000F000Fu) | kBias128, kBias128);
      a[1][i] = bf2_sub(((v[0][i] >> 4) & 0x000F000Fu) | kBias2048, kBias2048);
    }
  } else {
    low_frag<BITS>(v, p, a[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[0][i] = bf2_sub(a[0][i], kBias128);
  }
}

// Per column group j the ring row this lane's B column reads: column 8 j +
// lane / 4 is row 3m + q; columns past the 3M rows read the last one
// (their sums reach no output).
template <int J>
__device__ __forceinline__ void exact_rows(const __nv_bfloat16* xs, int rows,
                                           int row_elems, int lane,
                                           const __nv_bfloat16* (&xr)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
    xr[j] = xs + min(8 * j + (lane >> 2), rows - 1) * row_elems;
}

// The products of one step: the tile's exact codes against each column
// group's B fragment `b`, and the ones MMA per group.
template <int BITS, int J>
__device__ __forceinline__ void exact_step(
    const uint32_t (&a)[kGTiles][exact_frags<BITS>()][4], const uint2 (&b)[J],
    float (&acc)[J][kGTiles][4], float (&xa)[J][4]) {
  constexpr uint32_t kOnes = 0x3F803F80u;        // bf16 (1, 1)
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int f = 0; f < exact_frags<BITS>(); ++f)
        mma16816_bf16(acc[j][ct], a[ct][f][0], a[ct][f][1], a[ct][f][2],
                      a[ct][f][3], b[j].x, b[j].y);
    mma16816_bf16(xa[j], kOnes, kOnes, kOnes, kOnes, b[j].x, b[j].y);
  }
}

template <int J>
__device__ __forceinline__ void exact_clear(float (&acc)[J][kGTiles][4],
                                            float (&xa)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xa[j][i] = 0.f;
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct) acc[j][ct][i] = 0.f;
    }
}

// One round p of a stage in the float32 form (low_round's shape).
template <int BITS, int S, int W, int J>
__device__ __forceinline__ void exact_round(
    uint32_t (&w)[S][kGTiles][W][4], int p, const __nv_bfloat16* const (&xr)[J],
    const unsigned char* meta, int meta_es, int lg_share, int c0,
    float (&tot)[J][kGTiles][4]) {
  using F = GroupedForm<BITS>;
  const int t = (threadIdx.x & 31) & 3;
  float acc[J][kGTiles][4], xa[J][4];
  exact_clear<J>(acc, xa);
#pragma unroll
  for (int st = 0; st < S; ++st) {
    uint2 b[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      b[j] = *reinterpret_cast<const uint2*>(xr[j] + p * F::xstride + 16 * st +
                                             4 * t);
    uint32_t a[kGTiles][exact_frags<BITS>()][4];
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct) exact_frag<BITS>(w[st][ct], p, a[ct]);
    exact_step<BITS, J>(a, b, acc, xa);
  }
  low_shift<BITS>(w, p);
#pragma unroll
  for (int j = 0; j < J; ++j)
    low_correct<BITS, true>(acc[j], xa[j], p, meta, meta_es, lg_share, c0,
                            tot[j]);
}

// One warp's share of a whole ring stage in the float32 form (every width:
// grouped_stage_low's words, rounds and per-round corrections; 8 bits takes
// its P = 2 rounds' meta from every stage): `xs` the stage's activation rows
// [rows = 3M][P][xstride].
template <int BITS, int J>
__device__ __forceinline__ void exact_stage(const uint32_t* ws,
                                            const __nv_bfloat16* xs, int rows,
                                            const unsigned char* meta,
                                            int meta_es, int lg_share,
                                            int wcol, int lane,
                                            float (&tot)[J][kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 8;
  constexpr int W = BITS == 3 ? 3 : 1;
  uint32_t w[S][kGTiles][W][4];
  low_load<BITS>(ws, wcol, lane, w);
  const int c0 = wcol + 2 * (lane >> 2);
  const __nv_bfloat16* xr[J];
  exact_rows<J>(xs, rows, F::rounds * F::xstride, lane, xr);
  if constexpr (BITS == 4 || BITS == 8) {
#pragma unroll
    for (int p = 0; p < F::rounds; ++p)
      exact_round<BITS>(w, p, xr, meta, meta_es, lg_share, c0, tot);
  } else {
#pragma unroll 1
    for (int p = 0; p < F::rounds; ++p)
      exact_round<BITS>(w, p, xr, meta, meta_es, lg_share, c0, tot);
  }
}

// One warp's share of a spanning stage of SPS-step superblocks in the
// float32 form (span_stage_low's order: each round corrected per
// superblock with its own slots; FULL as there).
template <int BITS, int SPS, int J, bool FULL>
__device__ __forceinline__ void exact_span_stage(
    const uint32_t* ws, const __nv_bfloat16* xs, int rows,
    const unsigned char* meta, int meta_es, int lg_share, int sb_meta,
    int parts, int wcol, int lane, float (&tot)[J][kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 8;
  constexpr int W = BITS == 3 ? 3 : 1;
  constexpr int sb = span_superblock<BITS, SPS>();
  static_assert(SPS == 1 || SPS == 2, "8-row steps per superblock");
  const int t = lane & 3;
  uint32_t w[S][kGTiles][W][4];
  low_load<BITS>(ws, wcol, lane, w);
  const int c0 = wcol + 2 * (lane >> 2);
  const __nv_bfloat16* xr[J];
  exact_rows<J>(xs, rows, F::rounds * F::xstride, lane, xr);
#pragma unroll 1
  for (int p = 0; p < F::rounds; ++p) {
    float acc[J][kGTiles][4], xa[J][4];
    exact_clear<J>(acc, xa);
#pragma unroll
    for (int st = 0; st < S; ++st) {
      const int j = st / SPS, sj = st % SPS;
      if (!FULL && j >= parts) break;
      uint2 b[J];
#pragma unroll
      for (int g = 0; g < J; ++g)
        b[g] = *reinterpret_cast<const uint2*>(xr[g] + p * 16 * SPS + 4 * t +
                                               j * sb + 16 * sj);
      uint32_t a[kGTiles][exact_frags<BITS>()][4];
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
        exact_frag<BITS>(w[st][ct], p, a[ct]);
      exact_step<BITS, J>(a, b, acc, xa);
      if (sj == SPS - 1) {                       // superblock j's last step
#pragma unroll
        for (int g = 0; g < J; ++g)
          low_correct<BITS, true>(acc[g], xa[g], p, meta + j * sb_meta,
                                  meta_es, lg_share, c0, tot[g]);
        exact_clear<J>(acc, xa);
      }
    }
    low_shift<BITS>(w, p);
  }
}

// One warp's share of a spanning stage of 4-row superblocks in the float32
// form (span_stage_pair's order: a step is one superblock's round pair,
// corrected at once with its slot; the exact codes 128 + c minus 128
// against each column group's parts; FULL as there).  Its own copy of
// span_stage_pair's word loads and code fields: built from shared helpers,
// the J = 1 form spilled at the ring's launch bound (3 bits, 96 registers).
template <int BITS, int J, bool FULL>
__device__ __forceinline__ void exact_span_pair_stage(
    const uint32_t* ws, const __nv_bfloat16* xs, int rows,
    const unsigned char* meta, int meta_es, int lg_share, int sb_meta,
    int parts, int wcol, int lane, float (&tot)[J][kGTiles][4]) {
  static_assert(BITS == 1 || BITS == 3, "4-row superblocks: 1 and 3 bits");
  using F = GroupedForm<BITS>;
  constexpr int S = F::n / 4;                    // superblocks per stage
  constexpr int W = BITS == 3 ? 3 : 1;
  constexpr int sb = span_superblock<BITS, 0>();
  const int g = lane >> 2, t = lane & 3;
  uint32_t w[S][kGTiles][W][2];
#pragma unroll
  for (int st = 0; st < S; ++st)
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int pl = 0; pl < W; ++pl) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            ws + (pl * F::n + 4 * st + t) * kGWordStride + wcol + 16 * ct +
            2 * g);
        w[st][ct][pl][0] = v.x;
        w[st][ct][pl][1] = v.y;
      }
  const int c0 = wcol + 2 * g;
  const __nv_bfloat16* xr[J];
  exact_rows<J>(xs, rows, F::rounds * F::xstride, lane, xr);
#pragma unroll 1
  for (int q = 0; q < F::rounds / 2; ++q) {
    const unsigned char* slot = meta + 2 * ((2 * q) >> lg_share) * kGBN *
                                           meta_es;
#pragma unroll
    for (int st = 0; st < S; ++st) {
      if (!FULL && st >= parts) break;
      uint2 b[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const __nv_bfloat16* xq = xr[j] + st * sb + 16 * q + 2 * t;
        b[j] = make_uint2(*reinterpret_cast<const uint32_t*>(xq),
                          *reinterpret_cast<const uint32_t*>(xq + 8));
      }
      uint32_t a[kGTiles][exact_frags<BITS>()][4];
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
        for (int h = 0; h < 2; ++h) {           // columns 2g, 2g + 1
          const uint32_t* v = w[st][ct][0];
          uint32_t lo, hi;
          if constexpr (BITS == 3) {
            lo = low_pair<3>(v[h], w[st][ct][2][h], 0u);
            hi = low_pair<3>(w[st][ct][1][h], w[st][ct][2][h] >> 1, 0u);
          } else {
            lo = (v[h] & F::pair_mask) | kBias128;
            hi = ((v[h] >> 1) & F::pair_mask) | kBias128;
          }
          a[ct][0][h] = bf2_sub(lo, kBias128);
          a[ct][0][2 + h] = bf2_sub(hi, kBias128);
        }
      float acc[J][kGTiles][4], xa[J][4];
      exact_clear<J>(acc, xa);
      exact_step<BITS, J>(a, b, acc, xa);
#pragma unroll
      for (int j = 0; j < J; ++j)
        low_correct_at<BITS, true>(acc[j], xa[j], 1.f, slot + st * sb_meta,
                                   meta_es, c0, tot[j]);
    }
#pragma unroll
    for (int st = 0; st < S; ++st)
#pragma unroll
      for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
        for (int pl = 0; pl < W; ++pl) {
          w[st][ct][pl][0] >>= 2;
          w[st][ct][pl][1] >>= 2;
        }
  }
}

// Bulk copies (TMA without a tensor map) into shared memory, completing
// on an mbarrier, and the barrier's operations.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(static_cast<unsigned>(
          __cvta_generic_to_shared(dst))),
      "l"(src), "r"(bytes),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar)))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar))),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// The barrier's phase waits for `bytes` more of bulk copies; with `arrive`
// this thread also arrives (the phase then completes once the bytes are
// in), without it the phase still waits for the arrival.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase of the given parity to complete; a phase
// that never completes (a byte count that cannot be met) traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) asm volatile("trap;");
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace amq
