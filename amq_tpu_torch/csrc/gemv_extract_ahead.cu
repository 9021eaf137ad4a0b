// Extract-ahead decode GEMV on warpgroup MMA (wgmma), M = 1.
//
// Replaces the Pallas kernel of scripts/pipelined_gemv.py (`_pipe_kernel`,
// launched by the `pl.pallas_call`s of its `build_pipe` and
// `check_parity`).  That kernel computes the decode GEMV in the grouped
// form of the JAX package's _gemv_blockdiag (ops/quant_matmul.py):
//
//   yp[g, n] = sum_{k in group g} x_k * (128 + c[k, n])        (the dot)
//   y[n]     = sum_g s[g, n] * yp[g, n]
//              - s[g, n] * (z[g, n] + 128) * xsum_g             (_correct)
//
// with xsum_g the f32 sum of the bf16 x the dot consumes, and it extracts
// superblock k+1's codes into a VMEM code slab (`cbuf`) while the matrix
// unit dots slab k against the block-diagonal x (`xd`, [T groups, 1024]).
//
// Here a block owns kXBN = 256 columns and a run of K (its split), with
// three roles in 288 threads:
//
// * a producer warp streams, by bulk copies (cp.async.bulk) completing on
//   mbarriers, each superblock's x and scale / zero rows into a superblock
//   ring and each code stage's packed word rows into a word ring;
// * the extractor warpgroup (warps 0-3) turns a word stage into the bf16
//   codes 128 + c of kXK = 64 K rows x 256 columns -- (w >> s) & mask |
//   0x4300_4300, one 32-bit register per two K rows of a column; 3-bit
//   recombined from its 2-bit and 1-bit planes at extraction -- and writes
//   them into a code ring slot in wgmma's canonical K-major layout with
//   the 128-byte swizzle (row n = column n, 128 bytes = the stage's 64 K
//   values, 16-byte chunk c at chunk c ^ (n % 8)), so that its 16-byte
//   stores (eight lanes on eight rows of one chunk) touch all 32 banks.
//   Beside the codes it writes the stage's block-diagonal x as the B
//   operand ([8 groups x 64 K], the same layout: K row k's x in group
//   g(k)'s row, zeros elsewhere) and the stage's per-group x sums; then
//   fence.proxy.async and an arrival on the slot's full barrier.  This is
//   the TPU kernel's cbuf and xd;
// * the consumer warpgroup (warps 4-7) runs the dot as
//   wgmma.mma_async m64n8k16 (f32 accumulate): A the 64-column code tile
//   x 16 K rows, read from the code ring through a shared-memory
//   descriptor, B the stage's block-diagonal x [16 K x 8 groups].  The
//   64 x 8 accumulator (4 registers a thread per 64-column tile) then holds
//   yp[g, n] for the superblock.  It keeps one wgmma group in flight
//   (commit, wait_group 1) and releases a code slot only after the wgmma
//   that read it completed; at each superblock's end (or its split's) it
//   applies _correct from the superblock ring's meta, summing xsum over the
//   stages it consumed.
//
// A code stage's 64 K rows are eight 8-row chunks, each from four
// consecutive word rows (two at 3 bits) of one extraction round and hence
// of one group: 4-bit (4 rounds): chunk c = round c/2, word rows 8j + 4(c%2)
// .. +4 of stage j; 2-bit (8 rounds): chunk c = round c, rows 4j .. 4j+4;
// 3-bit (16 rounds): chunk c = rounds 2c and 2c+1 (one group), 1-bit rows
// 2j, 2j+1 with their 2-bit rows.  The K order inside a stage is free (a
// wgmma sums over it), so B follows the codes.
//
// Bound on the H100: bytes (every packed word and scale/zero value read
// once per call; the tensor cores do 8 x the useful multiply-adds, far
// below their rate).  The code slab costs shared-memory bandwidth the
// register route does not pay: each code is written and read back as 16
// bits, 4 (4-bit) to 8 (2-bit) times the bytes of its word.  K is split
// across blocks at code-stage granularity as far as one wave of blocks
// fills the card (the grouped GEMV's rule); the f32 partials are summed in
// a fixed order by reduce_splits_kernel, so two calls give the same bits.

#include "qmm_tile.cuh"
#include "wgmma.cuh"

using namespace amq;

namespace {

constexpr int kSB = 1024;            // superblock rows
constexpr int kG = 8;                // groups of 128 rows per superblock
constexpr int kXBN = 256;            // columns per block
constexpr int kTiles = kXBN / 64;    // wgmma m64 tiles per block
constexpr int kXK = 64;              // K rows per code stage
constexpr int kSPB = kSB / kXK;      // code stages per superblock
constexpr int kXThreads = 288;       // 4 extractor + 4 consumer + 1 producer warps
constexpr int kCodeSlots = 2, kWordSlots = 2, kSbSlots = 2;

// A code slot: [kTiles][64 rows][128 B] codes, the B slab [8][128 B],
// the stage's x sums [8] f32; 1024-byte aligned (the 128-byte swizzle's
// atoms).
constexpr int kCodeBytes = kTiles * 64 * 128;
constexpr int kBOff = kCodeBytes;
constexpr int kXsumOff = kBOff + 1024;
constexpr int kCodeSlot = kXsumOff + 1024;
// A superblock slot: x [1024] bf16, scale [8][256], zero [8][256] bf16.
constexpr int kScaleOff = kSB * 2;
constexpr int kZeroOff = kScaleOff + kG * kXBN * 2;
constexpr int kSbSlot = kZeroOff + kG * kXBN * 2;
constexpr int kWordRow = kXBN * 4;    // bytes of one staged word row

// word rows of one code stage (3-bit: two 1-bit rows and four 2-bit rows)
__host__ __device__ constexpr int stage_rows(int nb) {
  return nb == 4 ? 8 : nb == 2 ? 4 : 6;
}

__host__ __device__ constexpr int smem_bytes(int nb) {
  return 1024 /* barriers, then alignment */ + kCodeSlots * kCodeSlot +
         kWordSlots * stage_rows(nb) * kWordRow + kSbSlots * kSbSlot +
         1024 /* base alignment */;
}

// The barriers, at the start of the aligned shared memory: full and
// empty per slot of the code, word and superblock rings.
struct Bars {
  uint64_t* p;
  __device__ uint64_t* code_full(int j) const { return p + j % kCodeSlots; }
  __device__ uint64_t* code_empty(int j) const {
    return p + kCodeSlots + j % kCodeSlots;
  }
  __device__ uint64_t* word_full(int j) const {
    return p + 2 * kCodeSlots + j % kWordSlots;
  }
  __device__ uint64_t* word_empty(int j) const {
    return p + 2 * kCodeSlots + kWordSlots + j % kWordSlots;
  }
  __device__ uint64_t* sb_full(int s) const {
    return p + 2 * (kCodeSlots + kWordSlots) + s % kSbSlots;
  }
  __device__ uint64_t* sb_empty(int s) const {
    return p + 2 * (kCodeSlots + kWordSlots) + kSbSlots + s % kSbSlots;
  }
};

// The block's shared memory, laid out from a 1024-byte aligned base.
template <int NB>
struct Smem {
  unsigned char* base;
  __device__ unsigned char* code(int j) const {
    return base + 1024 + (j % kCodeSlots) * kCodeSlot;
  }
  __device__ unsigned char* words(int j) const {
    return base + 1024 + kCodeSlots * kCodeSlot +
           (j % kWordSlots) * stage_rows(NB) * kWordRow;
  }
  __device__ unsigned char* sb(int s) const {
    return base + 1024 + kCodeSlots * kCodeSlot +
           kWordSlots * stage_rows(NB) * kWordRow + (s % kSbSlots) * kSbSlot;
  }
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d[64 x 8] += A[64 x 16] B[16 x 8], both K-major in shared memory
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// Byte offset of K chunk c (8 values) of row r in a 128-byte swizzled
// panel.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Stage j's word rows: source row (in the superblock's R rows) of staged
// row i.
template <int NB>
__device__ __forceinline__ int src_row(int js, int i) {
  if constexpr (NB == 4) return 8 * js + i;
  if constexpr (NB == 2) return 4 * js + i;
  // 3-bit: 2-bit rows 2js, 2js+1 (even rounds), 32+2js, +1 (odd rounds),
  // then 1-bit rows 2js, 2js+1 of the plane after the 2-bit plane's 64
  return (i >> 1) * 32 + 2 * js + (i & 1);
}

// The K rows of chunk c of stage js (within the superblock): four from
// ka, four from kb.
template <int NB>
__device__ __forceinline__ void chunk_rows(int js, int c, int& ka, int& kb) {
  if constexpr (NB == 4) {
    ka = (c >> 1) * 256 + 16 * js + 8 * (c & 1);
    kb = ka + 4;
  } else if constexpr (NB == 2) {
    ka = c * 128 + 8 * js;
    kb = ka + 4;
  } else {
    ka = 2 * c * 64 + 4 * js;
    kb = ka + 64;
  }
}

__device__ __forceinline__ uint32_t code4(uint32_t w, int p) {
  return ((w >> (4 * p)) & 0x000F000Fu) | 0x43004300u;
}
__device__ __forceinline__ uint32_t code2(uint32_t w, int p) {
  return ((w >> (2 * p)) & 0x00030003u) | 0x43004300u;
}
// 3-bit round q: 2 * (2-bit field q/2 of `hi`) + (1-bit field q of `lo`)
__device__ __forceinline__ uint32_t code3(uint32_t hi, uint32_t lo, int q) {
  return (((hi >> (2 * (q >> 1))) << 1) & 0x00060006u) |
         ((lo >> q) & 0x00010001u) | 0x43004300u;
}

// Extractor thread et (0..127): its columns' codes of one word stage into
// code slot `cs`.  Lanes take consecutive columns, so word loads are
// consecutive words and each 16-byte store instruction covers rows n..n+7
// of one chunk (eight distinct 16-byte bank groups per phase).
template <int NB>
__device__ __forceinline__ void extract(const unsigned char* wsm,
                                        unsigned char* cs, int et) {
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(wsm);
  auto store = [&](int n, int c, uint32_t a, uint32_t b, uint32_t d,
                   uint32_t e) {
    *reinterpret_cast<uint4*>(cs + (n >> 6) * (64 * 128) + swz(n & 63, c)) =
        make_uint4(a, b, d, e);
  };
  if constexpr (NB == 4) {
#pragma unroll
    for (int q = 0; q < 2 * kXBN / 128; ++q) {   // (column, half) units
      const int u = et + 128 * q, n = u % kXBN, half = u / kXBN;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ws[(4 * half + i) * kXBN + n];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        store(n, 2 * p + half, code4(w[0], p), code4(w[1], p), code4(w[2], p),
              code4(w[3], p));
    }
  } else if constexpr (NB == 2) {
#pragma unroll
    for (int q = 0; q < kXBN / 128; ++q) {
      const int n = et + 128 * q;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ws[i * kXBN + n];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        store(n, p, code2(w[0], p), code2(w[1], p), code2(w[2], p),
              code2(w[3], p));
    }
  } else {
#pragma unroll
    for (int q = 0; q < kXBN / 128; ++q) {
      const int n = et + 128 * q;
      uint32_t w[6];   // 2-bit even-round rows, odd-round rows, 1-bit rows
#pragma unroll
      for (int i = 0; i < 6; ++i) w[i] = ws[i * kXBN + n];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store(n, c, code3(w[0], w[4], 2 * c), code3(w[1], w[5], 2 * c),
              code3(w[2], w[4], 2 * c + 1), code3(w[3], w[5], 2 * c + 1));
    }
  }
}

// Extractor threads 0..63: the stage's B slab (row g, chunk c: the chunk's
// eight x values if the chunk lies in group g, else zeros) and its x sums
// per group.
template <int NB>
__device__ __forceinline__ void build_b(const __nv_bfloat16* xs,
                                        unsigned char* cs, int js, int et) {
  const int g = et >> 3, c = et & 7;
  int ka, kb;
  chunk_rows<NB>(js, c, ka, kb);
  uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
  float sum = 0.f;
  if (g == ka / 128) {
    lo = *reinterpret_cast<const uint2*>(xs + ka);
    hi = *reinterpret_cast<const uint2*>(xs + kb);
    const uint32_t v[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v[i]));
      sum += f.x + f.y;
    }
  }
  *reinterpret_cast<uint4*>(cs + kBOff + swz(g, c)) =
      make_uint4(lo.x, lo.y, hi.x, hi.y);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (c == 0) reinterpret_cast<float*>(cs + kXsumOff)[g] = sum;
}

// Grid (ceil(N / kXBN), splits), 288 threads.  x [K] bf16; packed
// [Kp*NB/32, Np]; scale, zero [Kp/128, Np] bf16; split y of `per` code
// stages into partial [splits, N] (f32), or, unsplit, out [N] bf16.
template <int NB>
__global__ void __launch_bounds__(kXThreads, 2)
    extract_ahead_kernel(const __nv_bfloat16* __restrict__ x,
                         const uint32_t* __restrict__ packed,
                         const __nv_bfloat16* __restrict__ scale,
                         const __nv_bfloat16* __restrict__ zero,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ partial, int K, int Kp, int N,
                         int Np, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<NB> sm{smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023)};
  const Bars bars{reinterpret_cast<uint64_t*>(sm.base)};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kXBN;
  const int cols = min(kXBN, Np - col0);           // a multiple of 8
  const int st_lo = blockIdx.y * per;
  const int st_hi = min(Kp / kSB * kSPB, st_lo + per);
  if (tid == 0) {
    for (int i = 0; i < kCodeSlots; ++i) {
      mbar_init(bars.code_full(i), 4);
      mbar_init(bars.code_empty(i), 4);
    }
    for (int i = 0; i < kWordSlots; ++i) {
      mbar_init(bars.word_full(i), 1);
      mbar_init(bars.word_empty(i), 4);
    }
    for (int i = 0; i < kSbSlots; ++i) {
      mbar_init(bars.sb_full(i), 1);
      mbar_init(bars.sb_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: per segment (the split's stages in one superblock) its
    // superblock slot, then its word stages
    constexpr int R = kSB * NB / 32;
    int j = 0;
    for (int seg = 0, st = st_lo; st < st_hi; ++seg) {
      const int sbi = st / kSPB, end = min(st_hi, (sbi + 1) * kSPB);
      unsigned char* sbs = sm.sb(seg);
      if (seg >= kSbSlots)
        mbar_wait(bars.sb_empty(seg), (seg / kSbSlots - 1) & 1);
      const int xlen = max(0, min(kSB, K - sbi * kSB));   // a multiple of 8
      __nv_bfloat16* xd = reinterpret_cast<__nv_bfloat16*>(sbs);
      for (int i = xlen + lane; i < kSB; i += 32) xd[i] = __float2bfloat16(0.f);
      // these generic writes come before the copies' (async proxy) writes
      fence_proxy_async();
      __syncwarp();
      if (lane == 0)
        mbar_arrive_expect_tx(bars.sb_full(seg), xlen * 2 + 2 * kG * cols * 2);
      __syncwarp();
      if (lane == 0 && xlen > 0)
        bulk_g2s(xd, x + static_cast<size_t>(sbi) * kSB, xlen * 2,
                 bars.sb_full(seg));
      if (lane >= 1 && lane <= 2 * kG) {
        const int i = lane - 1, which = i / kG, g = i % kG;
        bulk_g2s(sbs + (which ? kZeroOff : kScaleOff) + g * kXBN * 2,
                 (which ? zero : scale) +
                     static_cast<size_t>(sbi * kG + g) * Np + col0,
                 cols * 2, bars.sb_full(seg));
      }
      for (; st < end; ++st, ++j) {
        if (j >= kWordSlots)
          mbar_wait(bars.word_empty(j), (j / kWordSlots - 1) & 1);
        if (lane == 0)
          mbar_arrive_expect_tx(bars.word_full(j),
                                stage_rows(NB) * cols * 4);
        __syncwarp();
        if (lane < stage_rows(NB))
          bulk_g2s(sm.words(j) + lane * kWordRow,
                   packed + (static_cast<size_t>(sbi) * R +
                             src_row<NB>(st % kSPB, lane)) * Np + col0,
                   cols * 4, bars.word_full(j));
      }
    }
    return;
  }

  if (warp < 4) {
    // extractors
    int j = 0;
    for (int seg = 0, st = st_lo; st < st_hi; ++seg) {
      const int sbi = st / kSPB, end = min(st_hi, (sbi + 1) * kSPB);
      mbar_wait(bars.sb_full(seg), (seg / kSbSlots) & 1);
      const __nv_bfloat16* xs =
          reinterpret_cast<const __nv_bfloat16*>(sm.sb(seg));
      for (; st < end; ++st, ++j) {
        mbar_wait(bars.word_full(j), (j / kWordSlots) & 1);
        if (j >= kCodeSlots)
          mbar_wait(bars.code_empty(j), (j / kCodeSlots - 1) & 1);
        unsigned char* cs = sm.code(j);
        extract<NB>(sm.words(j), cs, tid);
        if (tid < 64) build_b<NB>(xs, cs, st % kSPB, tid);
        // the generic writes of the slot come before wgmma's reads
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bars.word_empty(j));
          mbar_arrive(bars.code_full(j));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.sb_empty(seg));
    }
    return;
  }

  // consumer warpgroup: warp w4 holds rows 16 w4 + lane/4 (+8) of each
  // 64-column tile, groups 2t and 2t + 1 (t = lane % 4) of the accumulator
  const int w4 = warp - 4, t = lane & 3;
  float d[kTiles][4], tot[kTiles][2];
#pragma unroll
  for (int u = 0; u < kTiles; ++u) tot[u][0] = tot[u][1] = 0.f;
  int j = 0;
  for (int seg = 0, st = st_lo; st < st_hi; ++seg) {
    const int sbi = st / kSPB, end = min(st_hi, (sbi + 1) * kSPB);
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[u][i] = 0.f;
    float xs0 = 0.f, xs1 = 0.f;
    for (const int first = st; st < end; ++st, ++j) {
      mbar_wait(bars.code_full(j), (j / kCodeSlots) & 1);
      __syncwarp();                  // converged for the aligned wgmma
      const unsigned char* cs = sm.code(j);
      const uint32_t ca = saddr(cs);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kXK / 16; ++kk) {
        const uint64_t db = smem_desc(ca + kBOff + kk * 32, 16, 1024);
#pragma unroll
        for (int u = 0; u < kTiles; ++u)
          wgmma_n8(d[u], smem_desc(ca + u * (64 * 128) + kk * 32, 16, 1024),
                   db);
      }
      wgmma_commit();
      const float* xsum = reinterpret_cast<const float*>(cs + kXsumOff);
      xs0 += xsum[2 * t];
      xs1 += xsum[2 * t + 1];
      wgmma_wait<1>();               // stage j - 1's products are done
      fence_regs(d);
      if (st > first) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars.code_empty(j - 1));
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.code_empty(j - 1));
    // _correct with the superblock's meta
    mbar_wait(bars.sb_full(seg), (seg / kSbSlots) & 1);
    const __nv_bfloat16* sc =
        reinterpret_cast<const __nv_bfloat16*>(sm.sb(seg) + kScaleOff);
    const __nv_bfloat16* zc =
        reinterpret_cast<const __nv_bfloat16*>(sm.sb(seg) + kZeroOff);
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = u * 64 + 16 * w4 + (lane >> 2) + 8 * h;
        const float s0 = __bfloat162float(sc[(2 * t) * kXBN + n]);
        const float z0 = __bfloat162float(zc[(2 * t) * kXBN + n]);
        const float s1 = __bfloat162float(sc[(2 * t + 1) * kXBN + n]);
        const float z1 = __bfloat162float(zc[(2 * t + 1) * kXBN + n]);
        float v = tot[u][h];
        v = fmaf(s0, d[u][2 * h], v);
        v = fmaf(-s0 * (z0 + 128.f), xs0, v);
        v = fmaf(s1, d[u][2 * h + 1], v);
        v = fmaf(-s1 * (z1 + 128.f), xs1, v);
        tot[u][h] = v;
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.sb_empty(seg));
  }
  // a column's groups sit in the four lanes of its row
#pragma unroll
  for (int u = 0; u < kTiles; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = tot[u][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int n = col0 + u * 64 + 16 * w4 + (lane >> 2) + 8 * h;
      if (t != 0 || n >= N) continue;
      if (gridDim.y == 1)
        out[n] = __float2bfloat16(v);
      else
        partial[static_cast<size_t>(blockIdx.y) * N + n] = v;
    }
}

template <int NB>
cudaError_t allow() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      extract_ahead_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(NB));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(extract_ahead_kernel<NB>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

template <int NB>
cudaError_t launch(const __nv_bfloat16* x, const uint32_t* packed,
                   const __nv_bfloat16* scale, const __nv_bfloat16* zero,
                   __nv_bfloat16* out, float* partial, int K, int Kp, int N,
                   int Np, int splits, int per, cudaStream_t stream) {
  cudaError_t e = allow<NB>();
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kXBN - 1) / kXBN, splits);
  extract_ahead_kernel<NB><<<grid, kXThreads, smem_bytes(NB), stream>>>(
      x, packed, scale, zero, out, partial, K, Kp, N, Np, per);
  return cudaGetLastError();
}

template <int NB>
int blocks_per_sm() {
  int blocks = 0;
  cudaError_t e = allow<NB>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, extract_ahead_kernel<NB>, kXThreads, smem_bytes(NB));
  return e == cudaSuccess ? blocks : -1;
}

}  // namespace

// x [1, K] bf16 (K a multiple of 8); packed int32 [Kp*nbits/32, Np]; scale
// / zero bf16 [Kp/128, Np]; out [1, N] bf16; with splits > 1, partial f32
// [splits, N].  Superblock 1024, group 128, nbits 2-4, Np a multiple of 8,
// 16-byte aligned operands; `per` code stages (kXK = 64 K rows, 16 per
// superblock) per split, splits covering them all.  Returns 0 or the
// launch's cudaError_t; -1 for arguments the kernel does not take.
extern "C" int amq_gemv_extract_ahead(const void* x, const int32_t* packed,
                                      const void* scale, const void* zero,
                                      void* out, float* partial, int K,
                                      int Kp, int N, int Np, int nbits,
                                      int group_size, int superblock,
                                      int splits, int per, void* stream) {
  const int n_st = Kp / kSB * kSPB;
  if (superblock != kSB || group_size != kSB / kG || Kp % kSB || K > Kp ||
      K % 8 || N > Np || Np % 8 || !aligned16(x) || !aligned16(packed) ||
      !aligned16(scale) || !aligned16(zero) || splits < 1 || per < 1 ||
      static_cast<long long>(splits) * per < n_st ||
      (splits - 1) * per >= n_st || (splits > 1 && partial == nullptr))
    return -1;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = reinterpret_cast<const uint32_t*>(packed);
  const auto* s = static_cast<const __nv_bfloat16*>(scale);
  const auto* z = static_cast<const __nv_bfloat16*>(zero);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nbits) {
    case 2: e = launch<2>(xb, w, s, z, o, partial, K, Kp, N, Np, splits, per, st); break;
    case 3: e = launch<3>(xb, w, s, z, o, partial, K, Kp, N, Np, splits, per, st); break;
    case 4: e = launch<4>(xb, w, s, z, o, partial, K, Kp, N, Np, splits, per, st); break;
    default: return -1;
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  reduce_splits_kernel<<<(N + 255) / 256, 256, 0, st>>>(partial, out, N,
                                                        splits, 1);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel one SM holds at this width (the split rule's wave),
// or -1 on an error or a width it has no kernel for.
extern "C" int amq_gemv_extract_ahead_blocks(int nbits) {
  switch (nbits) {
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
    default: return -1;
  }
}
