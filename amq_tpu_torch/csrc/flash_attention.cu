// Blockwise (flash) causal attention for prefill and evaluation.
//
// Replaces the Pallas kernel of the JAX package's
// ops/flash_attention.py::flash_attention (_flash_kernel).  Layout:
// q/out [B, Hq, S, d], k/v [B, Hkv, T, d], f32 or bf16, d 64 or 128.  GQA
// reads KV head h / (Hq / Hkv) in place, never widened to Hq.  Query row i
// sits at absolute position offset + i, where offset is read from a device
// tensor inside the kernel (no host sync, so the launch can be captured in
// a CUDA graph), and attends keys k <= offset + i with k < T (keys at or
// beyond T are masked here, which equals the JAX wrapper's zero pad: call
// sites guarantee offset + S <= T).  The key-tile loop stops at the last
// tile any row of the query tile can see, so fully masked tiles cost
// nothing, and the element mask runs only on tiles that cross the diagonal
// or T.  Query tiles are scheduled heaviest first (the causal work grows
// with the tile index).
//
// Numerics follow the Pallas kernel: f32 scores, masked scores -1e30, an
// online softmax with f32 running max / denominator / accumulator, p
// rounded to the input dtype before the PV product while the denominator
// sums the unrounded p, l == 0 -> 1, output in q's dtype.
//
// Bound on the H100: operations.  Causal attention does 4 d flops per
// (query, visible key) pair against q + o + K/V bytes read once per query
// tile; at S = 2048, d = 128 that is hundreds of flops per byte, far above
// the card's ridge, so the products have to run on the tensor cores.
//
// bf16 (evaluation, prefill): warpgroup MMA (wgmma, sm_90a).  A block of
// two warpgroups owns 128 query rows, 64 each (wgmma's M).  Q is staged
// once; 64-key K and V tiles stream through a two-stage shared-memory
// ring filled by 16-byte cp.async copies, so tile j + 1 loads while tile j
// is multiplied.  Every tile is stored as 128-byte-wide column panels in
// the 128-byte swizzle the wgmma descriptors read.  S = Q K^T takes both
// operands from shared memory (a key-major K tile is already the K-major B
// operand); the online softmax runs on the f32 accumulator in registers
// (row max and sum by quad shuffles, scores scaled by scale * log2(e) and
// exponentiated base 2); P is converted to bf16 in registers, where the
// accumulator's layout is the A-fragment layout of the PV product, and
// O += P V takes V from shared memory as an MN-major (transposed) B
// operand.  One __syncthreads per key tile; nothing goes through shared
// memory between the two products.
//
// f32 (PTQ calibration, float32 evaluation): split TF32 on the tensor
// cores (3xTF32, mma.sync m16n8k8).  One TF32 product keeps 11 significant
// bits and misses the JAX suite's 2e-4 by about 5x at S = T = 2048, d 128;
// so every operand x of both products is split as hi = tf32_rna(x), lo =
// tf32_rna(x - hi) (x - hi is exact in f32), and each product is taken as
// lo * hi + hi * lo + hi * hi into the f32 accumulator, the small terms
// first.  The dropped lo * lo is 2^-22 of the product: about 1e-6
// absolute at that shape (tests/test_torch_flash_tf32.py emulates it).
// The tensor cores do three products where CUDA cores would do one, and
// still have 495 / 3 TFLOP/s against 67.
//   Budget (d 128; d 64 halves every row-length array):
//   - a block is eight warps of 16 query rows (128 rows, the bf16 block's),
//     one block an SM, no spill (REGS in chip_smoke.py);
//   - shared memory: Q (72 KB as f32, rows d + 16 floats apart) and a
//     two-stage cp.async ring of 64-key K and V tiles as f32 (141 KB),
//     215 KB in all.  Q stays f32 and is split again at each key tile:
//     its hi and lo held in registers would take 128 a thread (even Q as
//     f32 in registers, 64, spilled), stored split they would not fit
//     beside the ring;
//   - a warp's O accumulator (16 x d) is 64 registers, its score tile (16
//     x 64 keys) 32; the fragments of one k-step are split as they are
//     read;
//   - K and V are split where they are read from shared memory, by the
//     warp that multiplies them: storing hi and lo would double the ring
//     and the shared-memory reads, 72 KB a warp per tile already.
//   Fragments are read with 16-byte shared loads, free of bank conflicts:
//   - S = Q K^T permutes d inside each 16-wide slice (any order of the
//     summed index does), so a thread's float4 of a K row (or its Q row)
//     holds its B (A) fragments of two k-steps; Q and K rows are d + 16
//     floats apart, so the two rows of a quarter warp land on the two
//     halves of the banks;
//   - O += P V takes P from the score accumulator in registers: in an
//     8-key step the A fragment's column t holds key 2t and column t + 4
//     key 2t + 1, which is where the accumulator already has them, and V's
//     B fragments (rows 2t and 2t + 1) are read in its stored [keys, d]
//     layout, no transpose; output column g of n-tile 4 q + i is d 32 q +
//     4 g + i, so a thread's float4 of a V row serves four n-tiles.  V rows
//     are d + 4 floats apart (rows 2t of a quarter warp 8 banks apart).
//   The split is most of the instructions: about 0.8 elements an HMMA at
//   six instructions each.  Diagonal-tile skipping, the heaviest-first
//   order and the element mask follow the bf16 kernel; a warp also skips
//   the tiles past its own last row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

using namespace amq;

namespace {

constexpr int kThreads = 256;  // eight warps, two warpgroups
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA

constexpr int kWgBQ = 128;     // queries per block: two warpgroups of 64
constexpr int kWgBK = 64;      // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int wg_q_bytes() { return kWgBQ * D * 2; }
template <int D>
__host__ __device__ constexpr int wg_kv_bytes() { return kWgBK * D * 2; }   // one K or V tile
template <int D>
__host__ __device__ constexpr int wg_smem_bytes() {
  // Q, two stages of K and V, and slack to align the base to 1024 bytes
  return wg_q_bytes<D>() + 4 * wg_kv_bytes<D>() + 1024;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 zero-fills the 16 bytes (rows past S or T)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : AMQ_F16(d, 0), AMQ_F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (four bf16x2 per
// thread), B MN-major (transposed) in shared memory
template <int N>
struct WgmmaRsT;

template <>
struct WgmmaRsT<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : AMQ_F16(d, 0), AMQ_F16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRsT<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : AMQ_F16(d, 0), AMQ_F16(d, 16), AMQ_F16(d, 32), AMQ_F16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef AMQ_F16
#undef AMQ_F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + N_ROWS) of a [*, D] bf16 matrix into panel layout at
// dst; rows at or past `limit` are zero-filled
template <int D, int N_ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int limit, int tid) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  static_assert(N_ROWS * kChunks % kThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < N_ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + tid;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* g =
        src + static_cast<size_t>(ok ? row0 + r : 0) * D + c * 8;
    cp_async16(dst + (c / 8) * (N_ROWS * 128) + r * 128 +
                   (((c % 8) ^ (r & 7)) << 4),
               g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel_wgmma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ offset_ptr,
    __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int S, int T_len,
    int causal, float scale_log2) {
  extern __shared__ float4 smem4[];   // declared alike in every kernel
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem4)) + 1023) &
      ~1023u;
  const uint32_t sKV = sQ + wg_q_bytes<D>();   // stage s: K, then V
  constexpr int kKV = wg_kv_bytes<D>();

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest query tile first
  const int bh = blockIdx.y;                   // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;                    // warpgroup: rows 64 wg ..
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int offset = causal ? offset_ptr[0] : 0;
  const int q0 = iq * kWgBQ;
  const int wq0 = q0 + 64 * wg;                // the warpgroup's first row
  // this thread's rows (accumulator layout): r_lo and r_lo + 8
  const int r_lo = wq0 + 16 * warp + lane / 4;

  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * S * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * T_len * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * T_len * D;

  int n_tiles = (T_len + kWgBK - 1) / kWgBK;
  if (causal) {
    const int q_hi = offset + min(q0 + kWgBQ, S) - 1;   // highest position
    n_tiles = max(0, min(n_tiles, q_hi / kWgBK + 1));
  }

  load_tile<D, kWgBQ>(sQ, qb, q0, S, tid);
  if (n_tiles > 0) {
    load_tile<D, kWgBK>(sKV, kb, 0, T_len, tid);
    load_tile<D, kWgBK>(sKV + kKV, vb, 0, T_len, tid);
  }
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t sK = sKV + (j & 1) * 2 * kKV, sV = sK + kKV;
    cp_async_wait_all();          // tile j (and Q) landed for this thread
    fence_proxy_async();
    __syncthreads();              // ... for every thread; tile j - 1 consumed
    if (j + 1 < n_tiles) {        // refill the other stage meanwhile
      const uint32_t nK = sKV + ((j + 1) & 1) * 2 * kKV;
      load_tile<D, kWgBK>(nK, kb, (j + 1) * kWgBK, T_len, tid);
      load_tile<D, kWgBK>(nK + kKV, vb, (j + 1) * kWgBK, T_len, tid);
    }
    cp_async_commit();

    // S = Q K^T: 64 rows x 64 keys per warpgroup, d / 16 steps
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qa =
          sQ + (kk / 4) * (kWgBQ * 128) + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t ka = sK + (kk / 4) * (kWgBK * 128) + (kk % 4) * 32;
      wgmma_ss_n64(s, smem_desc(qa, 16, 1024), smem_desc(ka, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale, mask (tiles across the diagonal or T only), online softmax.
    // s[4c + e]: row r_lo + 8 (e / 2), key k0 + 8 c + 2 (lane % 4) + e % 2
    const int k0 = j * kWgBK;
    const bool edge = k0 + kWgBK > T_len ||
                      (causal && k0 + kWgBK - 1 > offset + wq0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int c = 0; c < kWgBK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * c + e] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * c + 2 * (lane % 4) + (e & 1);
          const int qp = offset + r_lo + 8 * (e >> 1);
          if (kp >= T_len || (causal && kp > qp)) x = kNeg;
        }
        s[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= corr[i];
    }
    // P in bf16 as the PV product's A fragments: 16-key step kk holds
    // (row r_lo, keys 2t..), (r_lo + 8, 2t..), (r_lo, 8 + 2t..), (r_lo + 8,
    // 8 + 2t..), t = lane % 4 -- the accumulator's chunks 2 kk and 2 kk + 1
    uint32_t pa[kWgBK / 16][4];
#pragma unroll
    for (int c = 0; c < kWgBK / 8; ++c) {
      const float p0 = exp2f(s[4 * c] - mx[0]);
      const float p1 = exp2f(s[4 * c + 1] - mx[0]);
      const float p2 = exp2f(s[4 * c + 2] - mx[1]);
      const float p3 = exp2f(s[4 * c + 3] - mx[1]);
      l_run[0] += p0 + p1;        // the denominator sums p unrounded
      l_run[1] += p2 + p3;
      pa[c / 2][(c % 2) * 2] = pack_bf16(p0, p1);
      pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[4 * c] *= corr[0];
      o[4 * c + 1] *= corr[0];
      o[4 * c + 2] *= corr[1];
      o[4 * c + 3] *= corr[1];
    }

    // O += P V: 64 rows x D per warpgroup, 64 / 16 steps
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      WgmmaRsT<D>::run(o, pa[kk],
                       smem_desc(sV + kk * 16 * 128, kWgBK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }

  // o[4c + 2i + e]: row r_lo + 8 i, column 8 c + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = l == 0.f ? 1.f : l;
    const int r = r_lo + 8 * i;
    if (r >= S) continue;
    __nv_bfloat16* ob = out + (static_cast<size_t>(bh) * S + r) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * c + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * c + 2 * i] / l, o[4 * c + 2 * i + 1] / l);
  }
}

// ---------------------------------------------------------------------------
// f32: split TF32 on mma.sync

constexpr int kTfBQ = 128;     // queries per block: eight warps of 16 rows
constexpr int kTfBK = 64;      // keys per tile
template <int D>
__host__ __device__ constexpr int tf_k_stride() { return D + 16; }   // floats
template <int D>
__host__ __device__ constexpr int tf_v_stride() { return D + 4; }
template <int D>
__host__ __device__ constexpr int tf_stage_floats() {
  return kTfBK * (tf_k_stride<D>() + tf_v_stride<D>());   // K, then V
}
template <int D>
__host__ __device__ constexpr int tf_smem_bytes() {
  // Q, then the two-stage ring
  return (kTfBQ * tf_k_stride<D>() + 2 * tf_stage_floats<D>()) * 4;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to 2^-22 x, both TF32.  hi is rounded with two integer
// operations, cvt.rna's bits for every x but NaN (whose lo, rounded by
// cvt.rna itself, is then NaN, so the products stay NaN); cvt.rna on hi
// would add its NaN guard, two more instructions an element
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
  split_tf32(x.z, hi[2], lo[2]);
  split_tf32(x.w, hi[3], lo[3]);
}

// d[16 x 8] += a[16 x 8] b[8 x 8], one TF32 product
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: lo * hi and hi * lo, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// rows [row0, row0 + N_ROWS) of a [*, D] f32 matrix to dst, rows RS
// floats apart; rows at or past `limit` are zero-filled
template <int D, int RS, int N_ROWS = kTfBK>
__device__ __forceinline__ void load_tile_f32(uint32_t dst,
                                              const float* __restrict__ src,
                                              int row0, int limit, int tid) {
  constexpr int kChunks = D / 4;   // 16-byte chunks per row
  static_assert(N_ROWS * kChunks % kThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < N_ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + tid;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < limit;
    const float* g = src + static_cast<size_t>(ok ? row0 + r : 0) * D + c * 4;
    cp_async16(dst + (r * RS + c * 4) * 4, g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel_tf32x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int32_t* __restrict__ offset_ptr,
    float* __restrict__ out, int Hq, int Hkv, int S, int T_len, int causal,
    float scale) {
  constexpr int KS = tf_k_stride<D>(), VS = tf_v_stride<D>();
  constexpr int kStage = tf_stage_floats<D>();
  constexpr int NC = kTfBK / 8;      // 8-key n-tiles of S, k-steps of PV
  extern __shared__ float4 smem4[];
  const float* sQ = reinterpret_cast<const float*>(smem4);
  const float* sm = sQ + kTfBQ * KS;          // the ring: stage s, K then V
  const uint32_t sq =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
  const uint32_t sbase = sq + kTfBQ * KS * 4;

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest query tile first
  const int bh = blockIdx.y;                   // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;        // fragment row, column
  const int offset = causal ? offset_ptr[0] : 0;
  const int q0 = iq * kTfBQ;
  const int wq0 = q0 + 16 * warp;              // the warp's first row
  const int r_lo = wq0 + g;                    // this thread's rows r_lo, + 8

  const float* qb = q + static_cast<size_t>(bh) * S * D;
  const float* kb = k + static_cast<size_t>(kvh) * T_len * D;
  const float* vb = v + static_cast<size_t>(kvh) * T_len * D;

  int n_tiles = (T_len + kTfBK - 1) / kTfBK;
  if (causal) {
    const int q_hi = offset + min(q0 + kTfBQ, S) - 1;   // highest position
    n_tiles = max(0, min(n_tiles, q_hi / kTfBK + 1));
  }
  // the tiles this warp multiplies: none past its own last row
  int w_tiles = wq0 < S ? n_tiles : 0;
  if (causal && wq0 < S)
    w_tiles = min(n_tiles, (offset + min(wq0 + 16, S) - 1) / kTfBK + 1);

  load_tile_f32<D, KS, kTfBQ>(sq, qb, q0, S, tid);
  if (n_tiles > 0) {
    load_tile_f32<D, KS>(sbase, kb, 0, T_len, tid);
    load_tile_f32<D, VS>(sbase + KS * kTfBK * 4, vb, 0, T_len, tid);
  }
  cp_async_commit();
  // this thread's Q rows r_lo, r_lo + 8 at d 4 t (A fragments' columns)
  const float* qw = sQ + (16 * warp + g) * KS + 4 * t;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();          // tile j landed for this thread
    __syncthreads();              // ... for every thread; tile j - 1 consumed
    if (j + 1 < n_tiles) {        // refill the other stage meanwhile
      const uint32_t nxt = sbase + ((j + 1) & 1) * kStage * 4;
      load_tile_f32<D, KS>(nxt, kb, (j + 1) * kTfBK, T_len, tid);
      load_tile_f32<D, VS>(nxt + KS * kTfBK * 4, vb, (j + 1) * kTfBK, T_len,
                           tid);
    }
    cp_async_commit();
    if (j >= w_tiles) continue;   // no row of this warp sees tile j
    const float* Ks = sm + (j & 1) * kStage;
    const float* Vs = Ks + KS * kTfBK;

    // S = Q K^T: s[c][e] is row r_lo + 8 (e / 2), key 8 c + 2 t + e % 2
    float s[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll 2
    for (int ds = 0; ds < D / 16; ++ds) {
      // A fragments of k-steps 2 ds and 2 ds + 1: (row g, column t),
      // (g + 8, t), (g, t + 4), (g + 8, t + 4); q scaled first, as the
      // reference does
      const float4 x0 = *reinterpret_cast<const float4*>(qw + 16 * ds);
      const float4 x1 =
          *reinterpret_cast<const float4*>(qw + 8 * KS + 16 * ds);
      uint32_t ah[2][4], al[2][4];
      split_tf32(__fmul_rn(x0.x, scale), ah[0][0], al[0][0]);
      split_tf32(__fmul_rn(x1.x, scale), ah[0][1], al[0][1]);
      split_tf32(__fmul_rn(x0.y, scale), ah[0][2], al[0][2]);
      split_tf32(__fmul_rn(x1.y, scale), ah[0][3], al[0][3]);
      split_tf32(__fmul_rn(x0.z, scale), ah[1][0], al[1][0]);
      split_tf32(__fmul_rn(x1.z, scale), ah[1][1], al[1][1]);
      split_tf32(__fmul_rn(x0.w, scale), ah[1][2], al[1][2]);
      split_tf32(__fmul_rn(x1.w, scale), ah[1][3], al[1][3]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        // B fragments (row t, t + 4; column g): key 8 c + g at the same d
        const float4 kx = *reinterpret_cast<const float4*>(
            Ks + (8 * c + g) * KS + 16 * ds + 4 * t);
        uint32_t bh[4], bl[4];
        split4(kx, bh, bl);
        mma_3xtf32(s[c], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(s[c], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // mask (tiles across the diagonal or T only), online softmax in base 2
    const int k0 = j * kTfBK;
    const bool edge = k0 + kTfBK > T_len ||
                      (causal && k0 + kTfBK - 1 > offset + wq0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[c][e] * kLog2e;
        if (edge) {
          const int kp = k0 + 8 * c + 2 * t + (e & 1);
          const int qp = offset + r_lo + 8 * (e >> 1);
          if (kp >= T_len || (causal && kp > qp)) x = kNeg;
        }
        s[c][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] = exp2f(s[c][e] - mx[e >> 1]);
        l_run[e >> 1] += s[c][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: 8-key step c takes P's A fragment from s[c] (column t is
    // key 8 c + 2 t, column t + 4 key 8 c + 2 t + 1) and V rows 8 c + 2 t
    // and 8 c + 2 t + 1 as B; n-tile 4 qd + i, column g is d 32 qd + 4 g + i
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t ph[4], pl[4];
      split_tf32(s[c][0], ph[0], pl[0]);
      split_tf32(s[c][2], ph[1], pl[1]);
      split_tf32(s[c][1], ph[2], pl[2]);
      split_tf32(s[c][3], ph[3], pl[3]);
      const float* v0 = Vs + (8 * c + 2 * t) * VS + 4 * g;
#pragma unroll
      for (int qd = 0; qd < D / 32; ++qd) {
        const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * qd);
        const float4 x1 = *reinterpret_cast<const float4*>(v0 + VS + 32 * qd);
        uint32_t h0[4], l0[4], h1[4], l1[4];
        split4(x0, h0, l0);
        split4(x1, h1, l1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_3xtf32(o[4 * qd + i], ph, pl, h0[i], h1[i], l0[i], l1[i]);
      }
    }
  }
  cp_async_wait_all();            // nothing in flight at exit

  // o[4 qd + i][2 r + e]: row r_lo + 8 r, d 32 qd + 8 t + 4 e + i
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = l == 0.f ? 1.f : l;
    const int row = r_lo + 8 * r;
    if (row >= S) continue;
    float* ob = out + (static_cast<size_t>(bh) * S + row) * D + 8 * t;
#pragma unroll
    for (int qd = 0; qd < D / 32; ++qd)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(ob + 32 * qd + 4 * e) = make_float4(
            o[4 * qd][2 * r + e] / l, o[4 * qd + 1][2 * r + e] / l,
            o[4 * qd + 2][2 * r + e] / l, o[4 * qd + 3][2 * r + e] / l);
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem) {
  // once per instantiation, before any capture
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int32_t* offset, void* out, int B, int Hq,
                       int Hkv, int S, int T_len, int causal, float scale,
                       cudaStream_t s) {
  static const cudaError_t configured =
      configure(flash_kernel_tf32x3<D>, tf_smem_bytes<D>());
  if (configured != cudaSuccess) return configured;
  const dim3 grid((S + kTfBQ - 1) / kTfBQ, B * Hq);
  flash_kernel_tf32x3<D><<<grid, kThreads, tf_smem_bytes<D>(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), offset, static_cast<float*>(out), Hq, Hkv,
      S, T_len, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int32_t* offset, void* out, int B, int Hq,
                        int Hkv, int S, int T_len, int causal, float scale,
                        cudaStream_t s) {
  static const cudaError_t configured =
      configure(flash_kernel_wgmma<D>, wg_smem_bytes<D>());
  if (configured != cudaSuccess) return configured;
  const dim3 grid((S + kWgBQ - 1) / kWgBQ, B * Hq);
  flash_kernel_wgmma<D><<<grid, kThreads, wg_smem_bytes<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), offset,
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, S, T_len, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 or the launch's cudaError_t; -1 for arguments the kernel does
// not take (the Python wrapper checks them first).
extern "C" int amq_flash_attention(const void* q, const void* k, const void* v,
                                   const int32_t* offset, void* out, int bf16,
                                   int B, int Hq, int Hkv, int S, int T_len,
                                   int D, int causal, void* stream) {
  if ((D != 64 && D != 128) || B < 1 || S < 1 || T_len < 1 || Hkv < 1 ||
      Hq % Hkv != 0 || B * Hq > 65535)
    return -1;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = D == 128 ? launch_bf16<128>(q, k, v, offset, out, B, Hq, Hkv, S, T_len,
                                    causal, scale, s)
                 : launch_bf16<64>(q, k, v, offset, out, B, Hq, Hkv, S, T_len,
                                   causal, scale, s);
  else
    e = D == 128 ? launch_f32<128>(q, k, v, offset, out, B, Hq, Hkv, S, T_len,
                                   causal, scale, s)
                 : launch_f32<64>(q, k, v, offset, out, B, Hq, Hkv, S, T_len,
                                  causal, scale, s);
  return static_cast<int>(e);
}
