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
// f32: CUDA cores (TF32 tensor cores would not hold the JAX suite's 2e-4
// tolerance).  64-query x 64-key tiles staged in shared memory as f32,
// each of 256 threads holding a 4 x 4 block of scores and a 4 x (d / 16)
// block of the output in registers, with 16-byte shared loads laid out
// free of bank conflicts; K and V share one staging buffer so two blocks
// fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

using namespace amq;

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups of 4 queries x 16 threads
constexpr float kNeg = -1e30f;

// the CUDA-core kernel below runs for f32 inputs only (bf16 takes the
// tensor-core kernel); p.astype(v.dtype) of the Pallas kernel is then exact
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ float round_as(float v, float) { return v; }

template <int D>
constexpr int smem_bytes() {
  // Q tile and one K-or-V tile (row stride D + 4), P tile (stride kBK + 4)
  return ((kBQ + kBK) * (D + 4) + kBQ * (kBK + 4)) * 4;
}

template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           int row0, int n_rows, int tid) {
  constexpr int RS = D + 4;
  for (int i = tid; i < kBK * D; i += kThreads) {
    const int r = i / D, e = i % D;
    dst[r * RS + e] =
        row0 + r < n_rows ? to_f(src[static_cast<size_t>(row0 + r) * D + e]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ offset_ptr, T* __restrict__ out, int Hq,
    int Hkv, int S, int T_len, int causal, float scale) {
  constexpr int RS = D + 4;     // Q / KV row stride (floats)
  constexpr int PS = kBK + 4;   // P row stride
  constexpr int NJ = D / 64;    // float4 column groups per thread in PV
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * RS;
  float* Ps = KVs + kBK * RS;

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest query tile first
  const int bh = blockIdx.y;                   // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int offset = causal ? offset_ptr[0] : 0;
  const int q0 = iq * kBQ;

  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* kb = k + static_cast<size_t>(kvh) * T_len * D;
  const T* vb = v + static_cast<size_t>(kvh) * T_len * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, e = i % D;
    Qs[r * RS + e] =
        q0 + r < S ? to_f(qb[static_cast<size_t>(q0 + r) * D + e]) * scale : 0.f;
  }

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    const int q_hi = offset + min(q0 + kBQ, S) - 1;   // highest query position
    n_tiles = max(0, min(n_tiles, q_hi / kBK + 1));
  }

  float m_run[4], l_run[4], acc[4][4 * NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = kNeg;
    l_run[a] = 0.f;
#pragma unroll
    for (int n = 0; n < 4 * NJ; ++n) acc[a][n] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();                       // previous V tile and P consumed
    stage_tile<T, D>(KVs, kb, k0, T_len, tid);
    __syncthreads();

    // scores of rows ty*4 + a against keys tx + 16*c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + a) * RS + e]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * c) * RS + e]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qv[a].x, kv[c].x, s[a][c]);
          s[a][c] = fmaf(qv[a].y, kv[c].y, s[a][c]);
          s[a][c] = fmaf(qv[a].z, kv[c].z, s[a][c]);
          s[a][c] = fmaf(qv[a].w, kv[c].w, s[a][c]);
        }
    }

    // mask, online softmax (row statistics shared by the 16 threads of a row)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int q_pos = offset + q0 + ty * 4 + a;
      float mx = m_run[a];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k_pos = k0 + tx + 16 * c;
        const bool ok = k_pos < T_len && (!causal || k_pos <= q_pos);
        s[a][c] = ok ? s[a][c] : kNeg;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = expf(m_run[a] - mx);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - mx);
        ls += p;
        Ps[(ty * 4 + a) * PS + tx + 16 * c] = round_as(p, T());
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      l_run[a] = l_run[a] * corr + ls;
      m_run[a] = mx;
#pragma unroll
      for (int n = 0; n < 4 * NJ; ++n) acc[a][n] *= corr;
    }
    __syncthreads();                       // P complete, K consumed
    stage_tile<T, D>(KVs, vb, k0, T_len, tid);
    __syncthreads();

    // acc[a][4*jj + t] += sum_k P[row a][k] * V[k][tx*4 + 64*jj + t]
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pv[a] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + a) * PS + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &KVs[(kk + t) * RS + tx * 4 + 64 * jj]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = t == 0 ? pv[a].x : t == 1 ? pv[a].y : t == 2 ? pv[a].z : pv[a].w;
            acc[a][4 * jj + 0] = fmaf(p, vv.x, acc[a][4 * jj + 0]);
            acc[a][4 * jj + 1] = fmaf(p, vv.y, acc[a][4 * jj + 1]);
            acc[a][4 * jj + 2] = fmaf(p, vv.z, acc[a][4 * jj + 2]);
            acc[a][4 * jj + 3] = fmaf(p, vv.w, acc[a][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty * 4 + a;
    if (r >= S) continue;
    const float l = l_run[a] == 0.f ? 1.f : l_run[a];
    T* ob = out + (static_cast<size_t>(bh) * S + r) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        store(ob + tx * 4 + 64 * jj + t, acc[a][4 * jj + t] / l);
  }
}

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
  extern __shared__ float4 smem4[];   // the one declaration of this file
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
      configure(flash_kernel<float, D>, smem_bytes<D>());
  if (configured != cudaSuccess) return configured;
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_kernel<float, D><<<grid, kThreads, smem_bytes<D>(), s>>>(
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
