// Blockwise (flash) causal attention for prefill and evaluation.
//
// Replaces the Pallas kernel of the JAX package's
// ops/flash_attention.py::flash_attention (_flash_kernel).  Layout:
// q/out [B, Hq, S, d], k/v [B, Hkv, T, d], f32 or bf16, d 64 or 128.  One
// block per (64-query tile, b * Hq + h); GQA reads KV head h / (Hq / Hkv)
// in place, never widened to Hq.  Query row i sits at absolute position
// offset + i, where offset is read from a device tensor inside the kernel
// (no host sync, so the launch can be captured in a CUDA graph), and
// attends keys k <= offset + i with k < T (keys at or beyond T are masked
// here, which equals the JAX wrapper's zero pad: call sites guarantee
// offset + S <= T).  The key-tile loop stops at the last tile any row of
// the query tile can see, so fully masked tiles cost nothing.
//
// Numerics follow the Pallas kernel: scores (q * scale) . k in f32, masked
// scores -1e30, an online softmax with f32 running max / denominator /
// accumulator, p rounded to the input dtype before the PV product while
// the denominator sums the unrounded p, l == 0 -> 1, output in q's dtype.
//
// Bound on the H100: operations.  Causal attention does 4 d flops per
// (query, visible key) pair against q + o + K/V bytes read once per query
// tile; at S = 2048, d = 128 that is hundreds of flops per byte, far above
// the card's ridge.  This first design computes on CUDA cores in f32 (the
// f32 inputs need it; a bf16 mma.sync / wgmma path is later work): 64-key
// tiles staged in shared memory as f32, each of 256 threads holding a 4 x 4
// block of scores and a 4 x (d / 16) block of the output in registers, with
// 16-byte shared loads laid out free of bank conflicts.  Query tiles are
// scheduled heaviest first (the causal work grows with the tile index), and
// K and V share one staging buffer so two blocks fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups of 4 queries x 16 threads
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// round to the input dtype and back (the Pallas kernel's p.astype(v.dtype))
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* offset, void* out, int B, int Hq, int Hkv,
                   int S, int T_len, int causal, float scale, cudaStream_t s) {
  static bool configured = false;   // once per instantiation, before capture
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_kernel<T, D><<<grid, kThreads, smem_bytes<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), offset, static_cast<T*>(out), Hq, Hkv, S,
      T_len, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_d(int D, const void* q, const void* k, const void* v,
                 const int32_t* offset, void* out, int B, int Hq, int Hkv,
                 int S, int T_len, int causal, float scale, cudaStream_t s) {
  if (D == 128)
    return launch<T, 128>(q, k, v, offset, out, B, Hq, Hkv, S, T_len, causal,
                          scale, s);
  return launch<T, 64>(q, k, v, offset, out, B, Hq, Hkv, S, T_len, causal,
                       scale, s);
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
  cudaError_t e =
      bf16 ? by_d<__nv_bfloat16>(D, q, k, v, offset, out, B, Hq, Hkv, S,
                                 T_len, causal, scale, s)
           : by_d<float>(D, q, k, v, offset, out, B, Hq, Hkv, S, T_len,
                         causal, scale, s);
  return static_cast<int>(e);
}
