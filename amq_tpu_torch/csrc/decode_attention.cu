// Single-query decode attention against one layer of the stacked KV cache.
//
// Replaces the Pallas kernel of the JAX package's
// ops/decode_attention.py::decode_attention_indexed (_attn_kernel).  One
// block per (row b, KV head h) holds that KV head's G query heads.  The
// live length offsets[b] is read inside the kernel from a device tensor,
// and the loop over 32-key tiles stops there, so positions past the live
// context are never read.  An optional sliding window keeps keys with
// t > off - window.  This step's key/value (not yet in the cache, which is
// read-only inside the layer loop) join as a final column.  Online softmax
// in f32.
//
// Bound on the H100: bytes.  Each live key and value row is read once per
// KV head (G query heads share it), about 4 operations per byte read.  The
// design reads K rows one warp per key (lanes along hd, coalesced) and V
// rows one thread per dimension (coalesced), and reads nothing past the
// live length.  At B = 1 only Hkv blocks run, so short contexts are
// latency-bound, not bandwidth-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // >= hd (64 or 128)
constexpr int kTile = 32;       // keys per tile
constexpr int kGMax = 16;       // query heads per KV head
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TQ, typename TC, typename TO>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const TQ* __restrict__ q,        // [B, Hkv, G, hd]
    const TC* __restrict__ kc,       // [B, Hkv, T, hd] (one layer)
    const TC* __restrict__ vc,
    const TQ* __restrict__ kn,       // [B, Hkv, hd]
    const TQ* __restrict__ vn,
    const int32_t* __restrict__ offsets,  // [B]
    TO* __restrict__ out,            // [B, Hkv, G, hd]
    int Hkv, int G, int T, int hd, int window, float inv) {
  __shared__ float qs[kGMax][128];
  __shared__ float sc[kGMax][kTile];
  const int bh = blockIdx.x;               // b * Hkv + h
  const int b = bh / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = kThreads / 32;
  const int off = min(max(offsets[b], 0), T);
  const int t_lo = window > 0 ? max(0, off - window + 1) : 0;

  for (int i = tid; i < G * hd; i += kThreads)
    qs[i / hd][i % hd] = to_f(q[static_cast<size_t>(bh) * G * hd + i]);

  float m_run[kGMax], l_run[kGMax], acc[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m_run[g] = kNeg;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }
  const TC* kbase = kc + static_cast<size_t>(bh) * T * hd;
  const TC* vbase = vc + static_cast<size_t>(bh) * T * hd;
  __syncthreads();

  for (int t0 = t_lo; t0 < off; t0 += kTile) {
    // scores: one warp per key, lanes along hd
    for (int j = warp; j < kTile; j += nwarps) {
      const int t = t0 + j;
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
        if (t < off) {
          for (int e = lane; e < hd; e += 32)
            d += qs[g][e] * to_f(kbase[static_cast<size_t>(t) * hd + e]);
          d = warp_sum(d) * inv;
        } else {
          d = kNeg;
        }
        if (lane == 0) sc[g][j] = d;
      }
    }
    __syncthreads();
    // online softmax update; every thread keeps the running max/denominator
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= G) break;
      float mx = m_run[g];
      for (int j = 0; j < kTile; ++j) mx = fmaxf(mx, sc[g][j]);
      const float corr = expf(m_run[g] - mx);
      float lsum = 0.f, pv = 0.f;
      for (int j = 0; j < kTile; ++j) {
        const float p = expf(sc[g][j] - mx);
        lsum += p;
        if (tid < hd && t0 + j < off)
          pv += p * to_f(vbase[static_cast<size_t>(t0 + j) * hd + tid]);
      }
      m_run[g] = mx;
      l_run[g] = l_run[g] * corr + lsum;
      acc[g] = acc[g] * corr + pv;
    }
    __syncthreads();
  }

  // this step's key/value as the final column (position off)
  const size_t nb = static_cast<size_t>(bh) * hd;
  for (int g = warp; g < G; g += nwarps) {
    float d = 0.f;
    for (int e = lane; e < hd; e += 32) d += qs[g][e] * to_f(kn[nb + e]);
    d = warp_sum(d) * inv;
    if (lane == 0) sc[g][0] = d;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g >= G) break;
    const float s1 = sc[g][0];
    const float mf = fmaxf(m_run[g], s1);
    const float corr = expf(m_run[g] - mf);
    const float p1 = expf(s1 - mf);
    const float l = l_run[g] * corr + p1;
    if (tid < hd) {
      const float o = (acc[g] * corr + p1 * to_f(vn[nb + tid])) / l;
      from_f(out + (static_cast<size_t>(bh) * G + g) * hd + tid, o);
    }
  }
}

template <typename TQ, typename TC, typename TO>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, const int32_t* offsets,
                   void* out, int B, int Hkv, int G, int T, int hd, int window,
                   float inv, cudaStream_t s) {
  decode_attn_kernel<TQ, TC, TO><<<B * Hkv, kThreads, 0, s>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), offsets, static_cast<TO*>(out), Hkv, G, T,
      hd, window, inv);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t by_out(int out_bf16, const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, const int32_t* offsets,
                   void* out, int B, int Hkv, int G, int T, int hd, int window,
                   float inv, cudaStream_t s) {
  if (out_bf16)
    return launch<TQ, TC, __nv_bfloat16>(q, kc, vc, kn, vn, offsets, out, B,
                                         Hkv, G, T, hd, window, inv, s);
  return launch<TQ, TC, float>(q, kc, vc, kn, vn, offsets, out, B, Hkv, G, T,
                               hd, window, inv, s);
}

template <typename TQ>
cudaError_t by_cache(int cache_bf16, int out_bf16, const void* q,
                     const void* kc, const void* vc, const void* kn,
                     const void* vn, const int32_t* offsets, void* out, int B,
                     int Hkv, int G, int T, int hd, int window, float inv,
                     cudaStream_t s) {
  if (cache_bf16)
    return by_out<TQ, __nv_bfloat16>(out_bf16, q, kc, vc, kn, vn, offsets, out,
                                     B, Hkv, G, T, hd, window, inv, s);
  return by_out<TQ, float>(out_bf16, q, kc, vc, kn, vn, offsets, out, B, Hkv,
                           G, T, hd, window, inv, s);
}

}  // namespace

// Returns 0 or a cudaError_t of the launch; -1 for arguments the kernel
// does not take (the Python wrapper checks them first).
extern "C" int amq_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* k_new,
                                    const void* v_new, const int32_t* offsets,
                                    void* out, int q_bf16, int cache_bf16,
                                    int out_bf16, int B, int Hkv, int G, int T,
                                    int hd, int window, void* stream) {
  if (hd > 128 || hd % 32 || G < 1 || G > kGMax || B < 1) return -1;
  const float inv = 1.f / sqrtf(static_cast<float>(hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_bf16)
    e = by_cache<__nv_bfloat16>(cache_bf16, out_bf16, q, k_cache, v_cache,
                                k_new, v_new, offsets, out, B, Hkv, G, T, hd,
                                window, inv, s);
  else
    e = by_cache<float>(cache_bf16, out_bf16, q, k_cache, v_cache, k_new,
                        v_new, offsets, out, B, Hkv, G, T, hd, window, inv, s);
  return static_cast<int>(e);
}
