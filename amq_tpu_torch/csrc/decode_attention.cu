// Single-query decode attention against one layer of the stacked KV cache.
//
// Replaces the Pallas kernel of the JAX package's
// ops/decode_attention.py::decode_attention_indexed (_attn_kernel).  One
// block per (row b, KV head h) holds that KV head's G query heads.  The
// live length offsets[b] is read inside the kernel from a device tensor,
// so positions past the live context are never read.  An optional sliding
// window keeps keys with t > off - window.  This step's key/value (not yet
// in the cache, which is read-only inside the layer loop) join as a final
// column.  Online softmax in f32.
//
// Bound on the H100: bytes.  Each live key and value row is read once per
// KV head (G query heads share it), about 4 operations per byte read.  At
// decode sizes (B 1-4, 64-200 live keys, 32 KV heads) that is a few
// hundred KB, under a microsecond at the memory rate: what sets the time
// is latency, the dependent round trips to device memory and the serial
// work between them.  So the design is a warp-split flash-decode:
//
// * eight warps per block split the live range [t_lo, off) into
//   contiguous shares, computed from the row's own offset and window only,
//   so a row's result does not depend on B or on the other rows;
// * each lane loads 16 bytes (8 bf16 or 4 f32 dimensions) of a key row,
//   a warp covers 32 * 16 bytes of rows per load, and a warp issues all K
//   and V loads of a chunk of keys before it uses any of them;
// * q sits in registers (the lane's dimensions for each head), scores are
//   reduced over the lanes of a row by shuffles, and the online softmax is
//   warp-local: no shared memory and no block barrier in the key loop;
// * one merge of the warps' (max, sum, accumulator) states goes through
//   shared memory in fixed warp order (deterministic, no float atomics),
//   then the new column, then the store in out's dtype.
//
// Heads are taken GC at a time (GC = 1 for G = 1, else 4), one pass over
// the warp's keys per group of GC heads, so the per-lane accumulators stay
// at GC x 8 floats at every G up to 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGMax = 16;       // query heads per KV head
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of cache as floats
__device__ __forceinline__ void widen(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void widen(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// sum over the LPR lanes that hold one key row
template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TQ, typename TC, typename TO, int HD, int GC>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const TQ* __restrict__ q,        // [B, Hkv, G, hd]
    const TC* __restrict__ kc,       // [B, Hkv, T, hd] (one layer)
    const TC* __restrict__ vc,
    const TQ* __restrict__ kn,       // [B, Hkv, hd]
    const TQ* __restrict__ vn,
    const int32_t* __restrict__ offsets,  // [B]
    TO* __restrict__ out,            // [B, Hkv, G, hd]
    int Hkv, int G, int T, int window, float inv) {
  constexpr int VEC = 16 / sizeof(TC);   // dimensions per lane
  constexpr int LPR = HD / VEC;          // lanes per key row
  constexpr int RPI = 32 / LPR;          // key rows per warp load
  constexpr int U = GC == 1 ? 8 : 4;     // K and V loads in flight per lane
  constexpr int CHUNK = U * RPI;         // keys per warp step
  __shared__ float red_acc[kWarps][GC][HD];
  __shared__ float red_m[kWarps][GC], red_l[kWarps][GC], s_new[GC];

  const int bh = blockIdx.x;             // b * Hkv + h
  const int b = bh / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = lane / LPR, col = (lane % LPR) * VEC;
  const int off = min(max(offsets[b], 0), T);
  const int t_lo = window > 0 ? max(0, off - window + 1) : 0;
  // this warp's contiguous share of [t_lo, off), set by the row alone
  const int share = (off - t_lo + kWarps - 1) / kWarps;
  const int w_lo = min(off, t_lo + warp * share);
  const int w_hi = min(off, w_lo + share);
  const TC* kbase = kc + static_cast<size_t>(bh) * T * HD + col;
  const TC* vbase = vc + static_cast<size_t>(bh) * T * HD + col;

  for (int g0 = 0; g0 < G; g0 += GC) {
    float qr[GC][VEC], acc[GC][VEC], m[GC], l[GC];
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      const bool live = g0 + gi < G;
      const TQ* qg = q + (static_cast<size_t>(bh) * G + g0 + gi) * HD + col;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[gi][e] = live ? to_f(qg[e]) : 0.f;
        acc[gi][e] = 0.f;
      }
      m[gi] = kNeg;
      l[gi] = 0.f;
    }

    for (int t0 = w_lo; t0 < w_hi; t0 += CHUNK) {
      uint4 kw[U], vw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * RPI + row;
        if (t < w_hi) {
          kw[u] = __ldg(reinterpret_cast<const uint4*>(kbase + static_cast<size_t>(t) * HD));
          vw[u] = __ldg(reinterpret_cast<const uint4*>(vbase + static_cast<size_t>(t) * HD));
        } else {
          kw[u] = vw[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float sc[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        widen(kw[u], kf);
        const bool ok = t0 + u * RPI + row < w_hi;
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[gi][e], kf[e], d);
          d = row_sum<LPR>(d) * inv;
          sc[u][gi] = ok ? d : kNeg;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float mx = m[gi];
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][gi]);
        const float corr = expf(m[gi] - mx);
        m[gi] = mx;
        l[gi] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[gi][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // keys past the share score kNeg; their p is 0, not exp(0)
          const float p = sc[u][gi] == kNeg ? 0.f : expf(sc[u][gi] - mx);
          sc[u][gi] = p;
          l[gi] += p;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[VEC];
        widen(vw[u], vf);
#pragma unroll
        for (int gi = 0; gi < GC; ++gi)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[gi][e] = fmaf(sc[u][gi], vf[e], acc[gi][e]);
      }
    }

    // merge the warp's key rows (lanes with the same dimensions), then
    // hand the warp's state to the block through shared memory
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
      for (int xo = LPR; xo < 32; xo <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[gi], xo);
        const float lo = __shfl_xor_sync(0xffffffffu, l[gi], xo);
        const float mx = fmaxf(m[gi], mo);
        const float f = expf(m[gi] - mx), fo = expf(mo - mx);
        l[gi] = l[gi] * f + lo * fo;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[gi][e] = acc[gi][e] * f + __shfl_xor_sync(0xffffffffu, acc[gi][e], xo) * fo;
        m[gi] = mx;
      }
      if (row == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) red_acc[warp][gi][col + e] = acc[gi][e];
        if (lane == 0) {
          red_m[warp][gi] = m[gi];
          red_l[warp][gi] = l[gi];
        }
      }
    }
    // this step's key as the final column (position off): its scores
    if (warp == 0) {
      const TQ* kg = kn + static_cast<size_t>(bh) * HD + col;
      float kf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = to_f(kg[e]);
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qr[gi][e], kf[e], d);
        d = row_sum<LPR>(d) * inv;
        if (lane == 0) s_new[gi] = d;
      }
    }
    __syncthreads();

    // one thread per (head, dimension): the warps' states in warp order,
    // then the new column
    for (int i = tid; i < GC * HD; i += kThreads) {
      const int gi = i / HD, e = i % HD, g = g0 + gi;
      if (g >= G) continue;
      float mw = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, red_m[w][gi]);
      float lw = 0.f, aw = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(red_m[w][gi] - mw);
        lw += red_l[w][gi] * f;
        aw += red_acc[w][gi][e] * f;
      }
      const float s1 = s_new[gi];
      const float mf = fmaxf(mw, s1);
      const float corr = expf(mw - mf);
      const float p1 = expf(s1 - mf);
      const float lt = lw * corr + p1;
      const float o = (aw * corr + p1 * to_f(vn[static_cast<size_t>(bh) * HD + e])) / lt;
      from_f(out + (static_cast<size_t>(bh) * G + g) * HD + e, o);
    }
    __syncthreads();   // the next group of heads reuses the buffers
  }
}

template <typename TQ, typename TC, typename TO, int HD, int GC>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, const int32_t* offsets,
                   void* out, int B, int Hkv, int G, int T, int window,
                   float inv, cudaStream_t s) {
  decode_attn_kernel<TQ, TC, TO, HD, GC><<<B * Hkv, kThreads, 0, s>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), offsets, static_cast<TO*>(out), Hkv, G, T,
      window, inv);
  return cudaGetLastError();
}

template <typename TQ, typename TC, typename TO>
cudaError_t by_shape(const void* q, const void* kc, const void* vc,
                     const void* kn, const void* vn, const int32_t* offsets,
                     void* out, int B, int Hkv, int G, int T, int hd,
                     int window, float inv, cudaStream_t s) {
  if (hd == 128)
    return G == 1 ? launch<TQ, TC, TO, 128, 1>(q, kc, vc, kn, vn, offsets, out,
                                               B, Hkv, G, T, window, inv, s)
                  : launch<TQ, TC, TO, 128, 4>(q, kc, vc, kn, vn, offsets, out,
                                               B, Hkv, G, T, window, inv, s);
  return G == 1 ? launch<TQ, TC, TO, 64, 1>(q, kc, vc, kn, vn, offsets, out, B,
                                            Hkv, G, T, window, inv, s)
                : launch<TQ, TC, TO, 64, 4>(q, kc, vc, kn, vn, offsets, out, B,
                                            Hkv, G, T, window, inv, s);
}

template <typename TQ, typename TC>
cudaError_t by_out(int out_bf16, const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, const int32_t* offsets,
                   void* out, int B, int Hkv, int G, int T, int hd, int window,
                   float inv, cudaStream_t s) {
  if (out_bf16)
    return by_shape<TQ, TC, __nv_bfloat16>(q, kc, vc, kn, vn, offsets, out, B,
                                           Hkv, G, T, hd, window, inv, s);
  return by_shape<TQ, TC, float>(q, kc, vc, kn, vn, offsets, out, B, Hkv, G, T,
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
  if ((hd != 64 && hd != 128) || G < 1 || G > kGMax || B < 1) return -1;
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
