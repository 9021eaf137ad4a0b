// Single-query decode attention against one layer of the stacked KV cache.
//
// Replaces the Pallas kernel of the JAX package's
// ops/decode_attention.py::decode_attention_indexed (_attn_kernel).  The
// live length offsets[b] is read inside the kernel from a device tensor,
// so positions past the live context are never read.  An optional sliding
// window keeps keys with t > off - window.  This step's key/value (not yet
// in the cache, which is read-only inside the layer loop) join as a final
// column.  Online softmax in f32.
//
// Bound on the H100: bytes.  Each live key and value row is read once per
// KV head (its G query heads share it), about 4 operations per byte read
// (G = 4-8).  The chat shapes (B 8-32, ~1300 live keys, 4 or 8 KV heads)
// read 21-170 MB a call, 6-51 us at 3.35 TB/s; B 1 at 64-200 keys reads a
// few hundred KB, where latency sets the time.  One block per (row, KV
// head) gave 32-256 blocks for 132 SMs at the chat shapes, each walking
// ~1300 keys in dependent chunks (5-46 % of the byte bound).  So the
// design is a split flash-decode:
//
// * the grid is (split, row b x KV head h).  A row's live range [t_lo, off)
//   (its own offset and window) is cut into splits of `span` keys from
//   t_lo; `span` comes from the model's shape alone (Hkv, hd, the cache's
//   dtype: ops/decode_attention.split_plan, 64 Hkv keys at hd 128 in bf16,
//   128-1024), never from B or the live lengths, so a row's result does
//   not depend on B or the other rows.  The grid holds ceil(T / span)
//   splits, T the cache's capacity, so one launch shape serves every
//   offset (a CUDA graph replays it); blocks whose split holds no live key
//   exit at once;
// * eight warps split the block's keys into contiguous shares, each warp
//   keeps its own online softmax, and the warps' (max, sum, accumulator)
//   states merge through shared memory in fixed warp order;
// * one split (T <= span: short caches, B 1 generate) is the whole row: the
//   block adds the new column and stores the output, one launch, with q and
//   this step's key and value copied to shared memory (cp.async) while the
//   cache streams.  Several splits store each live block's state to
//   scratch (f32 [B*Hkv, splits, G, hd + 2]: accumulator, max, sum), and
//   decode_attn_kernel_merge, one block per (head, row x KV head) and a
//   thread per dimension, merges the live splits in split order, adds the
//   new column and stores.  Deterministic, no float atomics;
// * bf16 q and bf16 cache at G > 1 run on the tensor cores (mma.sync
//   m16n8k16), all G <= 8 heads of a KV head in one pass over the keys (G
//   9-16 in two): S^T = K Q^T with 16 keys as M and the heads as N, K's
//   rows loaded 16 bytes a lane straight into A fragments (the hd axis
//   permuted alike in K and q, which the sum does not see); O^T += V^T P
//   with the 16 keys as the reduction, V and P transposed in registers
//   (movmatrix).  p enters PV as two bf16 parts (hi + lo, ~16 bits), so
//   the bf16 forms keep f32 accuracy: q k's and V p's products are exact,
//   the sums f32;
// * G = 1 (no key shared by two heads) and the f32 forms run on the CUDA
//   cores in f32: each lane loads 16 bytes of a key row, scores are reduced
//   over a row's lanes by shuffles, and the heads are taken GC at a time
//   (GC = 1 for G = 1, else 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGMax = 16;       // query heads per KV head
constexpr int kStep = 16;       // keys per warp step on the tensor cores
constexpr int kMmaHeads = 8;    // heads per pass on the tensor cores (N)
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

// 16 bytes at p as four 32-bit words, or zeros (a key past the range: its
// cache row may hold anything, and 0 * NaN would reach the sums)
template <typename T>
__device__ __forceinline__ void load16(uint32_t (&r)[4], const T* p, bool ok) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (ok) w = __ldg(reinterpret_cast<const uint4*>(p));
  r[0] = w.x;
  r[1] = w.y;
  r[2] = w.z;
  r[3] = w.w;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the 8 x 8 bf16 matrix whose row lane / 4, columns 2 (lane % 4) + {0, 1}
// this lane holds, transposed (the same fragment layout)
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16 of what hi leaves
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x, y);
  lo = pack_bf16(x - __uint_as_float(hi << 16),
                 y - __uint_as_float(hi & 0xffff0000u));
}

// 16 bytes from device to shared memory, not through registers
template <typename T>
__device__ __forceinline__ void cp_async16(T* smem, const T* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// q's G rows and this step's key and value row of one (row, KV head) into
// shared memory, in flight while the block reads the cache
template <typename TQ, int HD>
__device__ __forceinline__ void prefetch_new(TQ* s_q, TQ* s_kn, TQ* s_vn,
                                             const TQ* qb, const TQ* kg,
                                             const TQ* vg, int G, int tid) {
  constexpr int V = 16 / sizeof(TQ);
  for (int i = tid; i < G * HD / V; i += kThreads) cp_async16(s_q + i * V, qb + i * V);
  if (tid < HD / V) {
    cp_async16(s_kn + tid * V, kg + tid * V);
    cp_async16(s_vn + tid * V, vg + tid * V);
  }
  cp_async_commit();
}

// One warp over keys [lo, hi) for heads g0 .. g0 + 7 on the tensor cores
// (heads past G read q as zero and are not stored).  Lane = 4 g + c.
//
// Scores: S^T[16 keys, 8 heads] = K Q^T, one m16n8k16 per 16 dimensions.
// The lane loads key rows t0 + g and t0 + 8 + g at dimensions 32 j + 8 c ..
// + 8 (16 bytes each); word w of that load holds dimensions 32 j + 8 c +
// 2 w, + 1.  Product (j, hh) takes words 2 hh (A columns 2 c, 2 c + 1) and
// 2 hh + 1 (columns 2 c + 8, + 9) of both rows, and q of head g at the
// same dimensions as B: the same permutation of hd on both sides.  The
// result holds S[t0 + g] and S[t0 + 8 + g] at heads 2 c, 2 c + 1.
//
// PV: O^T[16 dims, 8 heads] += V^T[16 dims, 16 keys] P[16 keys, 8 heads].
// P's bf16 pairs (key t0 + g, heads 2 c, 2 c + 1) transposed give B (keys
// 2 c, 2 c + 1 at head g), once for p's hi part and once for its lo part.  Word w of V's load, transposed, holds keys
// t0 + 2 c, + 1 at dimension 32 j + 8 (g / 2) + 2 w + g % 2: words 2 pp and
// 2 pp + 1 are rows g and g + 8 of M block (j, pp), the first 8 keys from
// row t0 + g's load and the second from row t0 + 8 + g's.  So o[j][pp]
// holds heads 2 c (0, 2) and 2 c + 1 (1, 3) at dimension 32 j + 8 (g / 2)
// + 4 pp + g % 2 (0, 1) and that + 2 (2, 3).
template <int HD>
__device__ __forceinline__ void warp_pass_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, int G, int g0, int lo, int hi,
    float inv, int lane, float (&acc)[kMmaHeads][HD], float (&ms)[kMmaHeads],
    float (&ls)[kMmaHeads]) {
  constexpr int J = HD / 32;
  const int g = lane >> 2, c = lane & 3;
  uint32_t qf[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
    load16(qf[j], q + static_cast<size_t>(g0 + g) * HD + 32 * j + 8 * c,
           g0 + g < G);
  float o[J][2][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[j][pp][r] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const __nv_bfloat16* kb = kc + 8 * c;
  const __nv_bfloat16* vb = vc + 8 * c;

  for (int t0 = lo; t0 < hi; t0 += kStep) {
    const int ta = t0 + g, tb = ta + 8;
    const bool oka = ta < hi, okb = tb < hi;
    uint32_t ka[J][4], kz[J][4], va[J][4], vz[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      load16(ka[j], kb + static_cast<size_t>(ta) * HD + 32 * j, oka);
      load16(kz[j], kb + static_cast<size_t>(tb) * HD + 32 * j, okb);
      load16(va[j], vb + static_cast<size_t>(ta) * HD + 32 * j, oka);
      load16(vz[j], vb + static_cast<size_t>(tb) * HD + 32 * j, okb);
    }
    // two chains of products (hh), summed: half the dependent latency
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mma_bf16(s[hh], ka[j][2 * hh], kz[j][2 * hh], ka[j][2 * hh + 1],
                 kz[j][2 * hh + 1], qf[j][2 * hh], qf[j][2 * hh + 1]);
    const float s0 = oka ? (s[0][0] + s[1][0]) * inv : kNeg;
    const float s1 = oka ? (s[0][1] + s[1][1]) * inv : kNeg;
    const float s2 = okb ? (s[0][2] + s[1][2]) * inv : kNeg;
    const float s3 = okb ? (s[0][3] + s[1][3]) * inv : kNeg;
    // the step's max per head: over the lane's two keys, then the 8 lanes
    // of the same c
    float x0 = fmaxf(s0, s2), x1 = fmaxf(s1, s3);
#pragma unroll
    for (int sh = 4; sh < 32; sh <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, sh));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, sh));
    }
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    // keys past the range score kNeg; their p is 0, not exp(0)
    const float p0 = oka ? expf(s0 - n0) : 0.f;
    const float p1 = oka ? expf(s1 - n1) : 0.f;
    const float p2 = okb ? expf(s2 - n0) : 0.f;
    const float p3 = okb ? expf(s3 - n1) : 0.f;
    l0 = l0 * c0 + p0 + p2;
    l1 = l1 * c1 + p1 + p3;
    // p as two bf16 parts, hi + lo: PV keeps ~16 of p's bits, and each
    // product of bf16 V and a part is exact in the f32 sum
    uint32_t ph[2], pl[2];
    split_bf16(p0, p1, ph[0], pl[0]);
    split_bf16(p2, p3, ph[1], pl[1]);
    const uint32_t bh0 = transpose8(ph[0]), bh1 = transpose8(ph[1]);
    const uint32_t bl0 = transpose8(pl[0]), bl1 = transpose8(pl[1]);
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        o[j][pp][0] *= c0;
        o[j][pp][1] *= c1;
        o[j][pp][2] *= c0;
        o[j][pp][3] *= c1;
        const uint32_t a0 = transpose8(va[j][2 * pp]);
        const uint32_t a1 = transpose8(va[j][2 * pp + 1]);
        const uint32_t a2 = transpose8(vz[j][2 * pp]);
        const uint32_t a3 = transpose8(vz[j][2 * pp + 1]);
        mma_bf16(o[j][pp], a0, a1, a2, a3, bh0, bh1);
        mma_bf16(o[j][pp], a0, a1, a2, a3, bl0, bl1);
      }
  }

  // the lanes' partial sums over the 8 lanes of the same c
#pragma unroll
  for (int sh = 4; sh < 32; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  if (g == 0) {
    ms[2 * c] = m0;
    ms[2 * c + 1] = m1;
    ls[2 * c] = l0;
    ls[2 * c + 1] = l1;
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 32 * j + 8 * (g >> 1) + 4 * pp + 2 * h + (g & 1);
        acc[2 * c][d] = o[j][pp][2 * h];
        acc[2 * c + 1][d] = o[j][pp][2 * h + 1];
      }
}

// One warp over keys [lo, hi) for heads g0 .. g0 + GC - 1 on the CUDA
// cores: each lane loads 16 bytes (VEC dimensions) of a key row, LPR lanes
// a row, RPI rows a warp load, U loads of K and of V in flight a lane.
template <typename TQ, typename TC, int HD, int GC>
__device__ __forceinline__ void warp_pass_cores(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, int G, int g0, int lo, int hi, float inv,
    int lane, float (&acc_s)[GC][HD], float (&ms)[GC], float (&ls)[GC]) {
  constexpr int VEC = 16 / sizeof(TC);   // dimensions per lane
  constexpr int LPR = HD / VEC;          // lanes per key row
  constexpr int RPI = 32 / LPR;          // key rows per warp load
  constexpr int U = GC == 1 ? 8 : 4;     // K and V loads in flight per lane
  constexpr int CHUNK = U * RPI;         // keys per warp step
  const int row = lane / LPR, col = (lane % LPR) * VEC;
  const TC* kbase = kc + col;
  const TC* vbase = vc + col;

  float qr[GC][VEC], acc[GC][VEC], m[GC], l[GC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    const bool live = g0 + gi < G;
    const TQ* qg = q + static_cast<size_t>(g0 + gi) * HD + col;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[gi][e] = live ? to_f(qg[e]) : 0.f;
      acc[gi][e] = 0.f;
    }
    m[gi] = kNeg;
    l[gi] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += CHUNK) {
    uint4 kw[U], vw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * RPI + row;
      if (t < hi) {
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
      const bool ok = t0 + u * RPI + row < hi;
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
        // keys past the range score kNeg; their p is 0, not exp(0)
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

  // merge the warp's key rows (lanes with the same dimensions)
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
    for (int xo = LPR; xo < 32; xo <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], xo);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], xo);
      const float mx = fmaxf(m[gi], mo);
      const float f = expf(m[gi] - mx), fo = expf(mo - mx);
      l[gi] = l[gi] * f + lo_ * fo;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[gi][e] = acc[gi][e] * f + __shfl_xor_sync(0xffffffffu, acc[gi][e], xo) * fo;
      m[gi] = mx;
    }
    if (row == 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[gi][col + e] = acc[gi][e];
      if (lane == 0) {
        ms[gi] = m[gi];
        ls[gi] = l[gi];
      }
    }
  }
}

// q . k_new / sqrt(hd) of one head, by one warp
template <typename TQ, int HD>
__device__ __forceinline__ float new_score(const TQ* __restrict__ qg,
                                           const TQ* __restrict__ kg,
                                           int lane, float inv) {
  float d = 0.f;
#pragma unroll
  for (int e = lane; e < HD; e += 32) d = fmaf(to_f(qg[e]), to_f(kg[e]), d);
  return row_sum<32>(d) * inv;
}

// the output from a merged (max, sum, accumulator) state and the new
// column (score s1, value v1)
template <typename TO>
__device__ __forceinline__ void finish(TO* o, float mw, float lw, float aw,
                                       float s1, float v1) {
  const float mf = fmaxf(mw, s1);
  const float corr = expf(mw - mf);
  const float p1 = expf(s1 - mf);
  from_f(o, (aw * corr + p1 * v1) / (lw * corr + p1));
}

// bf16 q and bf16 cache take the tensor-core pass when a KV head has
// several query heads (GC = 8); G = 1 has none to share a key with
template <typename TQ, typename TC, int GC>
constexpr bool kOnTensorCores = std::is_same<TQ, __nv_bfloat16>::value &&
                                std::is_same<TC, __nv_bfloat16>::value &&
                                GC == kMmaHeads;

template <typename TQ, typename TC, typename TO, int HD, int GC>
__global__ void __launch_bounds__(kThreads, kOnTensorCores<TQ, TC, GC> ? 2 : 1)
decode_attn_kernel(
    const TQ* __restrict__ q,        // [B, Hkv, G, hd]
    const TC* __restrict__ kc,       // [B, Hkv, T, hd] (one layer)
    const TC* __restrict__ vc,
    const TQ* __restrict__ kn,       // [B, Hkv, hd]
    const TQ* __restrict__ vn,
    const int32_t* __restrict__ offsets,  // [B]
    TO* __restrict__ out,            // [B, Hkv, G, hd]
    float* __restrict__ part,        // [B * Hkv, splits, G, hd + 2] or null
    int Hkv, int G, int T, int window, int span, float inv) {
  constexpr bool kMma = kOnTensorCores<TQ, TC, GC>;
  __shared__ float red_acc[kWarps][GC][HD];
  __shared__ float red_m[kWarps][GC], red_l[kWarps][GC];
  __shared__ __align__(16) TQ s_q[kGMax * HD];
  __shared__ __align__(16) TQ s_kn[HD], s_vn[HD];

  const int split = blockIdx.x, bh = blockIdx.y, splits = gridDim.x;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool whole = splits == 1;
  const TQ* qb = q + static_cast<size_t>(bh) * G * HD;
  if (whole)
    prefetch_new<TQ, HD>(s_q, s_kn, s_vn, qb, kn + static_cast<size_t>(bh) * HD,
                         vn + static_cast<size_t>(bh) * HD, G, tid);
  const int off = min(max(offsets[b], 0), T);
  const int t_lo = window > 0 ? max(0, off - window + 1) : 0;
  // this block's split of [t_lo, off), set by the row alone
  const int s_lo = t_lo + split * span;
  const int s_hi = min(off, s_lo + span);
  if (!whole && s_lo >= s_hi) return;
  // this warp's contiguous share of the split (whole warp steps on the
  // tensor cores)
  constexpr int quantum = kMma ? kStep : 1;
  const int share = (s_hi - s_lo + kWarps * quantum - 1) / (kWarps * quantum) * quantum;
  const int w_lo = min(s_hi, s_lo + warp * share);
  const int w_hi = min(s_hi, w_lo + share);
  const size_t cache_row = static_cast<size_t>(bh) * T * HD;

  for (int g0 = 0; g0 < G; g0 += GC) {
    if constexpr (kMma)
      warp_pass_mma<HD>(qb, kc + cache_row, vc + cache_row, G, g0, w_lo, w_hi,
                        inv, lane, red_acc[warp], red_m[warp], red_l[warp]);
    else
      warp_pass_cores<TQ, TC, HD, GC>(qb, kc + cache_row, vc + cache_row, G,
                                      g0, w_lo, w_hi, inv, lane, red_acc[warp],
                                      red_m[warp], red_l[warp]);
    if (whole) cp_async_wait_all();
    __syncthreads();

    // one thread per (head, dimension), a warp's 32 dimensions of one head:
    // the warps' states in warp order, then the new column and the store,
    // or the split's state to scratch
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
      const size_t row = static_cast<size_t>(bh) * G + g;
      if (whole) {
        const float s1 = new_score<TQ, HD>(s_q + g * HD, s_kn, lane, inv);
        finish(out + row * HD + e, mw, lw, aw, s1, to_f(s_vn[e]));
      } else {
        float* pr = part + ((static_cast<size_t>(bh) * splits + split) * G + g) * (HD + 2);
        pr[e] = aw;
        if (e == 0) {
          pr[HD] = mw;
          pr[HD + 1] = lw;
        }
      }
    }
    __syncthreads();   // the next group of heads reuses the buffers
  }
}

// sum or max over the block's HD threads (HD / 32 warps), in a fixed tree
template <int HD, bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();                       // s_red's last readers are done
  if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = v;
  __syncthreads();
  v = s_red[0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) v = kMax ? fmaxf(v, s_red[w]) : v + s_red[w];
  return v;
}

// One block per (head g, row x KV head), a thread per dimension: the live
// splits' states in split order, then the new column and the store.
template <typename TQ, typename TO, int HD>
__global__ void __launch_bounds__(HD) decode_attn_kernel_merge(
    const TQ* __restrict__ q, const TQ* __restrict__ kn,
    const TQ* __restrict__ vn, const int32_t* __restrict__ offsets,
    const float* __restrict__ part, TO* __restrict__ out, int Hkv, int G,
    int T, int window, int span, int splits, float inv) {
  constexpr int kChunk = 256;            // splits whose weights smem holds
  __shared__ float s_f[kChunk], s_l[kChunk], s_red[HD / 32];
  const int g = blockIdx.x, bh = blockIdx.y, b = bh / Hkv, e = threadIdx.x;
  const size_t row = static_cast<size_t>(bh) * G + g;
  const float qe = to_f(q[row * HD + e]);
  const float ke = to_f(kn[static_cast<size_t>(bh) * HD + e]);
  const float ve = to_f(vn[static_cast<size_t>(bh) * HD + e]);
  const int off = min(max(offsets[b], 0), T);
  const int t_lo = window > 0 ? max(0, off - window + 1) : 0;
  const int live = (off - t_lo + span - 1) / span;
  const size_t stride = static_cast<size_t>(G) * (HD + 2);   // per split
  const float* pr = part + (static_cast<size_t>(bh) * splits * G + g) * (HD + 2);
  float mx = kNeg;
  for (int s = e; s < live; s += HD) mx = fmaxf(mx, pr[s * stride + HD]);
  const float mw = block_reduce<HD, true>(mx, s_red);
  const float s1 = block_reduce<HD, false>(qe * ke, s_red) * inv;
  float lw = 0.f, aw = 0.f;
  for (int c0 = 0; c0 < live; c0 += kChunk) {
    const int n = min(kChunk, live - c0);
    for (int s = e; s < n; s += HD) {
      const float* ps = pr + (c0 + s) * stride;
      s_f[s] = expf(ps[HD] - mw);
      s_l[s] = ps[HD + 1];
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      lw += s_l[s] * s_f[s];
      aw += pr[(c0 + s) * stride + e] * s_f[s];
    }
    __syncthreads();
  }
  finish(out + row * HD + e, mw, lw, aw, s1, ve);
}

template <typename TQ, typename TC, typename TO, int HD, int GC>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, const int32_t* offsets,
                   void* out, float* part, int B, int Hkv, int G, int T,
                   int window, int span, float inv, cudaStream_t s) {
  const int splits = (T + span - 1) / span;
  decode_attn_kernel<TQ, TC, TO, HD, GC><<<dim3(splits, B * Hkv), kThreads, 0, s>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), offsets, static_cast<TO*>(out), part, Hkv,
      G, T, window, span, inv);
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_attn_kernel_merge<TQ, TO, HD><<<dim3(G, B * Hkv), HD, 0, s>>>(
        static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
        static_cast<const TQ*>(vn), offsets, part, static_cast<TO*>(out), Hkv,
        G, T, window, span, splits, inv);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TC, typename TO, int HD>
cudaError_t by_heads(const void* q, const void* kc, const void* vc,
                     const void* kn, const void* vn, const int32_t* offsets,
                     void* out, float* part, int B, int Hkv, int G, int T,
                     int window, int span, float inv, cudaStream_t s) {
  if (G == 1)
    return launch<TQ, TC, TO, HD, 1>(q, kc, vc, kn, vn, offsets, out, part, B,
                                     Hkv, G, T, window, span, inv, s);
  return launch<TQ, TC, TO, HD, kOnTensorCores<TQ, TC, kMmaHeads> ? kMmaHeads : 4>(
      q, kc, vc, kn, vn, offsets, out, part, B, Hkv, G, T, window, span, inv, s);
}

template <typename TQ, typename TC, typename TO>
cudaError_t by_shape(const void* q, const void* kc, const void* vc,
                     const void* kn, const void* vn, const int32_t* offsets,
                     void* out, float* part, int B, int Hkv, int G, int T,
                     int hd, int window, int span, float inv, cudaStream_t s) {
  if (hd == 128)
    return by_heads<TQ, TC, TO, 128>(q, kc, vc, kn, vn, offsets, out, part, B,
                                     Hkv, G, T, window, span, inv, s);
  return by_heads<TQ, TC, TO, 64>(q, kc, vc, kn, vn, offsets, out, part, B,
                                  Hkv, G, T, window, span, inv, s);
}

template <typename TQ, typename TC>
cudaError_t by_out(int out_bf16, const void* q, const void* kc, const void* vc,
                   const void* kn, const void* vn, const int32_t* offsets,
                   void* out, float* part, int B, int Hkv, int G, int T,
                   int hd, int window, int span, float inv, cudaStream_t s) {
  if (out_bf16)
    return by_shape<TQ, TC, __nv_bfloat16>(q, kc, vc, kn, vn, offsets, out,
                                           part, B, Hkv, G, T, hd, window,
                                           span, inv, s);
  return by_shape<TQ, TC, float>(q, kc, vc, kn, vn, offsets, out, part, B, Hkv,
                                 G, T, hd, window, span, inv, s);
}

template <typename TQ>
cudaError_t by_cache(int cache_bf16, int out_bf16, const void* q,
                     const void* kc, const void* vc, const void* kn,
                     const void* vn, const int32_t* offsets, void* out,
                     float* part, int B, int Hkv, int G, int T, int hd,
                     int window, int span, float inv, cudaStream_t s) {
  if (cache_bf16)
    return by_out<TQ, __nv_bfloat16>(out_bf16, q, kc, vc, kn, vn, offsets, out,
                                     part, B, Hkv, G, T, hd, window, span, inv,
                                     s);
  return by_out<TQ, float>(out_bf16, q, kc, vc, kn, vn, offsets, out, part, B,
                           Hkv, G, T, hd, window, span, inv, s);
}

}  // namespace

// Returns 0 or a cudaError_t of the launches; -1 for arguments the kernel
// does not take (the Python wrapper checks them first).  `span` keys a
// split (a multiple of 16); `part` is scratch of B * Hkv * ceil(T / span)
// * G * (hd + 2) floats, unused (and may be null) when T <= span.
extern "C" int amq_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* k_new,
                                    const void* v_new, const int32_t* offsets,
                                    void* out, void* part, int q_bf16,
                                    int cache_bf16, int out_bf16, int B,
                                    int Hkv, int G, int T, int hd, int window,
                                    int span, void* stream) {
  if ((hd != 64 && hd != 128) || G < 1 || G > kGMax || B < 1 || T < 1 ||
      span < kStep || span % kStep != 0 || (T > span && part == nullptr))
    return -1;
  const float inv = 1.f / sqrtf(static_cast<float>(hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t e;
  if (q_bf16)
    e = by_cache<__nv_bfloat16>(cache_bf16, out_bf16, q, k_cache, v_cache,
                                k_new, v_new, offsets, out, p, B, Hkv, G, T,
                                hd, window, span, inv, s);
  else
    e = by_cache<float>(cache_bf16, out_bf16, q, k_cache, v_cache, k_new,
                        v_new, offsets, out, p, B, Hkv, G, T, hd, window,
                        span, inv, s);
  return static_cast<int>(e);
}
