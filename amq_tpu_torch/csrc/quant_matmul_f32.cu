// The float32 decode GEMV (M <= 8) on tensor cores, and the split pass that
// feeds it and the tile kernel's float32 form.
//
// Replaces the float32 form of the Pallas kernels of the JAX package's
// ops/quant_matmul.py -- quant_matmul_indexed (_qmm_kernel_stacked),
// quant_matmul_swiglu_indexed (_qmm_kernel_swiglu) and quant_matmul
// (_qmm_kernel) with f32 activations (acc_dtype = f32): _dequant_tile in
// f32, then a dot at preferred_element_type f32 (quant_matmul.py:359-384,
// :519-538, :785-808).  It computes that function: sum_k (c_k - z) s x_k
// per column, rewritten per group as s sum c x - (z s) sum x.
//
// Bound on the H100: bytes, as the bf16 grouped GEMV (quant_matmul.cu):
// the packed words and meta once per call.  So the design keeps the bf16
// GEMV's ring (qmm_grouped.cuh: producer warp, bulk copies, 256 columns a
// block, K split over blocks by the same plan) and its words, and changes
// only what crosses the tensor cores (qmm_tile.cuh, "The float32 form"):
// codes exact in bf16 against x split once into three bf16 parts (hi, mid,
// lo: x's 24 bits), f32 accumulation, the group's scale and zero applied
// in f32 afterwards.  The alternative, split TF32 (the codes are exact in
// TF32 too, x in hi + lo), runs two products at TF32's half rate; the bf16
// parts run three at the bf16 rate, and up to M = 2 the three parts fill
// the n8 columns an M = 1 call leaves empty (mma.sync m16n8k16), so the
// MMAs a step are the bf16 GEMV's.  From M = 3 the parts take three n8
// column groups (J = 3, one block an SM: its accumulators do not fit the
// two-block register budget).  The SwiGLU prologue (silu(g) * u in f32, no
// rounding, as the plain version) is the split pass's, once per element.
// Row m's columns, corrections and sums are the same at every M, and the
// splits come from the M = 2 kernel's occupancy (two blocks an SM, as the
// bf16 GEMV; M > 2 then runs in two waves), so row m has the same bits at
// any M; two calls are equal (fixed-order sums).
//
// Entries: amq_split_f32 (the split pass), amq_qmm_grouped_f32 (the GEMV;
// amq_qmm's arguments, x the split pass's bf16 parts [M][3][K]),
// amq_qmm_grouped_f32_blocks (its blocks per SM).

#include "qmm_grouped.cuh"

using namespace amq;

namespace {

// The split pass: x [M, K] f32 (row stride ldx; with u, silu(x) * u in
// f32) split into bf16 parts q = 0, 1, 2 (hi, mid, lo).  `chunk` 0 (the
// GEMV): xsp [M][3][K], row 3m + q.  `chunk` 16, 32 or 64 (the tile
// kernel's 2 ns): xsp is the tile kernel's x slot image, per chunk of K
// rows and part [mpad rows][128 bytes] in its 128-byte swizzle (the 16
// bytes of piece c of row m at piece c ^ (m % 8); zeros past K), so that
// one bulk copy brings a part's rows, and xsc [Kp / chunk][mpad] the f32
// sums of x over each chunk.  Grid (ceil(Kp / 2048), M), 256 threads of
// eight elements each; rows of the image past M are not written.
__global__ void split_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ u, int K, int ldx,
                                 int Kp, __nv_bfloat16* __restrict__ xsp,
                                 float* __restrict__ xsc, int chunk,
                                 int mpad) {
  const int m = blockIdx.y;
  const int k = blockIdx.x * 2048 + 8 * threadIdx.x;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (k < K) {
    const size_t i = static_cast<size_t>(m) * ldx + k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 xv = *reinterpret_cast<const float4*>(x + i + 4 * h);
      v[4 * h] = xv.x; v[4 * h + 1] = xv.y;
      v[4 * h + 2] = xv.z; v[4 * h + 3] = xv.w;
      if (u != nullptr) {
        const float4 uv = *reinterpret_cast<const float4*>(u + i + 4 * h);
        v[4 * h] = silu_mul(v[4 * h], uv.x);
        v[4 * h + 1] = silu_mul(v[4 * h + 1], uv.y);
        v[4 * h + 2] = silu_mul(v[4 * h + 2], uv.z);
        v[4 * h + 3] = silu_mul(v[4 * h + 3], uv.w);
      }
    }
  }
  if (k < (chunk ? Kp : K)) {
    float r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = v[e];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      // part q of the eight: each rounded to bf16, the rest kept (exact)
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 p = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
        const float2 f = __bfloat1622float2(p);
        r[2 * e] -= f.x;
        r[2 * e + 1] -= f.y;
        o[e] = *reinterpret_cast<uint32_t*>(&p);
      }
      size_t at;
      if (chunk == 0) {
        at = (static_cast<size_t>(m) * 3 + q) * K + k;
      } else {
        const int c = (k % chunk) / 8;
        at = ((static_cast<size_t>(k / chunk) * 3 + q) * mpad + m) * 64 +
             8 * (c ^ (m & 7));
      }
      *reinterpret_cast<uint4*>(xsp + at) = out;
    }
  }
  if (chunk == 0) return;
  // the chunk's sum: this thread's eight in order, then a fixed tree over
  // the chunk / 8 lanes that hold it
  float s = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
  for (int o = 1; o < chunk / 8; o <<= 1) s += __shfl_xor_sync(~0u, s, o);
  if ((threadIdx.x & (chunk / 8 - 1)) == 0 && k < Kp)
    xsc[static_cast<size_t>(k / chunk) * mpad + m] = s;
}

// Blocks per SM of the float32 GEMV: J = 1 keeps the bf16 GEMV's two.
template <int J>
constexpr int exact_min_blocks() {
  return J == 1 ? 2 : 1;
}

// Consumer warps of the whole-stage kernel: the S stages of the split from
// stage st_lo into tot.
template <int BITS, int J>
__device__ void exact_consume(const GemvArgs& a, const GroupedRing& r, int S,
                              float (&tot)[J][kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wcol = warp * 16 * kGTiles;
  const int lg_share = __ffs(P / r.slots) - 1;     // rounds per slot: 2^lg
  for (int s = 0; s < S; ++s) {
    mbar_wait(ring_full(s), (s / kGStages) & 1);
    const unsigned char* st = ring_stage(r, s);
    exact_stage<BITS, J>(
        reinterpret_cast<const uint32_t*>(st),
        reinterpret_cast<const __nv_bfloat16*>(st + r.lay.x_off),
        3 * a.op.M, st + r.lay.meta_off, r.es, lg_share, wcol, lane, tot);
    __syncwarp();                  // the warp is done with the slot
    if (lane == 0) mbar_arrive(ring_empty(s));
  }
}

// Consumer warps of the spanning kernel (SPS-step superblocks; SPS = 0:
// the 4-row superblocks' round pairs).
template <int BITS, int SPS, int J>
__device__ void exact_span_consume(const GemvArgs& a, const GroupedRing& r,
                                   int span, int st_lo, int S,
                                   float (&tot)[J][kGTiles][4]) {
  using F = GroupedForm<BITS>;
  constexpr int P = F::rounds;
  constexpr int sb = span_superblock<BITS, SPS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wcol = warp * 16 * kGTiles;
  const int per_sb = r.slots / span;
  const int lg_share = __ffs(P / per_sb) - 1;       // rounds per slot: 2^lg
  const int sb_meta = 2 * per_sb * kGBN * r.es;     // meta bytes of each
  for (int s = 0; s < S; ++s) {
    mbar_wait(ring_full(s), (s / kGStages) & 1);
    const unsigned char* st = ring_stage(r, s);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + r.lay.x_off);
    const int parts = min(span, a.Kp / sb - (st_lo + s) * span);
    const unsigned char* meta = st + r.lay.meta_off;
    if constexpr (SPS == 0) {
      if (parts == span)
        exact_span_pair_stage<BITS, J, true>(ws, xs, 3 * a.op.M, meta, r.es,
                                             lg_share, sb_meta, parts, wcol,
                                             lane, tot);
      else
        exact_span_pair_stage<BITS, J, false>(ws, xs, 3 * a.op.M, meta, r.es,
                                              lg_share, sb_meta, parts, wcol,
                                              lane, tot);
    } else {
      if (parts == span)
        exact_span_stage<BITS, SPS, J, true>(ws, xs, 3 * a.op.M, meta, r.es,
                                             lg_share, sb_meta, parts, wcol,
                                             lane, tot);
      else
        exact_span_stage<BITS, SPS, J, false>(ws, xs, 3 * a.op.M, meta, r.es,
                                              lg_share, sb_meta, parts, wcol,
                                              lane, tot);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring_empty(s));
  }
}

// tot into out [M, N] (split < 0) or split's f32 partials: row m's value is
// its three part columns 3m + q summed in order q = 0, 1, 2, gathered from
// the lanes that hold them (column c: group c / 8, lane t = (c % 8) / 2,
// register parity c % 2).
template <int J>
__device__ __forceinline__ void exact_store(const GemvArgs& a,
                                            const float (&tot)[J][kGTiles][4],
                                            int col0, int split) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp * 16 * kGTiles;
  constexpr int kRows = 8 * J / 3;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m >= a.op.M) break;                        // warp-uniform
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int h = 0; h < 2; ++h) {               // columns 2g, 2g + 1
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int c = 3 * m + q;
          v += __shfl_sync(~0u, tot[c >> 3][ct][2 * h + (c & 1)],
                           4 * g + ((c & 7) >> 1));
        }
        const int n = col0 + wcol + 16 * ct + 2 * g + h;
        if (t != 0 || n >= a.N) continue;
        if (split < 0)
          store_f(a.out, static_cast<size_t>(m) * a.N + n, v, a.out_bf16);
        else
          a.partial[(static_cast<size_t>(split) * a.op.M + m) * a.N + n] = v;
      }
  }
}

template <int J>
__device__ __forceinline__ void exact_zero(float (&tot)[J][kGTiles][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int ct = 0; ct < kGTiles; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[j][ct][i] = 0.f;
}

// The float32 grouped GEMV at whole-stage layouts: grid (ceil(N / kGBN),
// splits), as qmm_grouped_kernel.
template <int BITS, int J>
__global__ void __launch_bounds__((kGWarps + 1) * 32, exact_min_blocks<J>())
    qmm_grouped_f32_kernel(GemvArgs a) {
  const GroupedRing r = grouped_ring<BITS, true>(a, true);
  const int col0 = blockIdx.x * kGBN;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = grouped_stages<BITS>(a, st_lo);
  if (threadIdx.x >> 5 == kGWarps) {
    for (int j = 0; j < S; ++j)
      grouped_issue<BITS, true>(a, r, col0, st_lo + j, j, threadIdx.x & 31,
                                kIssueAll);
    return;
  }
  float tot[J][kGTiles][4];
  exact_zero<J>(tot);
  exact_consume<BITS, J>(a, r, S, tot);
  exact_store<J>(a, tot, col0, gridDim.y == 1 ? -1 : blockIdx.y);
}

// ... at spanning layouts of SPS-step superblocks, as
// qmm_grouped_span_kernel (SPS = 0: the 4-row superblocks' pair form, 1
// and 3 bits at 128 rows).
template <int BITS, int SPS, int J>
__global__ void __launch_bounds__((kGWarps + 1) * 32, exact_min_blocks<J>())
    qmm_grouped_f32_span_kernel(GemvArgs a) {
  static_assert(BITS != 8, "8-bit superblocks hold whole stages");
  constexpr int span = GroupedForm<BITS>::n / (SPS == 0 ? 4 : 8 * SPS);
  const GroupedRing r = grouped_ring<BITS, true>(a, true, span);
  const int col0 = blockIdx.x * kGBN;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = span_stages(a, span, st_lo);
  if (threadIdx.x >> 5 == kGWarps) {
    for (int j = 0; j < S; ++j)
      span_issue<BITS, true>(a, r, span, col0, st_lo + j, j, threadIdx.x & 31);
    return;
  }
  float tot[J][kGTiles][4];
  exact_zero<J>(tot);
  exact_span_consume<BITS, SPS, J>(a, r, span, st_lo, S, tot);
  exact_store<J>(a, tot, col0, gridDim.y == 1 ? -1 : blockIdx.y);
}

template <int BITS, int J>
cudaError_t exact_allow(size_t smem) {
  static size_t allowed = 0;
  return allow_smem(qmm_grouped_f32_kernel<BITS, J>, smem, allowed);
}

template <int BITS, int SPS, int J>
cudaError_t exact_span_allow(size_t smem) {
  static size_t allowed = 0;
  return allow_smem(qmm_grouped_f32_span_kernel<BITS, SPS, J>, smem, allowed);
}

// f(kernel, allow) with the kernel of this call's layout and J (spanning:
// span_form's SPS = 0, 1 and 2 forms), or cudaErrorInvalidValue for a
// layout without one.
template <int BITS, int J, class Fn>
cudaError_t with_exact_kernel(int sb, Fn f) {
  if (grouped_whole_stages(BITS, sb))
    return f(qmm_grouped_f32_kernel<BITS, J>, exact_allow<BITS, J>);
  if constexpr (span_form<BITS, 0>())
    if (sb == span_superblock<BITS, 0>())
      return f(qmm_grouped_f32_span_kernel<BITS, 0, J>,
               exact_span_allow<BITS, 0, J>);
  if constexpr (span_form<BITS, 1>())
    if (sb == span_superblock<BITS, 1>())
      return f(qmm_grouped_f32_span_kernel<BITS, 1, J>,
               exact_span_allow<BITS, 1, J>);
  if constexpr (span_form<BITS, 2>())
    if (sb == span_superblock<BITS, 2>())
      return f(qmm_grouped_f32_span_kernel<BITS, 2, J>,
               exact_span_allow<BITS, 2, J>);
  return cudaErrorInvalidValue;
}

template <int BITS, int J>
cudaError_t launch_exact(const GemvArgs& a, int splits, cudaStream_t stream) {
  const size_t smem = grouped_smem<BITS>(a.op.M, false, a.w.meta_bf16,
                                         a.w.superblock, a.w.group_size, true);
  return with_exact_kernel<BITS, J>(
      a.w.superblock, [&](auto kernel, auto allow) {
        cudaError_t e = allow(smem);
        if (e != cudaSuccess) return e;
        dim3 grid((a.N + kGBN - 1) / kGBN, splits);
        kernel<<<grid, (kGWarps + 1) * 32, smem, stream>>>(a);
        return cudaGetLastError();
      });
}

template <int BITS>
cudaError_t dispatch_exact(const GemvArgs& a, int splits, cudaStream_t s) {
  return a.op.M <= 2 ? launch_exact<BITS, 1>(a, splits, s)
                     : launch_exact<BITS, 3>(a, splits, s);
}

// Blocks of the M = 2 kernel (J = 1: one stream, two, and speculative
// rounds of the one-token draft) one SM holds, or -1 on an error.  Every M
// splits alike by it, so M > 2 (J = 3, one block an SM) runs in more than
// one wave.
template <int BITS>
int exact_blocks(int meta_bf16, int sb, int gs) {
  const size_t smem = grouped_smem<BITS>(2, false, meta_bf16, sb, gs, true);
  int n = -1;
  with_exact_kernel<BITS, 1>(sb, [&](auto kernel, auto allow) {
    if (allow(smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, (kGWarps + 1) * 32, smem) != cudaSuccess) {
      cudaGetLastError();
      n = -1;
    }
    return cudaSuccess;
  });
  return n;
}

// The layouts the float32 GEMV takes: the bf16 GEMV's (grouped_takes).
bool exact_takes(const void* x, int x_bf16, const int32_t* packed,
                 const void* scale, const void* zero, int M, int K, int ldx,
                 int Kp, int Np, int nbits, int gs, int sb) {
  return grouped_takes(x, nullptr, x_bf16, packed, scale, zero, M, K, ldx, Kp,
                       Np, nbits, gs, sb, true);
}

}  // namespace

// The split pass (see split_f32_kernel: `chunk` 0, or 16 / 32 / 64 with
// xsc and mpad >= M rows of the image); -1 for arguments it does not take.
extern "C" int amq_split_f32(const void* x, const void* u, int M, int K,
                             int ldx, int Kp, void* xsp, float* xsc,
                             int chunk, int mpad, void* stream) {
  if (M < 1 || K % 8 || ldx % 4 || Kp % 64 || K > Kp || !aligned16(x) ||
      (u != nullptr && !aligned16(u)) || !aligned16(xsp) ||
      (chunk != 0 && ((chunk != 16 && chunk != 32 && chunk != 64) ||
                      xsc == nullptr || mpad < M || mpad % 4)))
    return -1;
  dim3 grid((Kp + 2047) / 2048, M);
  split_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), K, ldx, Kp,
      static_cast<__nv_bfloat16*>(xsp), xsc, chunk, mpad);
  return static_cast<int>(cudaGetLastError());
}

// The float32 grouped GEMV: amq_qmm_grouped's arguments, x the split
// pass's parts [M][3][K] (x_bf16 1, ldx K, u null); -1 for a call it does
// not take.
extern "C" int amq_qmm_grouped_f32(const void* x, const void* u, int x_bf16,
                                   const int32_t* packed, const void* scale,
                                   const void* zero, int meta_bf16, void* out,
                                   int out_bf16, float* partial, int M, int K,
                                   int ldx, int Kp, int N, int Np, int nbits,
                                   int group_size, int superblock, int splits,
                                   int sb_per_split, void* stream) {
  const int spb = nbits == 8 ? superblock / 4 / GroupedForm<8>::n : 1;
  if (u != nullptr ||
      !exact_takes(x, x_bf16, packed, scale, zero, M, K, ldx, Kp, Np, nbits,
                   group_size, superblock) ||
      splits < 1 || sb_per_split < 1 || sb_per_split % spb ||
      (splits > 1 && partial == nullptr))
    return -1;
  GemvArgs a{Operand{x, nullptr, 1, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nbits) {
    case 1: e = dispatch_exact<1>(a, splits, s); break;
    case 2: e = dispatch_exact<2>(a, splits, s); break;
    case 3: e = dispatch_exact<3>(a, splits, s); break;
    case 4: e = dispatch_exact<4>(a, splits, s); break;
    default: e = dispatch_exact<8>(a, splits, s); break;
  }
  return finish_splits(e, partial, out, M * N, splits, out_bf16, s);
}

// Blocks of the float32 GEMV one SM holds at its M = 2 form (the split
// rule's wave), or -1 on an error or a layout it does not take.
extern "C" int amq_qmm_grouped_f32_blocks(int nbits, int meta_bf16,
                                          int group_size, int superblock) {
  switch (nbits) {
    case 1: return exact_blocks<1>(meta_bf16, superblock, group_size);
    case 2: return exact_blocks<2>(meta_bf16, superblock, group_size);
    case 3: return exact_blocks<3>(meta_bf16, superblock, group_size);
    case 4: return exact_blocks<4>(meta_bf16, superblock, group_size);
    case 8: return exact_blocks<8>(meta_bf16, superblock, group_size);
    default: return -1;
  }
}
