// The decode MLP of one layer, down(swiglu(gateup(x))), in one launch, in
// the grouped form on tensor cores.
//
// Replaces the JAX package's ops/quant_matmul.py::quant_matmul_mlp_indexed
// (_qmm_kernel_mlp), which its AMQ_MLP_KERNEL switch selects at decode
// (M <= 8, bf16).  The TPU kernel runs one sequential grid: phase-1 steps
// accumulate the gateup GEMV (_gemv_blockdiag) into a bf16 VMEM scratch,
// phase-2 steps apply SwiGLU to slices of it and run the down GEMV
// (_gemv_blockdiag again), so the gateup output never leaves the chip and
// down's first weight tiles stream in while gateup's last ones compute.
//
// Bound on the H100: bytes (both layers' packed words and scale/zero read
// once, a few operations per weight).  A Hopper grid has no sequential
// axis to carry that scratch, so this is one cooperative launch (all
// blocks resident at once) of grouped-ring blocks (qmm_grouped.cuh: a
// producer warp, bulk copies, full / empty mbarriers, 256 columns per
// block), one block per (column tile, K split) item of the larger
// product; a block runs at most one item of each, through one ring whose
// stage count runs on, so its barriers re-arm from gateup to down:
//   1. gateup items write f32 partials; then the producer issues the words
//      and meta of its block's first down stages, which do not depend on
//      the activations (the one thing the fused kernel can do that the
//      separate pair cannot: they stream in across the grid barriers);
//   2. every thread of the grid takes a share of the activation: the
//      partials summed in split order, gate and up rounded to bf16 (the
//      reference's bf16 scratch), silu(gate) * up in f32 rounded to bf16,
//      zero at or past the real intermediate width, into a bf16 [M, Kp_d]
//      buffer;
//   3. down items over that activation (the producer issues the
//      activation rows of the prefetched stages, then whole stages),
//      written out or as f32 partials;
//   4. when down's K is split, the grid sums its partials in split order
//      into the output, rounded once.
// A grid barrier separates each stage from the next.  The gateup and down
// splits are the separate grouped calls' (the wrapper passes them), and
// every sum has the separate chain's fixed order, so the result equals the
// separate gateup -> SwiGLU-down chain of grouped GEMVs bit for bit, and
// two calls give the same bits.  The scratch round trip (the M x 22016
// partials of a few splits, M x 11264 activations at Llama-2-7B) is under
// 1 % of the weight bytes and stays in the 50 MB L2.  (Tried on the H100
// and not kept: activation chunks computed by their last gateup
// contributor and flagged to down's producers instead of stages 2's
// barriers, slower, since every gateup item ends in the same wave; and
// down's split sum by each tile's last split behind a ticket, which made
// ptxas spill at 1 and 2 bits.)

#include <cooperative_groups.h>

#include "qmm_grouped.cuh"

namespace cg = cooperative_groups;
using namespace amq;

namespace {

struct MlpArgs {
  GemvArgs gu;            // x [M, K_gu] -> f32 partials gu.partial
  GemvArgs dn;            // act [M, Kp_d] -> out, or partials dn.partial
  int splits_gu, splits_d, inter;
  // column tiles and (tile, split) items of each product (reckoned on the
  // host, so that they are no registers of the kernel)
  int tiles_gu, tiles_d, items_gu, items_d;
  __nv_bfloat16* act;     // [M, Kp_d]
};

// Generic stores of global memory before (writer) or after (reader) the
// grid barrier, ordered with the bulk copies (async proxy) that read them.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Stage 2: the gateup partials summed in split order, gate and up rounded
// to bf16, silu(gate) * up in f32 rounded to bf16 (zero at or past the
// real intermediate width) into the bf16 activation; every thread of the
// grid takes a share.
__device__ __forceinline__ void mlp_swiglu(const MlpArgs& a) {
  const int M = a.gu.op.M, Kp_d = a.dn.op.K;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M * Kp_d;
       i += gridDim.x * blockDim.x) {
    const int m = i / Kp_d, j = i - m * Kp_d;
    float v = 0.f;
    if (j < a.inter) {
      float g = 0.f, u = 0.f;
      for (int s = 0; s < a.splits_gu; ++s) {
        const float* p =
            a.gu.partial + (static_cast<size_t>(s) * M + m) * a.gu.N;
        g += p[j];
        u += p[a.inter + j];
      }
      v = silu_mul(round_bf16(g), round_bf16(u));
    }
    a.act[i] = __float2bfloat16(v);
  }
  fence_proxy_async_global();
}

// Stage 4: down's split partials summed in split order into the output,
// rounded once.
__device__ __forceinline__ void mlp_sum_splits(const MlpArgs& a) {
  const int MN = a.gu.op.M * a.dn.N;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < a.splits_d; ++s)
      v += a.dn.partial[static_cast<size_t>(s) * MN + i];
    store_f(a.dn.out, i, v, a.dn.out_bf16);
  }
}

// Consumer warps: block b's item of one product (column tile b % tiles, K
// split b / tiles), from the block's ring stage `count`; returns the count
// after it.  `direct`: write the output, else the split's partials.  At
// 1-4 bits it takes the pipelined consumer (rounds in a loop at every
// width; the same products and sums in the same order as the grouped
// GEMV's, so the same bits): of the choices tried, the one ptxas fits in
// the launch bound's 96 registers at every width without a spill.
template <int BITS>
__device__ __forceinline__ int mlp_consume(const GemvArgs& g,
                                           const GroupedRing& r, int tiles,
                                           int items, int count,
                                           bool direct) {
  if (blockIdx.x >= items) return count;
  const int st_lo = blockIdx.x / tiles * g.sb_per_split;
  float tot[kGTiles][4];
  grouped_consume<BITS, BITS != 8>(g, r, st_lo,
                                   grouped_stages<BITS>(g, st_lo), count,
                                   tot);
  grouped_store(g, tot, blockIdx.x % tiles * kGBN,
                direct ? -1 : blockIdx.x / tiles);
  return count;
}

// Producer warp: stages [lo, hi) of block b's item of one product (clipped
// to the item's), as the block's ring stages count + j, with `parts` of
// each.  Returns the item's stages (0 for a block without one).
template <int BITS>
__device__ __forceinline__ int mlp_produce(const GemvArgs& g,
                                           const GroupedRing& r, int tiles,
                                           int items, int count, int lo,
                                           int hi, int parts) {
  if (blockIdx.x >= items) return 0;
  const int st_lo = blockIdx.x / tiles * g.sb_per_split;
  const int S = grouped_stages<BITS>(g, st_lo);
  for (int j = lo; j < min(hi, S); ++j)
    grouped_issue<BITS>(g, r, blockIdx.x % tiles * kGBN, st_lo + j,
                        count + j, threadIdx.x & 31, parts);
  return S;
}

// 1-D grid of co-resident blocks, one per item of the larger product
// (every block holds at most one item of each, so that nothing but the
// grouped GEMV's own state lives across a product); (kGWarps + 1) warps
// each, split into roles as the grouped GEMV's are: the producer warp and
// the consumer warps each walk both products on a path of their own and
// meet the grid's other warps at its barriers (every thread takes all
// three, or two when down's K is not split).
template <int BITS>
__global__ void __launch_bounds__((kGWarps + 1) * 32, 2)
    qmm_mlp_kernel(const __grid_constant__ MlpArgs a) {
  cg::grid_group grid = cg::this_grid();
  const GroupedRing r = grouped_ring<BITS>(a.gu, true);
  constexpr int kEnd = 1 << 30;
  if (threadIdx.x >> 5 == kGWarps) {
    const int count = mlp_produce<BITS>(a.gu, r, a.tiles_gu, a.items_gu, 0,
                                        0, kEnd, kIssueAll);
    // the words and meta of down's first stages do not depend on the
    // activations: they stream in across the grid barriers
    mlp_produce<BITS>(a.dn, r, a.tiles_d, a.items_d, count, 0, kGStages,
                      kIssueWeights);
    grid.sync();
    mlp_swiglu(a);
    grid.sync();
    fence_proxy_async_global();
    mlp_produce<BITS>(a.dn, r, a.tiles_d, a.items_d, count, 0, kGStages,
                      kIssueActs);
    mlp_produce<BITS>(a.dn, r, a.tiles_d, a.items_d, count, kGStages, kEnd,
                      kIssueAll);
  } else {
    const int count =
        mlp_consume<BITS>(a.gu, r, a.tiles_gu, a.items_gu, 0, false);
    grid.sync();
    mlp_swiglu(a);
    grid.sync();
    mlp_consume<BITS>(a.dn, r, a.tiles_d, a.items_d, count,
                      a.splits_d == 1);
  }
  if (a.splits_d == 1) return;
  grid.sync();
  mlp_sum_splits(a);
}

template <int BITS>
cudaError_t launch(const MlpArgs& a, cudaStream_t stream) {
  auto kernel = qmm_mlp_kernel<BITS>;
  constexpr int threads = (kGWarps + 1) * 32;
  const size_t smem = grouped_smem<BITS>(a.gu.op.M, false, a.gu.w.meta_bf16,
                                         a.gu.w.superblock,
                                         a.gu.w.group_size);
  static size_t allowed = 0, counted = 0;
  static int per_sm = 0, sms = 0;
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return e;
  if (smem != counted) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    counted = smem;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = a.items_gu > a.items_d ? a.items_gu : a.items_d;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  MlpArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                  dim3(threads), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// x [M, K_gu] (bf16, row stride ldx) -> out [M, N_d].  The splits are the
// separate grouped calls' (gateup: splits_gu of per_gu ring stages; down,
// as the SwiGLU-down call: splits_d of per_d).  Scratch from the caller:
// gu_part f32 [splits_gu, M, N_gu], act bf16 [M, Kp_d], and d_part f32
// [splits_d, M, N_d] when splits_d > 1.  Returns 0 or the launch's
// cudaError_t (a refused cooperative launch included: the items of a
// product must fit the blocks the card holds at once); -1 for a call the
// ring does not take.
extern "C" int amq_qmm_mlp(const void* x, int x_bf16, int M, int K_gu,
                           int ldx, const int32_t* gu_packed,
                           const void* gu_scale, const void* gu_zero,
                           const int32_t* d_packed, const void* d_scale,
                           const void* d_zero, int meta_bf16, int Np_gu,
                           int Np_d, int N_gu, int inter, int Kp_gu, int Kp_d,
                           int N_d, int nbits, int group_size, int superblock,
                           int splits_gu, int per_gu, int splits_d, int per_d,
                           float* gu_part, void* act, float* d_part,
                           void* out, int out_bf16, void* stream) {
  const int spb = nbits == 8 ? superblock / 4 / GroupedForm<8>::n : 1;
  if (!grouped_takes(x, nullptr, x_bf16, gu_packed, gu_scale, gu_zero, M,
                     K_gu, ldx, Kp_gu, Np_gu, nbits, group_size,
                     superblock) ||
      !grouped_takes(act, nullptr, 1, d_packed, d_scale, d_zero, M, Kp_d,
                     Kp_d, Kp_d, Np_d, nbits, group_size, superblock) ||
      2 * inter > N_gu || N_gu > Np_gu || inter > Kp_d || N_d > Np_d ||
      splits_gu < 1 || per_gu < 1 || per_gu % spb || splits_d < 1 ||
      per_d < 1 || per_d % spb || gu_part == nullptr ||
      (splits_d > 1 && d_part == nullptr))
    return -1;
  const Weights gu_w{reinterpret_cast<const uint32_t*>(gu_packed), gu_scale,
                     gu_zero, meta_bf16, Np_gu, group_size, superblock};
  const Weights d_w{reinterpret_cast<const uint32_t*>(d_packed), d_scale,
                    d_zero, meta_bf16, Np_d, group_size, superblock};
  const int tiles_gu = (N_gu + kGBN - 1) / kGBN;
  const int tiles_d = (N_d + kGBN - 1) / kGBN;
  const MlpArgs a{
      GemvArgs{Operand{x, nullptr, 1, M, K_gu, ldx}, gu_w, nullptr, 0,
               gu_part, N_gu, Kp_gu, per_gu},
      GemvArgs{Operand{act, nullptr, 1, M, Kp_d, Kp_d}, d_w, out, out_bf16,
               d_part, N_d, Kp_d, per_d},
      splits_gu, splits_d, inter, tiles_gu, tiles_d, tiles_gu * splits_gu,
      tiles_d * splits_d, static_cast<__nv_bfloat16*>(act)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return static_cast<int>(launch<1>(a, s));
    case 2: return static_cast<int>(launch<2>(a, s));
    case 3: return static_cast<int>(launch<3>(a, s));
    case 4: return static_cast<int>(launch<4>(a, s));
    default: return static_cast<int>(launch<8>(a, s));
  }
}
