// The decode MLP of one layer, down(swiglu(gateup(x))), in one launch.
//
// Replaces the JAX package's ops/quant_matmul.py::quant_matmul_mlp_indexed
// (_qmm_kernel_mlp), which its AMQ_MLP_KERNEL switch selects at decode
// (M <= 8, bf16).  The TPU kernel runs one sequential grid: phase-1 steps
// accumulate the gateup GEMV into a VMEM scratch, phase-2 steps apply
// SwiGLU to slices of it and run the down GEMV, so the gateup output never
// leaves the chip and the weight prefetch runs across the boundary.
//
// A Hopper grid has no sequential axis to carry that scratch, so this is
// one cooperative launch (no larger than the blocks that fit on the card
// at once) with three grid-wide barriers:
//   1. blocks stride over the gateup (64-column tile, K split) work items,
//      each a GEMV tile through the cp.async ring of qmm_tile.cuh, and
//      write f32 partials to scratch;
//   2. sum the partials, round gate and up to bf16 (as the separate path's
//      gateup output is rounded), silu(gate) * up in f32 rounded to bf16,
//      zero at or past the real intermediate width;
//   3. the down GEMV over that activation, f32 partials;
//   4. sum the partials into the output, rounded once.
// No float atomics: every sum has a fixed order, so two calls on the same
// inputs give the same bits, and the splits are the separate kernels', so
// the result equals the separate gateup -> SwiGLU-down chain's.
//
// Bound on the H100: bytes (both layers' packed words and scale/zero read
// once, a few operations per weight).  The scratch round trip (M x 22016
// f32 partials, M x 11264 activations at Llama-2-7B) is under 1 % of the
// weight bytes and stays in the 50 MB L2.

#include <cooperative_groups.h>

#include "qmm_tile.cuh"

namespace cg = cooperative_groups;
using namespace amq;

namespace {

struct MlpArgs {
  Operand x;                   // [M, K_gu]
  Weights gu, dn;              // gateup [Kp_gu*b/32, Np_gu], down [.., Np_d]
  int N_gu, inter, Kp_gu, Kp_d, N_d;
  int splits_gu, per_gu, splits_d, per_d;
  float* gu_part;              // [splits_gu, M, N_gu]
  float* act;                  // [M, Kp_d]
  float* d_part;               // [splits_d, M, N_d]
  void* out;                   // [M, N_d]
  int out_bf16;
};

// One GEMV phase: blocks stride over (column tile, K split) items.
template <int NB, int MT>
__device__ void gemv_phase(const Operand& op, const Weights& w, int N, int Kp,
                           int splits, int per, float* part,
                           unsigned char* smem) {
  const int sb = w.superblock;
  const int tiles = (N + kBN - 1) / kBN;
  float acc[MT];
  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int lo = split * per;
    gemv_tile<NB, MT>(op, w, tile * kBN, lo, min(Kp / sb, lo + per), smem,
                      acc);
    sum_slices<MT>(acc, reinterpret_cast<float*>(smem + MT * sb * 4));
    const int n = tile * kBN + threadIdx.x;
    if (threadIdx.y == 0 && n < N) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= op.M) break;
        part[(static_cast<size_t>(split) * op.M + m) * N + n] = acc[m];
      }
    }
  }
}

// 1-D grid of co-resident blocks; block (kBN, kKS).
template <int NB, int MT>
__global__ void __launch_bounds__(kThreads) qmm_mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = a.x.M;
  const int tid = blockIdx.x * kThreads + threadIdx.y * kBN + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  gemv_phase<NB, MT>(a.x, a.gu, a.N_gu, a.Kp_gu, a.splits_gu, a.per_gu,
                     a.gu_part, smem);
  grid.sync();

  for (int i = tid; i < M * a.Kp_d; i += stride) {
    const int m = i / a.Kp_d, j = i - m * a.Kp_d;
    float v = 0.f;
    if (j < a.inter) {
      float g = 0.f, u = 0.f;
      for (int s = 0; s < a.splits_gu; ++s) {
        const float* p = a.gu_part + (static_cast<size_t>(s) * M + m) * a.N_gu;
        g += p[j];
        u += p[a.inter + j];
      }
      g = round_bf16(g);
      u = round_bf16(u);
      v = round_bf16(g / (1.f + expf(-g)) * u);
    }
    a.act[i] = v;
  }
  grid.sync();

  const Operand xd{a.act, nullptr, 0, M, a.inter, a.Kp_d};
  gemv_phase<NB, MT>(xd, a.dn, a.N_d, a.Kp_d, a.splits_d, a.per_d, a.d_part,
                     smem);
  grid.sync();

  const int MN = M * a.N_d;
  for (int i = tid; i < MN; i += stride) {
    float v = 0.f;
    for (int s = 0; s < a.splits_d; ++s)
      v += a.d_part[static_cast<size_t>(s) * MN + i];
    store_f(a.out, i, v, a.out_bf16);
  }
}

template <int NB, int MT>
cudaError_t launch(MlpArgs& a, cudaStream_t stream) {
  auto kernel = qmm_mlp_kernel<NB, MT>;
  const int smem = tile_smem_bytes(NB, MT, a.gu.superblock, a.gu.group_size,
                                   a.gu.meta_bf16);
  static int smem_set = 0, per_sm = 0, sms = 0;
  if (smem != smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int items_gu = (a.N_gu + kBN - 1) / kBN * a.splits_gu;
  const int items_d = (a.N_d + kBN - 1) / kBN * a.splits_d;
  const int want = items_gu > items_d ? items_gu : items_d;
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(kBN, kKS), args, smem,
      stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NB>
cudaError_t dispatch(MlpArgs& a, cudaStream_t stream) {
  if (a.x.M <= 1) return launch<NB, 1>(a, stream);
  if (a.x.M <= 2) return launch<NB, 2>(a, stream);
  if (a.x.M <= 4) return launch<NB, 4>(a, stream);
  return launch<NB, 8>(a, stream);
}

}  // namespace

// x [M, K_gu] (row stride ldx) -> out [M, N_d].  Scratch from the caller:
// gu_part [splits_gu, M, N_gu], act [M, Kp_d], d_part [splits_d, M, N_d],
// all f32.  Returns 0 or the launch's cudaError_t (a refused cooperative
// launch included); -1 for arguments the kernel does not take.
extern "C" int amq_qmm_mlp(const void* x, int x_bf16, int M, int K_gu,
                           int ldx, const int32_t* gu_packed,
                           const void* gu_scale, const void* gu_zero,
                           const int32_t* d_packed, const void* d_scale,
                           const void* d_zero, int meta_bf16, int Np_gu,
                           int Np_d, int N_gu, int inter, int Kp_gu, int Kp_d,
                           int N_d, int nbits, int group_size, int superblock,
                           int splits_gu, int per_gu, int splits_d, int per_d,
                           float* gu_part, float* act, float* d_part,
                           void* out, int out_bf16, void* stream) {
  if (M < 1 || M > 8 || superblock % 64 || superblock % group_size ||
      superblock > 1024 || Kp_gu % superblock || Kp_d % superblock ||
      Np_gu % 8 || Np_d % 8 || 2 * inter > N_gu || inter > Kp_d ||
      splits_gu < 1 || splits_d < 1 || !aligned16(gu_packed) ||
      !aligned16(gu_scale) || !aligned16(gu_zero) || !aligned16(d_packed) ||
      !aligned16(d_scale) || !aligned16(d_zero) ||
      !rounds_nest_groups(nbits, superblock, group_size))
    return -1;
  MlpArgs a{Operand{x, nullptr, x_bf16, M, K_gu, ldx},
            Weights{reinterpret_cast<const uint32_t*>(gu_packed), gu_scale,
                    gu_zero, meta_bf16, Np_gu, group_size, superblock},
            Weights{reinterpret_cast<const uint32_t*>(d_packed), d_scale,
                    d_zero, meta_bf16, Np_d, group_size, superblock},
            N_gu, inter, Kp_gu, Kp_d, N_d, splits_gu, per_gu, splits_d,
            per_d, gu_part, act, d_part, out, out_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return static_cast<int>(dispatch<1>(a, s));
    case 2: return static_cast<int>(dispatch<2>(a, s));
    case 3: return static_cast<int>(dispatch<3>(a, s));
    case 4: return static_cast<int>(dispatch<4>(a, s));
    case 8: return static_cast<int>(dispatch<8>(a, s));
    default: return -1;
  }
}
