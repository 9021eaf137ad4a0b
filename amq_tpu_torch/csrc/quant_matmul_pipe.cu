// Software-pipelined decode GEMV over pair-planar packed weights.
//
// Replaces the pipelined branches of the JAX package's
// ops/quant_matmul.py: quant_matmul_indexed (_qmm_kernel_stacked_pipe with
// _pipe_specs) and quant_matmul_swiglu_indexed (_qmm_kernel_swiglu_pipe),
// the decode GEMVs its AMQ_PIPE switch selects (M <= 8, bf16 activations,
// at least 8 groups per superblock, widths 1-4).  A non-null `u` turns on
// the SwiGLU prologue x = silu(gate) * up.
//
// Bound on the H100: bytes.  Every packed word and scale/zero value is read
// once per call, a few operations per weight.  The TPU kernel overlaps the
// extraction of superblock k with the dot of k-1 through two VMEM code
// slabs; here each block (64 columns, 8 row slices) walks its K range
// superblock by superblock through a two-stage shared-memory ring that
// cp.async fills (qmm_tile.cuh), so the copy of superblock k+1 is in flight
// while the threads extract and accumulate superblock k.  Columns per block,
// the coalescing (a warp reads 128 contiguous bytes of a word row), the
// split-K partials of small-N sites and f32 accumulation with one rounding
// are those of the non-pipelined GEMV in quant_matmul.cu, and the two share
// their arithmetic (qmm_tile.cuh), so their results agree bit for bit.

#include "qmm_tile.cuh"

using namespace amq;

namespace {

// Grid (ceil(N/kBN), splits); block (kBN, kKS).
template <int NB, int MT>
__global__ void __launch_bounds__(kThreads) qmm_pipe_kernel(GemvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = a.w.superblock;
  const int col0 = blockIdx.x * kBN;
  const int sb_lo = blockIdx.y * a.sb_per_split;
  const int sb_hi = min(a.Kp / sb, sb_lo + a.sb_per_split);
  float acc[MT];
  gemv_tile<NB, MT>(a.op, a.w, col0, sb_lo, sb_hi, smem, acc);
  sum_slices<MT>(acc, reinterpret_cast<float*>(smem + MT * sb * 4));
  write_cols<MT>(a, acc, col0 + threadIdx.x);
}

template <int NB, int MT>
cudaError_t launch(const GemvArgs& a, int splits, cudaStream_t stream) {
  const int smem = tile_smem_bytes(NB, MT, a.w.superblock, a.w.group_size,
                                   a.w.meta_bf16);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_pipe_kernel<NB, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  dim3 grid((a.N + kBN - 1) / kBN, splits);
  qmm_pipe_kernel<NB, MT><<<grid, dim3(kBN, kKS), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NB>
cudaError_t dispatch(const GemvArgs& a, int splits, cudaStream_t stream) {
  if (a.op.M <= 1) return launch<NB, 1>(a, splits, stream);
  if (a.op.M <= 2) return launch<NB, 2>(a, splits, stream);
  if (a.op.M <= 4) return launch<NB, 4>(a, splits, stream);
  return launch<NB, 8>(a, splits, stream);
}

}  // namespace

// The arguments of amq_qmm (quant_matmul.cu).  Returns 0 or the launch's
// cudaError_t; -1 for arguments the kernel does not take (the Python
// wrapper checks them first).
extern "C" int amq_qmm_pipe(const void* x, const void* u, int x_bf16,
                            const int32_t* packed, const void* scale,
                            const void* zero, int meta_bf16, void* out,
                            int out_bf16, float* partial, int M, int K, int ldx,
                            int Kp, int N, int Np, int nbits, int group_size,
                            int superblock, int splits, int sb_per_split,
                            void* stream) {
  if (M < 1 || M > 8 || superblock % 64 || superblock % group_size ||
      Kp % superblock || superblock > 1024 || splits < 1 || Np % 8 ||
      !aligned16(packed) || !aligned16(scale) || !aligned16(zero) ||
      !rounds_nest_groups(nbits, superblock, group_size))
    return -1;
  GemvArgs a{Operand{x, u, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nbits) {
    case 1: e = dispatch<1>(a, splits, s); break;
    case 2: e = dispatch<2>(a, splits, s); break;
    case 3: e = dispatch<3>(a, splits, s); break;
    case 4: e = dispatch<4>(a, splits, s); break;
    default: return -1;
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int MN = M * N;
  reduce_splits_kernel<<<(MN + 255) / 256, 256, 0, s>>>(partial, out, MN,
                                                        splits, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
