// Software-pipelined decode GEMV over pair-planar packed weights, in the
// grouped form on tensor cores.
//
// Replaces the pipelined branches of the JAX package's
// ops/quant_matmul.py: quant_matmul_indexed (_qmm_kernel_stacked_pipe with
// _pipe_specs) and quant_matmul_swiglu_indexed (_qmm_kernel_swiglu_pipe),
// the decode GEMVs its AMQ_PIPE switch selects (M <= 8, bf16 activations,
// at least 8 groups per superblock, widths 1-4).  Both compute
// _gemv_dot_codes: bf16 128 + c codes, an f32 sum per group, and
// s * y - xsum * (z + 128) * s.  A non-null `u` turns on the SwiGLU
// prologue x = silu(gate) * up (f32, rounded to bf16).
//
// Bound on the H100: bytes (every packed word and scale/zero value read
// once per call, a few operations per weight).  The TPU kernel extracts
// tile k into a VMEM code slab while the matrix unit dots tile k-1.  Here
// the kernel is the grouped GEMV's ring (qmm_grouped.cuh:
// qmm_grouped_kernel<BITS, true>) with the pipelined consumer
// (qmm_tile.cuh's grouped_stage_pipe): the codes stay in registers, and
// each consumer warp extracts the next step's A fragments (and loads its x
// fragment) before it issues the current step's MMAs, across round ends
// too.  It takes the grouped GEMV's splits, and its products, sums and
// corrections run in the grouped GEMV's order, so the two give the same
// bits.

#include "qmm_grouped.cuh"

using namespace amq;

// The arguments of amq_qmm_grouped (quant_matmul.cu), at 1/2/3/4 bits:
// `sb_per_split` counts ring stages.  Returns 0 or the launch's
// cudaError_t; -1 for a call it does not take (the Python wrapper checks
// first).
extern "C" int amq_qmm_pipe(const void* x, const void* u, int x_bf16,
                            const int32_t* packed, const void* scale,
                            const void* zero, int meta_bf16, void* out,
                            int out_bf16, float* partial, int M, int K, int ldx,
                            int Kp, int N, int Np, int nbits, int group_size,
                            int superblock, int splits, int sb_per_split,
                            void* stream) {
  if (nbits < 1 || nbits > 4 ||
      !grouped_takes(x, u, x_bf16, packed, scale, zero, M, K, ldx, Kp, Np,
                     nbits, group_size, superblock) ||
      splits < 1 || sb_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  GemvArgs a{Operand{x, u, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nbits) {
    case 1: e = launch_grouped<1, true>(a, splits, s); break;
    case 2: e = launch_grouped<2, true>(a, splits, s); break;
    case 3: e = launch_grouped<3, true>(a, splits, s); break;
    default: e = launch_grouped<4, true>(a, splits, s); break;
  }
  return finish_splits(e, partial, out, M * N, splits, out_bf16, s);
}
