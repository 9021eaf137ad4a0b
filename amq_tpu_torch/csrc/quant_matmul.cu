// Fused unpack -> dequantize -> matmul for pair-planar packed weights.
//
// Replaces the Pallas kernels of the JAX package's ops/quant_matmul.py:
// quant_matmul_indexed (_qmm_kernel_stacked), quant_matmul_swiglu_indexed
// (_qmm_kernel_swiglu) and quant_matmul (_quant_matmul_packed /
// _qmm_kernel).  Two entry points serve all three (amq_qmm: the CUDA-core
// GEMV and the GEMM; amq_qmm_grouped): the caller passes the selected
// layer's slab of a stacked buffer (a view, never a copy), and a non-null
// `u` turns on the SwiGLU prologue x = silu(gate) * up.
//
// Storage (read as the JAX package writes it): codes packed per superblock
// of `sb` K-rows into R = sb*b/32 rows of 32-bit words [R, Np]; the code at
// block row k = p*2R + 2r + h sits in word row r at bit 16h + b*p.  3-bit
// is a 2-bit plane (c >> 1) followed by a 1-bit plane (c & 1).  Scale and
// zero are [Kp/g, Np] in f32 or bf16; w = (c - z) * s.
//
// Bound on the H100: bytes.  At decode (M <= 8) every packed word and meta
// value is read once per call and the arithmetic is a few operations per
// weight, far below the card's operations-per-byte balance.  The CUDA-core
// GEMV (the M <= 8 calls neither the grouped GEMV nor its float32 form,
// quant_matmul_f32.cu, takes) therefore keeps loads coalesced and many in
// flight: neighbouring
// threads own neighbouring N columns (one 128-byte row segment per warp),
// each block splits a superblock's rows over 8 row slices, and small-N
// sites split K across blocks (partials reduced by a second pass).
// Activations and the superblock's meta live in shared memory; within a
// chunk of rows each extraction round p maps to one quantization group, so
// its scale and zero sit in registers.  The prefill path (8 < M < 256)
// dequantizes a 64 x 64 weight tile into shared memory and runs a plain
// register-tiled f32 product over it, with K split across blocks when the
// site has few column tiles.  Accumulation is f32 throughout.
//
// The grouped GEMV (amq_qmm_grouped): bf16 activations, M <= 8, at 8, 4,
// 3, 2 and 1 bits -- the JAX package's serving condition (single_m and
// acc_dtype == bf16) for its block-diagonal grouped GEMV
// (_gemv_blockdiag), and so the decode and speculative-verify calls of
// the 2/3/4-bit layers (quant_matmul_indexed, quant_matmul_swiglu_indexed)
// and of the 8-bit lm_head.  It computes the reference's grouped form
// (qmm_tile.cuh: grouped_step at 8 bits, grouped_stage_low below; at
// superblocks smaller than a ring stage span_stage_low / span_stage_pair,
// several superblocks a stage): codes
// extracted as exact bf16 128 + code values (a shift and a LOP3 per two
// codes, often only the LOP3; no I2F or FFMA per weight), products on
// tensor cores (mma.sync.m16n8k16, f32 accumulation), the activation sums
// from one more MMA against ones, one correction per group and round.
// Bound: bytes.  Its ring (a producer warp, bulk copies, full / empty
// mbarriers, 256 columns per block, K split over blocks at the occupancy
// of an M = 8 call, the splits summed in fixed order by
// reduce_splits_kernel) is set out at the top of qmm_grouped.cuh, which
// the pipelined GEMV (quant_matmul_pipe.cu) and the one-launch MLP
// (quant_matmul_mlp.cu) share.  (Summing the splits in
// the tile's last block instead, behind a ticket counter, saved no time on
// the H100: the last block's sum lengthened the kernel's tail by what the
// second launch had cost.)

#include "qmm_grouped.cuh"

using namespace amq;

namespace {

constexpr int kGemmBN = 64;    // GEMM: columns per block
constexpr int kGemmBM = 64;    // GEMM: rows per block
constexpr int kGemmKC = 64;    // GEMM: K step

// Decode GEMV, M <= MT <= 8.  Block (kBN, kKS); grid (ceil(N/kBN), splits).
// Each thread reads its column's words straight into registers; the
// arithmetic is qmm_tile.cuh's superblock_fma, the pipelined GEMV's.
template <int NB, int MT>
__global__ void __launch_bounds__(kThreads) qmm_gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int sb = a.w.superblock, gs = a.w.group_size, T = sb / gs;
  const int Np = a.w.Np;
  float* xs = smem;                  // [MT][sb]
  float* ss = xs + MT * sb;          // [T][kBN] scale
  float* bs = ss + T * kBN;          // [T][kBN] -zero*scale
  float* red = bs + T * kBN;         // [kKS][MT][kBN]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBN + tx;
  const int n = blockIdx.x * kBN + tx;
  const int n_sb = a.Kp / sb;
  const int sb_lo = blockIdx.y * a.sb_per_split;
  const int sb_hi = min(n_sb, sb_lo + a.sb_per_split);
  const int rows_sb = sb * NB / 32;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int sbi = sb_lo; sbi < sb_hi; ++sbi) {
    __syncthreads();
    for (int i = tid; i < MT * sb; i += kThreads) {
      const int m = i / sb;
      xs[i] = act_at(a.op, m, sbi * sb + (i - m * sb));
    }
    for (int i = tid; i < T * kBN; i += kThreads) {
      const int t = i / kBN;
      const int c = blockIdx.x * kBN + (i - t * kBN);
      float s = 0.f, z = 0.f;
      if (c < Np) {
        const size_t j = static_cast<size_t>(sbi * T + t) * Np + c;
        s = load_f(a.w.scale, j, a.w.meta_bf16);
        z = load_f(a.w.zero, j, a.w.meta_bf16);
      }
      ss[i] = s;
      bs[i] = -z * s;
    }
    __syncthreads();
    if (n < a.N) {
      const uint32_t* w =
          a.w.packed + static_cast<size_t>(sbi) * rows_sb * Np + n;
      superblock_fma<NB, MT>(
          [=](int r) { return __ldg(w + static_cast<size_t>(r) * Np); },
          [=](int g) { return make_float2(ss[g * kBN + tx], bs[g * kBN + tx]); },
          xs, sb, gs, ty, acc);
    }
  }
  sum_slices<MT>(acc, red);
  write_cols<MT>(a, acc, n);
}

template <int BITS>
__device__ __forceinline__ uint32_t pow2_code(const uint32_t* __restrict__ w,
                                              int Np, int R, int k) {
  const int p = k / (2 * R);
  const int rem = k - p * 2 * R;
  const uint32_t word = __ldg(w + static_cast<size_t>(rem >> 1) * Np);
  return (word >> (16 * (rem & 1) + BITS * p)) & ((1u << BITS) - 1u);
}

// Code at superblock-local row k of the column `w` points into.
template <int NB>
__device__ __forceinline__ uint32_t code_at(const uint32_t* w, int Np, int sb,
                                            int k) {
  if constexpr (NB == 3) {
    return (pow2_code<2>(w, Np, sb / 16, k) << 1) |
           pow2_code<1>(w + static_cast<size_t>(sb / 16) * Np, Np, sb / 32, k);
  } else {
    return pow2_code<NB>(w, Np, sb * NB / 32, k);
  }
}

// Prefill GEMM, 8 < M.  256 threads; grid (ceil(N/64), ceil(M/64), splits).
template <int NB>
__global__ void __launch_bounds__(256) qmm_gemm_kernel(GemvArgs a) {
  __shared__ float ws[kGemmKC][kGemmBN];
  __shared__ float xs[kGemmBM][kGemmKC + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kGemmBN, m0 = blockIdx.y * kGemmBM;
  const int sb = a.w.superblock, gs = a.w.group_size, T = sb / gs;
  const int Np = a.w.Np;
  const int rows_sb = sb * NB / 32;
  const int k_lo = blockIdx.z * a.sb_per_split * sb;
  const int k_hi = min(a.Kp, k_lo + a.sb_per_split * sb);
  float acc[4][4] = {};

  for (int k0 = k_lo; k0 < k_hi; k0 += kGemmKC) {
    const int sbi = k0 / sb, kin = k0 - sbi * sb;
    const uint32_t* w = a.w.packed + static_cast<size_t>(sbi) * rows_sb * Np;
    __syncthreads();
    for (int i = tid; i < kGemmKC * kGemmBN; i += 256) {
      const int kk = i / kGemmBN, nn = i - kk * kGemmBN, n = n0 + nn;
      const int k = kin + kk;
      float v = 0.f;
      if (n < a.N) {
        const size_t j = static_cast<size_t>(sbi * T + k / gs) * Np + n;
        const float s = load_f(a.w.scale, j, a.w.meta_bf16);
        const float z = load_f(a.w.zero, j, a.w.meta_bf16);
        v = (static_cast<float>(code_at<NB>(w + n, Np, sb, k)) - z) * s;
      }
      ws[kk][nn] = v;
    }
    for (int i = tid; i < kGemmBM * kGemmKC; i += 256) {
      const int mm = i / kGemmKC, kk = i - mm * kGemmKC;
      xs[mm][kk] = act_at(a.op, m0 + mm, k0 + kk);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGemmKC; ++kk) {
      float xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wb[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m >= a.op.M || n >= a.N) continue;
      if (gridDim.z == 1) {
        store_f(a.out, static_cast<size_t>(m) * a.N + n, acc[i][j], a.out_bf16);
      } else {
        a.partial[(static_cast<size_t>(blockIdx.z) * a.op.M + m) * a.N + n] =
            acc[i][j];
      }
    }
  }
}

// Blocks of the grouped kernel one SM holds at this call's shared memory
// and the kernel's registers, or -1 on an error.
template <class Kernel>
int ring_blocks(Kernel kernel, cudaError_t allowed, size_t smem) {
  int n = 0;
  if (allowed != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, (kGWarps + 1) * 32, smem) != cudaSuccess) {
    cudaGetLastError();       // not left for the next launch's check
    return -1;
  }
  return n;
}

// ... the whole-stage kernel, or the spanning one where the layout spans.
template <int BITS>
int grouped_blocks(int M, bool swiglu, int meta_bf16, int sb, int gs) {
  const size_t smem = grouped_smem<BITS>(M, swiglu, meta_bf16, sb, gs);
  if constexpr (BITS != 8) {
    if (!grouped_whole_stages(BITS, sb)) {
      int n = -1;
      with_span_kernel<BITS>(sb, [&](auto kernel, auto allow) {
        n = ring_blocks(kernel, allow(smem), smem);
        return cudaSuccess;
      });
      return n;
    }
  }
  return ring_blocks(qmm_grouped_kernel<BITS, false>,
                     grouped_allow<BITS, false>(smem), smem);
}

template <int NB, int MT>
cudaError_t launch_gemv(const GemvArgs& a, int splits, cudaStream_t stream) {
  const int T = a.w.superblock / a.w.group_size;
  const size_t smem =
      sizeof(float) * (MT * a.w.superblock + 2 * T * kBN + kKS * MT * kBN);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_gemv_kernel<NB, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        96 * 1024);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((a.N + kBN - 1) / kBN, splits);
  qmm_gemv_kernel<NB, MT><<<grid, dim3(kBN, kKS), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NB>
cudaError_t dispatch_gemv(const GemvArgs& a, int splits, cudaStream_t stream) {
  if (a.op.M <= 1) return launch_gemv<NB, 1>(a, splits, stream);
  if (a.op.M <= 2) return launch_gemv<NB, 2>(a, splits, stream);
  if (a.op.M <= 4) return launch_gemv<NB, 4>(a, splits, stream);
  return launch_gemv<NB, 8>(a, splits, stream);
}

template <int NB>
cudaError_t launch_gemm(const GemvArgs& a, int splits, cudaStream_t stream) {
  dim3 grid((a.N + kGemmBN - 1) / kGemmBN, (a.op.M + kGemmBM - 1) / kGemmBM,
            splits);
  qmm_gemm_kernel<NB><<<grid, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t of the launch; -1 for arguments the kernels
// do not take (the Python wrapper checks them first).
extern "C" int amq_qmm(const void* x, const void* u, int x_bf16,
                       const int32_t* packed, const void* scale,
                       const void* zero, int meta_bf16, void* out, int out_bf16,
                       float* partial, int M, int K, int ldx, int Kp, int N,
                       int Np,
                       int nbits, int group_size, int superblock, int splits,
                       int sb_per_split, void* stream) {
  if (M < 1 || superblock % 64 || superblock % group_size || Kp % superblock ||
      superblock > 1024 || splits < 1 ||
      (M <= 8 && !rounds_nest_groups(nbits, superblock, group_size)))
    return -1;
  GemvArgs a{Operand{x, u, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (M <= 8) {
    switch (nbits) {
      case 1: e = dispatch_gemv<1>(a, splits, s); break;
      case 2: e = dispatch_gemv<2>(a, splits, s); break;
      case 3: e = dispatch_gemv<3>(a, splits, s); break;
      case 4: e = dispatch_gemv<4>(a, splits, s); break;
      case 8: e = dispatch_gemv<8>(a, splits, s); break;
      default: return -1;
    }
  } else {
    switch (nbits) {
      case 1: e = launch_gemm<1>(a, splits, s); break;
      case 2: e = launch_gemm<2>(a, splits, s); break;
      case 3: e = launch_gemm<3>(a, splits, s); break;
      case 4: e = launch_gemm<4>(a, splits, s); break;
      case 8: e = launch_gemm<8>(a, splits, s); break;
      default: return -1;
    }
  }
  return finish_splits(e, partial, out, M * N, splits, out_bf16, s);
}

// The grouped tensor-core GEMV at 8, 4, 3, 2 and 1 bits, for the calls
// grouped_takes accepts (spanning layouts too: qmm_grouped_span_kernel).
// Same arguments as amq_qmm, but `sb_per_split` counts ring stages
// (grouped_round_rows / GroupedForm::n of them per superblock, at 8 bits a
// multiple of that: whole superblocks; at a spanning layout one per
// grouped_span superblocks, the last stage of K holding the rest); -1 for
// a call it does not take.
extern "C" int amq_qmm_grouped(const void* x, const void* u, int x_bf16,
                               const int32_t* packed, const void* scale,
                               const void* zero, int meta_bf16, void* out,
                               int out_bf16, float* partial, int M, int K,
                               int ldx, int Kp, int N, int Np, int nbits,
                               int group_size, int superblock, int splits,
                               int sb_per_split, void* stream) {
  const int spb = nbits == 8 ? superblock / 4 / GroupedForm<8>::n : 1;
  if (!grouped_takes(x, u, x_bf16, packed, scale, zero, M, K, ldx, Kp, Np,
                     nbits, group_size, superblock, true) ||
      splits < 1 || sb_per_split < 1 || sb_per_split % spb ||
      (splits > 1 && partial == nullptr))
    return -1;
  GemvArgs a{Operand{x, u, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!grouped_whole_stages(nbits, superblock)) {
    switch (nbits) {
      case 1: e = launch_span<1>(a, splits, s); break;
      case 2: e = launch_span<2>(a, splits, s); break;
      case 3: e = launch_span<3>(a, splits, s); break;
      default: e = launch_span<4>(a, splits, s); break;
    }
  } else {
    switch (nbits) {
      case 1: e = launch_grouped<1, false>(a, splits, s); break;
      case 2: e = launch_grouped<2, false>(a, splits, s); break;
      case 3: e = launch_grouped<3, false>(a, splits, s); break;
      case 4: e = launch_grouped<4, false>(a, splits, s); break;
      default: e = launch_grouped<8, false>(a, splits, s); break;
    }
  }
  return finish_splits(e, partial, out, M * N, splits, out_bf16, s);
}

// Blocks of the grouped GEMV one SM holds for a call of this shape (the
// split rule's wave), or -1 on an error.
extern "C" int amq_qmm_grouped_blocks(int nbits, int M, int swiglu,
                                      int meta_bf16, int group_size,
                                      int superblock) {
  switch (nbits) {
    case 1: return grouped_blocks<1>(M, swiglu, meta_bf16, superblock, group_size);
    case 2: return grouped_blocks<2>(M, swiglu, meta_bf16, superblock, group_size);
    case 3: return grouped_blocks<3>(M, swiglu, meta_bf16, superblock, group_size);
    case 4: return grouped_blocks<4>(M, swiglu, meta_bf16, superblock, group_size);
    case 8: return grouped_blocks<8>(M, swiglu, meta_bf16, superblock, group_size);
    default: return -1;
  }
}

// Dynamic shared memory of one grouped block for a call of this shape, in
// bytes (what launch_grouped asks for), or -1 for a width it has no
// kernel for.
extern "C" long long amq_qmm_grouped_smem(int nbits, int M, int swiglu,
                                          int meta_bf16, int group_size,
                                          int superblock) {
  switch (nbits) {
    case 1: return grouped_smem<1>(M, swiglu, meta_bf16, superblock, group_size);
    case 2: return grouped_smem<2>(M, swiglu, meta_bf16, superblock, group_size);
    case 3: return grouped_smem<3>(M, swiglu, meta_bf16, superblock, group_size);
    case 4: return grouped_smem<4>(M, swiglu, meta_bf16, superblock, group_size);
    case 8: return grouped_smem<8>(M, swiglu, meta_bf16, superblock, group_size);
    default: return -1;
  }
}
