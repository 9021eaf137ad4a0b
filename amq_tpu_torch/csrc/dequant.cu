// Dequantize a pair-planar packed weight to [K, N] in one pass.
//
// The JAX package computes this outside any Pallas kernel (its
// core/quantize.py dequantize_kn, one XLA fusion); the evaluation
// path dequantizes every linear with M >= 256 this way before a library
// matmul.  No library call unpacks the JAX storage layout, so this is the
// port's own kernel: each packed word is read once, each output value
// written once.
//
// Storage (the JAX package's, see quant_matmul.cu): per superblock of sb
// K-rows, the words of a width-b plane are R = sb*b/32 rows [R, Np]; the
// code at block row k = p*2R + 2r + h sits in word row r at bit 16h + b*p.
// 3/5/6-bit are a hi plane (c >> lo) followed by a lo plane (c & (2^lo-1)),
// each pair-planar.  Scale and zero are [Kp/gs, Np], f32 or bf16.
//
// Function: w[k, n] = (c - z) * s in the output type, rounded as the plain
// PyTorch version (core/quantize.py dequantize_kn) rounds it: in bf16
// t = bf16(c - z), then bf16(t * s) (meta rounded to bf16 first); in f32
// (c - z) * s.  Only the logical [K, N] block is written (no K or N pad).
//
// Bound on the H100: bytes.  The output (2 or 4 bytes per weight) is 4-16
// times the packed input, so the design is the output's: each thread owns
// one word row of the lo (or only) plane and VEC = 8 neighbouring columns,
// reads those words with 16-byte loads (and, for split widths, the hi-plane
// words that hold the same K rows, each also read by exactly one thread),
// and writes its 2P output rows 8 columns at a time with 16-byte stores
// (neighbouring threads on neighbouring columns, so a warp writes whole
// 128-byte segments).  Calls whose N, Np or pointers do not allow 16-byte
// access take the same kernel with VEC = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct DqArgs {
  const uint32_t* packed;
  const void* scale;
  const void* zero;
  int meta_bf16;
  void* out;
  int out_bf16;
  int K, N, Np, gs, sb, n_sb;
};

// (hi bits, lo bits) of a width; a power-of-two width is one plane (lo).
template <int NB>
struct Planes {
  static constexpr int hi = NB == 3 ? 2 : (NB == 5 || NB == 6) ? 4 : 0;
  static constexpr int lo = NB - hi;
};

template <int VEC>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
    w[0] = __ldg(p);
  }
}

// VEC meta values of one row, as floats (exact from bf16).
template <int VEC>
__device__ __forceinline__ void load_meta(const void* base, size_t i, int bf16,
                                          float (&v)[VEC]) {
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + i;
    if constexpr (VEC == 8) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(u[j] << 16);
        v[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
      }
    } else {
      v[0] = __bfloat162float(p[0]);
    }
  } else {
    const float* p = static_cast<const float*>(base) + i;
    if constexpr (VEC == 8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      v[0] = __ldg(p);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(void* base, size_t i, int bf16,
                                          const float (&s)[VEC],
                                          const float (&z)[VEC],
                                          const uint32_t (&c)[VEC]) {
  if (bf16) {
    uint32_t h[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // bf16(c - z) then bf16(t * s), meta rounded to bf16 first
      const float zb = __bfloat162float(__float2bfloat16_rn(z[j]));
      const float sb = __bfloat162float(__float2bfloat16_rn(s[j]));
      const float t = __bfloat162float(
          __float2bfloat16_rn(__fsub_rn(static_cast<float>(c[j]), zb)));
      h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(t, sb)));
    }
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(base) + i;
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                     h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    } else {
      *reinterpret_cast<unsigned short*>(p) =
          static_cast<unsigned short>(h[0]);
    }
  } else {
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = __fmul_rn(__fsub_rn(static_cast<float>(c[j]), z[j]), s[j]);
    float* p = static_cast<float*>(base) + i;
    if constexpr (VEC == 8) {
      reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      p[0] = o[0];
    }
  }
}

// One thread: word row r of the lo plane of superblock sbi, columns
// n0 .. n0+VEC-1; writes the 2P K rows that word row holds.
template <int NB, int VEC>
__global__ void __launch_bounds__(256) dequant_kernel(DqArgs a) {
  constexpr int HB = Planes<NB>::hi, LB = Planes<NB>::lo;
  constexpr int P = 16 / LB;
  constexpr uint32_t lmask = (1u << LB) - 1u;
  constexpr uint32_t hmask = (1u << (HB > 0 ? HB : 1)) - 1u;
  const int sb = a.sb, Np = a.Np;
  const int R_lo = sb * LB / 32, R_hi = sb * HB / 32;
  const int chunks = (a.N + VEC - 1) / VEC;
  const long long item = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (item >= static_cast<long long>(a.n_sb) * R_lo * chunks) return;
  const int chunk = static_cast<int>(item % chunks);
  const long long rest = item / chunks;
  const int r = static_cast<int>(rest % R_lo);
  const int sbi = static_cast<int>(rest / R_lo);
  const int n0 = chunk * VEC;
  if (VEC == 1 && n0 >= a.N) return;
  const uint32_t* wsb =
      a.packed + static_cast<size_t>(sbi) * (R_hi + R_lo) * Np + n0;
  uint32_t lo[VEC];
  load_words<VEC>(wsb + static_cast<size_t>(R_hi + r) * Np, lo);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int k0 = p * 2 * R_lo + 2 * r;           // h = 0; h = 1 is k0 + 1
    const int kg0 = sbi * sb + k0;
    if (kg0 >= a.K) break;
    uint32_t hi[VEC];
    int hshift = 0;
    if constexpr (HB > 0) {
      const int p_h = k0 / (2 * R_hi);
      const int r_h = (k0 - p_h * 2 * R_hi) / 2;
      load_words<VEC>(wsb + static_cast<size_t>(r_h) * Np, hi);
      hshift = HB * p_h;
    }
    const size_t mi = static_cast<size_t>(kg0 / a.gs) * Np + n0;
    float s[VEC], z[VEC];
    load_meta<VEC>(a.scale, mi, a.meta_bf16, s);
    load_meta<VEC>(a.zero, mi, a.meta_bf16, z);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kg0 + h >= a.K) break;
      uint32_t c[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        c[j] = (lo[j] >> (16 * h + LB * p)) & lmask;
        if constexpr (HB > 0)
          c[j] |= ((hi[j] >> (16 * h + hshift)) & hmask) << LB;
      }
      store_row<VEC>(a.out, static_cast<size_t>(kg0 + h) * a.N + n0,
                     a.out_bf16, s, z, c);
    }
  }
}

template <int NB>
cudaError_t launch(const DqArgs& a, bool vec, cudaStream_t stream) {
  const int R_lo = a.sb * Planes<NB>::lo / 32;
  const int vw = vec ? 8 : 1;
  const long long items =
      static_cast<long long>(a.n_sb) * R_lo * ((a.N + vw - 1) / vw);
  const unsigned blocks = static_cast<unsigned>((items + 255) / 256);
  if (vec) {
    dequant_kernel<NB, 8><<<blocks, 256, 0, stream>>>(a);
  } else {
    dequant_kernel<NB, 1><<<blocks, 256, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// out [K, N] = dequant(packed)[:K, :N].  n_sb superblocks are read (the
// ones holding rows below K).  Returns 0 or the launch's cudaError_t; -1
// for arguments the kernel does not take.
extern "C" int amq_dequant_kn(const int32_t* packed, const void* scale,
                              const void* zero, int meta_bf16, void* out,
                              int out_bf16, int K, int N, int Np, int nbits,
                              int group_size, int superblock, int n_sb,
                              void* stream) {
  if (K < 1 || N < 1 || N > Np || group_size < 2 || group_size % 2 ||
      superblock % group_size || superblock % 32 ||
      static_cast<long long>(n_sb) * superblock < K)
    return -1;
  DqArgs a{reinterpret_cast<const uint32_t*>(packed), scale, zero, meta_bf16,
           out, out_bf16, K, N, Np, group_size, superblock, n_sb};
  const bool vec = N % 8 == 0 && Np % 8 == 0 && aligned16(packed) &&
                   aligned16(scale) && aligned16(zero) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return static_cast<int>(launch<1>(a, vec, s));
    case 2: return static_cast<int>(launch<2>(a, vec, s));
    case 3: return static_cast<int>(launch<3>(a, vec, s));
    case 4: return static_cast<int>(launch<4>(a, vec, s));
    case 5: return static_cast<int>(launch<5>(a, vec, s));
    case 6: return static_cast<int>(launch<6>(a, vec, s));
    case 8: return static_cast<int>(launch<8>(a, vec, s));
    default: return -1;
  }
}
