// The routed experts of a sparse (Qwen2-MoE) layer on packed weights.
//
// The JAX package has no mixture-of-experts layer, so these kernels replace
// no Pallas kernel: they were added for Qwen2-57B-A14B, whose 64 experts a
// layer hold ~80 % of a decode step's bytes.  Three launches a layer, all
// capturable (no host read: the grouping by expert exists only on the
// device):
//
//  * moe_align_kernel (one block): counts the step's (row, expert) pairs
//    per expert, lays the experts out in order, each padded to whole row
//    tiles of BM, scatters the pair ids into that layout (-1 on pads),
//    names each tile's expert (-1: no work) and adds the number of
//    experts hit, of pairs and of experts (hit or not) to the per-layer
//    counters.
//  * moe_gemv_kernel (BM 16: decode, at most 8 rows, so one tile per
//    expert hit) / moe_tile_kernel (BM 64: prefill), one launch per
//    product: a block is one (tile, column block).  It reads its tile's
//    expert from the device and skips tiles with none, so an expert no row
//    chose is never read.  The gate|up form gathers x's rows of its pairs
//    and writes act = silu(gate) * up (each rounded to bf16 first, then
//    rounded once: swiglu_plain of the bf16 products) per tile row: its
//    128 columns are 64 gate and the same 64 up columns, so a thread holds
//    both halves of its outputs.  The down form reads act's tile rows and
//    writes each pair's [H] output.
//  * moe_combine_kernel: out[m] = sum_k w[m, k] y[m k + k] +
//    sigmoid(s[m]) * shared[m], in float32, rounded once.
//
// Storage (the JAX package's pair-planar layout, see quant_matmul.cu): per
// superblock of sb K rows a width-b container packs R = sb * b / 32 word
// rows, the code of block row k = p*2R + 2r + h in word row r at bit
// 16h + b*p.  So the two 16-bit halves of a word hold K rows 2r and 2r+1
// of plane p: the pair an mma B fragment register holds.  2- and 4-bit
// containers (the serving stacks: 3-bit codes ride 4-bit containers).
//
// Arithmetic: the weight is dequantized as the port's bf16 multi-row form
// (qmm_tile_plain) does, (c - z) * s in bf16 with a rounding after each
// operation, then mma.sync m16n8k16 bf16 x bf16 -> f32 over K.
//
// Bound on the H100: at decode, bytes (each hit expert's words and meta
// read once; ~42 of 64 experts a layer at 8 slots); at prefill the
// tensor cores and the dequantization (each tile of 64 rows dequantizes
// its expert's slice again).  Design: 128 threads, two-stage cp.async ring
// of one superblock's words (row stride padded to 136 words, so the
// fragment reads hit 32 banks), scale, zero and x rows (ldmatrix), 2
// blocks an SM at BM 16; each word read from shared memory once and
// dequantized for all its planes, scale and zero held in registers per
// group (the decode form is bound by these operations at 2 bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MOE_MAX_E = 256;
constexpr int MOE_THREADS = 128;
constexpr int MOE_BN = 128;           // columns of a block (gate|up: 64 + 64)
constexpr int MOE_WS = MOE_BN + 8;    // word row stride in shared memory
constexpr int MOE_GROUP = 128;        // K rows per scale / zero

struct MoeArgs {
  const __nv_bfloat16* x;        // gate|up: [M, K] rows; down: act [T*BM, K]
  const uint32_t* packed;        // expert `first` of the stack
  const __nv_bfloat16* scale;
  const __nv_bfloat16* zero;
  long long w_stride;            // words per expert
  long long m_stride;            // scale (zero) entries per expert
  const int* sorted;             // [T * BM] pair id or -1
  const int* tile_expert;        // [T] expert or -1
  __nv_bfloat16* out;            // gate|up: act [T*BM, I]; down: y [P, N]
  int K, N, I, sb, topk;
};

__device__ __forceinline__ void moe_cp16(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void moe_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void moe_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void moe_ldmatrix4(uint32_t (&a)[4],
                                              const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ void moe_mma(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ __nv_bfloat162 moe_as_bf162(uint32_t v) {
  __nv_bfloat162 out;
  *reinterpret_cast<uint32_t*>(&out) = v;
  return out;
}

__device__ __forceinline__ uint32_t moe_as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two codes of one word's plane (already shifted down) as the bf16
// pair (c - z) * s: 128 + c by bit pattern, minus 128 (exact), then the
// meta, rounding after each operation.
template <int BITS>
__device__ __forceinline__ uint32_t moe_dequant(uint32_t w, __nv_bfloat162 s,
                                                __nv_bfloat162 z) {
  constexpr uint32_t mask = BITS == 4 ? 0x000F000Fu : 0x00030003u;
  const __nv_bfloat162 c = __hsub2(moe_as_bf162((w & mask) | 0x43004300u),
                                   moe_as_bf162(0x43004300u));
  return moe_as_u32(__hmul2(__hsub2(c, z), s));
}

template <int BITS, int BM>
struct MoeSmem {
  // bytes of one stage: words, scale, zero, x rows
  static __host__ __device__ int words(int sb) {
    return sb * BITS / 32 * MOE_WS * 4;
  }
  static __host__ __device__ int meta(int sb) {
    return sb / MOE_GROUP * MOE_BN * 2;
  }
  static __host__ __device__ int rows(int sb) { return BM * (sb + 8) * 2; }
  static __host__ __device__ int stage(int sb) {
    return words(sb) + 2 * meta(sb) + rows(sb);
  }
};

// gmem column of shared column c (a multiple of 4 within a 64-column half
// for gate|up) of column block nb
template <bool GATEUP>
__device__ __forceinline__ int moe_col(int c, int nb, int I) {
  if constexpr (GATEUP) return c < 64 ? 64 * nb + c : I + 64 * nb + c - 64;
  return MOE_BN * nb + c;
}

template <int BITS, int BM, bool GATEUP>
__device__ __forceinline__ void moe_body(const MoeArgs& a) {
  constexpr int MT = BM / 16;
  constexpr int P = 16 / BITS;
  const int tile = blockIdx.x, nb = blockIdx.y;
  const int expert = a.tile_expert[tile];
  if (expert < 0) return;
  extern __shared__ __align__(16) unsigned char moe_smem[];
  __shared__ int rowsrc[BM];
  __shared__ int rowdst[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sb = a.sb, R = sb * BITS / 32, G = sb / MOE_GROUP;
  const int n_sb = a.K / sb;
  for (int r = tid; r < BM; r += MOE_THREADS) {
    const int pos = tile * BM + r;
    const int pair = a.sorted[pos];
    if constexpr (GATEUP) {
      rowsrc[r] = pair >= 0 ? pair / a.topk : -1;
    } else {
      rowsrc[r] = pair >= 0 ? pos : -1;
    }
    rowdst[r] = GATEUP ? pos : pair;
  }
  __syncthreads();
  const uint32_t* wbase = a.packed + a.w_stride * expert;
  const __nv_bfloat16* sbase = a.scale + a.m_stride * expert;
  const __nv_bfloat16* zbase = a.zero + a.m_stride * expert;
  const int stage_bytes = MoeSmem<BITS, BM>::stage(sb);

  auto load = [&](int st, int s) {
    unsigned char* base = moe_smem + st * stage_bytes;
    uint32_t* Ws = reinterpret_cast<uint32_t*>(base);
    __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(
        base + MoeSmem<BITS, BM>::words(sb));
    __nv_bfloat16* Zs = Ss + G * MOE_BN;
    __nv_bfloat16* As = Zs + G * MOE_BN;
    for (int i = tid; i < R * (MOE_BN / 4); i += MOE_THREADS) {
      const int r = i / (MOE_BN / 4), c = (i % (MOE_BN / 4)) * 4;
      moe_cp16(Ws + r * MOE_WS + c,
               wbase + static_cast<long long>(s * R + r) * a.N +
                   moe_col<GATEUP>(c, nb, a.I),
               16);
    }
    for (int i = tid; i < G * (MOE_BN / 8); i += MOE_THREADS) {
      const int g = i / (MOE_BN / 8), c = (i % (MOE_BN / 8)) * 8;
      const long long off = static_cast<long long>(s * G + g) * a.N +
                            moe_col<GATEUP>(c, nb, a.I);
      moe_cp16(Ss + g * MOE_BN + c, sbase + off, 16);
      moe_cp16(Zs + g * MOE_BN + c, zbase + off, 16);
    }
    const int chunks = sb / 8;
    for (int i = tid; i < BM * chunks; i += MOE_THREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const int src = rowsrc[r];
      const __nv_bfloat16* g =
          src >= 0 ? a.x + static_cast<long long>(src) * a.K + s * sb + c
                   : a.x;
      moe_cp16(As + r * (sb + 8) + c, g, src >= 0 ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  // this thread's shared column of each n8 tile (the B fragment's n)
  int scol[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    scol[n] = GATEUP ? (n < 2 ? 16 * warp + 8 * n : 64 + 16 * warp + 8 * (n - 2))
                     : 32 * warp + 8 * n;
    scol[n] += lane >> 2;
  }

  load(0, 0);
  moe_commit();
  for (int s = 0; s < n_sb; ++s) {
    if (s + 1 < n_sb) load((s + 1) & 1, s + 1);
    moe_commit();
    moe_wait1();
    __syncthreads();
    const unsigned char* base = moe_smem + (s & 1) * stage_bytes;
    const uint32_t* Ws = reinterpret_cast<const uint32_t*>(base);
    const __nv_bfloat16* Ss = reinterpret_cast<const __nv_bfloat16*>(
        base + MoeSmem<BITS, BM>::words(sb));
    const __nv_bfloat16* Zs = Ss + G * MOE_BN;
    const __nv_bfloat16* As = Zs + G * MOE_BN;
    // a 16-row chunk lies in one group, and a plane's chunks change group
    // only every 8 chunks (2R divides 128, or is a multiple of it): scale
    // and zero are read for all planes there, not per chunk
    __nv_bfloat162 s2[P][4], z2[P][4];
    for (int j = 0; j < R / 8; ++j) {
      if ((j & 7) == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int g = (p * 2 * R + 16 * j) / MOE_GROUP;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            s2[p][n] = __bfloat162bfloat162(Ss[g * MOE_BN + scol[n]]);
            z2[p][n] = __bfloat162bfloat162(Zs[g * MOE_BN + scol[n]]);
          }
        }
      }
      uint32_t w0[4], w1[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        w0[n] = Ws[(8 * j + (lane & 3)) * MOE_WS + scol[n]];
        w1[n] = Ws[(8 * j + 4 + (lane & 3)) * MOE_WS + scol[n]];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int k0 = p * 2 * R + 16 * j;
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          moe_ldmatrix4(af[m], As + (16 * m + (lane & 15)) * (sb + 8) + k0 +
                                   (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t b0 =
              moe_dequant<BITS>(w0[n] >> (BITS * p), s2[p][n], z2[p][n]);
          const uint32_t b1 =
              moe_dequant<BITS>(w1[n] >> (BITS * p), s2[p][n], z2[p][n]);
#pragma unroll
          for (int m = 0; m < MT; ++m) moe_mma(acc[m][n], af[m], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // C fragment: c0, c1 at row lane/4, columns 2(lane%4) + {0, 1}; c2, c3
  // eight rows below
  const int cc = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + (lane >> 2) + 8 * h;
      const int dst = rowdst[row];
      if (dst < 0) continue;
      if constexpr (GATEUP) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float g = __bfloat162float(
                __float2bfloat16_rn(acc[m][n][2 * h + q]));
            const float u = __bfloat162float(
                __float2bfloat16_rn(acc[m][n + 2][2 * h + q]));
            v[q] = g / (1.f + expf(-g)) * u;
          }
          const int col = 64 * nb + 16 * warp + 8 * n + cc;
          *reinterpret_cast<__nv_bfloat162*>(
              a.out + static_cast<long long>(dst) * a.I + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = MOE_BN * nb + 32 * warp + 8 * n + cc;
          *reinterpret_cast<__nv_bfloat162*>(
              a.out + static_cast<long long>(dst) * a.N + col) =
              __floats2bfloat162_rn(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        }
      }
    }
  }
}

template <int BITS, bool GATEUP>
__global__ void __launch_bounds__(MOE_THREADS, 2)
    moe_gemv_kernel(MoeArgs a) {
  moe_body<BITS, 16, GATEUP>(a);
}

template <int BITS, bool GATEUP>
__global__ void __launch_bounds__(MOE_THREADS, 1)
    moe_tile_kernel(MoeArgs a) {
  moe_body<BITS, 64, GATEUP>(a);
}

__global__ void __launch_bounds__(1024)
    moe_align_kernel(const int64_t* ids, int P, int E, int bm, int tiles,
                     int* sorted, int* tile_expert,
                     unsigned long long* hits, unsigned long long* pairs,
                     unsigned long long* offered) {
  __shared__ int count[MOE_MAX_E];
  __shared__ int start[MOE_MAX_E];
  __shared__ int cursor[MOE_MAX_E];
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < E; e += nt) count[e] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += nt) atomicAdd(&count[ids[p]], 1);
  for (int i = tid; i < tiles * bm; i += nt) sorted[i] = -1;
  __syncthreads();
  if (tid == 0) {
    int off = 0, hit = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = off;
      cursor[e] = off;
      hit += count[e] > 0;
      off += (count[e] + bm - 1) / bm * bm;
    }
    atomicAdd(hits, static_cast<unsigned long long>(hit));
    atomicAdd(pairs, static_cast<unsigned long long>(P));
    atomicAdd(offered, static_cast<unsigned long long>(E));
  }
  __syncthreads();
  for (int t = tid; t < tiles; t += nt) {
    const int pos = t * bm;
    int owner = -1;
    for (int e = 0; e < E; ++e) {
      const int end = start[e] + (count[e] + bm - 1) / bm * bm;
      if (pos >= start[e] && pos < end) {
        owner = e;
        break;
      }
    }
    tile_expert[t] = owner;
  }
  for (int p = tid; p < P; p += nt) {
    const int at = atomicAdd(&cursor[ids[p]], 1);
    sorted[at] = p;
  }
}

// out [M, H] = sum_k w[m, k] * y[m * topk + k] + sigmoid(s[m]) * shared[m]
__global__ void __launch_bounds__(256)
    moe_combine_kernel(const __nv_bfloat16* y, const float* w,
                       const __nv_bfloat16* shared, const float* s,
                       __nv_bfloat16* out, int topk, int H) {
  const int m = blockIdx.x;
  const float gate = 1.f / (1.f + expf(-s[m]));
  for (int c = threadIdx.x * 8; c < H; c += blockDim.x * 8) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    for (int k = 0; k < topk; ++k) {
      const float wk = w[m * topk + k];
      const uint4 v = *reinterpret_cast<const uint4*>(
          y + static_cast<long long>(m * topk + k) * H + c);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(moe_as_bf162(u[q]));
        acc[2 * q] += wk * f.x;
        acc[2 * q + 1] += wk * f.y;
      }
    }
    const uint4 v = *reinterpret_cast<const uint4*>(
        shared + static_cast<long long>(m) * H + c);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(moe_as_bf162(u[q]));
      o[q] = moe_as_u32(__floats2bfloat162_rn(acc[2 * q] + gate * f.x,
                                              acc[2 * q + 1] + gate * f.y));
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * H + c) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int BITS, int BM, bool GATEUP>
static cudaError_t moe_launch(const MoeArgs& a, int tiles, int col_blocks,
                              cudaStream_t stream) {
  const int smem = 2 * MoeSmem<BITS, BM>::stage(a.sb);
  dim3 grid(tiles, col_blocks);
  if constexpr (BM == 16) {
    cudaFuncSetAttribute(moe_gemv_kernel<BITS, GATEUP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    moe_gemv_kernel<BITS, GATEUP><<<grid, MOE_THREADS, smem, stream>>>(a);
  } else {
    cudaFuncSetAttribute(moe_tile_kernel<BITS, GATEUP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    moe_tile_kernel<BITS, GATEUP><<<grid, MOE_THREADS, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int BITS, bool GATEUP>
static cudaError_t moe_launch_bm(const MoeArgs& a, int bm, int tiles,
                                 int col_blocks, cudaStream_t stream) {
  return bm == 16 ? moe_launch<BITS, 16, GATEUP>(a, tiles, col_blocks, stream)
                  : moe_launch<BITS, 64, GATEUP>(a, tiles, col_blocks, stream);
}

// The pair layout of ids [P] (experts below E): sorted [tiles * bm],
// tile_expert [tiles]; adds the experts hit, P and E to counts[0], counts[c],
// counts[2c] (c the stride between the three counters).
extern "C" int amq_moe_align(const int64_t* ids, int P, int E, int bm,
                             int tiles, int* sorted, int* tile_expert,
                             unsigned long long* counts, int c,
                             void* stream) {
  if (P < 1 || E < 1 || E > MOE_MAX_E || bm < 1 || tiles < 1) return -1;
  moe_align_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, P, E, bm, tiles, sorted, tile_expert, counts, counts + c,
      counts + 2 * c);
  return static_cast<int>(cudaGetLastError());
}

// One expert product over the tiles of amq_moe_align's layout.  gateup:
// x [M, K], packed [E', K*b/32, 2I] from the layer's first expert, out act
// [tiles*bm, I]; down (gateup 0): x = act [tiles*bm, K], packed
// [E', K*b/32, N], out y [P, N].  -1 for arguments the kernels do not take.
extern "C" int amq_moe_experts(int gateup, const void* x, const int32_t* packed,
                               const void* scale, const void* zero,
                               long long w_stride, long long m_stride,
                               const int* sorted, const int* tile_expert,
                               void* out, int K, int N, int nbits,
                               int superblock, int topk, int bm, int tiles,
                               void* stream) {
  const int I = gateup ? N / 2 : 0;
  if ((nbits != 2 && nbits != 4) || (bm != 16 && bm != 64) ||
      superblock % MOE_GROUP || superblock > 1024 || K % superblock ||
      (gateup ? (N % 128 || I % 64) : N % MOE_BN) || topk < 1 || tiles < 1)
    return -1;
  MoeArgs a{static_cast<const __nv_bfloat16*>(x),
            reinterpret_cast<const uint32_t*>(packed),
            static_cast<const __nv_bfloat16*>(scale),
            static_cast<const __nv_bfloat16*>(zero),
            w_stride, m_stride, sorted, tile_expert,
            static_cast<__nv_bfloat16*>(out), K, N, I, superblock, topk};
  const int col_blocks = gateup ? I / 64 : N / MOE_BN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (nbits == 4) {
    rc = gateup ? moe_launch_bm<4, true>(a, bm, tiles, col_blocks, s)
                : moe_launch_bm<4, false>(a, bm, tiles, col_blocks, s);
  } else {
    rc = gateup ? moe_launch_bm<2, true>(a, bm, tiles, col_blocks, s)
                : moe_launch_bm<2, false>(a, bm, tiles, col_blocks, s);
  }
  return static_cast<int>(rc);
}

extern "C" int amq_moe_combine(const void* y, const float* w,
                               const void* shared, const float* s, void* out,
                               int M, int topk, int H, void* stream) {
  if (M < 1 || topk < 1 || H % 8) return -1;
  moe_combine_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), w,
      static_cast<const __nv_bfloat16*>(shared), s,
      static_cast<__nv_bfloat16*>(out), topk, H);
  return static_cast<int>(cudaGetLastError());
}
