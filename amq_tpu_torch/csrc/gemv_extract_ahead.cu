// Extract-ahead decode GEMV on tensor cores, M = 1.
//
// Replaces the Pallas kernel of scripts/pipelined_gemv.py (`_pipe_kernel`,
// launched by the `pl.pallas_call`s of its `build_pipe` and
// `check_parity`).  That kernel computes the decode GEMV in the grouped
// form of the JAX package's _gemv_blockdiag (ops/quant_matmul.py):
//
//   yp[g, n] = sum_{k in group g} x_k * (128 + c[k, n])        (the dot)
//   y[n]     = sum_g s[g, n] * yp[g, n]
//              - s[g, n] * (z[g, n] + 128) * xsum_g             (correction)
//
// with xsum_g the f32 sum of the bf16-rounded x the dot consumes (a
// full-precision xsum would leave 128 x the rounding residual), and it
// overlaps the extraction of superblock k+1 into a code slab with the dot
// of superblock k.  Here, per block of kBN = 32 columns, looping over the
// Kp/1024 superblocks (4 or 11 at the Llama-2-7B sites):
//
// * producer warps (4 of 8) keep a two-stage ring of packed-word slabs
//   filled with 16-byte cp.async copies (the TPU's make_async_copy pair)
//   and extract slab k+1 into a two-stage bf16 code ring: each word half
//   becomes a bf16 `128 + c` through (w >> s) & mask | 0x4300_4300, and
//   a word's two halves are the two consecutive K rows one 32-bit
//   register of an mma B fragment holds.  3-bit takes the 2-bit plane
//   under 0x4380 (256 + 2 c_hi) and recombines (hi - 256) + lo in bf16,
//   exact at every step (values <= 135);
// * meanwhile consumer warps (4 of 8, one 8-column n-tile each) run slab
//   k's dot with mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  The A
//   operand is the block-diagonal X': row g holds x only on group g's 128
//   columns, so a k16 step (inside one group) has one nonzero A row and
//   rows 8-15 are zero padding; all 64 steps of a superblock accumulate
//   into one C tile whose row g is yp[g, :].  The epilogue applies the
//   correction per superblock into f32 column totals, and the output is
//   rounded to bf16 once.
//
// Shared memory sets the design.  The TPU holds [2, 1024, 2048] bf16 codes
// (8 MB of VMEM); a Hopper block has 227 KB, and one 1024 x 64 bf16 code
// stage alone is 128 KB.  So the column tile is 32: two code stages of
// 1024 rows x 32 columns (each column padded to 1032 codes so the mma
// fragment loads hit 32 distinct banks) are 132,096 bytes, plus two word
// stages of R rows x 40 words (32 + 8 pad, keeping the 16-byte cp.async
// alignment and conflict-free producer reads): 173,056 bytes at 4-bit.
// One 256-thread block per SM follows; ceil(N/32) blocks (128 at the o
// and down sites, 688 at gateup).
//
// Bound on the H100: bytes (every packed word and scale/zero value read
// once per call; the tensor cores do 16 x the useful multiply-adds, still
// far below their rate).  This is the probe of the TPU layout's question
// on Hopper: whether moving the dot to tensor cores and taking the
// extraction to a cheaper bf16 form frees the CUDA cores enough to move
// the GEMV toward its byte bound.

#include <cstring>

#include "qmm_tile.cuh"

using namespace amq;

namespace {

constexpr int kSB = 1024;            // superblock rows (K step)
constexpr int kG = 8;                // groups of 128 per superblock
constexpr int kCols = 32;            // columns per block
constexpr int kCodeStride = 516;     // 32-bit words per code column (1032 bf16)
constexpr int kWordStride = 40;      // words per word-stage row
constexpr int kBlock = 256;          // 4 consumer + 4 producer warps
constexpr int kProducers = 128;

__host__ __device__ constexpr int word_rows(int nb) { return kSB * nb / 32; }

__host__ __device__ constexpr int smem_bytes(int nb) {
  return 2 * kCols * kCodeStride * 4 + 2 * word_rows(nb) * kWordStride * 4;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  __nv_bfloat162 r;
  memcpy(&r, &v, 4);
  return r;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// Copies of superblock `sbi`'s word slab (columns col0..col0+31) into a
// word stage [R][kWordStride]; columns at or past Np arrive as zeros.
template <int NB>
__device__ __forceinline__ void issue_words(const uint32_t* packed, int Np,
                                            int col0, int sbi, uint32_t* wst,
                                            int pt) {
  constexpr int R = word_rows(NB);
  const uint32_t* src = packed + static_cast<size_t>(sbi) * R * Np;
  for (int c = pt; c < R * (kCols / 4); c += kProducers) {
    const int r = c >> 3, q = c & 7;
    const int col = col0 + q * 4;
    const bool ok = col < Np;
    cp_async16(wst + r * kWordStride + q * 4,
               ok ? src + static_cast<size_t>(r) * Np + col : packed, ok);
  }
}

// Producer item -> (column, word row): a warp covers 8 columns x 4 rows,
// so its word-stage reads (stride 40) and code-stage writes (stride 516)
// each touch 32 distinct banks.
__device__ __forceinline__ void item_rc(int item, int& n, int& r) {
  const int lane = item & 31, chunk = item >> 5;
  n = (lane & 7) + 8 * (chunk & 3);
  r = (lane >> 3) + 4 * (chunk >> 2);
}

// Extract one word stage into one code stage: code column n holds the bf16
// values 128 + c[k, n] for k = 0..1023, two per 32-bit word.
template <int NB>
__device__ __forceinline__ void extract(const uint32_t* wst, uint32_t* cst,
                                        int pt) {
  if constexpr (NB == 3) {
    // hi plane: 64 rows of 2-bit fields (code k = 128p + 2r + h); lo plane:
    // 32 rows of 1-bit fields (k = 64p + 2r + h), so hi row r, round p
    // meets lo row r % 32, round 2p + r / 32
    const __nv_bfloat162 b256 = __floats2bfloat162_rn(256.f, 256.f);
    for (int item = pt; item < 64 * kCols; item += kProducers) {
      int n, r;
      item_rc(item, n, r);
      const uint32_t wh = wst[r * kWordStride + n];
      const uint32_t wl = wst[(64 + (r & 31)) * kWordStride + n];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t hi = ((wh >> (2 * p)) & 0x00030003u) | 0x43804380u;
        const uint32_t lo =
            ((wl >> (2 * p + (r >> 5))) & 0x00010001u) | 0x43004300u;
        cst[n * kCodeStride + p * 64 + r] =
            as_u32(__hadd2(__hsub2(as_bf162(hi), b256), as_bf162(lo)));
      }
    }
  } else {
    constexpr int R = word_rows(NB), P = 16 / NB;
    constexpr uint32_t pm = ((1u << NB) - 1u) * 0x00010001u;
    for (int item = pt; item < R * kCols; item += kProducers) {
      int n, r;
      item_rc(item, n, r);
      const uint32_t w = wst[r * kWordStride + n];
#pragma unroll
      for (int p = 0; p < P; ++p)
        cst[n * kCodeStride + p * R + r] = ((w >> (NB * p)) & pm) | 0x43004300u;
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // A rows 8-15 (registers a1, a3) are the zero padding; no side effects,
  // so not volatile: the compiler may schedule it
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t x_pair(const __nv_bfloat16* x, int K,
                                           int k) {
  // K is even, so a pair at even k is wholly inside or past K
  return k < K ? *reinterpret_cast<const uint32_t*>(x + k) : 0u;
}

// Consumer warp `cw`: superblock sbi's dot over code stage `cst` for the
// block's columns cw*8 .. cw*8+7 and its correction, added to col_acc
// (lanes 0-3 hold columns 2q, 2q+1 of the n-tile).
__device__ __forceinline__ void consume(const uint32_t* cst,
                                        const __nv_bfloat16* x, int K,
                                        const __nv_bfloat16* scale,
                                        const __nv_bfloat16* zero, int Np,
                                        int col0, int sbi, int cw, int lane,
                                        float (&col_acc)[2]) {
  const int gid = lane >> 2, q = lane & 3;
  const uint32_t* cb = cst + (cw * 8 + gid) * kCodeStride;
  // Every device-memory load of the superblock first, all independent: the
  // x pairs of this lane's A row (group gid; 16 registers) and the
  // column's scale / zero of group gid.  Loaded inside the k loop, each
  // k step waited one load latency.
  uint32_t xa[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = sbi * kSB + gid * 128 + j * 16 + 2 * q;
    xa[2 * j] = x_pair(x, K, k);
    xa[2 * j + 1] = x_pair(x, K, k + 8);
  }
  const int col = col0 + cw * 8 + 2 * q;
  float2 s = make_float2(0.f, 0.f), z = make_float2(0.f, 0.f);
  if (col < Np) {
    const size_t m = static_cast<size_t>(sbi * kG + gid) * Np + col;
    s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(scale + m));
    z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zero + m));
  }
  float xs = 0.f;          // this lane's share of xsum of group gid
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 f = __bfloat1622float2(as_bf162(xa[j]));
    xs += f.x + f.y;
  }
  xs += __shfl_xor_sync(0xffffffffu, xs, 1);
  xs += __shfl_xor_sync(0xffffffffu, xs, 2);

  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int g = 0; g < kG; ++g) {
    const bool own = gid == g;   // A row g is the only nonzero row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kb = g * 128 + j * 16;
      const uint32_t a0 = own ? xa[2 * j] : 0u;
      const uint32_t a2 = own ? xa[2 * j + 1] : 0u;
      const uint32_t b0 = cb[(kb >> 1) + q];
      const uint32_t b1 = cb[(kb >> 1) + 4 + q];
      if (j & 1) {               // two accumulators: two mma chains
        mma_bf16(c1, a0, a2, b0, b1);
      } else {
        mma_bf16(c0, a0, a2, b0, b1);
      }
    }
  }
  // row gid of the C tile: yp[gid, 2q], yp[gid, 2q + 1]
  float v[2] = {s.x * (c0[0] + c1[0]) - s.x * (z.x + 128.f) * xs,
                s.y * (c0[1] + c1[1]) - s.y * (z.y + 128.f) * xs};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 4);
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 8);
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 16);
    col_acc[e] += v[e];
  }
}

// Grid ceil(N/32), block 256.  x [K] bf16; packed [Kp*NB/32, Np]; scale,
// zero [Kp/128, Np] bf16; out [N] bf16.
template <int NB>
__global__ void __launch_bounds__(kBlock)
    extract_ahead_kernel(const __nv_bfloat16* x, const uint32_t* packed,
                         const __nv_bfloat16* scale,
                         const __nv_bfloat16* zero, __nv_bfloat16* out, int K,
                         int Kp, int N, int Np) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = word_rows(NB);
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem);   // [2][32][516]
  uint32_t* words = codes + 2 * kCols * kCodeStride;     // [2][R][40]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool producer = warp >= 4;
  const int pt = tid - kProducers;
  const int col0 = blockIdx.x * kCols;
  const int n_sb = Kp / kSB;
  auto cstage = [&](int i) { return codes + (i & 1) * kCols * kCodeStride; };
  auto wstage = [&](int i) { return words + (i & 1) * R * kWordStride; };

  if (producer) {
    issue_words<NB>(packed, Np, col0, 0, wstage(0), pt);
    cp_async_commit();
    if (n_sb > 1) issue_words<NB>(packed, Np, col0, 1, wstage(1), pt);
    cp_async_commit();
    cp_async_wait<1>();
    producer_sync();
    extract<NB>(wstage(0), cstage(0), pt);
  }
  __syncthreads();

  float col_acc[2] = {0.f, 0.f};
  for (int i = 0; i < n_sb; ++i) {
    if (producer) {
      // slab i+2 goes into the word stage slab i left (extracted before
      // the barrier that closed iteration i-1)
      if (i + 2 < n_sb)
        issue_words<NB>(packed, Np, col0, i + 2, wstage(i), pt);
      cp_async_commit();
      if (i + 1 < n_sb) {
        cp_async_wait<1>();        // this thread's copies of slab i+1
        producer_sync();           // every producer's
        extract<NB>(wstage(i + 1), cstage(i + 1), pt);
      }
    } else {
      consume(cstage(i), x, K, scale, zero, Np, col0, i, warp, lane,
              col_acc);
    }
    __syncthreads();               // code stage i and word stage i+1 free
  }
  if (!producer && lane < 4) {
    const int col = col0 + warp * 8 + 2 * lane;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (col + e < N) out[col + e] = __float2bfloat16(col_acc[e]);
  }
}

template <int NB>
cudaError_t launch(const __nv_bfloat16* x, const uint32_t* packed,
                   const __nv_bfloat16* scale, const __nv_bfloat16* zero,
                   __nv_bfloat16* out, int K, int Kp, int N, int Np,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes(NB);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        extract_ahead_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  extract_ahead_kernel<NB><<<(N + kCols - 1) / kCols, kBlock, smem, stream>>>(
      x, packed, scale, zero, out, K, Kp, N, Np);
  return cudaGetLastError();
}

}  // namespace

// x [1, K] bf16 (K even, 4-byte aligned); packed int32 [Kp*nbits/32, Np];
// scale / zero bf16 [Kp/128, Np]; out [1, N] bf16.  Superblock 1024,
// group 128, nbits 2-4, Np a multiple of 4, 16-byte aligned words.
// Returns 0 or the launch's cudaError_t; -1 for arguments the kernel does
// not take.
extern "C" int amq_gemv_extract_ahead(const void* x, const int32_t* packed,
                                      const void* scale, const void* zero,
                                      void* out, int K, int Kp, int N, int Np,
                                      int nbits, int group_size,
                                      int superblock, void* stream) {
  if (superblock != kSB || group_size != kSB / kG || Kp % kSB || K > Kp ||
      K % 2 || N > Np || Np % 4 || !aligned16(packed) ||
      (reinterpret_cast<uintptr_t>(x) & 3u) ||
      (reinterpret_cast<uintptr_t>(scale) & 3u) ||
      (reinterpret_cast<uintptr_t>(zero) & 3u))
    return -1;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w = reinterpret_cast<const uint32_t*>(packed);
  const auto* s = static_cast<const __nv_bfloat16*>(scale);
  const auto* z = static_cast<const __nv_bfloat16*>(zero);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 2: return static_cast<int>(launch<2>(xb, w, s, z, o, K, Kp, N, Np, st));
    case 3: return static_cast<int>(launch<3>(xb, w, s, z, o, K, Kp, N, Np, st));
    case 4: return static_cast<int>(launch<4>(xb, w, s, z, o, K, Kp, N, Np, st));
    default: return -1;
  }
}
