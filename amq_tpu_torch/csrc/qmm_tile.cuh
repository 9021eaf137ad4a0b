// The decode-GEMV arithmetic over pair-planar packed weights, and one GEMV
// tile walked through a two-stage cp.async ring.
//
// Shared by quant_matmul.cu (the decode GEMV, whose loads go straight from
// device memory into registers), quant_matmul_pipe.cu (the pipelined decode
// GEMV and its SwiGLU variant) and quant_matmul_mlp.cu (the one-launch
// decode MLP).  All three take their extraction and fma order from
// superblock_fma, their row-slice sum from sum_slices and their split-K sum
// from reduce_splits_kernel, so they give the same bits.
//
// A block of kBN columns x kKS row slices (512 threads) accumulates x[M, K]
// @ dequant(W)[K, col0:col0+kBN].  In gemv_tile the packed words and the
// scale/zero of superblock i+1 travel from device memory into one stage of a
// shared-memory ring with 16-byte cp.async.cg copies (one commit group per
// superblock) while the threads extract and accumulate superblock i from
// the other stage: the Hopper counterpart of the TPU kernel's two code
// slabs, where the extraction of tile k overlaps the dot of tile k-1.
//
// Storage is the JAX package's (see quant_matmul.cu): per superblock of sb
// K-rows, R = sb*b/32 rows of 32-bit words [R, Np]; the code at block row
// k = p*2R + 2r + h sits in word row r at bit 16h + b*p; 3-bit is a 2-bit
// plane followed by a 1-bit plane; w = (c - z) * s per group of gs rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One named namespace and no anonymous one: nvcc names every anonymous
// namespace of a file alike in its host stubs, so a second one (the
// including file's) would make the kernels' stub names ambiguous.
namespace amq {

constexpr int kBN = 64;                // columns per block
constexpr int kKS = 8;                 // row slices per block
constexpr int kThreads = kBN * kKS;
constexpr int kStages = 2;             // ring depth (superblocks in flight)

// Activation operand: x [M, K] (row stride ldx), zero past M and K; with
// `u` set, the SwiGLU prologue silu(x) * u.
struct Operand {
  const void* x;
  const void* u;
  int x_bf16;
  int M, K, ldx;
};

// One layer's packed weight: words [Kp*b/32, Np], scale/zero [Kp/gs, Np].
struct Weights {
  const uint32_t* packed;
  const void* scale;
  const void* zero;
  int meta_bf16;
  int Np, group_size, superblock;
};

// One dequant-matmul call: out [M, N], or f32 partials [splits, M, N] when
// K is split over blocks (sb_per_split superblocks each).
struct GemvArgs {
  Operand op;
  Weights w;
  void* out;
  int out_bf16;
  float* partial;
  int N, Kp, sb_per_split;
};

__device__ __forceinline__ float load_f(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// x[m, k] (or silu(x) * u in f32, rounded to the input type, as the plain
// version does); zero past M and past K (the K pad is never read).
__device__ __forceinline__ float act_at(const Operand& a, int m, int k) {
  if (m >= a.M || k >= a.K) return 0.f;
  const size_t i = static_cast<size_t>(m) * a.ldx + k;
  float v = load_f(a.x, i, a.x_bf16);
  if (a.u != nullptr) {
    v = v / (1.f + expf(-v)) * load_f(a.u, i, a.x_bf16);
    if (a.x_bf16) v = round_bf16(v);
  }
  return v;
}

// One pair-planar plane of BITS-wide fields for this thread's column:
// `word(r)` is the plane's word row r, `meta(g)` the column's {scale,
// -zero*scale} of group g.  Within a chunk of rc rows, round p reads only
// group (p*2R + 2*r0) / gs, so its scale and zero sit in registers.
template <int BITS, bool ZERO, int MT, class Word, class Meta>
__device__ __forceinline__ void plane_fma(Word word, Meta meta, int R,
                                          float cmul, const float* xs, int sb,
                                          int gs, int ty, float (&acc)[MT]) {
  constexpr int P = 16 / BITS;
  constexpr uint32_t mask = (1u << BITS) - 1u;
  const int rc = R < gs / 2 ? R : gs / 2;
  for (int r0 = 0; r0 < R; r0 += rc) {
    float s[P], b[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float2 sz = meta((p * 2 * R + 2 * r0) / gs);
      s[p] = sz.x * cmul;
      b[p] = ZERO ? sz.y : 0.f;
    }
#pragma unroll 2
    for (int r = r0 + ty; r < r0 + rc; r += kKS) {
      const uint32_t wd = word(r);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float w0 = fmaf(static_cast<float>((wd >> (BITS * p)) & mask),
                              s[p], b[p]);
        const float w1 = fmaf(
            static_cast<float>((wd >> (16 + BITS * p)) & mask), s[p], b[p]);
        const int k = p * 2 * R + 2 * r;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xv = *reinterpret_cast<const float2*>(xs + m * sb + k);
          acc[m] = fmaf(xv.x, w0, fmaf(xv.y, w1, acc[m]));
        }
      }
    }
  }
}

// acc[m] += this thread's row slice of one superblock: xs [MT][sb] (f32
// activations) times the column whose word row r is `word(r)`.
template <int NB, int MT, class Word, class Meta>
__device__ __forceinline__ void superblock_fma(Word word, Meta meta,
                                               const float* xs, int sb, int gs,
                                               int ty, float (&acc)[MT]) {
  if constexpr (NB == 3) {
    // (2*hi + lo - z) * s: the hi plane carries 2*s, the lo plane the zero
    const int R2 = sb / 16;
    plane_fma<2, false, MT>(word, meta, R2, 2.f, xs, sb, gs, ty, acc);
    plane_fma<1, true, MT>([&](int r) { return word(R2 + r); }, meta, sb / 32,
                           1.f, xs, sb, gs, ty, acc);
  } else {
    plane_fma<NB, true, MT>(word, meta, sb * NB / 32, 1.f, xs, sb, gs, ty,
                            acc);
  }
}

// Bytes of shared memory: one ring stage (words, then scale rows, then
// zero rows, each row kBN wide), and the whole block (activation of one
// superblock in f32, then the ring, which the final cross-slice sum reuses).
__host__ __device__ inline int stage_bytes(int nbits, int sb, int gs,
                                           int meta_bf16) {
  return sb * nbits / 32 * kBN * 4 + 2 * (sb / gs) * kBN * (meta_bf16 ? 2 : 4);
}

__host__ __device__ inline int tile_smem_bytes(int nbits, int mt, int sb,
                                               int gs, int meta_bf16) {
  const int ring = kStages * stage_bytes(nbits, sb, gs, meta_bf16);
  const int red = kKS * mt * kBN * 4;
  return mt * sb * 4 + (ring > red ? ring : red);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of superblock `sbi` (columns col0..col0+kBN) into
// `stage`.  Columns at or past Np arrive as zeros.  Every source address is
// 16-byte aligned: the caller checks Np % 8 == 0 and the base pointers.
template <int NB>
__device__ __forceinline__ void issue_stage(const Weights& w, int col0, int sbi,
                                            unsigned char* stage, int tid) {
  const int sb = w.superblock, T = sb / w.group_size;
  const int R = sb * NB / 32;
  uint32_t* ws = reinterpret_cast<uint32_t*>(stage);
  const uint32_t* src = w.packed + static_cast<size_t>(sbi) * R * w.Np;
  constexpr int kWordChunks = kBN / 4;        // 16-byte chunks per word row
  for (int c = tid; c < R * kWordChunks; c += kThreads) {
    const int r = c / kWordChunks, q = c - r * kWordChunks;
    const int col = col0 + q * 4;
    const bool ok = col < w.Np;
    cp_async16(ws + r * kBN + q * 4,
               ok ? src + static_cast<size_t>(r) * w.Np + col : w.packed, ok);
  }
  const int es = w.meta_bf16 ? 2 : 4;
  const int cpr = kBN * es / 16;              // chunks per meta row
  const int epc = 16 / es;                    // values per chunk
  unsigned char* ms = stage + R * kBN * 4;
  for (int c = tid; c < 2 * T * cpr; c += kThreads) {
    const int row = c / cpr, q = c - row * cpr;   // rows: T scale, T zero
    const int which = row >= T, t = row - which * T;
    const int col = col0 + q * epc;
    const bool ok = col < w.Np;
    const unsigned char* base =
        static_cast<const unsigned char*>(which ? w.zero : w.scale);
    cp_async16(ms + row * kBN * es + q * 16,
               ok ? base + (static_cast<size_t>(sbi * T + t) * w.Np + col) * es
                  : base,
               ok);
  }
}

__device__ __forceinline__ float meta_at(const unsigned char* ms, int row,
                                         int tx, int bf16) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(ms)[row * kBN + tx])
              : reinterpret_cast<const float*>(ms)[row * kBN + tx];
}

// Superblocks [sb_lo, sb_hi) of the operand and the weight through the
// ring, each handed to `step(word, meta, xs, acc)` once it is staged:
// `word(r)` is this thread's column's word row r, `meta(g)` its {scale,
// zero} of group g, xs the activation [MT][sb].  Every thread of the block
// calls it; it ends with the block synchronised and the ring free.
template <int NB, int MT, class Step>
__device__ void gemv_tile(const Operand& op, const Weights& w, int col0,
                          int sb_lo, int sb_hi, unsigned char* smem,
                          float (&acc)[MT], Step step) {
  const int sb = w.superblock, gs = w.group_size, T = sb / gs;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kBN + tx;
  const int R = sb * NB / 32;
  const int sbytes = stage_bytes(NB, sb, gs, w.meta_bf16);
  const int meta_bf16 = w.meta_bf16;
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + MT * sb * 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  const int n = sb_hi - sb_lo;
  if (n <= 0) return;

  issue_stage<NB>(w, col0, sb_lo, ring, tid);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    // superblock i+1 goes into the stage superblock i-1 used (every thread
    // left it at the barrier that closed iteration i-1)
    if (i + 1 < n)
      issue_stage<NB>(w, col0, sb_lo + i + 1,
                      ring + ((i + 1) % kStages) * sbytes, tid);
    cp_async_commit();
    const int sbi = sb_lo + i;
    for (int j = tid; j < MT * sb; j += kThreads) {
      const int m = j / sb;
      xs[j] = act_at(op, m, sbi * sb + (j - m * sb));
    }
    cp_async_wait<1>();          // this thread's copies of superblock i
    __syncthreads();             // everyone's copies, and the activation
    const unsigned char* st = ring + (i % kStages) * sbytes;
    const uint32_t* wcol = reinterpret_cast<const uint32_t*>(st) + tx;
    const unsigned char* ms = st + R * kBN * 4;
    step([=](int r) { return wcol[r * kBN]; },
         [=](int g) {
           return make_float2(meta_at(ms, g, tx, meta_bf16),
                              meta_at(ms, T + g, tx, meta_bf16));
         },
         xs, acc);
    __syncthreads();             // stage i and the activation are free
  }
}

// acc[m] (per thread: its column, its row slice) over superblocks
// [sb_lo, sb_hi) of the operand times the weight: gemv_tile with
// superblock_fma as its step.
template <int NB, int MT>
__device__ void gemv_tile(const Operand& op, const Weights& w, int col0,
                          int sb_lo, int sb_hi, unsigned char* smem,
                          float (&acc)[MT]) {
  const int sb = w.superblock, gs = w.group_size, ty = threadIdx.y;
  gemv_tile<NB, MT>(
      op, w, col0, sb_lo, sb_hi, smem, acc,
      [=](auto word, auto meta, const float* xs, float (&a)[MT]) {
        superblock_fma<NB, MT>(
            word,
            [=](int g) {
              const float2 sz = meta(g);
              return make_float2(sz.x, -sz.y * sz.x);
            },
            xs, sb, gs, ty, a);
      });
}

// Sum the kKS row slices: afterwards the threads of slice 0 hold their
// column's totals in acc.  `red` [kKS][MT][kBN] may alias the ring
// (gemv_tile has released it).
template <int MT>
__device__ __forceinline__ void sum_slices(float (&acc)[MT], float* red) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(ty * MT + m) * kBN + tx] = acc[m];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < kKS; ++s) v += red[(s * MT + m) * kBN + tx];
      acc[m] = v;
    }
  }
  __syncthreads();
}

// After sum_slices: slice 0 writes its column n of the output (rounded
// once), or of split blockIdx.y's partials when K is split.
template <int MT>
__device__ __forceinline__ void write_cols(const GemvArgs& a,
                                           const float (&acc)[MT], int n) {
  if (threadIdx.y != 0 || n >= a.N) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= a.op.M) break;
    if (gridDim.y == 1) {
      store_f(a.out, static_cast<size_t>(m) * a.N + n, acc[m], a.out_bf16);
    } else {
      a.partial[(static_cast<size_t>(blockIdx.y) * a.op.M + m) * a.N + n] =
          acc[m];
    }
  }
}

// out[i] = sum over splits of partial[s, i], rounded once.
__global__ void reduce_splits_kernel(const float* partial, void* out, int MN,
                                     int splits, int out_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[static_cast<size_t>(s) * MN + i];
  store_f(out, i, v, out_bf16);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace amq
