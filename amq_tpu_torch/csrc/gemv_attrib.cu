// Attribution probe of the decode GEMV: the production body with parts
// taken out.
//
// Replaces the Pallas kernel of scripts/kernel_attrib.py (`_kernel`,
// launched by the `pl.pallas_call` of its `build`), which times the TPU
// GEMV body with the extraction, the dot or both removed.  Here a body
// per production decode GEMV, templated on <NB, MT, VARIANT>, wraps the
// loop of qmm_tile.cuh's superblock_fma in that GEMV's launch shape and
// shared-memory use:
//
//   kGemv  qmm_gemv_kernel (quant_matmul.cu): words straight from device
//          memory into registers, activation and meta staged in shared
//          memory once per superblock;
//   kPipe  the same GEMV with words and meta through the two-stage
//          cp.async ring of qmm_tile.cuh's gemv_tile, which every variant
//          runs, with its own step per superblock (the pipelined route's
//          design before it took the grouped form).
//
// Every variant loads the same bytes as production (the activation, every
// scale/zero, every packed word); they differ only in what they do with
// them:
//
//   kFull     the production arithmetic (superblock_fma, gemv_tile,
//             sum_slices, write_cols, reduce_splits_kernel themselves), so
//             its output equals the production GEMV's bit for bit;
//   kFmaOnly  no extraction: every code is 129.0f, built as
//             (word & zmask_h) | bits(129.0f) with zmask_h run-time zeros
//             that differ for the two halves h of a word, so the compiler
//             can neither fold the code nor merge the two dequantizing
//             fmafs of a word (the rounds p differ in their scale): the
//             same fmaf count per weight as kFull.  The words are
//             XOR-folded per column (xr) as well;
//   kExtOnly  kFull's shift, mask and int->float conversion, no FMA
//             against x: the codes are summed per column in f32 (cs;
//             integers below 2^24, so exact) in one chain, as kFull's dot
//             is one chain of fmafs, and the meta values XOR-folded into
//             xr;
//   kLoadOnly words and meta XOR-folded per column into xr.
//
// xr and cs combine over row slices and K splits with atomicXor /
// atomicAdd, both order-free here (XOR; integer-valued f32 sums below
// 2^24), so every output is a deterministic function with a plain
// PyTorch version (probes/kernel_attrib.py).
//
// Every variant runs with as many blocks resident per SM as kFull in the
// same body and width, so that a time tracking kFull's says what kFull's
// critical path is and not how many loads each variant keeps in flight.  A
// stripped variant is compiled for kFull's blocks per SM (min_blocks below,
// from kFull's registers), which caps its registers; where it would still
// fit more blocks, its launch pads the dynamic shared memory until it fits
// as many (plan).  amq_gemv_attrib_occupancy reports the blocks, registers,
// local bytes and shared memory each variant launches with.
//
// Bound on the H100: bytes, as the production GEMV (every word and meta
// value read once per call, a few operations per weight).  The question
// the probe answers is which of loads, extraction and FMAs sets the
// production time: the variant whose time tracks kFull's is on the
// critical path.

#include <algorithm>

#include "qmm_tile.cuh"

using namespace amq;

namespace {

enum Body { kGemv = 0, kPipe = 1 };
enum Variant { kFull = 0, kFmaOnly = 1, kExtOnly = 2, kLoadOnly = 3 };

// Blocks of kFull per SM at 512 threads, from its registers per thread on
// sm_90a (65536 per SM; the production kernels' own): GEMV body 64, 89, 40
// at 2, 3, 4 bits; pipelined body 64, 91, 59.  The stripped variants are
// compiled to fit as many (their kernels *_pinned).  kFull keeps
// production's bare __launch_bounds__(kThreads): a minimum of even one
// block per SM changes how ptxas allocates its registers.
constexpr int min_blocks(int nb, int body) {
  if (nb == 3) return 1;
  return nb == 4 && body == kGemv ? 3 : 2;
}

// Outputs of the stripped variants, folded into (XOR, add): zeroed by the
// caller for a fresh result.
struct Probe {
  uint32_t* xr;     // [N] XOR fold
  float* cs;        // [N] code sums
  uint32_t zmask;   // 0 at run time
};

constexpr uint32_t kBits129 = 0x43010000u;   // 129.0f

// One pair-planar plane of a stripped variant, with plane_fma's loop
// structure and word / meta access (qmm_tile.cuh).
template <int BITS, bool ZERO, int MT, int VARIANT, class Word, class Meta>
__device__ __forceinline__ void plane_probe(Word word, Meta meta, int R,
                                            float cmul, const float* xs,
                                            int sb, int gs, int ty,
                                            uint32_t zmask, float (&acc)[MT],
                                            uint32_t& xr, float& cs) {
  constexpr int P = 16 / BITS;
  constexpr uint32_t mask = (1u << BITS) - 1u;
  const int rc = R < gs / 2 ? R : gs / 2;
  const uint32_t zlo = zmask, zhi = zmask >> 1;
  for (int r0 = 0; r0 < R; r0 += rc) {
    float s[P], b[P];
    if constexpr (VARIANT == kFmaOnly) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float2 sz = meta((p * 2 * R + 2 * r0) / gs);
        s[p] = sz.x * cmul;
        b[p] = ZERO ? sz.y : 0.f;
      }
    }
#pragma unroll 2
    for (int r = r0 + ty; r < r0 + rc; r += kKS) {
      const uint32_t wd = word(r);
      if constexpr (VARIANT == kFmaOnly || VARIANT == kLoadOnly) xr ^= wd;
      if constexpr (VARIANT == kFmaOnly) {
        const float c0 = __uint_as_float((wd & zlo) | kBits129);
        const float c1 = __uint_as_float((wd & zhi) | kBits129);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float w0 = fmaf(c0, s[p], b[p]);
          const float w1 = fmaf(c1, s[p], b[p]);
          const int k = p * 2 * R + 2 * r;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float2 xv =
                *reinterpret_cast<const float2*>(xs + m * sb + k);
            acc[m] = fmaf(xv.x, w0, fmaf(xv.y, w1, acc[m]));
          }
        }
      } else if constexpr (VARIANT == kExtOnly) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          cs += static_cast<float>((wd >> (BITS * p)) & mask);
          cs += static_cast<float>((wd >> (16 + BITS * p)) & mask);
        }
      }
    }
  }
}

// One staged superblock of a stripped variant: superblock_fma's plane
// split (qmm_tile.cuh) over plane_probe, with `meta(g)` the column's
// {scale, -zero*scale}, then (kExtOnly, kLoadOnly) the XOR fold of
// `raw(g)`, the column's staged meta values.
template <int NB, int MT, int VARIANT, class Word, class Meta, class Raw>
__device__ __forceinline__ void probe_step(Word word, Meta meta, Raw raw,
                                           const float* xs, int sb, int gs,
                                           int ty, uint32_t zmask,
                                           float (&acc)[MT], uint32_t& xr,
                                           float& cs) {
  if constexpr (NB == 3) {
    const int R2 = sb / 16;
    plane_probe<2, false, MT, VARIANT>(word, meta, R2, 2.f, xs, sb, gs, ty,
                                       zmask, acc, xr, cs);
    plane_probe<1, true, MT, VARIANT>([&](int r) { return word(R2 + r); },
                                      meta, sb / 32, 1.f, xs, sb, gs, ty,
                                      zmask, acc, xr, cs);
  } else {
    plane_probe<NB, true, MT, VARIANT>(word, meta, sb * NB / 32, 1.f, xs, sb,
                                       gs, ty, zmask, acc, xr, cs);
  }
  if constexpr (VARIANT == kExtOnly || VARIANT == kLoadOnly) {
    if (ty == 0) {
      for (int g = 0; g < sb / gs; ++g) {
        const float2 v = raw(g);
        xr ^= __float_as_uint(v.x) ^ __float_as_uint(v.y);
      }
    }
  }
}

// The stripped variants' column totals: xr and cs of this thread's row
// slice into the column's outputs.
template <int VARIANT>
__device__ __forceinline__ void fold_out(const Probe& pr, int n, int N,
                                         uint32_t xr, float cs) {
  if (n >= N) return;
  if constexpr (VARIANT != kFull) {
    if (xr) atomicXor(pr.xr + n, xr);
  }
  if constexpr (VARIANT == kExtOnly) atomicAdd(pr.cs + n, cs);
}

// BODY kGemv: qmm_gemv_kernel's launch shape, shared memory and staging.
// Block (kBN, kKS); grid (ceil(N/kBN), splits).
template <int NB, int MT, int VARIANT>
__device__ __forceinline__ void gemv_body(GemvArgs a, Probe pr) {
  // both bodies declare the dynamic shared memory alike (bytes)
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = a.w.superblock, gs = a.w.group_size, T = sb / gs;
  const int Np = a.w.Np;
  float* xs = reinterpret_cast<float*>(smem);   // [MT][sb]
  float* ss = xs + MT * sb;          // [T][kBN] scale
  float* bs = ss + T * kBN;          // [T][kBN] -zero*scale (kFull, kFmaOnly)
                                     //          or zero (the others)
  float* red = bs + T * kBN;         // [kKS][MT][kBN]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBN + tx;
  const int n = blockIdx.x * kBN + tx;
  const int n_sb = a.Kp / sb;
  const int sb_lo = blockIdx.y * a.sb_per_split;
  const int sb_hi = min(n_sb, sb_lo + a.sb_per_split);
  const int rows_sb = sb * NB / 32;
  constexpr bool kFmaMeta = VARIANT == kFull || VARIANT == kFmaOnly;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  uint32_t xr = 0;
  float cs = 0.f;

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
      bs[i] = kFmaMeta ? -z * s : z;
    }
    __syncthreads();
    if (n < a.N) {
      const uint32_t* w =
          a.w.packed + static_cast<size_t>(sbi) * rows_sb * Np + n;
      auto word = [=](int r) { return __ldg(w + static_cast<size_t>(r) * Np); };
      auto meta = [=](int g) {
        return make_float2(ss[g * kBN + tx], bs[g * kBN + tx]);
      };
      if constexpr (VARIANT == kFull) {
        superblock_fma<NB, MT>(word, meta, xs, sb, gs, ty, acc);
      } else {
        probe_step<NB, MT, VARIANT>(word, meta, meta, xs, sb, gs, ty,
                                    pr.zmask, acc, xr, cs);
      }
    }
  }
  if constexpr (kFmaMeta) {
    sum_slices<MT>(acc, red);
    write_cols<MT>(a, acc, n);
  }
  fold_out<VARIANT>(pr, n, a.N, xr, cs);
}

// BODY kPipe: qmm_pipe_kernel's launch shape and shared memory; every
// variant walks gemv_tile's ring.
template <int NB, int MT, int VARIANT>
__device__ __forceinline__ void pipe_body(GemvArgs a, Probe pr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = a.w.superblock, gs = a.w.group_size, ty = threadIdx.y;
  const int col0 = blockIdx.x * kBN;
  const int sb_lo = blockIdx.y * a.sb_per_split;
  const int sb_hi = min(a.Kp / sb, sb_lo + a.sb_per_split);
  float acc[MT];
  uint32_t xr = 0;
  float cs = 0.f;
  if constexpr (VARIANT == kFull) {
    gemv_tile<NB, MT>(a.op, a.w, col0, sb_lo, sb_hi, smem, acc);
  } else {
    const uint32_t zmask = pr.zmask;
    gemv_tile<NB, MT>(
        a.op, a.w, col0, sb_lo, sb_hi, smem, acc,
        [&](auto word, auto raw, const float* xs, float (&ac)[MT]) {
          probe_step<NB, MT, VARIANT>(
              word,
              [=](int g) {
                const float2 sz = raw(g);
                return make_float2(sz.x, -sz.y * sz.x);
              },
              raw, xs, sb, gs, ty, zmask, ac, xr, cs);
        });
  }
  if constexpr (VARIANT == kFull || VARIANT == kFmaOnly) {
    sum_slices<MT>(acc, reinterpret_cast<float*>(smem + MT * sb * 4));
    write_cols<MT>(a, acc, col0 + threadIdx.x);
  }
  fold_out<VARIANT>(pr, col0 + threadIdx.x, a.N, xr, cs);
}

// The kernels: kFull under production's launch bounds, the stripped
// variants compiled for kFull's blocks per SM.
template <int NB, int MT, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    attrib_gemv_kernel(GemvArgs a, Probe pr) {
  gemv_body<NB, MT, VARIANT>(a, pr);
}

template <int NB, int MT, int VARIANT>
__global__ void __launch_bounds__(kThreads, min_blocks(NB, kGemv))
    attrib_gemv_pinned(GemvArgs a, Probe pr) {
  gemv_body<NB, MT, VARIANT>(a, pr);
}

template <int NB, int MT, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    attrib_pipe_kernel(GemvArgs a, Probe pr) {
  pipe_body<NB, MT, VARIANT>(a, pr);
}

template <int NB, int MT, int VARIANT>
__global__ void __launch_bounds__(kThreads, min_blocks(NB, kPipe))
    attrib_pipe_pinned(GemvArgs a, Probe pr) {
  pipe_body<NB, MT, VARIANT>(a, pr);
}

// The kernel of one body and variant (M = 1).
template <int NB, int VARIANT>
constexpr auto kernel_of(int body) {
  if constexpr (VARIANT == kFull) {
    return body == kGemv ? attrib_gemv_kernel<NB, 1, VARIANT>
                         : attrib_pipe_kernel<NB, 1, VARIANT>;
  } else {
    return body == kGemv ? attrib_gemv_pinned<NB, 1, VARIANT>
                         : attrib_pipe_pinned<NB, 1, VARIANT>;
  }
}

// How one variant launches at one layout: its kernel, its dynamic shared
// memory (the body's own, or padded) and the blocks per SM that follow.
struct Plan {
  const void* fn;
  int smem;
  int blocks;
};

int own_smem(int nb, int body, int sb, int gs, int meta_bf16) {
  if (body == kGemv)   // quant_matmul.cu's launch_gemv, M = 1
    return static_cast<int>(sizeof(float) *
                            (sb + 2 * (sb / gs) * kBN + kKS * kBN));
  return tile_smem_bytes(nb, 1, sb, gs, meta_bf16);   // gemv_tile's ring
}

cudaError_t blocks_per_sm(const void* fn, int smem, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                       smem);
}

// The variant's plan, worked out at its first launch per body and layout:
// kFull's own; a stripped variant that would fit more blocks per SM than
// kFull gets more dynamic shared memory until it fits as many.
template <int NB, int VARIANT>
cudaError_t plan(int body, int sb, int gs, int meta_bf16, Plan* out) {
  static Plan cached[2];
  static int cached_own[2] = {-1, -1};
  const int own = own_smem(NB, body, sb, gs, meta_bf16);
  if (cached_own[body] == own) {
    *out = cached[body];
    return cudaSuccess;
  }
  const void* fn = reinterpret_cast<const void*>(kernel_of<NB, VARIANT>(body));
  int dev = 0, per_sm = 0, reserved = 0, optin = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  int smem = own;
  if (e == cudaSuccess) e = blocks_per_sm(fn, smem, &blocks);
  if constexpr (VARIANT != kFull) {
    Plan full{};
    if (e == cudaSuccess) e = plan<NB, kFull>(body, sb, gs, meta_bf16, &full);
    if (e == cudaSuccess && blocks > full.blocks) {
      // too large for one block more than kFull fits
      smem = std::max(own, per_sm / (full.blocks + 1) - reserved + 128);
      e = blocks_per_sm(fn, smem, &blocks);
      while (e == cudaSuccess && blocks > full.blocks && smem + 128 <= optin) {
        smem += 128;
        e = blocks_per_sm(fn, smem, &blocks);
      }
    }
  }
  if (e != cudaSuccess) return e;
  *out = Plan{fn, smem, blocks};
  cached[body] = *out;
  cached_own[body] = own;
  return cudaSuccess;
}

// M = 1 (the decode probe's case): MT = 1.
template <int NB, int VARIANT>
cudaError_t launch(const GemvArgs& a, const Probe& pr, int body, int splits,
                   cudaStream_t stream) {
  Plan p{};
  cudaError_t e = plan<NB, VARIANT>(body, a.w.superblock, a.w.group_size,
                                    a.w.meta_bf16, &p);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kBN - 1) / kBN, splits), block(kBN, kKS);
  kernel_of<NB, VARIANT>(body)<<<grid, block, p.smem, stream>>>(a, pr);
  return cudaGetLastError();
}

template <int NB, int VARIANT>
struct Tag {
  static constexpr int nb = NB, variant = VARIANT;
};

template <int NB, class F>
cudaError_t visit_variant(int variant, F f) {
  switch (variant) {
    case kFull: return f(Tag<NB, kFull>{});
    case kFmaOnly: return f(Tag<NB, kFmaOnly>{});
    case kExtOnly: return f(Tag<NB, kExtOnly>{});
    default: return f(Tag<NB, kLoadOnly>{});
  }
}

// f(Tag<nbits, variant>) for nbits 2-4 and the four variants.
template <class F>
cudaError_t visit(int nbits, int variant, F f) {
  switch (nbits) {
    case 2: return visit_variant<2>(variant, f);
    case 3: return visit_variant<3>(variant, f);
    default: return visit_variant<4>(variant, f);
  }
}

bool takes(int nbits, int body, int variant) {
  return nbits >= 2 && nbits <= 4 && (body == kGemv || body == kPipe) &&
         variant >= kFull && variant <= kLoadOnly;
}

}  // namespace

// The arguments of amq_qmm (quant_matmul.cu) for M = 1, plus the stripped
// variants' outputs xr [N] (int32 bits) and cs [N] (f32), which the kernel
// folds into (XOR, add), `body` (0 GEMV, 1 pipelined GEMV), `variant` (0 full,
// 1 fma_only, 2 ext_only, 3 load_only) and `zmask` (pass 0).  Returns 0
// or the launch's cudaError_t; -1 for arguments the kernels do not take.
extern "C" int amq_gemv_attrib(const void* x, const void* u, int x_bf16,
                               const int32_t* packed, const void* scale,
                               const void* zero, int meta_bf16, void* out,
                               int out_bf16, float* partial, int32_t* xr,
                               float* cs, int M, int K, int ldx, int Kp, int N,
                               int Np, int nbits, int group_size,
                               int superblock, int splits, int sb_per_split,
                               int body, int variant, unsigned zmask,
                               void* stream) {
  if (M != 1 || superblock % 64 || superblock % group_size ||
      Kp % superblock || superblock > 1024 || splits < 1 ||
      !takes(nbits, body, variant))
    return -1;
  if (body == kPipe &&
      (Np % 8 || !aligned16(packed) || !aligned16(scale) || !aligned16(zero)))
    return -1;
  GemvArgs a{Operand{x, u, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  Probe pr{reinterpret_cast<uint32_t*>(xr), cs, zmask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = visit(nbits, variant, [&](auto t) {
    return launch<decltype(t)::nb, decltype(t)::variant>(a, pr, body, splits,
                                                         s);
  });
  const bool has_y = variant == kFull || variant == kFmaOnly;
  if (e != cudaSuccess || splits == 1 || !has_y) return static_cast<int>(e);
  const int MN = M * N;
  reduce_splits_kernel<<<(MN + 255) / 256, 256, 0, s>>>(partial, out, MN,
                                                        splits, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

// How one variant launches at a layout (superblock, group size, meta
// type): out[0] blocks per SM, out[1] registers per thread, out[2] local
// (spill) bytes per thread, out[3] dynamic shared memory bytes.  Returns 0,
// a cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int amq_gemv_attrib_occupancy(int nbits, int body, int variant,
                                         int superblock, int group_size,
                                         int meta_bf16, int* out) {
  if (!takes(nbits, body, variant) || superblock % group_size) return -1;
  return static_cast<int>(visit(nbits, variant, [&](auto t) {
    Plan p{};
    cudaError_t e = plan<decltype(t)::nb, decltype(t)::variant>(
        body, superblock, group_size, meta_bf16, &p);
    cudaFuncAttributes fa{};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, p.fn);
    if (e != cudaSuccess) return e;
    out[0] = p.blocks;
    out[1] = fa.numRegs;
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = p.smem;
    return cudaSuccess;
  }));
}
