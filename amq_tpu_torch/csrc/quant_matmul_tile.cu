// The multi-row (prefill) dequant-matmul on warpgroup MMA (wgmma): bf16
// activations, 8 < M.
//
// Replaces the multi-row branch of the Pallas kernels of the JAX
// package's ops/quant_matmul.py: _qmm_kernel (quant_matmul), its stacked
// form _qmm_kernel_stacked (quant_matmul_indexed) and _qmm_kernel_swiglu
// (quant_matmul_swiglu_indexed).  There, with bf16 x (acc_dtype = bf16),
// each superblock tile is dequantized once by _dequant_tile -- in bf16 at
// widths 1-4, rounding after each operation: ((128 + c) - 128 - z) * s
// with f32 meta cast to bf16 first (3-bit: c = 2 hi + lo from its planes,
// exact); at 8 bits (c - z) * s in f32, rounded to bf16 once -- kept in
// VMEM across the M tiles and fed to an MXU dot with f32 accumulation.
// This kernel computes the same bf16 weights and the same product.
//
// The product is taken transposed, out^T [N, M] = W^T [N, Kp] x^T [Kp, M],
// so that the weight is wgmma's A operand in registers and x is B from
// shared memory.  A register of A holds K rows 2j, 2j+1 of one column,
// and in the pair-planar layout those are the two 16-bit halves of one
// packed word: (w >> b p) & mask | 0x4300_4300 is the register's exact
// bf16 pair 128 + c, and two __hsub2 and one __hmul2 give the reference's
// bf16 weights (8 bits: a byte permute makes each code the float
// 2^23 + c, then (c - z) * s in f32 and cvt.rn.bf16x2).  The register
// form was taken over a dequantized bf16 tile in shared memory because
// the words, not the weights, then cross shared memory: the tile would
// be 4 (4-bit) to 16 (1-bit) times their bytes, written and read back.
// Each packed word is read from device memory, and each weight
// dequantized, once per call: a block owns its columns and its split's
// K for every row of its M tile (M padded to wgmma n64 sub-tiles, one,
// two or four of them, 256 rows; a larger M takes more M tiles, and
// dequantizes once per M tile).  x as stored, [M, K] with K contiguous,
// is B's K-major layout: each 16-byte piece of a row goes to its
// 128-byte-swizzled place by cp.async (zero-filled past K).
//
// Roles: two producer warps and WG consumer warpgroups of 64 columns
// each (three at M <= 64: 192 columns, one block an SM; two at M <= 128;
// one above, where four sub-tiles' accumulators take 128 registers).  A
// ring stage is ns word rows of a superblock's round plane (ns = 32, or
// 16 / 8 where the plane is smaller or the ring would not fit), with the
// matching 2-bit rows at 3 bits and the scale / zero rows of every group
// its rounds touch, by bulk copies on a full / empty mbarrier pair (up to
// three stages); its P extraction rounds are P x chunks of 2 ns K rows,
// in a ring of their own (up to four slots, cp.async completing on the
// slot's full mbarrier).  The 4-row superblocks (1 and 3 bits at 128
// rows, whose round plane has 4 word rows: a k16 step would straddle two
// superblocks' rounds) take the pair form (template PAIR, so that every
// offset is a constant): a stage holds kPairNs = 16 rows, four whole
// superblocks (the last stage of K the ones left), and its 16 chunks of
// 32 K rows are four per superblock in K order; a k16 step takes one
// superblock's rounds q and q + 1, whose 16 K rows are adjacent and in
// one group, from the same word row (K pairs t and t + 4: the row's fields
// at the two rounds), so a lane loads one word per column and plane for
// both halves of its A registers.  Each chunk's meta slot is its group's,
// as in the whole-stage form.  The two producers run ahead independently.  A
// consumer warp reads its two columns' words (one 8-byte load per word
// row) and meta from the stage, builds the A registers of a chunk (meta
// once per group and column), waits for the chunk's x and issues ns / 8
// k16 steps of m64n64k16 per M sub-tile; it keeps one chunk's products in
// flight while it extracts the next (two sets of A registers), frees an x
// slot once its products are done, and never writes an accumulator while
// products are in flight (the block's first products overwrite them: any
// other write makes ptxas serialize every wgmma).
//
// Bound on the H100: bytes at 3 and 4 bits and M = 64 (the words and meta
// once, x and out), operations at 2 bits and from M ~ 128 (the tensor
// cores do the M x N x K multiply-adds at the bf16 rate).  K is split
// across blocks where the column tiles alone would not fill the card;
// the split depends on N, Kp and the layout only (wrapper's _tile_plan),
// never on M, and the f32 partials are summed in fixed order by
// reduce_splits_kernel, so row m of a call has the same bits at any M and
// two calls are equal.
//
// The SwiGLU prologue of _qmm_kernel_swiglu (x = silu(g) * u in f32,
// rounded to bf16) is a pass of its own (swiglu_bf16_kernel, entry
// amq_swiglu_bf16), once per element: recomputed per column tile, as the
// TPU kernel's prologue is per n tile, its exponentials would outweigh
// the products at the down site (16 column tiles).
//
// The float32 form (qmm_tile_f32_kernel, entry amq_qmm_tile_f32): f32
// activations, 8 < M, the reference's f32 function (_dequant_tile in f32,
// an f32 dot).  Codes are exact in bf16, so A holds the codes themselves
// (128 + c minus 128 in bf16; 8 bits: the byte as a float, converted
// exactly) and x arrives split once into three bf16 parts (hi, mid, lo:
// quant_matmul_f32.cu's split pass, rows 3m + q).  The parts stack along
// the K of one accumulator -- per k16 step three wgmma of the same A
// registers against the three part slabs of the x slot -- and each chunk
// (2 ns K rows of one group: ns is chosen so that no chunk spans groups)
// is corrected once its products are done, tot += s acc - (z s) xsum,
// with the chunk's x sums from the split pass beside the parts in the x
// slot.  The split pass writes the parts as the x slot's own image (its
// swizzle, zeros past K), so the x producer issues four bulk copies a
// chunk, not 1,536 copies of 16 bytes at M 64: issued by one warp, those
// set the pace on the H100.  The f32 total sits beside the accumulators
// (32 + 32 registers), and chunk c's A registers are extracted while
// chunk c - 1's products run (two sets), so the block is the M <= 64 one
// (three consumer warpgroups, 192 columns; larger M takes more 64-row M
// tiles) and a stage holds at most 16 word rows: with two sub-tiles
// (168 registers a thread at 320 threads) or 32-row stages (128 at 448)
// ptxas spilled.  Chunk c - 1's correction follows its wait; the first
// product of a chunk overwrites the accumulators (scale-d 0).  Bound:
// operations at M = 64 (three bf16 products), bytes below.  Row m's bits
// do not depend on M, as above.

#include "qmm_grouped.cuh"
#include "wgmma.cuh"

using namespace amq;

namespace {

constexpr int kTMaxW = 3;                  // word ring slots, at most
constexpr int kTMaxX = 4;                  // x ring slots, at most
constexpr int kTMT = 256;                  // rows of an M tile
constexpr int kTSmem = 232448;             // a block's shared memory, at most
constexpr int kTHead = 2048;               // barriers and base alignment

// The block's shape at WG consumer warpgroups of 64 columns each: M <= 64
// takes three (192 columns, one block an SM: with four, 576 threads hold
// 96 registers each, and the consumers spilled and ran slower on the H100
// at the 7B sites), M <= 128 two, larger M one (the accumulators of four
// 64-row sub-tiles take 128 registers a thread).
template <int WG>
struct TileCfg {
  static constexpr int bn = 64 * WG;             // weight columns per block
  static constexpr int warps = 4 * WG;           // consumer warps
  static constexpr int threads = (warps + 2) * 32;   // + two producer warps
  static constexpr int stride = bn + 8;          // words per staged row
};

__host__ __device__ constexpr int tile_wg(int NS) {
  return NS == 1 ? 3 : NS == 2 ? 2 : 1;
}

// The shape of one call's ring: round-plane rows per superblock R (3-bit:
// the 1-bit plane's), rows per stage ns, rounds P, meta slots per round
// Q (groups a chunk spans), meta bytes per value; bytes of a stage's
// words and meta and of one x chunk ([64 NS rows][128 bytes]).
struct TileShape {
  int R, ns, P, Q, es, words, stage, x;
};

// (`exact`, the float32 form: an x slot of three part slabs and 1 KB of
// x sums.)
__host__ __device__ inline TileShape tile_shape(int nb, int sb, int gs,
                                                int meta_bf16, int NS,
                                                int ns, bool exact = false) {
  const int bn = 64 * tile_wg(NS);
  TileShape t;
  t.R = nb == 3 ? sb / 32 : sb * nb / 32;
  t.ns = ns;
  t.P = nb == 3 ? 16 : 16 / nb;
  t.Q = 2 * ns > gs ? 2 * ns / gs : 1;
  t.es = meta_bf16 ? 2 : 4;
  t.words = (nb == 3 ? 3 : 1) * ns * (bn + 8) * 4;
  t.stage = t.words + t.P * t.Q * 2 * bn * t.es;
  t.x = exact ? 3 * NS * 64 * 128 + 1024 : NS * 64 * 128;
  return t;
}

// The ring's slots at a shape: (word slots, x slots), as many as fit a
// block's shared memory up to (3, 4); (0, 0) if two of each do not.
struct TileSlots {
  int w, x;
};

inline TileSlots tile_slots(const TileShape& t) {
  for (int w = kTMaxW; w >= 2; --w) {
    const int room = kTSmem - kTHead - w * t.stage;
    if (room >= 2 * t.x) return {w, room / t.x < kTMaxX ? room / t.x : kTMaxX};
  }
  return {0, 0};
}

inline size_t tile_smem(const TileShape& t, const TileSlots& n) {
  return kTHead + static_cast<size_t>(n.x) * t.x +
         static_cast<size_t>(n.w) * t.stage;
}

// The 4-row superblocks (1 and 3 bits at 128 rows: the round plane has 4
// word rows, so no stage of 8 or more rows lies in one superblock): a
// stage of kPairNs rows holds kPairNs / 4 whole superblocks, each with its
// own meta slots, and a 16-row k16 step takes one superblock and two
// rounds (the pair form; see the top of the file).
constexpr int kPairNs = 16;

__host__ __device__ constexpr bool tile_pair(int nb, int sb) {
  return (nb == 1 || nb == 3) && sb == 128;
}

// Word rows per stage of a layout (0: the kernel does not take it): the
// largest of 32, 16, 8 that divides the round plane's rows, whose chunks
// of 2 ns K rows lie in one group or hold whole ones, and whose ring fits
// at every block shape (one, two or four M sub-tiles); the 4-row
// superblocks take kPairNs rows at groups of a multiple of 32 (a chunk in
// one group).  It depends on the layout only, so the K order of the sums,
// and the bits of row m, are the same at any M.
inline int tile_ns(int nb, int gs, int sb, int meta_bf16) {
  if ((nb != 1 && nb != 2 && nb != 3 && nb != 4 && nb != 8) || sb % 64 ||
      sb > 1024 || gs < 16 || gs % 16 || sb % gs)
    return 0;
  const int R = nb == 3 ? sb / 32 : sb * nb / 32;
  const bool pair = tile_pair(nb, sb);
  for (int ns = 32; ns >= 8; ns /= 2)
    if ((pair ? ns == kPairNs && gs % (2 * ns) == 0
              : R % ns == 0 && (gs % (2 * ns) == 0 || (2 * ns) % gs == 0)) &&
        tile_slots(tile_shape(nb, sb, gs, meta_bf16, 1, ns)).w >= 2 &&
        tile_slots(tile_shape(nb, sb, gs, meta_bf16, 2, ns)).w >= 2 &&
        tile_slots(tile_shape(nb, sb, gs, meta_bf16, 4, ns)).w >= 2)
      return ns;
  return 0;
}

// Word rows per stage of a layout in the float32 form (0: not taken):
// tile_ns's rule at 16 or 8 rows, with chunks of 2 ns K rows inside one
// group (each chunk corrected with one group's meta) and a ring of the
// float32 x slots that fits at one M sub-tile.
inline int tile_ns_exact(int nb, int gs, int sb, int meta_bf16) {
  if ((nb != 1 && nb != 2 && nb != 3 && nb != 4 && nb != 8) || sb % 64 ||
      sb > 1024 || gs < 16 || gs % 16 || sb % gs)
    return 0;
  const int R = nb == 3 ? sb / 32 : sb * nb / 32;
  const bool pair = tile_pair(nb, sb);
  for (int ns = 16; ns >= 8; ns /= 2)
    if ((pair ? ns == kPairNs : R % ns == 0) && gs % (2 * ns) == 0 &&
        tile_slots(tile_shape(nb, sb, gs, meta_bf16, 1, ns, true)).w >= 2)
      return ns;
  return 0;
}

// The calls the kernel takes: bf16 x with 8 < M, a layout tile_ns takes,
// K, x's row stride and Np multiples of 8, 16-byte aligned x, words and
// meta (16-byte copies).
inline bool tile_takes(const void* x, int x_bf16, const int32_t* packed,
                       const void* scale, const void* zero, int meta_bf16,
                       int M, int K, int ldx, int Kp, int N, int Np, int nb,
                       int gs, int sb) {
  return x_bf16 && M > 8 && N <= Np && Kp % sb == 0 && K <= Kp &&
         K % 8 == 0 && ldx % 8 == 0 && Np % 8 == 0 && aligned16(x) &&
         aligned16(packed) && aligned16(scale) && aligned16(zero) &&
         tile_ns(nb, gs, sb, meta_bf16) > 0;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes 0 zero-fills the 16 bytes (K rows past K)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The barrier's phase counts one arrival of this thread once its earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar)))
               : "memory");
}

// d[64 x 64] = A[64 x 16] B[16 x 64] (+ d with `accumulate`), A in
// registers (four bf16x2 per thread), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : AMQ_F16(d, 0), AMQ_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The reference's bf16 weights of a pair of exact bf16 values 128 + c:
// (128 + c) - 128 (exact), - z, * s, each rounded to bf16.
__device__ __forceinline__ uint32_t deq_bf16(uint32_t raw, __nv_bfloat162 s,
                                             __nv_bfloat162 z) {
  const __nv_bfloat162 k128 = __floats2bfloat162_rn(128.f, 128.f);
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&raw);
  v = __hsub2(v, k128);
  v = __hsub2(v, z);
  return bf2_bits(__hmul2(v, s));
}

// 8 bits: round p's codes of a word's two halves, (c - z) * s in f32,
// rounded to bf16 once.  A code becomes the exact float 2^23 + c by one
// byte permute (c into the low mantissa byte of 0x4B000000; `sel0`,
// `sel1` the selectors of round p's low and high code, tile_sel8), then
// - 2^23: no integer conversion.
__device__ __forceinline__ uint32_t deq_8(uint32_t w, uint32_t sel0,
                                          uint32_t sel1, float s, float z) {
  const float c0 = __uint_as_float(__byte_perm(w, 0x4B00u, sel0)) - 8388608.f;
  const float c1 = __uint_as_float(__byte_perm(w, 0x4B00u, sel1)) - 8388608.f;
  return bf2_bits(__floats2bfloat162_rn(__fmul_rn(__fsub_rn(c0, z), s),
                                        __fmul_rn(__fsub_rn(c1, z), s)));
}

// The byte-permute selector of a word's byte b as [b, 0, 0, 0x4B].
__device__ __forceinline__ uint32_t tile_sel8(int b) {
  return static_cast<uint32_t>(b) | 0x5440u;
}

// The scale and zero of a thread's two columns (c, c + 1) in one meta
// slot (`bn` values a row), as the dequantization takes them: bf16 pairs
// (widths 1-4: f32 meta rounded to bf16), or f32 (8 bits).
struct ColMeta {
  __nv_bfloat162 s2[2], z2[2];
  float s[2], z[2];
};

__device__ __forceinline__ ColMeta col_meta(const unsigned char* slot, int es,
                                            int bn, int c) {
  ColMeta m;
  __nv_bfloat162 sb, zb;
  if (es == 2) {
    sb = reinterpret_cast<const __nv_bfloat162*>(slot)[c / 2];
    zb = reinterpret_cast<const __nv_bfloat162*>(slot + bn * 2)[c / 2];
    const float2 sf = __bfloat1622float2(sb), zf = __bfloat1622float2(zb);
    m.s[0] = sf.x; m.s[1] = sf.y;
    m.z[0] = zf.x; m.z[1] = zf.y;
  } else {
    const float2 sf = reinterpret_cast<const float2*>(slot)[c / 2];
    const float2 zf = reinterpret_cast<const float2*>(slot + bn * 4)[c / 2];
    m.s[0] = sf.x; m.s[1] = sf.y;
    m.z[0] = zf.x; m.z[1] = zf.y;
    sb = __floats2bfloat162_rn(sf.x, sf.y);
    zb = __floats2bfloat162_rn(zf.x, zf.y);
  }
  m.s2[0] = __low2bfloat162(sb);
  m.s2[1] = __high2bfloat162(sb);
  m.z2[0] = __low2bfloat162(zb);
  m.z2[1] = __high2bfloat162(zb);
  return m;
}

// The exact bf16 pairs 128 + c of the four A registers of chunk p at k16
// step kk of a stage of 4-row superblocks (kPairNs rows: four whole
// superblocks; 1 and 3 bits).  Chunk p is rounds 4 (p % 4) .. + 3 of the
// stage's superblock p / 4 (stage rows 4 (p / 4) ..), and step kk its
// rounds q = 4 (p % 4) + 2 kk and q + 1: K pairs t and t + 4 are the same
// word row t at the two rounds' fields (3-bit: the superblock's 2-bit
// rows t and 4 + t, stage blocks 0 and 1, at round q / 2, beside 1-bit
// row t).  Register i: K pair t + 4 (i >> 1), column c + (i & 1).
template <int NB>
__device__ __forceinline__ void pair_raw(const uint32_t* ws, int stride,
                                         int ns, int p, int kk, int t, int c,
                                         uint32_t (&raw)[4]) {
  static_assert(NB == 1 || NB == 3, "4-row superblocks: 1 and 3 bits");
  const int q = 4 * (p & 3) + 2 * kk;
  const int o = (4 * (p >> 2) + t) * stride + c;
  if constexpr (NB == 3) {
    const uint2 h0 = *reinterpret_cast<const uint2*>(ws + o);
    const uint2 h1 = *reinterpret_cast<const uint2*>(ws + ns * stride + o);
    const uint2 l = *reinterpret_cast<const uint2*>(ws + 2 * ns * stride + o);
    raw[0] = (((h0.x >> q) & 0x00030003u) << 1) | ((l.x >> q) & 0x00010001u) |
             0x43004300u;
    raw[1] = (((h0.y >> q) & 0x00030003u) << 1) | ((l.y >> q) & 0x00010001u) |
             0x43004300u;
    raw[2] = (((h1.x >> q) & 0x00030003u) << 1) |
             ((l.x >> (q + 1)) & 0x00010001u) | 0x43004300u;
    raw[3] = (((h1.y >> q) & 0x00030003u) << 1) |
             ((l.y >> (q + 1)) & 0x00010001u) | 0x43004300u;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(ws + o);
    raw[0] = ((w.x >> q) & 0x00010001u) | 0x43004300u;
    raw[1] = ((w.y >> q) & 0x00010001u) | 0x43004300u;
    raw[2] = ((w.x >> (q + 1)) & 0x00010001u) | 0x43004300u;
    raw[3] = ((w.y >> (q + 1)) & 0x00010001u) | 0x43004300u;
  }
}

// The four A registers of round p at k16 step kk of a stage (`stride`
// words a staged row).  A row 16 w4 + lane / 4 is weight column c, row
// + 8 column c + 1 (c even: one 8-byte load per word row gives both); K
// pairs t and t + 4 are stage rows 8 kk + t and + 4.  Register i: row
// r + 4 (i >> 1), column c + (i & 1).
// PAIR (4-row superblocks): chunk p is the stage's superblock p / 4,
// pair_raw's codes.
template <int NB, bool PAIR>
__device__ __forceinline__ void tile_frag(const uint32_t* ws, int stride,
                                          int ns, int p, int kk, int t, int c,
                                          const ColMeta& m, uint32_t (&a)[4]) {
  const int o = (8 * kk + t) * stride + c;
  uint32_t raw[4];
  if constexpr (PAIR) {
    pair_raw<NB>(ws, stride, ns, p, kk, t, c, raw);
  } else if constexpr (NB == 8) {
    // round p's codes: byte p of each half-word (rows 2r and 2r + 1)
    const uint32_t sel0 = tile_sel8(p), sel1 = tile_sel8(2 + p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 w = *reinterpret_cast<const uint2*>(ws + o + 4 * h * stride);
      a[2 * h] = deq_8(w.x, sel0, sel1, m.s[0], m.z[0]);
      a[2 * h + 1] = deq_8(w.y, sel0, sel1, m.s[1], m.z[1]);
    }
    return;
  } else if constexpr (NB == 3) {
    // 2-bit rows of p's parity (stage rows [0, ns) or [ns, 2 ns)), 1-bit
    // rows after them: 128 + 2 hi + lo
    const uint32_t* hs = ws + (p & 1) * ns * stride;
    const uint32_t* ls = ws + 2 * ns * stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 wh = *reinterpret_cast<const uint2*>(hs + o + 4 * h * stride);
      const uint2 wl = *reinterpret_cast<const uint2*>(ls + o + 4 * h * stride);
      raw[2 * h] = (((wh.x >> (2 * (p >> 1))) & 0x00030003u) << 1) |
                   ((wl.x >> p) & 0x00010001u) | 0x43004300u;
      raw[2 * h + 1] = (((wh.y >> (2 * (p >> 1))) & 0x00030003u) << 1) |
                       ((wl.y >> p) & 0x00010001u) | 0x43004300u;
    }
  } else {
    constexpr uint32_t mask = ((1u << NB) - 1u) * 0x00010001u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 w = *reinterpret_cast<const uint2*>(ws + o + 4 * h * stride);
      raw[2 * h] = ((w.x >> (NB * p)) & mask) | 0x43004300u;
      raw[2 * h + 1] = ((w.y >> (NB * p)) & mask) | 0x43004300u;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = deq_bf16(raw[i], m.s2[i & 1], m.z2[i & 1]);
}

// Where the chunks of a stage of 4-row superblocks lie in K: stage js is
// kPairNs / 4 whole superblocks from js kPairNs / 4, its chunk p the p-th
// 2 ns K rows of them; the last stage of K holds the superblocks left, and
// only their chunks (four a superblock, so an even count).
__device__ __forceinline__ int pair_k0(const TileShape& sh, int sb, int js,
                                       int p) {
  return js * (sh.ns / sh.R) * sb + 2 * sh.ns * p;
}

__device__ __forceinline__ int pair_chunks(const TileShape& sh, int sb,
                                           int Kp, int js) {
  return min(sh.P, (Kp - pair_k0(sh, sb, js, 0)) / (2 * sh.ns));
}

// Ring stages of K at 4-row superblocks: ceil(superblocks R / ns).
__device__ __forceinline__ int pair_stages(const TileShape& sh, int sb,
                                           int Kp) {
  return (Kp / sb * sh.R + sh.ns - 1) / sh.ns;
}

// A ring's position: slot and phase parity of its next item, stepped
// without divisions.
struct RingPos {
  int slot, phase;
  __device__ void step(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The barriers, at the start of the aligned shared memory: full and empty
// per word slot and per x slot.
struct TileBars {
  uint64_t* p;
  __device__ uint64_t* wfull(int i) const { return p + i; }
  __device__ uint64_t* wempty(int i) const { return p + kTMaxW + i; }
  __device__ uint64_t* xfull(int i) const { return p + 2 * kTMaxW + i; }
  __device__ uint64_t* xempty(int i) const {
    return p + 2 * kTMaxW + kTMaxX + i;
  }
};

// A block's rings in its dynamic shared memory, from a 1024-byte boundary
// (the 128-byte swizzle's atoms), addressed from ring_smem so that loads
// stay in shared space: barriers, x slots, word slots; `tile_ring` sets up
// the barriers (every thread of the block; an x slot fills on
// `x_arrivals` arrivals: a warp's cp.async, or one bulk copy's).
struct TileRing {
  TileBars bars;
  unsigned char *x, *w;
};

__device__ __forceinline__ TileRing tile_ring(const TileShape& sh,
                                              const TileSlots& slots,
                                              int warps, int x_arrivals) {
  const uint32_t raw = static_cast<uint32_t>(
      __cvta_generic_to_shared(ring_smem));
  unsigned char* base = ring_smem + (((raw + 1023) & ~1023u) - raw);
  const TileRing r{TileBars{reinterpret_cast<uint64_t*>(base)}, base + 1024,
                   base + 1024 + slots.x * sh.x};
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots.w; ++i) {
      mbar_init(r.bars.wfull(i), 1);
      mbar_init(r.bars.wempty(i), warps);
    }
    for (int i = 0; i < slots.x; ++i) {
      mbar_init(r.bars.xfull(i), x_arrivals);
      mbar_init(r.bars.xempty(i), warps);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  return r;
}

// Producer: stage js's words and meta into word slot wpos (the block's
// j-th stage: past the ring's `wslots` it first waits for the slot to be
// freed).  3-bit: 2-bit rows [r0, +ns) and [R + r0, +ns), then 1-bit rows
// [r0, +ns) of the plane after the 2-bit plane's 2R rows; the scale (row
// 2i) and zero (row 2i + 1) of every group the stage's rounds touch.
template <int NB, int WG>
__device__ __forceinline__ void tile_issue_words(
    const GemvArgs& a, const TileShape& sh, const TileBars& bars,
    unsigned char* wring, const RingPos& wpos, int j, int js, int wslots,
    int col0, int lane) {
  using C = TileCfg<WG>;
  const int sb = a.w.superblock, gs = a.w.group_size, Np = a.w.Np;
  const int cols = min(C::bn, Np - col0);          // a multiple of 8
  const int Rw = sb * NB / 32;                     // word rows per superblock
  const int spb = sh.R / sh.ns;
  const int sbi = js / spb, r0 = (js % spb) * sh.ns;
  unsigned char* st = wring + wpos.slot * sh.stage;
  const int nrows = (NB == 3 ? 3 : 1) * sh.ns;
  const int nmeta = 2 * sh.P * sh.Q;
  if (j >= wslots) mbar_wait(bars.wempty(wpos.slot), wpos.phase ^ 1);
  uint64_t* full = bars.wfull(wpos.slot);
  if (lane == 0)
    mbar_arrive_expect_tx(full, nrows * cols * 4 + nmeta * cols * sh.es);
  __syncwarp();
  for (int i = lane; i < nrows; i += 32) {
    const int pl = i / sh.ns, rr = r0 + i - pl * sh.ns;
    const int src = NB == 3 ? (pl == 2 ? 2 * sh.R : pl * sh.R) + rr : rr;
    bulk_g2s(st + i * C::stride * 4,
             a.w.packed + (static_cast<size_t>(sbi) * Rw + src) * Np + col0,
             cols * 4, full);
  }
  for (int i = lane; i < nmeta; i += 32) {
    const int slot = i >> 1, p = slot / sh.Q, q = slot - p * sh.Q;
    const int grp = (sbi * sb + p * 2 * sh.R + 2 * r0) / gs + q;
    const unsigned char* src = static_cast<const unsigned char*>(
        (i & 1) ? a.w.zero : a.w.scale);
    bulk_g2s(st + sh.words + i * C::bn * sh.es,
             src + (static_cast<size_t>(grp) * Np + col0) * sh.es,
             cols * sh.es, full);
  }
}

// Producer of a stage of 4-row superblocks (tile_issue_words' roles):
// stage js's parts <= kPairNs / 4 superblocks from sbi, each superblock's
// round-plane rows in turn (3-bit: its 2-bit rows [0, 4) and [4, 8), then
// its 1-bit rows), and the scale and zero of each chunk's group.
template <int NB, int WG>
__device__ __forceinline__ void tile_issue_pair_words(
    const GemvArgs& a, const TileShape& sh, const TileBars& bars,
    unsigned char* wring, const RingPos& wpos, int j, int js, int wslots,
    int col0, int lane) {
  using C = TileCfg<WG>;
  const int sb = a.w.superblock, gs = a.w.group_size, Np = a.w.Np;
  const int cols = min(C::bn, Np - col0);          // a multiple of 8
  const int Rw = sb * NB / 32;                     // word rows per superblock
  const int per = sh.ns / sh.R, sbi = js * per;
  const int parts = min(per, a.Kp / sb - sbi);     // superblocks in K
  unsigned char* st = wring + wpos.slot * sh.stage;
  const int nrows = (NB == 3 ? 3 : 1) * sh.ns;
  const int nmeta = 2 * pair_chunks(sh, sb, a.Kp, js) * sh.Q;
  if (j >= wslots) mbar_wait(bars.wempty(wpos.slot), wpos.phase ^ 1);
  uint64_t* full = bars.wfull(wpos.slot);
  if (lane == 0)
    mbar_arrive_expect_tx(full, nrows / per * parts * cols * 4 +
                                    nmeta * cols * sh.es);
  __syncwarp();
  for (int i = lane; i < nrows; i += 32) {
    const int pl = i / sh.ns, rr = i - pl * sh.ns;
    const int q = rr / sh.R, row = rr - q * sh.R;
    if (q >= parts) continue;
    const int src = NB == 3 ? (pl == 2 ? 2 * sh.R : pl * sh.R) + row : row;
    bulk_g2s(st + i * C::stride * 4,
             a.w.packed + (static_cast<size_t>(sbi + q) * Rw + src) * Np +
                 col0,
             cols * 4, full);
  }
  for (int i = lane; i < nmeta; i += 32) {
    const int slot = i >> 1, p = slot / sh.Q, q = slot - p * sh.Q;
    const int grp = pair_k0(sh, sb, js, p) / gs + q;
    const unsigned char* src = static_cast<const unsigned char*>(
        (i & 1) ? a.w.zero : a.w.scale);
    bulk_g2s(st + sh.words + i * C::bn * sh.es,
             src + (static_cast<size_t>(grp) * Np + col0) * sh.es,
             cols * sh.es, full);
  }
}

// One consumer chunk: chunk p of the stage at `ws` (ST k16 steps; A
// registers into a[BUF]), its products against the x slot at `xpos` into
// acc (the block's first chunk, `release` false, overwrites it: no other
// instruction writes an accumulator while products are in flight, or
// ptxas serializes them), and the release of the previous chunk's x slot
// `prev` once its products are done.
template <int NB, int NS, int ST, bool PAIR, int BUF>
__device__ __forceinline__ void tile_chunk(
    const TileShape& sh, const uint32_t* ws, const unsigned char* meta,
    int lg_q, int p, int c0, int lane, const TileBars& bars,
    const RingPos& xpos, int prev, bool release, uint32_t xa,
    uint32_t (&a)[2][ST][4], float (&acc)[NS][32]) {
  using C = TileCfg<tile_wg(NS)>;
  const int t = lane & 3;
  const int slot_bytes = 2 * C::bn * sh.es;
  ColMeta m;
#pragma unroll
  for (int kk = 0; kk < ST; ++kk) {
    if (kk == 0 || sh.Q > 1)
      m = col_meta(meta + (p * sh.Q + (kk >> lg_q)) * slot_bytes, sh.es,
                   C::bn, c0);
    tile_frag<NB, PAIR>(ws, C::stride, sh.ns, p, kk, t, c0, m, a[BUF][kk]);
  }
  mbar_wait(bars.xfull(xpos.slot), xpos.phase);
  // the chunk's cp.async writes (generic proxy) before wgmma's reads
  fence_proxy_async();
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < ST; ++kk)
#pragma unroll
    for (int s = 0; s < NS; ++s)
      wgmma_rs_n64(acc[s], a[BUF][kk],
                     smem_desc(xa + s * 64 * 128 + kk * 32, 16, 1024),
                     release || kk > 0);
  wgmma_commit();
  // the previous chunk's products are done: its A registers are free (the
  // accumulators, still being written, are left alone until the end)
  wgmma_wait<1>();
  fence_regs(a[BUF ^ 1]);
  if (release) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.xempty(prev));
  }
}

// Grid (ceil(N / bn), splits, ceil(M / 256)); each split a run of
// `sb_per_split` ring stages of ns = 8 ST word rows; `slots` the ring's.
// PAIR: the 4-row superblocks' form (kPairNs rows a stage).
template <int NB, int NS, int ST, bool PAIR>
__global__ void __launch_bounds__(TileCfg<tile_wg(NS)>::threads, 1)
    qmm_tile_kernel(GemvArgs a, TileSlots slots) {
  static_assert(!PAIR || 8 * ST == kPairNs, "the pair form's stage");
  using C = TileCfg<tile_wg(NS)>;
  const int sb = a.w.superblock, gs = a.w.group_size;
  const TileShape sh = tile_shape(NB, sb, gs, a.w.meta_bf16, NS, 8 * ST);
  const TileRing ring = tile_ring(sh, slots, C::warps, 32);
  const TileBars bars = ring.bars;
  unsigned char* xring = ring.x;
  unsigned char* wring = ring.w;

  const int col0 = blockIdx.x * C::bn;
  const int m0 = blockIdx.z * kTMT;
  const int spb = PAIR ? 1 : sh.R / sh.ns;         // stages per superblock
  const int n_st = PAIR ? pair_stages(sh, sb, a.Kp) : a.Kp / sb * spb;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = max(0, min(n_st, st_lo + a.sb_per_split) - st_lo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (warp >= C::warps) {
    // producers: warp C::warps the words and meta of each stage, warp
    // C::warps + 1 the x chunks, each as far ahead as its ring allows
    const int Mt = min(kTMT, a.op.M - m0);
    constexpr int kPieces = 2 * ST;                // 16 bytes per x row
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.op.x);
    RingPos wpos{0, 0}, xpos{0, 0};
    if (warp == C::warps) {
      for (int j = 0; j < S; ++j, wpos.step(slots.w))
        if constexpr (PAIR)
          tile_issue_pair_words<NB, tile_wg(NS)>(a, sh, bars, wring, wpos, j,
                                                 st_lo + j, slots.w, col0,
                                                 lane);
        else
          tile_issue_words<NB, tile_wg(NS)>(a, sh, bars, wring, wpos, j,
                                            st_lo + j, slots.w, col0, lane);
      return;
    }
    int xc = 0;
    for (int j = 0; j < S; ++j) {
      const int js = st_lo + j, sbi = js / spb, r0 = (js % spb) * sh.ns;
      const int chunks = PAIR ? pair_chunks(sh, sb, a.Kp, js) : sh.P;
      for (int p = 0; p < chunks; ++p, ++xc) {
        if (xc >= slots.x)
          mbar_wait(bars.xempty(xpos.slot), xpos.phase ^ 1);
        const uint32_t xs = static_cast<uint32_t>(__cvta_generic_to_shared(
            xring + xpos.slot * sh.x));
        const int k0 = PAIR ? pair_k0(sh, sb, js, p)
                            : sbi * sb + p * 2 * sh.R + 2 * r0;
        // rows past M are not copied (they reach only unwritten outputs)
        for (int i = lane; i < Mt * kPieces; i += 32) {
          const int m = i / kPieces, c = i % kPieces;
          const int k = k0 + 8 * c;
          const bool in = k < a.op.K;
          cp_async16(xs + m * 128 + ((c ^ (m & 7)) << 4),
                     x + static_cast<size_t>(m0 + m) * a.op.ldx + (in ? k : 0),
                     in ? 16 : 0);
        }
        cp_async_arrive(bars.xfull(xpos.slot));
        xpos.step(slots.x);
      }
    }
    return;
  }

  // consumer warpgroups: warp w4 of warpgroup wg holds A rows 16 w4 +
  // lane / 4 (weight column c0 = 64 wg + 16 w4 + 2 (lane / 4)) and + 8
  // (column c0 + 1)
  const int wg = warp >> 2, w4 = warp & 3;
  const int c0 = 64 * wg + 16 * w4 + 2 * (lane >> 2);
  const int lg_q = sh.Q > 1 ? __ffs(gs / 16) - 1 : 0;   // steps per meta slot
  float acc[NS][32];                  // set by the first chunk's products
  uint32_t afr[2][ST][4];
  const uint32_t xbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(xring));
  RingPos wpos{0, 0}, xpos{0, 0};
  int prev = 0;                       // the previous chunk's x slot
  bool started = false;
  for (int j = 0; j < S; ++j) {
    mbar_wait(bars.wfull(wpos.slot), wpos.phase);
    const unsigned char* st = wring + wpos.slot * sh.stage;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const unsigned char* meta = st + sh.words;
    const int chunks = PAIR ? pair_chunks(sh, sb, a.Kp, st_lo + j) : sh.P;
    for (int p = 0; p < chunks; p += 2) {  // an even count
      tile_chunk<NB, NS, ST, PAIR, 0>(sh, ws, meta, lg_q, p, c0, lane, bars,
                                      xpos, prev, started,
                                      xbase + xpos.slot * sh.x, afr, acc);
      prev = xpos.slot;
      xpos.step(slots.x);
      tile_chunk<NB, NS, ST, PAIR, 1>(sh, ws, meta, lg_q, p + 1, c0, lane,
                                      bars, xpos, prev, true,
                                      xbase + xpos.slot * sh.x, afr, acc);
      prev = xpos.slot;
      xpos.step(slots.x);
      started = true;
    }
    __syncwarp();                    // the warp is done with the stage
    if (lane == 0) mbar_arrive(bars.wempty(wpos.slot));
    wpos.step(slots.w);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (S == 0)                         // an empty split adds zeros
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;

  // acc[s][4 q + i]: weight column col0 + c0 + (i >> 1), row m0 + 64 s +
  // 8 q + 2 (lane % 4) + (i & 1); with N even the two columns of a row
  // are stored together
  const int t = lane & 3;
  const int n = col0 + c0;
  if (n >= a.N) return;
  const bool pair = a.N % 2 == 0;
  float* part = gridDim.y > 1 ? a.partial + static_cast<size_t>(blockIdx.y) *
                                                a.op.M * a.N
                              : nullptr;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + 64 * s + 8 * q + 2 * t + i;
        if (m >= a.op.M) continue;
        const float v0 = acc[s][4 * q + i], v1 = acc[s][4 * q + 2 + i];
        const size_t o = static_cast<size_t>(m) * a.N + n;
        if (!pair) {
          if (part) {
            part[o] = v0;
            if (n + 1 < a.N) part[o + 1] = v1;
          } else {
            store_f(a.out, o, v0, a.out_bf16);
            if (n + 1 < a.N) store_f(a.out, o + 1, v1, a.out_bf16);
          }
        } else if (part) {
          *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
        } else if (a.out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
              make_float2(v0, v1);
        }
      }
}

template <int NB, int NS, int ST, bool PAIR>
cudaError_t launch_tile(const GemvArgs& a, int splits, cudaStream_t stream) {
  using C = TileCfg<tile_wg(NS)>;
  const TileShape sh = tile_shape(NB, a.w.superblock, a.w.group_size,
                                  a.w.meta_bf16, NS, 8 * ST);
  const TileSlots slots = tile_slots(sh);
  if (slots.w < 2) return cudaErrorInvalidValue;
  const size_t smem = tile_smem(sh, slots);
  static size_t allowed = 0;
  cudaError_t e =
      allow_smem(qmm_tile_kernel<NB, NS, ST, PAIR>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + C::bn - 1) / C::bn, splits, (a.op.M + kTMT - 1) / kTMT);
  qmm_tile_kernel<NB, NS, ST, PAIR><<<grid, C::threads, smem, stream>>>(
      a, slots);
  return cudaGetLastError();
}

// M sub-tiles of a call: one (M <= 64, three warpgroups), two, or four.
template <int NB, int ST, bool PAIR = false>
cudaError_t dispatch_m(const GemvArgs& a, int splits, cudaStream_t s) {
  if (a.op.M <= 64) return launch_tile<NB, 1, ST, PAIR>(a, splits, s);
  if (a.op.M <= 128) return launch_tile<NB, 2, ST, PAIR>(a, splits, s);
  return launch_tile<NB, 4, ST, PAIR>(a, splits, s);
}

template <int NB>
cudaError_t dispatch_tile(const GemvArgs& a, int splits, cudaStream_t s) {
  if constexpr (NB == 1 || NB == 3)
    if (tile_pair(NB, a.w.superblock))
      return tile_ns(NB, a.w.group_size, a.w.superblock, a.w.meta_bf16)
                 ? dispatch_m<NB, kPairNs / 8, true>(a, splits, s)
                 : cudaErrorInvalidValue;
  switch (tile_ns(NB, a.w.group_size, a.w.superblock, a.w.meta_bf16)) {
    case 32: return dispatch_m<NB, 4>(a, splits, s);
    case 16: return dispatch_m<NB, 2>(a, splits, s);
    case 8: return dispatch_m<NB, 1>(a, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The float32 form (see the top of this file).

// The four A registers of round p at k16 step kk in the float32 form:
// tile_frag's registers of exact codes (widths 1-4: 128 + c minus 128;
// 8 bits: each byte as the float 2^23 + c minus 2^23, converted to bf16;
// PAIR: pair_raw's codes minus 128).
template <int NB, bool PAIR>
__device__ __forceinline__ void tile_frag_exact(const uint32_t* ws,
                                                int stride, int ns, int p,
                                                int kk, int t, int c,
                                                uint32_t (&a)[4]) {
  const int o = (8 * kk + t) * stride + c;
  if constexpr (PAIR) {
    pair_raw<NB>(ws, stride, ns, p, kk, t, c, a);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = bf2_sub(a[i], kBias128);
  } else if constexpr (NB == 8) {
    const uint32_t sel0 = tile_sel8(p), sel1 = tile_sel8(2 + p);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 w = *reinterpret_cast<const uint2*>(ws + o + 4 * h * stride);
      const uint32_t v[2] = {w.x, w.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float c0 =
            __uint_as_float(__byte_perm(v[e], 0x4B00u, sel0)) - 8388608.f;
        const float c1 =
            __uint_as_float(__byte_perm(v[e], 0x4B00u, sel1)) - 8388608.f;
        a[2 * h + e] = bf2_bits(__floats2bfloat162_rn(c0, c1));
      }
    }
  } else if constexpr (NB == 3) {
    const uint32_t* hs = ws + (p & 1) * ns * stride;
    const uint32_t* ls = ws + 2 * ns * stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 wh = *reinterpret_cast<const uint2*>(hs + o + 4 * h * stride);
      const uint2 wl = *reinterpret_cast<const uint2*>(ls + o + 4 * h * stride);
      a[2 * h] = bf2_sub((((wh.x >> (2 * (p >> 1))) & 0x00030003u) << 1) |
                             ((wl.x >> p) & 0x00010001u) | kBias128,
                         kBias128);
      a[2 * h + 1] = bf2_sub((((wh.y >> (2 * (p >> 1))) & 0x00030003u) << 1) |
                                 ((wl.y >> p) & 0x00010001u) | kBias128,
                             kBias128);
    }
  } else {
    constexpr uint32_t mask = ((1u << NB) - 1u) * 0x00010001u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 w = *reinterpret_cast<const uint2*>(ws + o + 4 * h * stride);
      a[2 * h] = bf2_sub(((w.x >> (NB * p)) & mask) | kBias128, kBias128);
      a[2 * h + 1] = bf2_sub(((w.y >> (NB * p)) & mask) | kBias128, kBias128);
    }
  }
}

// One chunk's correction, tot += s acc - (z s) xsum: `mc` the thread's two
// columns' scales and z s products, `xs` the chunk's x sums by M-tile row.
template <int NS>
__device__ __forceinline__ void tile_correct(const float (&acc)[NS][32],
                                             const float (&mc)[4],
                                             const float* xs, int t,
                                             float (&tot)[NS][32]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 xv =
          *reinterpret_cast<const float2*>(xs + 64 * s + 8 * q + 2 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float xi = i ? xv.y : xv.x;
        float& t0 = tot[s][4 * q + i];
        float& t1 = tot[s][4 * q + 2 + i];
        t0 = fmaf(-mc[2], xi, fmaf(mc[0], acc[s][4 * q + i], t0));
        t1 = fmaf(-mc[3], xi, fmaf(mc[1], acc[s][4 * q + 2 + i], t1));
      }
    }
}

// One float32 chunk: chunk p of the stage at `ws` -- its exact-code A
// registers into a[BUF] and its group's meta into mc[BUF] while the
// previous chunk's products run; then (`release`) that chunk's wait, its
// correction from x slot `prev` and the slot's release; then this chunk's
// products against the x slot at `xpos`, three parts per k16 step, the
// first overwriting acc.
template <int NB, int NS, int ST, bool PAIR, int BUF>
__device__ __forceinline__ void tile_chunk_exact(
    const TileShape& sh, const uint32_t* ws, const unsigned char* meta, int p,
    int c0, int lane, const TileBars& bars, const RingPos& xpos, int prev,
    bool release, const unsigned char* xring, uint32_t (&a)[2][ST][4],
    float (&mc)[2][4], float (&acc)[NS][32], float (&tot)[NS][32]) {
  using C = TileCfg<tile_wg(NS)>;
  constexpr int kSlab = NS * 64 * 128;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < ST; ++kk)
    tile_frag_exact<NB, PAIR>(ws, C::stride, sh.ns, p, kk, t, c0,
                              a[BUF][kk]);
  const ColMeta m = col_meta(meta + p * 2 * C::bn * sh.es, sh.es, C::bn, c0);
  mc[BUF][0] = m.s[0];
  mc[BUF][1] = m.s[1];
  mc[BUF][2] = m.z[0] * m.s[0];
  mc[BUF][3] = m.z[1] * m.s[1];
  wgmma_wait<0>();
  fence_regs(acc);
  if (release) {
    tile_correct<NS>(acc, mc[BUF ^ 1],
                     reinterpret_cast<const float*>(xring + prev * sh.x +
                                                    3 * kSlab),
                     t, tot);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.xempty(prev));
  }
  mbar_wait(bars.xfull(xpos.slot), xpos.phase);
  fence_proxy_async();
  __syncwarp();
  wgmma_fence();
  const uint32_t xa = static_cast<uint32_t>(
      __cvta_generic_to_shared(xring + xpos.slot * sh.x));
#pragma unroll
  for (int kk = 0; kk < ST; ++kk)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int s = 0; s < NS; ++s)
        wgmma_rs_n64(acc[s], a[BUF][kk],
                     smem_desc(xa + q * kSlab + s * 64 * 128 + kk * 32, 16,
                               1024),
                     kk > 0 || q > 0);
  wgmma_commit();
}

// Grid (ceil(N / bn), splits, ceil(M / (64 NS))); x the split pass's x
// slot image (ldx = mpad rows a part, a multiple of 64 NS), xsc its chunk
// sums [Kp / (2 ns)][mpad].  Launched at NS = 1 (see the top of the file);
// PAIR as qmm_tile_kernel's.
template <int NB, int NS, int ST, bool PAIR>
__global__ void __launch_bounds__(TileCfg<tile_wg(NS)>::threads, 1)
    qmm_tile_f32_kernel(GemvArgs a, TileSlots slots, const float* xsc) {
  static_assert(!PAIR || 8 * ST == kPairNs, "the pair form's stage");
  using C = TileCfg<tile_wg(NS)>;
  constexpr int kMT = 64 * NS;                     // rows of an M tile
  constexpr int kSlab = NS * 64 * 128;             // bytes of one part
  const int sb = a.w.superblock;
  const TileShape sh = tile_shape(NB, sb, a.w.group_size, a.w.meta_bf16, NS,
                                  8 * ST, true);
  const TileRing ring = tile_ring(sh, slots, C::warps, 1);
  const int col0 = blockIdx.x * C::bn;
  const int m0 = blockIdx.z * kMT;
  const int spb = PAIR ? 1 : sh.R / sh.ns;         // stages per superblock
  const int n_st = PAIR ? pair_stages(sh, sb, a.Kp) : a.Kp / sb * spb;
  const int st_lo = blockIdx.y * a.sb_per_split;
  const int S = max(0, min(n_st, st_lo + a.sb_per_split) - st_lo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (warp >= C::warps) {
    RingPos wpos{0, 0}, xpos{0, 0};
    if (warp == C::warps) {
      for (int j = 0; j < S; ++j, wpos.step(slots.w))
        if constexpr (PAIR)
          tile_issue_pair_words<NB, tile_wg(NS)>(a, sh, ring.bars, ring.w,
                                                 wpos, j, st_lo + j, slots.w,
                                                 col0, lane);
        else
          tile_issue_words<NB, tile_wg(NS)>(a, sh, ring.bars, ring.w, wpos,
                                            j, st_lo + j, slots.w, col0, lane);
      return;
    }
    // the x chunks: each part's rows of the M tile and the chunk's x sums,
    // one bulk copy each from the split pass's image (x, ldx rows a part)
    const unsigned char* img = static_cast<const unsigned char*>(a.op.x);
    const int mpad = a.op.ldx;
    int xc = 0;
    for (int j = 0; j < S; ++j) {
      const int js = st_lo + j, sbi = js / spb, r0 = (js % spb) * sh.ns;
      const int chunks = PAIR ? pair_chunks(sh, sb, a.Kp, js) : sh.P;
      for (int p = 0; p < chunks; ++p, ++xc) {
        if (xc >= slots.x)
          mbar_wait(ring.bars.xempty(xpos.slot), xpos.phase ^ 1);
        if (lane == 0) {
          unsigned char* xs = ring.x + xpos.slot * sh.x;
          uint64_t* full = ring.bars.xfull(xpos.slot);
          const int ci = (PAIR ? pair_k0(sh, sb, js, p)
                               : sbi * sb + p * 2 * sh.R + 2 * r0) /
                         (2 * sh.ns);
          mbar_arrive_expect_tx(full, 3 * kSlab + kMT * 4);
          for (int q = 0; q < 3; ++q)
            bulk_g2s(xs + q * kSlab,
                     img + ((static_cast<size_t>(ci) * 3 + q) * mpad + m0) *
                               128,
                     kSlab, full);
          bulk_g2s(xs + 3 * kSlab, xsc + static_cast<size_t>(ci) * mpad + m0,
                   kMT * 4, full);
        }
        __syncwarp();
        xpos.step(slots.x);
      }
    }
    return;
  }

  // consumer warpgroups: warp w4 of warpgroup wg holds A rows 16 w4 +
  // lane / 4 (weight column c0) and + 8 (column c0 + 1), as qmm_tile_kernel
  const int wg = warp >> 2, w4 = warp & 3;
  const int c0 = 64 * wg + 16 * w4 + 2 * (lane >> 2);
  float acc[NS][32];                  // set by each chunk's first product
  float tot[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[s][i] = 0.f;
  uint32_t afr[2][ST][4];
  float mc[2][4];
  RingPos wpos{0, 0}, xpos{0, 0};
  int prev = 0;                       // the previous chunk's x slot
  bool started = false;
  for (int j = 0; j < S; ++j) {
    mbar_wait(ring.bars.wfull(wpos.slot), wpos.phase);
    const unsigned char* st = ring.w + wpos.slot * sh.stage;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const unsigned char* meta = st + sh.words;
    const int chunks = PAIR ? pair_chunks(sh, sb, a.Kp, st_lo + j) : sh.P;
    for (int p = 0; p < chunks; p += 2) {  // an even count
      tile_chunk_exact<NB, NS, ST, PAIR, 0>(sh, ws, meta, p, c0, lane,
                                            ring.bars, xpos, prev, started,
                                            ring.x, afr, mc, acc, tot);
      prev = xpos.slot;
      xpos.step(slots.x);
      tile_chunk_exact<NB, NS, ST, PAIR, 1>(sh, ws, meta, p + 1, c0, lane,
                                            ring.bars, xpos, prev, true,
                                            ring.x, afr, mc, acc, tot);
      prev = xpos.slot;
      xpos.step(slots.x);
      started = true;
    }
    __syncwarp();                    // the warp is done with the stage
    if (lane == 0) mbar_arrive(ring.bars.wempty(wpos.slot));
    wpos.step(slots.w);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (started)                        // the last chunk (BUF 1)
    tile_correct<NS>(acc, mc[1],
                     reinterpret_cast<const float*>(ring.x + prev * sh.x +
                                                    3 * kSlab),
                     lane & 3, tot);

  // tot[s][4 q + i]: weight column col0 + c0 + (i >> 1), row m0 + 64 s +
  // 8 q + 2 (lane % 4) + (i & 1)
  const int t = lane & 3;
  const int n = col0 + c0;
  if (n >= a.N) return;
  float* part = gridDim.y > 1 ? a.partial + static_cast<size_t>(blockIdx.y) *
                                                a.op.M * a.N
                              : nullptr;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + 64 * s + 8 * q + 2 * t + i;
        if (m >= a.op.M) continue;
        const size_t o = static_cast<size_t>(m) * a.N + n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (n + h >= a.N) continue;
          const float v = tot[s][4 * q + 2 * h + i];
          if (part)
            part[o + h] = v;
          else
            store_f(a.out, o + h, v, a.out_bf16);
        }
      }
}

template <int NB, int NS, int ST, bool PAIR = false>
cudaError_t launch_tile_exact(const GemvArgs& a, int splits, const float* xsc,
                              cudaStream_t stream) {
  using C = TileCfg<tile_wg(NS)>;
  const TileShape sh = tile_shape(NB, a.w.superblock, a.w.group_size,
                                  a.w.meta_bf16, NS, 8 * ST, true);
  const TileSlots slots = tile_slots(sh);
  if (slots.w < 2) return cudaErrorInvalidValue;
  const size_t smem = tile_smem(sh, slots);
  static size_t allowed = 0;
  cudaError_t e =
      allow_smem(qmm_tile_f32_kernel<NB, NS, ST, PAIR>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + C::bn - 1) / C::bn, splits,
            (a.op.M + 64 * NS - 1) / (64 * NS));
  if (a.op.ldx % (64 * NS)) return cudaErrorInvalidValue;
  qmm_tile_f32_kernel<NB, NS, ST, PAIR><<<grid, C::threads, smem, stream>>>(
      a, slots, xsc);
  return cudaGetLastError();
}

template <int NB>
cudaError_t dispatch_tile_exact(const GemvArgs& a, int splits,
                                const float* xsc, cudaStream_t s) {
  if constexpr (NB == 1 || NB == 3)
    if (tile_pair(NB, a.w.superblock))
      return tile_ns_exact(NB, a.w.group_size, a.w.superblock, a.w.meta_bf16)
                 ? launch_tile_exact<NB, 1, kPairNs / 8, true>(a, splits, xsc,
                                                               s)
                 : cudaErrorInvalidValue;
  switch (tile_ns_exact(NB, a.w.group_size, a.w.superblock, a.w.meta_bf16)) {
    case 16: return launch_tile_exact<NB, 1, 2>(a, splits, xsc, s);
    case 8: return launch_tile_exact<NB, 1, 1>(a, splits, xsc, s);
    default: return cudaErrorInvalidValue;
  }
}

// silu(g) * u in f32, rounded to bf16 (qmm_tile.cuh's swiglu_pair), two
// elements a thread: g, u [M, K] with row stride ldx -> out [M, K].
__global__ void swiglu_bf16_kernel(const uint32_t* g, const uint32_t* u,
                                   uint32_t* out, int M, int K, int ldx) {
  const int half = K / 2;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(M) * half) return;
  const int m = static_cast<int>(i / half), k = static_cast<int>(i % half);
  const size_t src = static_cast<size_t>(m) * (ldx / 2) + k;
  out[i] = swiglu_pair(g[src], u[src]);
}

}  // namespace

// The tile kernel for the calls tile_takes accepts (u must be null: the
// SwiGLU prologue is amq_swiglu_bf16's pass).  amq_qmm's arguments, with
// `sb_per_split` counting ring stages (of amq_qmm_tile_rows word rows of
// the round plane: ceil(superblocks R / rows) of them in K); returns 0 or
// a cudaError_t of the launch, -1 for a call it does not take.
extern "C" int amq_qmm_tile(const void* x, const void* u, int x_bf16,
                            const int32_t* packed, const void* scale,
                            const void* zero, int meta_bf16, void* out,
                            int out_bf16, float* partial, int M, int K,
                            int ldx, int Kp, int N, int Np, int nbits,
                            int group_size, int superblock, int splits,
                            int sb_per_split, void* stream) {
  if (u != nullptr ||
      !tile_takes(x, x_bf16, packed, scale, zero, meta_bf16, M, K, ldx, Kp,
                  N, Np, nbits, group_size, superblock) ||
      splits < 1 || sb_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  GemvArgs a{Operand{x, nullptr, x_bf16, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nbits) {
    case 1: e = dispatch_tile<1>(a, splits, s); break;
    case 2: e = dispatch_tile<2>(a, splits, s); break;
    case 3: e = dispatch_tile<3>(a, splits, s); break;
    case 4: e = dispatch_tile<4>(a, splits, s); break;
    default: e = dispatch_tile<8>(a, splits, s); break;
  }
  return finish_splits(e, partial, out, M * N, splits, out_bf16, s);
}

// Word rows of the round plane per ring stage of a weight layout, 0 for a
// layout the tile kernel does not take (tile_ns).
extern "C" int amq_qmm_tile_rows(int nbits, int group_size, int superblock,
                                 int meta_bf16) {
  return tile_ns(nbits, group_size, superblock, meta_bf16);
}

// The tile kernel's float32 form: amq_qmm_tile's arguments, x the split
// pass's x slot image at the layout's 2 ns (ns: amq_qmm_tile_f32_rows)
// with ldx = its rows a part (M rounded up to 64; x_bf16 1, u null), then
// its chunk sums xsc [Kp / (2 ns)][ldx]; 0, a cudaError_t of the launch,
// or -1 for a call it does not take.
extern "C" int amq_qmm_tile_f32(const void* x, const void* u, int x_bf16,
                                const int32_t* packed, const void* scale,
                                const void* zero, int meta_bf16, void* out,
                                int out_bf16, float* partial, int M, int K,
                                int ldx, int Kp, int N, int Np, int nbits,
                                int group_size, int superblock, int splits,
                                int sb_per_split, const float* xsc,
                                void* stream) {
  if (u != nullptr || xsc == nullptr || ldx < M || !aligned16(xsc) ||
      !tile_takes(x, x_bf16, packed, scale, zero, meta_bf16, M, K, ldx, Kp,
                  N, Np, nbits, group_size, superblock) ||
      tile_ns_exact(nbits, group_size, superblock, meta_bf16) == 0 ||
      splits < 1 || sb_per_split < 1 || (splits > 1 && partial == nullptr))
    return -1;
  GemvArgs a{Operand{x, nullptr, 1, M, K, ldx},
             Weights{reinterpret_cast<const uint32_t*>(packed), scale, zero,
                     meta_bf16, Np, group_size, superblock},
             out, out_bf16, partial, N, Kp, sb_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nbits) {
    case 1: e = dispatch_tile_exact<1>(a, splits, xsc, s); break;
    case 2: e = dispatch_tile_exact<2>(a, splits, xsc, s); break;
    case 3: e = dispatch_tile_exact<3>(a, splits, xsc, s); break;
    case 4: e = dispatch_tile_exact<4>(a, splits, xsc, s); break;
    default: e = dispatch_tile_exact<8>(a, splits, xsc, s); break;
  }
  return finish_splits(e, partial, out, M * N, splits, out_bf16, s);
}

// Word rows per ring stage of a layout in the float32 form, 0 for a
// layout it does not take (tile_ns_exact).
extern "C" int amq_qmm_tile_f32_rows(int nbits, int group_size,
                                     int superblock, int meta_bf16) {
  return tile_ns_exact(nbits, group_size, superblock, meta_bf16);
}

// The SwiGLU prologue: out [M, K] (contiguous) = silu(g) * u of bf16 g, u
// [M, K] (row stride ldx), in f32, rounded to bf16.  -1 for odd K or ldx.
extern "C" int amq_swiglu_bf16(const void* g, const void* u, void* out, int M,
                               int K, int ldx, void* stream) {
  if (K % 2 || ldx % 2 || M < 1) return -1;
  const long long n = static_cast<long long>(M) * (K / 2);
  swiglu_bf16_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(u),
      static_cast<uint32_t*>(out), M, K, ldx);
  return static_cast<int>(cudaGetLastError());
}
