// Warpgroup MMA (wgmma) helpers shared by the kernels that run on it:
// flash_attention.cu's flash_kernel_wgmma, gemv_extract_ahead.cu and
// quant_matmul_tile.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the accumulator operands of an inline wgmma: 4 or 16 floats from a[i]
#define AMQ_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define AMQ_F16(a, i) \
  AMQ_F4(a, i), AMQ_F4(a, i + 4), AMQ_F4(a, i + 8), AMQ_F4(a, i + 12)

// A named namespace, as qmm_tile.cuh explains.
namespace amq {

// make generic-proxy writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers an asynchronous wgmma reads or writes to this point, so
// the compiler moves no use of them across a fence or a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: the tile is
// stored as panels 64 bf16 (128 bytes) wide, rows 128 bytes apart, the
// 16-byte chunk c of row r at chunk c ^ (r % 8) (1024-byte atoms of 8
// rows).  lbo: bytes between panels along the MN dimension of an MN-major
// operand; sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

}  // namespace amq
