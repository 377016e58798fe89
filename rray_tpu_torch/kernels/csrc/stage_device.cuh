// Staging of read-only tables into shared memory for the CUDA kernels
// (whitted.cu, bvh.cu): bulk asynchronous copies (cp.async.bulk, TMA's
// 1-D form) that complete on an mbarrier. Device code only.
#pragma once

#include <cstdint>

namespace rray {

constexpr unsigned kChunkBytes = 32 * 1024;  // one bulk copy's size at most

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) of
// scene tables from global to shared memory with bulk asynchronous
// copies that complete on one mbarrier; every thread waits for them.
__device__ __forceinline__ void stage_tables(float* dst, const float* src,
                                             unsigned bytes, uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     b),
                 "r"(bytes)
                 : "memory");
    for (unsigned off = 0; off < bytes; off += kChunkBytes) {
      const unsigned n = bytes - off < kChunkBytes ? bytes - off : kChunkBytes;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(d + off),
          "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
          : "memory");
    }
  }
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

}  // namespace rray
