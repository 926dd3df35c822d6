// Hopper's asynchronous bulk copy (cp.async.bulk, the 1-D form of the
// Tensor Memory Accelerator) and the shared-memory mbarriers it completes
// on, with the L2 cache policies a copy may carry. Shared by
// csrc/radon_dense.cu (the dense Radon pair's ring of stages) and
// csrc/fused_block.cu (fused_block_bwd_dc's resident channel slices).
//
// A bulk copy moves a multiple of 16 bytes between 16-byte-aligned global
// and shared addresses; one thread issues it, and the barrier's phase
// completes when the bytes announced by bar_expect_tx have landed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk_copy {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// Orders the shared-memory accesses this thread has made or acquired
// (generic proxy: plain loads and stores, and other threads' reads that an
// mbarrier wait has made visible) before the async-proxy operations it
// issues next. A producer that refills a stage its consumers have just
// read calls it between the wait and the bulk copy: without it a copy can
// overwrite values a consumer is still reading.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on bar's transaction count, with an L2 policy.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

}  // namespace bulk_copy
