// Bulk asynchronous copies into shared memory (cp.async.bulk, completing
// on an mbarrier), shared by the walks K2-tb (gotoh_tb.cu), K3-tb
// (gotoh_banded_tb.cu) and K4-tb (gotoh_wide_tb.cu, tiles of a tensor
// map). ops/_build.py hashes this header into the name of every kernel
// library, so a change here rebuilds them.

#pragma once

#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1)
               : "memory");
}

// makes the barriers' initialisation visible to the copies
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// `bytes` more to arrive on `bar` in its current phase, and this thread's
// arrival; the copies that bring them complete the phase
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// into shared memory, completing on `bar`
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  // order this thread's earlier reads of the buffer before the copy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one box of a 3-dimensional tensor map (`map`, a __grid_constant__
// kernel parameter) at element coordinates (x, y, z), x innermost, into
// shared memory at `dst` (128-aligned), completing on `bar`: `bytes` is
// the whole box, elements outside the tensor arriving as zeros. No proxy
// fence: the caller issues it only after every read of the buffer has
// returned the value that decided to issue it
__device__ __forceinline__ void load_box3d(void* dst, const void* map, int x,
                                           int y, int z, uint32_t bytes,
                                           uint64_t* bar) {
  expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// whether the phase of `bar` with this parity has completed, without
// waiting for it
__device__ __forceinline__ bool test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

}  // namespace bulk
