// Copies from device memory into shared memory by the Tensor Memory
// Accelerator (Hopper: cp.async.bulk.tensor), counted on an mbarrier in
// shared memory.
//
// One thread asks for a whole box of a tensor (a tensor map, made on the
// host with cuTensorMapEncodeTiled) with one instruction; the copy engine
// computes the addresses, fills what lies past the tensor's end with
// zeros and, once the box has landed, subtracts its bytes from the
// barrier's transaction count.  A phase of a barrier initialised with
// count 1 completes when its one arrival (bar_expect, which also adds the
// bytes to come) has been made and every byte has landed; bar_wait then
// returns to every thread that waits on that phase's parity, with the
// copied bytes visible to it.
//
// Kept to these few helpers, so that a CPU check of the kernels' logic can
// stand in a strided memcpy for tma_copy_3d and a counter for the barrier.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ryujin {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

// One thread, before any other thread uses the barrier, then a
// __syncthreads().
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and add `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy the box of the 3D tensor map `map` at coordinates (c0, c1, c2),
// innermost first, to dst (shared memory, 128-byte aligned), counted on
// bar.  map lies in the kernel's parameters (__grid_constant__).
__device__ __forceinline__ void tma_copy_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(shared_addr(bar))
      : "memory");
}

// Copy `bytes` (a multiple of 16) from src (device memory, 16-byte
// aligned) to dst (shared memory, 16-byte aligned) as one bulk copy,
// counted on bar: no tensor map, one instruction from one thread.
__device__ __forceinline__ void bulk_copy_1d(void* dst, const void* src, unsigned bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Arrive on bar once every cp.async this thread has issued so far has
// landed (the barrier's count includes this arrival: initialise it with
// the number of threads that arrive).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(shared_addr(bar))
               : "memory");
}

}  // namespace ryujin
