// Asynchronous copies from device memory into shared memory, for Hopper
// (sm_90): one-dimensional bulk copies (cp.async.bulk), completed on an
// mbarrier, where one thread issues a copy and every thread waits on the
// barrier's phase; and per-thread copies of 4 or 16 bytes (cp.async), which
// a thread issues without waiting and completes with cp_async_wait,
// cp_async_wait_all, or an arrival on an mbarrier (cp_async_arrive).
#pragma once

#include <stdint.h>

namespace hypad {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialise a barrier that one arrival (the issuing thread's) completes;
// the fences make the initialisation visible to the copy engine. Sync the
// block before any other thread waits on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Order this thread's earlier shared-memory accesses before later bulk
// copies into the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrive on the barrier and announce the bytes the copies of this phase
// will deliver.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Initialise a barrier that `count` arrivals complete (see mbar_init).
__device__ __forceinline__ void mbar_init_count(uint64_t* bar,
                                                unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on the barrier once every cp.async this thread has issued so far
// has landed (one of the arrivals the barrier was initialised to count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy kBytes (4 or 16; both addresses aligned to it) from device memory
// to shared memory without waiting.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(kBytes == 4 || kBytes == 16, "cp.async copies 4 or 16 bytes");
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

// Close this thread's group of the cp.async copies issued since the last.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight. The completed copies are visible to this thread; sync the
// threads that read them.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Wait for every cp.async copy this thread issued, committed or not.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

}  // namespace hypad
