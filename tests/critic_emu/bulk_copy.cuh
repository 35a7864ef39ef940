// The asynchronous copies and mbarriers of csrc/bulk_copy.cuh in the CPU
// emulation (see cuda_runtime.h). A copy lands when it is issued, or, in
// the lazy mode, only when a thread waits for it, so that a read of shared
// memory before its wait sees the bytes that were there before.
#pragma once
#include <stdint.h>

#include "cuda_runtime.h"
namespace hypad {
void mbar_init(uint64_t* bar);
void mbar_init_count(uint64_t* bar, unsigned count);
inline void fence_async_shared() {}
void mbar_expect_bytes(uint64_t* bar, unsigned bytes);
void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar);
void mbar_wait(uint64_t* bar, unsigned parity);
void cp_async16(void* dst, const void* src);
template <int kBytes>
inline void cp_async(void* dst, const void* src) {
  static_assert(kBytes == 16, "the kernel copies 16 bytes a cp.async");
  cp_async16(dst, src);
}
void cp_async_commit();
void cp_async_wait_all();
void cp_async_arrive(uint64_t* bar);
}  // namespace hypad
