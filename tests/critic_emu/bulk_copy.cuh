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
void cp_async_n(void* dst, const void* src, unsigned bytes);
inline void cp_async16(void* dst, const void* src) {
  cp_async_n(dst, src, 16);
}
template <int kBytes>
inline void cp_async(void* dst, const void* src) {
  static_assert(kBytes == 4 || kBytes == 16, "cp.async copies 4 or 16 bytes");
  cp_async_n(dst, src, kBytes);
}
void cp_async_commit();
void cp_async_wait_all();
// every committed group but the newest `pending` landed
void cp_async_wait_groups(int pending);
template <int kPending>
inline void cp_async_wait() {
  cp_async_wait_groups(kPending);
}
void cp_async_arrive(uint64_t* bar);
}  // namespace hypad
