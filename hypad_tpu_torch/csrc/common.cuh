// Helpers shared by the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

namespace hypad {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum of v over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(kFullMask, v, offset);
  return v;
}

#ifdef __CUDACC__
// 2^x on the special-function unit (ex2.approx.ftz.f32, one MUFU.EX2): a
// relative error of about 2^-22, subnormal arguments and results flushed
// to zero, 2^-inf = +0. The CPU emulation (tests/critic_emu) brings a
// stand-in of its own.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1/x on the special-function unit (rcp.approx.ftz.f32, one MUFU.RCP):
// within about an ulp, subnormals flushed to zero. The CPU emulation
// brings a stand-in of its own.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The cluster barrier in halves: arrive without ordering memory
// (barrier.cluster.arrive.relaxed: no fence before it), then wait for
// every thread of the cluster (barrier.cluster.wait, acquire). After
// mbar_init's fence, it makes the barriers' initialisation visible to the
// cluster. The CPU emulation brings stand-ins.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
#endif

}  // namespace hypad
