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

}  // namespace hypad
