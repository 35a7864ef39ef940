// The per-row steps shared by the two KDE-argmax kernels, K2
// (kde_argmax.cu) and K3 (kde_argmax_v2.cu): one warp per row of the
// (T, W) anti-diagonal matrix, lane l owning samples l, l+32, l+64, l+96
// (W <= 128). They differ only in how they sum the densities.
#pragma once

#include <math.h>

#include "common.cuh"

namespace hypad {

constexpr int kKdeMaxW = 128;
constexpr int kKdePerLane = kKdeMaxW / 32;
constexpr float kKdeSentinel = 1e18f;

// A row's samples as its lane holds them, and the row's statistics.
struct KdeRow {
  float vi[kKdePerLane];
  bool mi[kKdePerLane];
  float cnt, var, scale;
};

// Loads the lane's samples; mean, unbiased variance and the Scott scale
// -0.5 / h^2 (h^2 = var * cnt^-0.4, 1 where it is not positive) as warp
// shuffles; writes the row with masked entries set to the 1e18 sentinel
// to `vs` (the warp's W floats of shared memory) and syncs the warp.
__device__ __forceinline__ KdeRow kde_load_row(const float* v,
                                               const unsigned char* m,
                                               int width, int lane,
                                               float* vs) {
  KdeRow s;
  float cnt = 0.0f, sum = 0.0f;
#pragma unroll
  for (int q = 0; q < kKdePerLane; ++q) {
    const int i = lane + 32 * q;
    s.vi[q] = i < width ? v[i] : 0.0f;
    s.mi[q] = i < width && m[i] != 0;
    cnt += s.mi[q] ? 1.0f : 0.0f;
    sum += s.mi[q] ? s.vi[q] : 0.0f;
  }
  s.cnt = warp_sum(cnt);
  sum = warp_sum(sum);
  const float cnt_f = fmaxf(s.cnt, 1.0f);
  const float mean = sum / cnt_f;
  float ss = 0.0f;
#pragma unroll
  for (int q = 0; q < kKdePerLane; ++q) {
    const float c = s.mi[q] ? s.vi[q] - mean : 0.0f;
    ss += c * c;
  }
  s.var = warp_sum(ss) / fmaxf(cnt_f - 1.0f, 1.0f);
  const float h2 = s.var * powf(cnt_f, -0.4f);
  s.scale = -0.5f / (h2 > 0.0f ? h2 : 1.0f);
#pragma unroll
  for (int q = 0; q < kKdePerLane; ++q) {
    const int i = lane + 32 * q;
    if (i < width) vs[i] = s.mi[q] ? s.vi[q] : kKdeSentinel;
  }
  __syncwarp();
  return s;
}

// The row's first-max argmax over the lanes' densities (-inf where
// masked): the smallest index among equal maxima, as np.argmax picks.
__device__ __forceinline__ int kde_first_max(const float (&dens)[kKdePerLane],
                                             int width, int lane) {
  float best = -INFINITY;
  int best_i = 0x7fffffff;
#pragma unroll
  for (int q = 0; q < kKdePerLane; ++q) {
    const int i = lane + 32 * q;
    if (i >= width) continue;
    // ascending i per lane: a strict > keeps the first of equal maxima
    if (dens[q] > best || best_i == 0x7fffffff) {
      best = dens[q];
      best_i = i;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(kFullMask, best, offset);
    const int oi = __shfl_xor_sync(kFullMask, best_i, offset);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  return best_i;
}

}  // namespace hypad
