// Batched Gaussian-KDE argmax over the critic's anti-diagonal rows, Hopper.
//
// Replaces: hypad_tpu/ops/kde_pallas.py:42 `_kernel` (v1; launched by
// `_pallas_kde`, public entry `kde_argmax_rows_pallas`). Per row of the
// (T, W) anti-diagonal matrix, over its masked-in samples:
//   mean; unbiased variance; Scott bandwidth h^2 = var * n^-0.4;
//   dens_i = sum_j exp(scale * (v_i - v_j)^2), scale = -0.5 / h^2
//   (masked entries become a 1e18 sentinel, so any pair touching one adds
//   exactly 0); first-max argmax over i -> kde_val, and the use flag
//   (cnt > 1 and var > 0). The masked-median fallback stays outside the
//   kernel (hypad_tpu_torch/ops/kde_kernel.py), as on the TPU.
//
// Bound on the H100: the W x W exponentials, not the bytes. At the
// detector's shape (T = 20,099, W = 100) the row data is 10 MB (3 us at
// 3.35 TB/s) while the rows need about 2.0e8 exps; the exps run on the
// special-function units (16 per clock per SM), which puts the floor at a
// few tens of microseconds, above the 67 TFLOP/s f32 FMA rate's.
//
// Design: one warp per row. The row's values (sentinel-substituted) sit in
// shared memory; lane l owns samples l, l+32, l+64, l+96 (W <= 128) and sums
// exp over j in ascending order, reading v_j as a shared-memory broadcast.
// Mean, variance and the argmax are warp shuffles; the argmax keeps the
// smallest index among equal maxima (first-max-wins). `expf` (not `__expf`)
// keeps the densities within ulps of the plain PyTorch version, so the two
// can differ only where densities tie to the last bits (a different sample
// of the same row). Not yet done: computing each symmetric pair's exp once
// (the TPU's v2 kernel, hypad_tpu/ops/kde_pallas.py:91).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxW = 128;
constexpr int kPerLane = kMaxW / 32;
constexpr int kWarps = 8;  // rows per block
constexpr float kSentinel = 1e18f;

__global__ void __launch_bounds__(kWarps * 32)
kde_argmax_kernel(const float* __restrict__ vals,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ kde_val, unsigned char* __restrict__ use,
                  int rows, int width) {
  __shared__ float vs[kWarps][kMaxW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warp; no block-wide barrier follows
  const float* v = vals + (size_t)row * width;
  const unsigned char* m = mask + (size_t)row * width;

  float vi[kPerLane];
  bool mi[kPerLane];
  float cnt = 0.0f, sum = 0.0f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = lane + 32 * q;
    vi[q] = i < width ? v[i] : 0.0f;
    mi[q] = i < width && m[i] != 0;
    cnt += mi[q] ? 1.0f : 0.0f;
    sum += mi[q] ? vi[q] : 0.0f;
  }
  cnt = hypad::warp_sum(cnt);
  sum = hypad::warp_sum(sum);
  const float cnt_f = fmaxf(cnt, 1.0f);
  const float mean = sum / cnt_f;
  float ss = 0.0f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const float c = mi[q] ? vi[q] - mean : 0.0f;
    ss += c * c;
  }
  const float var = hypad::warp_sum(ss) / fmaxf(cnt_f - 1.0f, 1.0f);
  const float h2 = var * powf(cnt_f, -0.4f);
  const float scale = -0.5f / (h2 > 0.0f ? h2 : 1.0f);

#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = lane + 32 * q;
    if (i < width) vs[warp][i] = mi[q] ? vi[q] : kSentinel;
  }
  __syncwarp();

  float best = -INFINITY;
  int best_i = 0x7fffffff;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = lane + 32 * q;
    if (i >= width) continue;
    float dens = -INFINITY;
    if (mi[q]) {
      const float x = vs[warp][i];
      dens = 0.0f;
      for (int j = 0; j < width; ++j) {
        const float d = x - vs[warp][j];
        dens += expf(scale * (d * d));
      }
    }
    // ascending i per lane: a strict > keeps the first of equal maxima
    if (dens > best || best_i == 0x7fffffff) {
      best = dens;
      best_i = i;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(hypad::kFullMask, best, offset);
    const int oi = __shfl_xor_sync(hypad::kFullMask, best_i, offset);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (lane == 0) {
    kde_val[row] = v[best_i];
    use[row] = (cnt > 1.0f && var > 0.0f) ? 1 : 0;
  }
}

}  // namespace

// vals (rows, width) f32, mask (rows, width) bool bytes -> kde_val (rows,)
// f32, use (rows,) bool bytes; contiguous, on the device. Launches on
// `stream` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// shapes it does not take).
extern "C" int kde_argmax_forward(const float* vals, const unsigned char* mask,
                                  float* kde_val, unsigned char* use, int rows,
                                  int width, void* stream) {
  if (rows < 0 || width < 1 || width > kMaxW) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int blocks = (rows + kWarps - 1) / kWarps;
  kde_argmax_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      vals, mask, kde_val, use, rows, width);
  return cudaGetLastError();
}
