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
// smallest index among equal maxima (first-max-wins); both live in
// kde_row.cuh, shared with K3. `expf` (not `__expf`) keeps the densities
// within ulps of the plain PyTorch version, so the two can differ only
// where densities tie to the last bits (a different sample of the same
// row). K3 (kde_argmax_v2.cu) computes each symmetric pair's exp once.

#include "kde_row.cuh"

namespace {

constexpr int kMaxW = hypad::kKdeMaxW;
constexpr int kPerLane = hypad::kKdePerLane;
constexpr int kWarps = 8;  // rows per block

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
  const hypad::KdeRow s = hypad::kde_load_row(
      v, mask + (size_t)row * width, width, lane, vs[warp]);

  float dens[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int i = lane + 32 * q;
    dens[q] = -INFINITY;
    if (i < width && s.mi[q]) {
      const float x = vs[warp][i];
      float acc = 0.0f;
      for (int j = 0; j < width; ++j) {
        const float d = x - vs[warp][j];
        acc += expf(s.scale * (d * d));
      }
      dens[q] = acc;
    }
  }
  const int best_i = hypad::kde_first_max(dens, width, lane);
  if (lane == 0) {
    kde_val[row] = v[best_i];
    use[row] = (s.cnt > 1.0f && s.var > 0.0f) ? 1 : 0;
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
