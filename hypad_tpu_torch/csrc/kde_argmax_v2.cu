// Batched Gaussian-KDE argmax, each symmetric pair's exp computed once
// (K3), Hopper.
//
// Replaces: hypad_tpu/ops/kde_pallas.py:91 `_kernel_v2` (launched by
// `_pallas_kde_v2`, public entry `kde_argmax_rows_pallas(version="v2")`).
// The same output as K2 (kde_argmax.cu): per row of the (T, W)
// anti-diagonal matrix, the Scott-bandwidth density at each masked-in
// sample, its first-max argmax, and the use flag (cnt > 1 and var > 0). The
// densities are summed by offset instead of by sample:
//   dens_i = 1;  for r = 1..W-1:  e_i = exp(scale * (v_i - v_{i-r})^2) for
//   i >= r (0 below),  dens_i = dens_i + e_i + e_{i+r}  (e_{i+r} = 0 past
//   the row's end)
// so the exp of pair (i, i-r) serves both of its samples: W(W-1)/2 exps a
// row instead of K2's W^2. Masked entries are the 1e18 sentinel, so a pair
// touching one adds exactly 0 to a real sample. The additions follow the
// plain version (hypad_tpu_torch/ops/kde.py `kde_argmax_rows_v2_parts`)
// term by term; only `expf` against the host's exp can differ, in the last
// bits, so the two agree at tie level, as the TPU's v2 agrees with v1
// (kde_pallas.py:100-104). The masked-median fallback stays outside.
//
// Bound on the H100: the exps. At the detector's shape (T = 20,099,
// W = 100) the rows need about 9.9e7 of them, which take about 24 us on
// the special-function units (16 per clock per SM at 1.98 GHz), against
// 3 us for the 10 MB of row data.
//
// Design: one warp per row, as K2 (row load, statistics and argmax in
// kde_row.cuh). The sentinel-substituted row and one buffer of W exps per
// offset of a group of 4 sit in the warp's shared memory. For each offset r
// of the group the lanes take the W - r pairs (i, i-r) in turn (i = r +
// lane, r + lane + 32, ...), so no lane idles on an empty pair until fewer
// than 32 are left, and write the exp to e_r[i]; __syncwarp; then, offset
// by offset in ascending r, the lane that owns sample i adds e_r[i] and
// then e_r[i + r] to its density; __syncwarp again before the next group
// overwrites the buffers. Grouping changes no addition's order (the
// outputs are the bits of a group of 1); it cut the time a launch from
// 0.366 to 0.258 ms at the detect shape on an H100 80GB HBM3 at 700 W,
// where one barrier pair per offset left the warps waiting (K2: 0.121 ms
// there). K3 is still about 2x K2: each offset costs every
// lane 4 slots of loads and adds, as many as K2's exp slots, so the halved
// exps do not show yet. No tensor cores, no TMA.

#include "kde_row.cuh"

namespace {

constexpr int kMaxW = hypad::kKdeMaxW;
constexpr int kPerLane = hypad::kKdePerLane;
constexpr int kWarps = 8;  // rows per block
constexpr int kGroup = 4;  // offsets whose exps share a pair of barriers

__global__ void __launch_bounds__(kWarps * 32)
kde_argmax_v2_kernel(const float* __restrict__ vals,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ kde_val,
                     unsigned char* __restrict__ use, int rows, int width) {
  __shared__ float vs[kWarps][kMaxW];
  __shared__ float eb[kWarps][kGroup][kMaxW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warp; no block-wide barrier follows
  const float* v = vals + (size_t)row * width;
  const hypad::KdeRow s = hypad::kde_load_row(
      v, mask + (size_t)row * width, width, lane, vs[warp]);
  const float* x = vs[warp];

  float dens[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) dens[q] = 1.0f;  // the self pair
  for (int r0 = 1; r0 < width; r0 += kGroup) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int r = r0 + g;
      for (int i = r + lane; i < width; i += 32) {
        const float d = x[i] - x[i - r];
        eb[warp][g][i] = expf(s.scale * (d * d));
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int r = r0 + g;
      const float* e = eb[warp][g];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = lane + 32 * q;
        if (r < width && i < width) {
          const float fwd = i >= r ? e[i] : 0.0f;
          const float back = i + r < width ? e[i + r] : 0.0f;
          dens[q] = dens[q] + fwd + back;
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    if (!s.mi[q]) dens[q] = -INFINITY;
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
extern "C" int kde_argmax_v2_forward(const float* vals,
                                     const unsigned char* mask,
                                     float* kde_val, unsigned char* use,
                                     int rows, int width, void* stream) {
  if (rows < 0 || width < 1 || width > kMaxW) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int blocks = (rows + kWarps - 1) / kWarps;
  kde_argmax_v2_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      vals, mask, kde_val, use, rows, width);
  return cudaGetLastError();
}
