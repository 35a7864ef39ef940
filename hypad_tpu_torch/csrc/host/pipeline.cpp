// HypAD-TPU native host runtime: signal preprocessing core.
//
// Implements the hot host-side data path — interval aggregation, mean
// imputation, (-1,1) min-max scaling and rolling-window extraction — as a
// single C++ pass over the raw (timestamp, value) arrays. Semantics are
// identical to hypad_tpu_torch/data/pipeline.py (itself specified by the
// reference's utils/dataloader.py:61-222); the Python pipeline remains the
// portable fallback and the parity oracle (tests/test_torch_native.py).
//
// C ABI (ctypes-friendly): the caller provides input arrays; the library
// allocates outputs and hands back an opaque result handle that must be
// released with hypad_release.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

extern "C" {

struct HypadResult {
  // aggregated timeline
  double* index;      // (n_buckets)
  int64_t n_buckets;
  // windows
  float* windows;     // (n_windows, window_size) row-major
  float* targets;     // (n_windows, target_size)
  double* x_index;    // (n_windows)
  double* y_index;    // (n_windows)
  int64_t n_windows;
  int64_t window_size;
  int64_t target_size;
};

static double nan_d() { return std::numeric_limits<double>::quiet_NaN(); }

// Full univariate preprocessing pass. Returns nullptr on error (signal too
// short for one window). Inputs need not be sorted; a stable sort by
// timestamp is applied exactly like the reference's sort_values.
HypadResult* hypad_prepare_univariate(const double* timestamps,
                                      const double* values, int64_t n,
                                      double interval, int64_t window_size,
                                      int64_t target_size,
                                      int64_t step_size) {
  if (n <= 0 || interval <= 0) return nullptr;

  // ---- stable sort by timestamp
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return timestamps[a] < timestamps[b];
  });

  const double t0 = timestamps[order.front()];
  const double t_max = timestamps[order.back()];
  const int64_t n_buckets =
      static_cast<int64_t>(std::floor((t_max - t0) / interval)) + 1;

  // ---- bucketed mean aggregation (NaN-aware)
  std::vector<double> sums(n_buckets, 0.0);
  std::vector<int64_t> counts(n_buckets, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t src = order[i];
    const double v = values[src];
    if (std::isnan(v)) continue;
    int64_t b = static_cast<int64_t>(
        std::floor((timestamps[src] - t0) / interval));
    b = std::min(std::max<int64_t>(b, 0), n_buckets - 1);
    sums[b] += v;
    counts[b] += 1;
  }
  std::vector<double> agg(n_buckets);
  for (int64_t b = 0; b < n_buckets; ++b)
    agg[b] = counts[b] ? sums[b] / counts[b] : nan_d();

  // ---- mean imputation
  double total = 0.0;
  int64_t total_n = 0;
  for (double v : agg)
    if (!std::isnan(v)) { total += v; total_n += 1; }
  const double col_mean = total_n ? total / total_n : 0.0;
  for (double& v : agg)
    if (std::isnan(v)) v = col_mean;

  // ---- (-1, 1) min-max scale
  double mn = agg[0], mx = agg[0];
  for (double v : agg) { mn = std::min(mn, v); mx = std::max(mx, v); }
  const double scale = mx > mn ? 2.0 / (mx - mn) : 0.0;
  for (double& v : agg) v = (v - mn) * scale - 1.0;

  // ---- rolling windows
  const int64_t max_start = n_buckets - window_size - target_size + 1;
  if (max_start <= 0) return nullptr;
  const int64_t n_windows = (max_start + step_size - 1) / step_size;

  auto* res = new HypadResult();
  res->n_buckets = n_buckets;
  res->window_size = window_size;
  res->target_size = target_size;
  res->n_windows = n_windows;
  res->index = static_cast<double*>(std::malloc(sizeof(double) * n_buckets));
  res->windows = static_cast<float*>(
      std::malloc(sizeof(float) * n_windows * window_size));
  res->targets = static_cast<float*>(
      std::malloc(sizeof(float) * n_windows * target_size));
  res->x_index = static_cast<double*>(std::malloc(sizeof(double) * n_windows));
  res->y_index = static_cast<double*>(std::malloc(sizeof(double) * n_windows));

  for (int64_t b = 0; b < n_buckets; ++b) res->index[b] = t0 + interval * b;
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t start = w * step_size;
    for (int64_t j = 0; j < window_size; ++j)
      res->windows[w * window_size + j] =
          static_cast<float>(agg[start + j]);
    for (int64_t j = 0; j < target_size; ++j)
      res->targets[w * target_size + j] =
          static_cast<float>(agg[start + window_size + j]);
    res->x_index[w] = res->index[start];
    res->y_index[w] = res->index[start + window_size];
  }
  return res;
}

void hypad_release(HypadResult* res) {
  if (!res) return;
  std::free(res->index);
  std::free(res->windows);
  std::free(res->targets);
  std::free(res->x_index);
  std::free(res->y_index);
  delete res;
}

}  // extern "C"
