// Native dynamic-threshold engine for the batched interval epilogue.
//
// Behavior spec: reference find_threshold / z_cost
// (utils/anomaly_detection_utils.py:1023-1095) — scipy.optimize.fmin
// (Nelder-Mead, rho=1 chi=2 psi=0.5 sigma=0.5, 5% initial step / 0.00025 at
// zero, xatol=fatol=1e-4, maxiter=maxfun=200) started from every integer z
// in [min_z, max_z), keeping the LAST start whose minimized cost is finite
// (the reference's best_cost-never-updates bug, preserved) — with every
// z_cost evaluation reduced to O(log L) by per-window sorted prefix tables
// (see hypad_tpu_torch/detect/intervals.py::_WindowTables, the numpy twin):
//   * below-threshold count/mean/std from prefix sums over the sorted
//     window at the searchsorted position of epsilon;
//   * the above-threshold run count by interval stabbing: a run starts at
//     i>=1 iff e_{i-1} <= eps < e_i, so the count is
//     #(a_sorted <= eps) - #(b_sorted <= eps) over kept pairs a < b, plus
//     the boundary term e_0 > eps.
//
// Bitwise contract: identical float64 results to the numpy batched path —
// prefix sums are the same serial accumulation as np.cumsum, all z_cost /
// Nelder-Mead arithmetic is the same IEEE double ops in the same order, and
// the window mean/std are COMPUTED BY NUMPY and passed in (numpy's pairwise
// reduction is not replicated here). Asserted in tests/test_torch_native.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kNaN = std::numeric_limits<double>::quiet_NaN();

struct ZTab {
  const double* sorted_e;   // (L) ascending, NaNs at the end
  const double* pre_sum;    // (L+1) running sum of sorted (NaN -> 0)
  const double* pre_sumsq;  // (L+1)
  const double* a_sorted;   // (n_pairs) ascending
  const double* b_sorted;   // (n_pairs) ascending
  int64_t L;
  int64_t n_pairs;
  int64_t n_valid;  // non-NaN count
  double first;     // window[0]
  double mean, std; // numpy-computed window stats
};

// cost(z) == +inf exactly when denominator == 0, i.e. eps >= max(e): no
// point above (runs then also 0). Used by the plateau early-exit below.
static inline bool all_below(const ZTab& t, double eps);

// count of elements <= v (searchsorted side='right'); NaN tail compares
// false on <=, landing it past every number — same as the numpy twin.
static inline int64_t count_le(const double* arr, int64_t n, double v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (arr[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

static double z_cost(const ZTab& t, double z) {
  double eps = t.mean + z * t.std;
  int64_t pos = count_le(t.sorted_e, t.L, eps);
  double delta_mean = 0.0, delta_std = 0.0;
  if (pos > 0) {
    double cnt = static_cast<double>(pos);
    double mean_b = t.pre_sum[pos] / cnt;
    double var_b = t.pre_sumsq[pos] / cnt - mean_b * mean_b;
    double std_b = std::sqrt(std::max(var_b, 0.0));
    delta_mean = t.mean - mean_b;
    delta_std = t.std - std_b;
  }
  int64_t above = t.n_valid - pos;
  int64_t runs = count_le(t.a_sorted, t.n_pairs, eps)
               - count_le(t.b_sorted, t.n_pairs, eps)
               + (t.first > eps ? 1 : 0);
  double numerator = -(delta_mean / t.mean + delta_std / t.std);
  int64_t denominator = above + runs * runs;
  if (denominator == 0) return kInf;
  return numerator / static_cast<double>(denominator);
}

// scipy fmin for N=1 (see file header); returns {x, fval}.
struct FminResult { double x, fval; };

static inline bool all_below(const ZTab& t, double eps) {
  return count_le(t.sorted_e, t.L, eps) >= t.n_valid;
}

static FminResult fmin_z(const ZTab& t, double x0) {
  double s0 = x0;
  double s1 = (x0 != 0.0) ? 1.05 * x0 : 0.00025;
  double f0 = z_cost(t, s0);
  double f1 = z_cost(t, s1);
  int fcalls = 2;
  auto sort2 = [&]() {
    if (f1 < f0 || (std::isnan(f0) && !std::isnan(f1))) {
      std::swap(s0, s1);
      std::swap(f0, f1);
    }
  };
  sort2();
  // EXACT plateau early-exit: with both simplex costs +inf, every branch
  // comparison (inf < inf) is false, so only inside-contraction + shrink
  // fire — s0 never moves, the simplex contracts toward s0, and every z
  // the loop will ever evaluate lies in [min(s0,s1) - 2|d|, max(s0,s1)].
  // fl(mean + z*std) is monotone in z, so if eps at the LOWEST reachable z
  // already clears max(e) (denominator == 0 region, see all_below), every
  // future eval returns +inf and the loop runs to the fcalls cap with
  // the predetermined result {x=s0, fval=inf} — which the caller ignores
  // (not finite). Skipping those ~200 evaluations is bitwise-neutral.
  if (std::isinf(f0) && f0 > 0 && std::isinf(f1) && f1 > 0) {
    double d = std::fabs(s1 - s0);
    double lo_reach = std::min(s0, s1) - 2.0 * d;
    if (all_below(t, t.mean + lo_reach * t.std)) return {s0, kInf};
  }
  for (int it = 1; it < 200 && fcalls < 200; ++it) {
    // NaN-safe convergence: inf-inf = NaN and NaN comparisons are false,
    // exactly like numpy's masked check in the batched twin
    double dx = std::fabs(s1 - s0), df = std::fabs(f0 - f1);
    if (dx <= 1e-4 && df <= 1e-4) break;
    double xr = 2.0 * s0 - s1;
    double fxr = z_cost(t, xr);
    ++fcalls;
    bool shrink = false;
    if (fxr < f0) {  // reflect improved the best: try expansion
      double xe = 3.0 * s0 - 2.0 * s1;
      double fxe = z_cost(t, xe);
      ++fcalls;
      if (fxe < fxr) { s1 = xe; f1 = fxe; }
      else           { s1 = xr; f1 = fxr; }
    } else {
      // for N=1 scipy's fsim[-2] IS fsim[0], so accept-reflection never
      // fires; straight to contraction
      if (fxr < f1) {  // outside contraction
        double xc = 1.5 * s0 - 0.5 * s1;
        double fxc = z_cost(t, xc);
        ++fcalls;
        if (fxc <= fxr) { s1 = xc; f1 = fxc; }
        else            { shrink = true; }
      } else {         // inside contraction
        double xcc = 0.5 * s0 + 0.5 * s1;
        double fxcc = z_cost(t, xcc);
        ++fcalls;
        if (fxcc < f1) { s1 = xcc; f1 = fxcc; }
        else           { shrink = true; }
      }
      if (shrink) {
        s1 = s0 + 0.5 * (s1 - s0);
        f1 = z_cost(t, s1);
        ++fcalls;
      }
    }
    sort2();
  }
  double fval = (std::isnan(f0) || std::isnan(f1)) ? kNaN
                                                   : std::min(f0, f1);
  return {s0, fval};
}

}  // namespace

extern "C" {

// windows: (Wn, L) row-major float64; means/stds: (Wn,) numpy-computed
// window statistics; out: (Wn,) thresholds.
void hypad_find_thresholds(const double* windows, const double* means,
                           const double* stds, int64_t Wn, int64_t L,
                           int64_t min_z, int64_t max_z, double* out) {
  std::vector<double> sorted(L), pre_sum(L + 1), pre_sumsq(L + 1);
  std::vector<double> a_sorted, b_sorted;
  a_sorted.reserve(L);
  b_sorted.reserve(L);
  for (int64_t w = 0; w < Wn; ++w) {
    const double* e = windows + w * L;
    // sort with NaNs at the end (numpy sort order)
    int64_t n_valid = 0;
    for (int64_t i = 0; i < L; ++i)
      if (!std::isnan(e[i])) sorted[n_valid++] = e[i];
    std::sort(sorted.begin(), sorted.begin() + n_valid);
    for (int64_t i = n_valid; i < L; ++i) sorted[i] = kNaN;
    // prefix sums: serial accumulation == np.cumsum
    pre_sum[0] = 0.0;
    pre_sumsq[0] = 0.0;
    for (int64_t i = 0; i < L; ++i) {
      double v = (i < n_valid) ? sorted[i] : 0.0;
      pre_sum[i + 1] = pre_sum[i] + v;
      pre_sumsq[i + 1] = pre_sumsq[i] + v * v;
    }
    // run-start stabbing pairs: keep (e[i-1], e[i]) with e[i-1] < e[i]
    a_sorted.clear();
    b_sorted.clear();
    for (int64_t i = 1; i < L; ++i) {
      if (e[i - 1] < e[i]) {  // NaN pairs drop out (comparison false)
        a_sorted.push_back(e[i - 1]);
        b_sorted.push_back(e[i]);
      }
    }
    std::sort(a_sorted.begin(), a_sorted.end());
    std::sort(b_sorted.begin(), b_sorted.end());

    ZTab t{sorted.data(), pre_sum.data(), pre_sumsq.data(),
           a_sorted.data(), b_sorted.data(), L,
           static_cast<int64_t>(a_sorted.size()), n_valid, e[0],
           means[w], stds[w]};
    // reference find_threshold: ascending starts, last finite cost wins
    double best_z = static_cast<double>(min_z);
    for (int64_t z = min_z; z < max_z; ++z) {
      FminResult r = fmin_z(t, static_cast<double>(z));
      if (r.fval < kInf) best_z = r.x;
    }
    out[w] = means[w] + best_z * stds[w];
  }
}

}  // extern "C"
