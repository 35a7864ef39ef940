// Batched Gaussian-KDE argmax over the critic's anti-diagonal rows, with the
// masked-median fallback, on Hopper: K2 (densities summed by sample) and K3
// (summed by offset), which share everything but the density phase.
//
// Replaces: hypad_tpu/ops/kde_pallas.py:42 `_kernel` (v1, K2) and
// hypad_tpu/ops/kde_pallas.py:91 `_kernel_v2` (v2, K3), both launched through
// the public entry `kde_argmax_rows_pallas(version=...)`, together with the
// fallback that `_kde_argmax_rows_pallas_impl` (:230-235) takes outside
// either kernel. Per row of the (T, W) anti-diagonal matrix, over its
// masked-in samples:
//   mean; unbiased variance; Scott bandwidth h^2 = var * n^-0.4;
//   dens_i = sum_j exp(scale * (v_i - v_j)^2), scale = -0.5 / h^2
//   (masked entries become a 1e18 sentinel, so any pair touching one adds
//   exactly 0); use = cnt > 1 and var > 0; the value is the first-max
//   density argmax where use holds, else the masked median (np.median
//   semantics, 0.5 * (lo + hi) in f32, as `masked_median` computes it).
//
// The two differ only in the order of each density's sum:
// - v1 (K2) follows no fixed order of JAX's; it agrees with its plain
//   version (hypad_tpu_torch/ops/kde.py `kde_argmax_rows_and_use`) at tie
//   level.
// - v2 (K3) keeps `_kernel_v2`'s order term by term: dens_i starts at 1,
//   then for r = 1..W-1 it adds the exp of pair (i, i-r), then that of pair
//   (i+r, i) (`dens = dens + e + back`, kde_pallas.py:124-133), a term
//   outside the row being exactly 0. Adding +0 to a density (>= 1) is
//   exact, so K3 skips no term that matters and adds zeros where it must;
//   only `expf` against the host's exp differs, in the last bits
//   (hypad_tpu_torch/ops/kde.py `kde_argmax_rows_v2_and_use`).
//
// What bounds it on the H100: instruction issue. At the detector's shape
// (T = 20,099, W = 100) the rows are 10 MB (3 us at 3.35 TB/s) and hold
// 9.9e7 unordered pairs. Accurate `expf` is about 8 instructions (one of
// them on the special-function unit), so a pair costs about 11 issue slots
// and two adds.
//
// Shared design:
// - Each unordered pair's exp is computed once and added to both samples'
//   densities: (v_i - v_j)^2 equals (v_j - v_i)^2 bit for bit, so each term
//   is the plain version's. `expf` stays at full accuracy (`__expf` would
//   move densities by ~1e-6 relative, far above the last-ulp ties the
//   tie-level check allows).
// - A row's samples form nb blocks of 4 (padding holds the sentinel). One
//   thread owns one block of one row: its 4 densities stay in registers. A
//   thread block of R rows (K2 16, K3 32) has R * nb threads, nb at least
//   32 / R so that it holds a full warp (R * nb = 400 at W = 100 in K2: 12
//   full warps and a half one, which sits out the warp-wide phases).
// - Phase 1 (one warp a row) loads the row, its mean, variance, Scott scale
//   and use flag; phase 3 takes each block's first max; phase 4 (one warp a
//   row) the row's first max, the smallest index among equal maxima, or,
//   on rows flagged use = 0 (a single sample, zero variance, or a NaN), the
//   masked median: one warp selects the two middle order statistics by
//   counting ranks over the row with ballots (no sort). The row is ranked
//   as the plain version sorts it: masked entries filled with the f32
//   maximum, NaNs last. A fallback row's warp ends its block, and a block
//   in the last wave ends the launch: counting each candidate's rank in one
//   lane over the whole row took 0.105 ms in K2, the ballots 0.069.
//
// K2's density phase (thread (r, I) = threadIdx r * nb + I): the block pairs
// follow a round-robin. In round k (1 <= k <= nb / 2) block I pairs with
// block I + k (mod nb), 16 exps, adding the row partials to its own
// registers and handing the 4 column partials to block I + k's thread
// through shared memory (two buffers, one barrier a round; the receiver adds
// them in round order, so the sums are deterministic). With nb even, round
// nb / 2 is taken by the lower half only. At most 32 registers a thread; at
// W = 100 a block takes 13 warps' slots, so 4 share an SM (1,257 blocks:
// 2.4 waves over 132 SMs). On the H100, 32-row blocks at 39 registers took
// 0.081 ms and at 32 registers 0.073 ms; two offsets a barrier round 0.075.
//
// K3's density phase (thread (r, I) = threadIdx I * R + r; with R = 32,
// warp I holds block I of every row, so every branch on I is uniform
// across it): the
// wrapping round-robin would break v2's order, so block I pairs in round D
// (1 <= D <= nb) with block I - D only, and keeps the 16 exps, its own
// forward terms (pair (i, i - r)), in registers; it hands them, transposed,
// to block I - D's thread, whose back terms (pair (i + r, i)) they are,
// through shared memory (two buffers, one barrier a round). Round D brings
// sample a of the block the forward terms at offsets 4D + a - 3..4D + a
// and the back terms at 4D - a..4D + 3 - a, so each sample adds its 8
// terms of offsets 4D - 3..4D (samples 0 and 3) or 4D - 2..4D + 1 (samples
// 1 and 2) in v2's order and carries the 1-3 terms a side that belong to
// round D + 1 in registers (8 a thread); round 0 (the in-block pairs)
// starts them, the round after a thread's last partner flushes them. A
// thread with no partner on a side skips that side's terms. Warps with no
// partner left (I < D) compute no exps and leave their issue slots to the
// others: the schedule is a triangle, with nb rounds and barriers against
// K2's nb / 2. At W = 100, 64 registers and 1 block of 800 threads an SM
// (629 blocks, 4.8 waves). On an H100 80GB HBM3 at 700 W, in one call of
// profile_kernels.py --k3-variant: these 0.1040 ms, 16-row blocks (two an
// SM) 0.1050-0.1053, 8-row blocks (four an SM) 0.1141.

// Wide instances: multivariate detection skews (N, F) rows with F up to 256
// (CASAS's 150), so each kernel has a second instance for rows of 129 to
// 256 entries, which each entry point picks by width: a lane
// holds 8 entries of a row in the warp phases, phase 4 takes a row's first
// max over up to 64 blocks, and a block holds 16 rows in both (16 x 64
// blocks of 4 = 1,024 threads), so in K3 a warp spans two blocks of 4 of 16
// rows and its branches on I are no longer uniform. The arithmetic per row
// is the narrow instances'. The narrow instances (rows up to 128) are the
// code they were before.

// Any-width instances: rows wider than 256 (a univariate window of 300, a
// stream of more features) go to kde_argmax_xwide_kernel (K2) and
// kde_argmax_v2_xwide_kernel (K3), one block a row of up to 16 warps, each
// thread owning samples tid, tid + blockDim, ... and reading the row from
// global memory (L1-resident), so no width is too wide. A sample's density
// is its own sum: K2 over j ascending, K3 in v2's order (1, then for each
// offset r the forward term of pair (i, i - r) and the back term of pair
// (i + r, i)); each pair's exp is computed by both of its samples' threads.
// The row statistics and the first max are block sums and a block argmax in
// a fixed order; the median fallback ranks each candidate (the samples and
// the first masked entry, which sort as the plain version's fill f32 max,
// NaNs last) against the whole row, one candidate a thread, and takes the
// first in index order that holds the rank.

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxW = 128;      // widest row of the narrow instances
constexpr int kWideMaxW = 256;  // widest row of the wide instances
constexpr float kSentinel = 1e18f;
constexpr int kK2Rows = 16;  // rows per block of K2
// K3's launch: rows per block, and the blocks an SM its register budget is
// set for (K2: 4, 32 registers); profile_kernels.py --k3-variant times
// other values beside these.
constexpr int kK3Rows = 32;
constexpr int kByOffsetBlocksPerSM = 1;
// The wide instances (rows of 129 to 256, multivariate feature counts): 16
// rows a block in both, so that 64 blocks of 4 samples a row make at most
// 1,024 threads; K2's at two blocks an SM (32 registers, as the narrow
// K2's), K3's at one (64).
constexpr int kWideRows = 16;
// The any-width instances: warps a block (one block a row).
constexpr int kXwMaxWarps = 16;

// Rows a block of the instance for rows up to kW wide.
template <int kW, bool kByOffset>
__host__ __device__ constexpr int block_rows() {
  return kW > kMaxW ? kWideRows : (kByOffset ? kK3Rows : kK2Rows);
}

struct Smem {
  float4* col;          // K2: (2, R, nb) column partials; K3: (2, R,
                        // 4 nb + 1) handed terms; double-buffered
  float* vs;            // (R, 4 nb) sentinel-substituted samples
  float* best;          // (R, nb) each block's best density
  float* scale;         // (R,)
  float* cnt;           // (R,)
  int* best_i;          // (R, nb) and its sample index
  unsigned char* in;    // (R, 4 nb) mask
  unsigned char* use;   // (R,)
};

// Blocks of 4 samples a row: at least 32 / R, so that a block of R rows
// holds a full warp for the warp-wide phases.
template <int R>
__host__ __device__ inline int row_blocks(int width) {
  return max((width + 3) / 4, 32 / R);
}

// float4s of one row's handed terms in K3: 4 a block, plus one so that the
// 8 rows of a quarter warp fall on distinct banks
__host__ __device__ inline int hand_stride(int nb) { return 4 * nb + 1; }

template <int R>
__host__ __device__ inline int col_float4s(int nb, bool by_offset) {
  return 2 * R * (by_offset ? hand_stride(nb) : nb);
}

template <int R>
__host__ __device__ inline size_t smem_bytes(int nb, bool by_offset) {
  return sizeof(float4) * col_float4s<R>(nb, by_offset) +
         sizeof(float) * (R * 4 * nb + R * nb + 2 * R) +
         sizeof(int) * R * nb + R * 4 * nb + R;
}

template <int R>
__device__ inline Smem carve(unsigned char* raw, int nb, bool by_offset) {
  Smem m;
  m.col = reinterpret_cast<float4*>(raw);
  m.vs = reinterpret_cast<float*>(m.col + col_float4s<R>(nb, by_offset));
  m.best = m.vs + R * 4 * nb;
  m.scale = m.best + R * nb;
  m.cnt = m.scale + R;
  m.best_i = reinterpret_cast<int*>(m.cnt + R);
  m.in = reinterpret_cast<unsigned char*>(m.best_i + R * nb);
  m.use = m.in + R * 4 * nb;
  return m;
}

// A row's statistics as one warp computes them, lane l holding entries
// l, l+32, ..., l + 32 (kPer - 1).
template <int kPer>
struct RowStats {
  float vi[kPer];
  bool mi[kPer];
  float cnt, var, scale;
};

// Loads the lane's samples; mean, unbiased variance and the Scott scale
// -0.5 / h^2 (h^2 = var * cnt^-0.4, 1 where it is not positive) as warp
// shuffles; writes the row with masked entries set to the 1e18 sentinel
// to `vs` (the row's W floats of shared memory).
template <int kPer>
__device__ __forceinline__ RowStats<kPer> load_row(const float* v,
                                                   const unsigned char* m,
                                                   int width, int lane,
                                                   float* vs) {
  RowStats<kPer> s;
  float cnt = 0.0f, sum = 0.0f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    s.vi[q] = i < width ? v[i] : 0.0f;
    s.mi[q] = i < width && m[i] != 0;
    cnt += s.mi[q] ? 1.0f : 0.0f;
    sum += s.mi[q] ? s.vi[q] : 0.0f;
  }
  s.cnt = hypad::warp_sum(cnt);
  sum = hypad::warp_sum(sum);
  const float cnt_f = fmaxf(s.cnt, 1.0f);
  const float mean = sum / cnt_f;
  float ss = 0.0f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const float c = s.mi[q] ? s.vi[q] - mean : 0.0f;
    ss += c * c;
  }
  s.var = hypad::warp_sum(ss) / fmaxf(cnt_f - 1.0f, 1.0f);
  const float h2 = s.var * powf(cnt_f, -0.4f);
  s.scale = -0.5f / (h2 > 0.0f ? h2 : 1.0f);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    if (i < width) vs[i] = s.mi[q] ? s.vi[q] : kSentinel;
  }
  return s;
}

// The k-th order statistic (0 <= k < W) of a row held as y, entry
// lane + 32 q in y[q]: masked entries as FLT_MAX (the plain version's
// fill), entries past the row as NaN. It is an entry with fewer than k+1
// smaller and at least k+1 smaller-or-equal entries; the candidates are
// the set bits of cand (lanes of y[q]), taken in index order, and the
// counts are warp ballots. A NaN compares with nothing, so it never
// matches, and a rank that no entry matches lies among the row's NaNs,
// which sort last. Called by a whole warp; every lane gets it.
template <int kPer>
__device__ float order_stat(const float (&y)[kPer],
                            const unsigned (&cand)[kPer], int k) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    for (unsigned bits = cand[q]; bits != 0u; bits &= bits - 1u) {
      const float x = __shfl_sync(hypad::kFullMask, y[q], __ffs(bits) - 1);
      int less = 0, eq = 0;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        less += __popc(__ballot_sync(hypad::kFullMask, y[p] < x));
        eq += __popc(__ballot_sync(hypad::kFullMask, y[p] == x));
      }
      if (less <= k && k < less + eq) return x;  // warp-uniform
    }
  }
  return __int_as_float(0x7fc00000);
}

// masked_median of one row of cnt masked-in samples: ranks (cnt - 1) // 2
// and cnt // 2, wrapped mod W, averaged in f32. The candidates are the
// samples and the first masked entry (all of them are FLT_MAX). Called by
// a whole warp on the few fallback rows; kept out of line so that its
// registers do not weigh on the density rounds.
template <int kPer>
__device__ __noinline__ float row_median(const float* v,
                                         const unsigned char* in, int width,
                                         int cnt, int lane) {
  float y[kPer];
  unsigned cand[kPer];
  bool fill_found = false;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    const bool inside = i < width, sample = inside && in[i];
    y[q] = !inside ? __int_as_float(0x7fc00000) : sample ? v[i] : FLT_MAX;
    cand[q] = __ballot_sync(hypad::kFullMask, sample);
    const unsigned fills = __ballot_sync(hypad::kFullMask, inside && !sample);
    if (fills != 0u && !fill_found) {
      cand[q] |= fills & (0u - fills);  // the lowest set bit
      fill_found = true;
    }
  }
  const int k_lo = cnt > 0 ? (cnt - 1) / 2 : width - 1;
  return 0.5f * (order_stat(y, cand, k_lo) + order_stat(y, cand, cnt / 2));
}

// K2's densities of samples 4I..4I+3 of row r, summed by sample.
template <int R>
__device__ __forceinline__ void densities_by_sample(const Smem& m, int r,
                                                    int I, int nb, int wp,
                                                    float (&p)[4]) {
  const float sc = m.scale[r];
  const float4* vrow4 = reinterpret_cast<const float4*>(m.vs + r * wp);
  const float4 v4 = vrow4[I];
  const float vi[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) p[a] = 1.0f;  // the self pairs: exp(0) = 1
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      const float d = vi[a] - vi[b];
      const float e = expf(sc * (d * d));
      p[a] += e;
      p[b] += e;
    }
  const int half = nb / 2;
  for (int off = 1; off <= half; ++off) {
    const bool last_even = 2 * off == nb;  // the pairs of round nb / 2 once
    float4* slot = m.col + ((off & 1) * R + r) * nb;
    if (!(last_even && I >= half)) {
      const int J = I + off < nb ? I + off : I + off - nb;
      const float4 w4 = vrow4[J];
      const float vj[4] = {w4.x, w4.y, w4.z, w4.w};
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float d = vi[a] - vj[b];
          const float e = expf(sc * (d * d));
          p[a] += e;
          c[b] += e;
        }
      slot[J] = make_float4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
    if (!(last_even && I < half)) {
      const float4 c = slot[I];
      p[0] += c.x;
      p[1] += c.y;
      p[2] += c.z;
      p[3] += c.w;
    }
  }
}

// exp(scale * (x - y)^2), the term of one pair
__device__ __forceinline__ float pair_term(float sc, float x, float y) {
  const float d = x - y;
  return expf(sc * (d * d));
}

// The terms a K3 thread carries into the next round, in ascending offset:
// back terms of samples 0 (3) and 1 (1), forward terms of samples 2 (1) and
// 3 (3).
struct Carry {
  float b0[3], b1, f2, f3[3];
};

// One round of K3's ordered adds for samples 4I..4I+3: f[a][b] is the
// forward term of pair (4I + a, 4(I - D) + b), offset 4D + a - b, and
// gh[a] holds the back terms g[a][b] of pairs (4(I + D) + b, 4I + a),
// offset 4D + b - a. Without a left (kF) or right (kG) partner those terms
// are 0, and adding +0 to a density changes no bit, so they are skipped.
template <bool kF, bool kG>
__device__ __forceinline__ void add_round(float (&p)[4], Carry& c,
                                          const float (&f)[4][4],
                                          const float4* gh) {
  float g[4][4];
  if (kG) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 h = gh[a];
      g[a][0] = h.x;
      g[a][1] = h.y;
      g[a][2] = h.z;
      g[a][3] = h.w;
    }
  }
  // sample 0: offsets 4D-3..4D
  if (kF) p[0] = p[0] + f[0][3];
  p[0] = p[0] + c.b0[0];
  if (kF) p[0] = p[0] + f[0][2];
  p[0] = p[0] + c.b0[1];
  if (kF) p[0] = p[0] + f[0][1];
  p[0] = p[0] + c.b0[2];
  if (kF) p[0] = p[0] + f[0][0];
  if (kG) p[0] = p[0] + g[0][0];
  // sample 1: offsets 4D-2..4D+1
  if (kF) p[1] = p[1] + f[1][3];
  p[1] = p[1] + c.b1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (kF) p[1] = p[1] + f[1][2 - k];
    if (kG) p[1] = p[1] + g[1][k];
  }
  // sample 2: offsets 4D-2..4D+1
  p[2] = p[2] + c.f2;
  if (kG) p[2] = p[2] + g[2][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (kF) p[2] = p[2] + f[2][4 - k];
    if (kG) p[2] = p[2] + g[2][k];
  }
  // sample 3: offsets 4D-3..4D
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[3] = p[3] + c.f3[k];
    if (kG) p[3] = p[3] + g[3][k];
  }
  if (kF) p[3] = p[3] + f[3][3];
  if (kG) p[3] = p[3] + g[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.b0[k] = kG ? g[0][k + 1] : 0.0f;
    c.f3[k] = kF ? f[3][2 - k] : 0.0f;
  }
  c.b1 = kG ? g[1][3] : 0.0f;
  c.f2 = kF ? f[2][0] : 0.0f;
}

// K3's densities of samples 4I..4I+3 of row r, summed in v2's order: for
// each offset ascending, the forward term (pair (i, i - r)), then the back
// term (pair (i + r, i)). Terms of pairs with a sample past the row are 0.
template <int R>
__device__ __forceinline__ void densities_by_offset(const Smem& m, int r,
                                                    int I, int nb, int wp,
                                                    int width,
                                                    float (&p)[4]) {
  const float sc = m.scale[r];
  const float4* vrow4 = reinterpret_cast<const float4*>(m.vs + r * wp);
  const float4 v4 = vrow4[I];
  const float vi[4] = {v4.x, v4.y, v4.z, v4.w};
  const int inside = width - 4 * I;  // below 4 only in the last block
  // round 0, the in-block pairs e[a][b] (a > b, offset a - b); a pair whose
  // upper sample lies past the row is 0
  float e[4][4];
#pragma unroll
  for (int a = 1; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b)
      e[a][b] = a < inside ? pair_term(sc, vi[a], vi[b]) : 0.0f;
  p[0] = 1.0f;  // the self pairs: exp(0) = 1
  p[1] = (1.0f + e[1][0]) + e[2][1];
  p[2] = (1.0f + e[2][1]) + e[3][2];
  p[3] = 1.0f;
  Carry c = {{e[1][0], e[2][0], e[3][0]}, e[3][1], e[2][0],
             {e[3][2], e[3][1], e[3][0]}};

  // rounds 1..I have a left partner, rounds 1..nb-1-I a right one; the
  // round after both ends adds the last carried terms
  const int last = max(I, nb - 1 - I) + 1;
  const int stride = hand_stride(nb);
  for (int D = 1; D <= nb; ++D) {
    float4* hand = m.col + ((D & 1) * R + r) * stride;
    const bool left = D <= I, right = I + D < nb;
    float f[4][4];
    if (left) {
      const float4 w4 = vrow4[I - D];
      const float vj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) f[a][b] = pair_term(sc, vi[a], vj[b]);
      if (inside < 4) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (a >= inside)
#pragma unroll
            for (int b = 0; b < 4; ++b) f[a][b] = 0.0f;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        hand[4 * (I - D) + b] = make_float4(f[0][b], f[1][b], f[2][b],
                                            f[3][b]);
    }
    __syncthreads();
    const float4* gh = hand + 4 * I;
    if (left && right) {
      add_round<true, true>(p, c, f, gh);
    } else if (left) {
      add_round<true, false>(p, c, f, gh);
    } else if (right) {
      add_round<false, true>(p, c, f, gh);
    } else if (D == last) {
      add_round<false, false>(p, c, f, gh);
    }
  }
}

template <int kW, bool kByOffset>
__device__ __forceinline__ void kde_argmax_body(
    const float* __restrict__ vals, const unsigned char* __restrict__ mask,
    float* __restrict__ kde_val, unsigned char* __restrict__ use, int rows,
    int width) {
  constexpr int kRows = block_rows<kW, kByOffset>();
  constexpr int kPer = kW / 32;  // a row's entries a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = row_blocks<kRows>(width), wp = 4 * nb;
  const Smem m = carve<kRows>(smem_raw, nb, kByOffset);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;  // full warps; a partial one idles
  const int row0 = blockIdx.x * kRows;

  // 1. statistics and the sentinel row, one full warp per row
  for (int r = warp; warp < nwarps && r < kRows; r += nwarps) {
    const int row = row0 + r;
    float* vrow = m.vs + r * wp;
    unsigned char* irow = m.in + r * wp;
    if (row < rows) {
      const RowStats<kPer> s = load_row<kPer>(vals + (size_t)row * width,
                                  mask + (size_t)row * width, width, lane,
                                  vrow);
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        if (lane + 32 * q < width) irow[lane + 32 * q] = s.mi[q];
      if (lane == 0) {
        m.scale[r] = s.scale;
        m.cnt[r] = s.cnt;
        m.use[r] = (s.cnt > 1.0f && s.var > 0.0f) ? 1 : 0;
      }
    } else {  // past the last row: computed on sentinels, never written
      for (int i = lane; i < width; i += 32) {
        vrow[i] = kSentinel;
        irow[i] = 0;
      }
      if (lane == 0) {
        m.scale[r] = -0.5f;
        m.cnt[r] = 0.0f;
        m.use[r] = 1;
      }
    }
    for (int i = width + lane; i < wp; i += 32) {
      vrow[i] = kSentinel;
      irow[i] = 0;
    }
  }
  __syncthreads();

  // 2. densities of samples 4I..4I+3 of row r
  int r, I;
  float p[4];
  if constexpr (kByOffset) {
    I = threadIdx.x / kRows;
    r = threadIdx.x - I * kRows;
    densities_by_offset<kRows>(m, r, I, nb, wp, width, p);
  } else {
    r = threadIdx.x / nb;
    I = threadIdx.x - r * nb;
    densities_by_sample<kRows>(m, r, I, nb, wp, p);
  }

  // 3. first max over the block's samples (masked: -inf), ascending
  float best = -INFINITY;
  int best_i = 0x7fffffff;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * I + a;
    if (i >= width) continue;
    const float dens = m.in[r * wp + i] ? p[a] : -INFINITY;
    if (dens > best || best_i == 0x7fffffff) {
      best = dens;
      best_i = i;
    }
  }
  m.best[r * nb + I] = best;
  m.best_i[r * nb + I] = best_i;
  __syncthreads();

  // 4. per row, one full warp: the argmax across the blocks, or the median
  for (int rr = warp; warp < nwarps && rr < kRows; rr += nwarps) {
    const int row = row0 + rr;
    if (row >= rows) continue;  // uniform across the warp
    const float* vrow = m.vs + rr * wp;
    float out;
    if (m.use[rr]) {
      float b = -INFINITY;
      int bi = 0x7fffffff;
      if (lane < nb) {
        b = m.best[rr * nb + lane];
        bi = m.best_i[rr * nb + lane];
      }
      for (int q = lane + 32; q < nb; q += 32) {  // wide rows: nb above 32
        const float ob = m.best[rr * nb + q];
        const int oi = m.best_i[rr * nb + q];
        if (ob > b || (ob == b && oi < bi)) {
          b = ob;
          bi = oi;
        }
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        const float ob = __shfl_xor_sync(hypad::kFullMask, b, offset);
        const int oi = __shfl_xor_sync(hypad::kFullMask, bi, offset);
        if (ob > b || (ob == b && oi < bi)) {
          b = ob;
          bi = oi;
        }
      }
      out = vrow[bi];  // a masked-in sample: the sentinel never wins
    } else {
      out = row_median<kPer>(vrow, m.in + rr * wp, width, (int)m.cnt[rr],
                             lane);
    }
    if (lane == 0) {
      kde_val[row] = out;
      use[row] = m.use[rr];
    }
  }
}

__global__ void __launch_bounds__(kK2Rows * kMaxW / 4, 4)
kde_argmax_kernel(const float* __restrict__ vals,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ kde_val, unsigned char* __restrict__ use,
                  int rows, int width) {
  kde_argmax_body<kMaxW, false>(vals, mask, kde_val, use, rows, width);
}

__global__ void __launch_bounds__(kK3Rows * kMaxW / 4, kByOffsetBlocksPerSM)
kde_argmax_v2_kernel(const float* __restrict__ vals,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ kde_val,
                     unsigned char* __restrict__ use, int rows, int width) {
  kde_argmax_body<kMaxW, true>(vals, mask, kde_val, use, rows, width);
}

__global__ void __launch_bounds__(kWideRows * kWideMaxW / 4, 2)
kde_argmax_wide_kernel(const float* __restrict__ vals,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ kde_val,
                       unsigned char* __restrict__ use, int rows, int width) {
  kde_argmax_body<kWideMaxW, false>(vals, mask, kde_val, use, rows, width);
}

__global__ void __launch_bounds__(kWideRows * kWideMaxW / 4, 1)
kde_argmax_v2_wide_kernel(const float* __restrict__ vals,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ kde_val,
                          unsigned char* __restrict__ use, int rows,
                          int width) {
  kde_argmax_body<kWideMaxW, true>(vals, mask, kde_val, use, rows, width);
}

template <int kW, bool kByOffset>
int launch(const float* vals, const unsigned char* mask, float* kde_val,
           unsigned char* use, int rows, int width, void* stream) {
  if (rows < 0 || width < 1 || width > kW) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  constexpr int kRows = block_rows<kW, kByOffset>();
  const auto kernel =
      kW > kMaxW ? (kByOffset ? kde_argmax_v2_wide_kernel
                              : kde_argmax_wide_kernel)
                 : (kByOffset ? kde_argmax_v2_kernel : kde_argmax_kernel);
  const int nb = row_blocks<kRows>(width);
  const size_t smem = smem_bytes<kRows>(nb, kByOffset);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kRows - 1) / kRows;
  kernel<<<blocks, kRows * nb, smem, (cudaStream_t)stream>>>(
      vals, mask, kde_val, use, rows, width);
  return cudaGetLastError();
}

// Sum of v over the block (blockDim.x a multiple of 32, at most
// kXwMaxWarps warps), in a fixed order; every thread gets it.
__device__ float xw_block_sum(float v, float* red) {
  v = hypad::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red's previous readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
  return hypad::warp_sum(t);
}

// The first max (the smallest index among equal maxima) over the block.
__device__ int xw_block_argmax(float b, int bi, float* redf, int* redi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(hypad::kFullMask, b, offset);
    const int oi = __shfl_xor_sync(hypad::kFullMask, bi, offset);
    if (ob > b || (ob == b && oi < bi)) {
      b = ob;
      bi = oi;
    }
  }
  __syncthreads();
  if (lane == 0) {
    redf[warp] = b;
    redi[warp] = bi;
  }
  __syncthreads();
  b = -INFINITY;
  bi = 0x7fffffff;
  if (lane < (int)(blockDim.x >> 5)) {
    b = redf[lane];
    bi = redi[lane];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(hypad::kFullMask, b, offset);
    const int oi = __shfl_xor_sync(hypad::kFullMask, bi, offset);
    if (ob > b || (ob == b && oi < bi)) {
      b = ob;
      bi = oi;
    }
  }
  return bi;
}

// Entry j of the row as the densities see it: the sample, or the sentinel
// where it is masked out.
__device__ __forceinline__ float xw_sample(const float* v,
                                           const unsigned char* m, int j) {
  return m[j] ? v[j] : kSentinel;
}

// The k-th order statistic of a row ranked as masked_median sorts it
// (masked entries f32 max, NaNs last): the first candidate in index order
// with fewer than k + 1 smaller and at least k + 1 smaller-or-equal
// entries; NaN when no candidate holds the rank. Candidates: the samples
// and the masked entry `fill` (-1 for none).
__device__ float xw_order_stat(const float* v, const unsigned char* m,
                               int width, int fill, int k, int* first) {
  __syncthreads();
  if (threadIdx.x == 0) *first = 0x7fffffff;
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    if (!m[c] && c != fill) continue;
    const float x = m[c] ? v[c] : FLT_MAX;
    int less = 0, eq = 0;
    for (int j = 0; j < width; ++j) {
      const float y = m[j] ? v[j] : FLT_MAX;
      less += y < x;
      eq += y == x;
    }
    if (less <= k && k < less + eq) atomicMin(first, c);
  }
  __syncthreads();
  const int c = *first;
  if (c == 0x7fffffff) return __int_as_float(0x7fc00000);
  return m[c] ? v[c] : FLT_MAX;
}

template <bool kByOffset>
__device__ __forceinline__ void kde_argmax_xwide_body(
    const float* __restrict__ vals, const unsigned char* __restrict__ mask,
    float* __restrict__ kde_val, unsigned char* __restrict__ use, int width) {
  __shared__ float redf[kXwMaxWarps];
  __shared__ int redi[kXwMaxWarps];
  __shared__ int first;
  const size_t row = blockIdx.x;
  const float* v = vals + row * width;
  const unsigned char* m = mask + row * width;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. mean, unbiased variance, Scott scale, use flag
  float cnt = 0.0f, sum = 0.0f;
  for (int i = tid; i < width; i += nt)
    if (m[i]) {
      cnt += 1.0f;
      sum += v[i];
    }
  cnt = xw_block_sum(cnt, redf);
  sum = xw_block_sum(sum, redf);
  const float cnt_f = fmaxf(cnt, 1.0f);
  const float mean = sum / cnt_f;
  float ss = 0.0f;
  for (int i = tid; i < width; i += nt)
    if (m[i]) {
      const float c = v[i] - mean;
      ss += c * c;
    }
  const float var = xw_block_sum(ss, redf) / fmaxf(cnt_f - 1.0f, 1.0f);
  const float h2 = var * powf(cnt_f, -0.4f);
  const float sc = -0.5f / (h2 > 0.0f ? h2 : 1.0f);
  const bool use_kde = cnt > 1.0f && var > 0.0f;

  float out;
  if (use_kde) {
    // 2. each owned sample's density; 3. the first max over the row
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = tid; i < width; i += nt) {
      float dens = -INFINITY;
      if (m[i]) {
        const float vi = v[i];
        if (kByOffset) {
          dens = 1.0f;  // the self pair
          for (int r = 1; r < width; ++r) {
            if (i - r >= 0) {
              const float d = vi - xw_sample(v, m, i - r);
              dens = dens + expf(sc * (d * d));
            }
            if (i + r < width) {
              const float d = xw_sample(v, m, i + r) - vi;
              dens = dens + expf(sc * (d * d));
            }
          }
        } else {
          dens = 0.0f;
          for (int j = 0; j < width; ++j) {
            const float d = vi - xw_sample(v, m, j);
            dens += expf(sc * (d * d));
          }
        }
      }
      if (dens > best || best_i == 0x7fffffff) {
        best = dens;
        best_i = i;
      }
    }
    out = v[xw_block_argmax(best, best_i, redf, redi)];
  } else {
    // the masked median: ranks (cnt - 1) // 2 and cnt // 2 (width - 1 and
    // 0 for a row of no sample), averaged in f32
    int fill = 0x7fffffff;
    for (int i = tid; i < width; i += nt)
      if (!m[i]) {
        fill = i;
        break;
      }
    __syncthreads();
    if (tid == 0) first = 0x7fffffff;
    __syncthreads();
    if (fill != 0x7fffffff) atomicMin(&first, fill);
    __syncthreads();
    fill = first == 0x7fffffff ? -1 : first;
    const int n = (int)cnt;
    const int k_lo = n > 0 ? (n - 1) / 2 : width - 1;
    const float lo = xw_order_stat(v, m, width, fill, k_lo, &first);
    const float hi = xw_order_stat(v, m, width, fill, n / 2, &first);
    out = 0.5f * (lo + hi);
  }
  if (tid == 0) {
    kde_val[row] = out;
    use[row] = use_kde ? 1 : 0;
  }
}

__global__ void __launch_bounds__(32 * kXwMaxWarps)
kde_argmax_xwide_kernel(const float* __restrict__ vals,
                        const unsigned char* __restrict__ mask,
                        float* __restrict__ kde_val,
                        unsigned char* __restrict__ use, int width) {
  kde_argmax_xwide_body<false>(vals, mask, kde_val, use, width);
}

__global__ void __launch_bounds__(32 * kXwMaxWarps)
kde_argmax_v2_xwide_kernel(const float* __restrict__ vals,
                           const unsigned char* __restrict__ mask,
                           float* __restrict__ kde_val,
                           unsigned char* __restrict__ use, int width) {
  kde_argmax_xwide_body<true>(vals, mask, kde_val, use, width);
}

// One block a row, of as many warps as the row has 32 entries, up to
// kXwMaxWarps.
template <bool kByOffset>
int launch_xwide(const float* vals, const unsigned char* mask, float* kde_val,
                 unsigned char* use, int rows, int width, void* stream) {
  if (rows < 0 || width < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int need = (width + 31) / 32;
  const int warps = need < kXwMaxWarps ? need : kXwMaxWarps;
  const auto kernel =
      kByOffset ? kde_argmax_v2_xwide_kernel : kde_argmax_xwide_kernel;
  kernel<<<rows, 32 * warps, 0, (cudaStream_t)stream>>>(vals, mask, kde_val,
                                                        use, width);
  return cudaGetLastError();
}

}  // namespace

// vals (rows, width) f32, mask (rows, width) bool bytes -> kde_val (rows,)
// f32 (the density argmax, or the masked median where use is 0), use
// (rows,) bool bytes; contiguous, on the device. Rows up to kMaxW wide
// launch the narrow instance, rows up to kWideMaxW the wide one, wider rows
// the any-width one. Launches
// on `stream` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// shapes it does not take). K2: the densities summed by sample.
extern "C" int kde_argmax_forward(const float* vals, const unsigned char* mask,
                                  float* kde_val, unsigned char* use, int rows,
                                  int width, void* stream) {
  if (width > kWideMaxW)
    return launch_xwide<false>(vals, mask, kde_val, use, rows, width, stream);
  return width > kMaxW ? launch<kWideMaxW, false>(vals, mask, kde_val, use,
                                                  rows, width, stream)
                       : launch<kMaxW, false>(vals, mask, kde_val, use, rows,
                                              width, stream);
}

// The same with K3: the densities summed by offset, in v2's order.
extern "C" int kde_argmax_v2_forward(const float* vals,
                                     const unsigned char* mask,
                                     float* kde_val, unsigned char* use,
                                     int rows, int width, void* stream) {
  if (width > kWideMaxW)
    return launch_xwide<true>(vals, mask, kde_val, use, rows, width, stream);
  return width > kMaxW ? launch<kWideMaxW, true>(vals, mask, kde_val, use,
                                                 rows, width, stream)
                       : launch<kMaxW, true>(vals, mask, kde_val, use, rows,
                                             width, stream);
}
