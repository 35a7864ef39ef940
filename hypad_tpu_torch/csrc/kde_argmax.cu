// Batched Gaussian-KDE argmax over the critic's anti-diagonal rows, with the
// masked-median fallback, on Hopper.
//
// Replaces: hypad_tpu/ops/kde_pallas.py:42 `_kernel` (v1; launched by
// `_pallas_kde`, public entry `kde_argmax_rows_pallas`), together with the
// fallback that `_kde_argmax_rows_pallas_impl` (:230-235) takes outside the
// kernel. Per row of the (T, W) anti-diagonal matrix, over its masked-in
// samples:
//   mean; unbiased variance; Scott bandwidth h^2 = var * n^-0.4;
//   dens_i = sum_j exp(scale * (v_i - v_j)^2), scale = -0.5 / h^2
//   (masked entries become a 1e18 sentinel, so any pair touching one adds
//   exactly 0); use = cnt > 1 and var > 0; the value is the first-max
//   density argmax where use holds, else the masked median (np.median
//   semantics, 0.5 * (lo + hi) in f32, as `masked_median` computes it).
//
// What bounds it on the H100: instruction issue. At the detector's shape
// (T = 20,099, W = 100) the rows are 10 MB (3 us at 3.35 TB/s) and need 2.0e8
// ordered pairs. Accurate `expf` is about 8 instructions (one of them on the
// special-function unit), so each pair costs about 11 issue slots when
// summed per ordered pair.
//
// Design:
// - Each unordered pair's exp is computed once and added to both samples'
//   densities: (v_i - v_j)^2 equals (v_j - v_i)^2 bit for bit, so each
//   term is the plain version's; only the order of the sums differs. `expf`
//   stays at full accuracy (`__expf` would move densities by ~1e-6
//   relative, far above the last-ulp ties the tie-level check allows).
// - A row's samples form nb = max(ceil(W / 4), 2) blocks of 4 (padding
//   holds the sentinel). One thread owns one block of one row: its 4
//   densities stay in registers. A thread block of 16 rows has 16 * nb
//   threads, so at least one full warp (400 at W = 100: 12 full warps and a
//   half one, which sits out the warp-wide phases). At most 32 registers a
//   thread; at W = 100 a block takes 13 warps' slots, so 4 share an SM
//   (1,257 blocks: 2.4 waves over 132 SMs). On the H100, 32-row blocks at
//   39 registers took 0.081 ms and at 32 registers 0.073 ms, as this layout
//   did with a lane-per-candidate median; two offsets a barrier round took
//   0.075.
// - The block pairs follow a round-robin: in round r (1 <= r <= nb / 2)
//   block I pairs with block I + r (mod nb), 16 exps, adding the row
//   partials to its own registers and handing the 4 column partials to block
//   I + r's thread through shared memory (two buffers, one barrier a round;
//   the receiver adds them in round order, so the sums are deterministic).
//   With nb even, round nb / 2 is taken by the lower half only. Each of a
//   thread's samples is read once from shared memory per round.
// - Mean, variance, the Scott scale and the use flag come from
//   kde_row.cuh, as in K3, so the use flags stay those of the plain
//   version. The argmax keeps the smallest index among equal maxima.
// - Rows flagged use = 0 (a single sample, zero variance, or a NaN) take
//   the masked median in the same launch: one warp selects the two middle
//   order statistics by counting ranks over the row with ballots (no
//   sort). The row is ranked as the plain version sorts it: masked entries
//   filled with the f32 maximum, NaNs last. A fallback row's warp ends its
//   block, and a block in the last wave ends the launch: counting each
//   candidate's rank in one lane over the whole row took 0.105 ms, the
//   ballots 0.069.

#include <float.h>

#include "kde_row.cuh"

namespace {

constexpr int kMaxW = hypad::kKdeMaxW;
constexpr int kPerLane = hypad::kKdePerLane;  // a row's entries a lane
constexpr int kRows = 16;  // rows per block
constexpr float kSentinel = hypad::kKdeSentinel;

struct Smem {
  float4* col;          // (2, kRows, nb) column partials, double-buffered
  float* vs;            // (kRows, 4 nb) sentinel-substituted samples
  float* best;          // (kRows, nb) each block's best density
  float* scale;         // (kRows,)
  float* cnt;           // (kRows,)
  int* best_i;          // (kRows, nb) and its sample index
  unsigned char* in;    // (kRows, 4 nb) mask
  unsigned char* use;   // (kRows,)
};

// Blocks of 4 samples a row: at least 2, so that a block of kRows rows
// holds a full warp for the warp-wide phases.
__host__ __device__ inline int row_blocks(int width) {
  return width > 8 ? (width + 3) / 4 : 2;
}

__host__ __device__ inline size_t smem_bytes(int nb) {
  return sizeof(float4) * 2 * kRows * nb +
         sizeof(float) * (kRows * 4 * nb + kRows * nb + 2 * kRows) +
         sizeof(int) * kRows * nb + kRows * 4 * nb + kRows;
}

__device__ inline Smem carve(unsigned char* raw, int nb) {
  Smem m;
  m.col = reinterpret_cast<float4*>(raw);
  m.vs = reinterpret_cast<float*>(m.col + 2 * kRows * nb);
  m.best = m.vs + kRows * 4 * nb;
  m.scale = m.best + kRows * nb;
  m.cnt = m.scale + kRows;
  m.best_i = reinterpret_cast<int*>(m.cnt + kRows);
  m.in = reinterpret_cast<unsigned char*>(m.best_i + kRows * nb);
  m.use = m.in + kRows * 4 * nb;
  return m;
}

// The k-th order statistic (0 <= k < W) of a row held as y, entry
// lane + 32 q in y[q]: masked entries as FLT_MAX (the plain version's
// fill), entries past the row as NaN. It is an entry with fewer than k+1
// smaller and at least k+1 smaller-or-equal entries; the candidates are
// the set bits of cand (lanes of y[q]), taken in index order, and the
// counts are warp ballots. A NaN compares with nothing, so it never
// matches, and a rank that no entry matches lies among the row's NaNs,
// which sort last. Called by a whole warp; every lane gets it.
__device__ float order_stat(const float (&y)[kPerLane],
                            const unsigned (&cand)[kPerLane], int k) {
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    for (unsigned bits = cand[q]; bits != 0u; bits &= bits - 1u) {
      const float x = __shfl_sync(hypad::kFullMask, y[q], __ffs(bits) - 1);
      int less = 0, eq = 0;
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
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
__device__ __noinline__ float row_median(const float* v,
                                         const unsigned char* in, int width,
                                         int cnt, int lane) {
  float y[kPerLane];
  unsigned cand[kPerLane];
  bool fill_found = false;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
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

__global__ void __launch_bounds__(kRows * kMaxW / 4, 4)
kde_argmax_kernel(const float* __restrict__ vals,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ kde_val, unsigned char* __restrict__ use,
                  int rows, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = row_blocks(width), wp = 4 * nb;
  const Smem m = carve(smem_raw, nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;  // full warps; a partial one idles
  const int row0 = blockIdx.x * kRows;

  // 1. statistics and the sentinel row, one full warp per row
  for (int r = warp; warp < nwarps && r < kRows; r += nwarps) {
    const int row = row0 + r;
    float* vrow = m.vs + r * wp;
    unsigned char* irow = m.in + r * wp;
    if (row < rows) {
      const hypad::KdeRow s = hypad::kde_load_row(
          vals + (size_t)row * width, mask + (size_t)row * width, width, lane,
          vrow);
#pragma unroll
      for (int q = 0; q < hypad::kKdePerLane; ++q)
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

  // 2. densities: thread (r, I) owns samples 4I..4I+3 of row r
  const int r = threadIdx.x / nb, I = threadIdx.x - r * nb;
  const float sc = m.scale[r];
  const float4* vrow4 = reinterpret_cast<const float4*>(m.vs + r * wp);
  const float4 v4 = vrow4[I];
  const float vi[4] = {v4.x, v4.y, v4.z, v4.w};
  float p[4] = {1.0f, 1.0f, 1.0f, 1.0f};  // the self pairs: exp(0) = 1
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
    float4* slot = m.col + ((off & 1) * kRows + r) * nb;
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
      out = row_median(vrow, m.in + rr * wp, width, (int)m.cnt[rr], lane);
    }
    if (lane == 0) {
      kde_val[row] = out;
      use[row] = m.use[rr];
    }
  }
}

}  // namespace

// vals (rows, width) f32, mask (rows, width) bool bytes -> kde_val (rows,)
// f32 (the density argmax, or the masked median where use is 0), use
// (rows,) bool bytes; contiguous, on the device. Launches on `stream` and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take).
extern "C" int kde_argmax_forward(const float* vals, const unsigned char* mask,
                                  float* kde_val, unsigned char* use, int rows,
                                  int width, void* stream) {
  if (rows < 0 || width < 1 || width > kMaxW) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int nb = row_blocks(width);
  const size_t smem = smem_bytes(nb);
  cudaError_t err = cudaFuncSetAttribute(
      kde_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kRows - 1) / kRows;
  kde_argmax_kernel<<<blocks, kRows * nb, smem, (cudaStream_t)stream>>>(
      vals, mask, kde_val, use, rows, width);
  return cudaGetLastError();
}
