// The WGAN-GP critic step on Hopper (sm_90a): K4 and K5.
//
// Replaces: hypad_tpu/train/critic_kernel.py:156 `_kernel` (K4, public
// entry `critics_fused_grads`) and hypad_tpu/train/critic_kernel.py:350
// `_kernel_full` (K5, public entry `critic_step_fused_full`).
//
// K4 takes the stacked rows of both critics,
//   bigx (3B, W) = [x, x_fake, interp_x],  bigz (3B, L) = [z_enc, z, interp_z],
// and the dropout keep-masks mx (4, 3B, Hx), mz (2, 3B, Hz), and computes for
// each critic its WGAN-GP loss and the loss's gradient with respect to every
// critic parameter, first and second order, in closed form. The critics are
// piecewise linear (leaky ReLU 0.2 and inverted dropout between Linear
// layers), so with the masks fixed (D_i = keep_i / (1 - p) * leaky'(a_i)):
//   forward   h_i = Drop_i(leaky(h_{i-1} W_i^T + b_i)), out = h_L Wo^T + bo
//   wl        = sum_r c_r out_r, c = sign/B * (-1 on rows [0,B), +1 on
//               [B,2B), 0 on the interpolates); sign +1 critic_x, -1 critic_z
//   GP input  g = d(sum out[2B:])/d interp = ((Wo o D_L) W_L ...) W_1
//   loss      = wl + 10 (gn - 1)^2, gn = sqrt(sum g^2 + 1e-12), ONE norm
//               over the whole (B, .) batch
//   wl grads  e_i = (e_{i+1} W_{i+1}) o D_i, gW_i = e_i^T h_{i-1}, gb_i = sum e_i
//   GP grads  gW_i += w_i^T u_{i-1}, u_i = D_i o (u_{i-1} W_i^T) on the
//               interpolate rows, u_0 = 20 (gn - 1) / gn * g, w_i the GP
//               backward chain's v o D_i; gWo += sum_r u_L; biases get none.
// K5 first runs the critic step's gradient-free generator forwards and forms
// bigx and bigz itself: the decoder on z_x (dense1, two bidirectional LSTM
// cells at T = 1 with the inter-layer keep-mask, dense2, tanh, and the
// MobiusLinear head with K1's clamp table when hyperbolic), and the encoder
// on x (bidirectional LSTM cell at T = 1, dense). At T = 1 with zero state
// the recurrent product and the forget gate drop out: h = s(o) tanh(s(i)
// tanh(g)), gates = x W_ih^T + b_ih + b_hh, gate order i, f, g, o.
//
// Bound on the H100: at B = 64 K4 moves about 0.15 MB and does about 5.5
// MFLOP, K5 about 0.77 MB and 22 MFLOP (chip_smoke.py's count), which is
// under a microsecond either way. What limits the kernel is the chain
// itself: each thread's serial run of dependent FMA and L2-load iterations
// through some 40 phases (layers, reductions over the batch).
//
// Design: two clusters of kClusterBlocks blocks, one per side, and no
// grid-wide sync. critic_x needs only x, a_x and the decoder forward;
// critic_z needs only z_z, a_z and the encoder forward. So cluster 0 runs
// the decoder and then critic_x, cluster 1 the encoder and then critic_z.
// Rank q of a cluster owns batch rows [q P, q P + P), P = ceil(B / 8), and
// in every stacked (3B, .) array the same rows of each third (b, B + b,
// 2B + b), so every row-local phase reads only rows its own block wrote:
// the generator layers, the bigx / bigz assembly, the critic forward and
// its diagonals, the GP v-chain (the interpolate rows 2B + b), the e-chain
// and the u-chain. Those phases need no barrier beyond __syncthreads(), and
// each output is computed by one thread with the same loop as in a single
// block, so they give the same bits at any cluster size.
//
// Sums over rows are split: each rank reduces its own rows in ascending
// order into a partial in the global workspace (the scalars wl and sum g^2
// by a block tree, each gradient entry by one thread), and after a
// cluster.sync() the owner of each output adds the partials in rank order
// 0..7, starting from rank 0's (no added zero). A GP-path weight gradient is
// still (sum of the wl-path partials) + (sum of the GP-path partials). There
// are two cluster barriers a side: one after the scalar partials (every rank
// needs wl for the loss and gn for the u-chain's coefficient), placed after
// the wl-path gradient partials that do not need them; one before the
// owners' sums. No float atomics: two launches give the same bits. At a
// cluster size of 1 this is the single-block arithmetic exactly.
//
// Memory ordering: cluster.sync() is barrier.cluster.arrive.release plus
// wait.acquire at cluster scope, which orders the blocks' global writes
// before the other blocks' reads. The partials, which are the only data one
// block reads from another, are read with __ldcg (L2, past L1); nothing
// the kernel writes is read through __ldg or a const __restrict__ pointer.
//
// Weights are read from global memory, where they stay L2-resident (the
// generator weights are about 640 KB f32 at the published widths, beyond
// the 227 KB of shared memory a block may have). Activations, backward
// diagonals, chains and partials live in a global workspace that the
// wrapper allocates (critic_step_workspace_floats). Shared memory holds the
// 33 KB tile of layer input rows and the 68-byte reduction scratch, under
// the 48 KB a block gets without an opt-in. Arithmetic is f32 FMA in
// ascending index order, no TF32 and no tensor cores.
//
// Measured at B = 64 on an NVIDIA H100 80GB HBM3 at 700 W
// (hypad_tpu_torch/profile_critic_step.py: CUDA events over 200 launches,
// the variants in turns): K5 0.109 ms and K4 0.052 ms a launch, against
// 0.414 and 0.174 ms for the former layout of one block a side. This code
// at a cluster size of 1 gives that layout's bits and takes 0.464 and
// 0.218 ms; at 16 blocks a side, a non-portable cluster, 0.097 and 0.048
// ms. Halving the rows a block owns again gains 11%, so what is left is
// mostly each output's serial dot product, a chain of up to 128 FMAs on
// weights read from L2, which no row split shortens. K5 - K4, about the
// decoder's forwards, is 0.057 ms. Not yet done: the weights in shared or
// distributed shared memory, then wgmma.

// Wide instance: multivariate feature counts above 128 (CASAS's 150, up to
// 256) make bigx, the encoder's input, the decoder's output and the
// MobiusLinear head that wide. Every function that stages input rows or
// holds a head row is a template on the widest input it takes, kIn, and the
// kernel has two instances, chosen at launch by the launch's widest input:
// kIn = 128 with 64-row tiles (the code and registers it had before), and
// kIn = 256 with 32-row tiles, whose 32.9 KB tile stays in static shared
// memory. Each output is still one thread's ascending-k FMA chain, so the
// tile height changes no bit.
//
// Any-width instance (kIn = kAnyIn): above 256 (a window of 300, or a
// stream of more features) the tile grows with the width, so this instance
// stages its rows in dynamic shared memory, as many rows at a time as the
// launch gave it room for (up to 32, at least one: 32 x 301 floats, 38.5
// KB, at 300; one row of up to 58,000 floats), and the Mobius head's clamp
// chain reads its row again for each pass instead of holding it in
// registers. The launch shape (two clusters of 8 blocks of 512 threads) and
// every sum's order are the other instances', so it computes the same bits
// they would.

// Signal axis (the fleet's counterpart of jax.vmap): the grid's y is the
// signal. Every slot carries a byte stride from one signal's slice to the
// next (weights, draws, gradients, losses (S, 2) and the workspace alike),
// and a block offsets each slot it reads or writes by blockIdx.y times that
// stride. A signal's two clusters run the single-signal launch's code on
// its own slices, so each signal gets the bits of its own launch; a cluster
// never spans two signals (clusters are (8, 1, 1)).

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;  // blocks a side, the portable maximum
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// The narrow instance takes layer inputs and a MobiusLinear head up to
// kMaxIn wide (4 lanes a thread in the head); the wide one, for multivariate
// feature counts, up to kWideMaxIn, staging fewer rows at a time so that its
// tile of 32 x 257 floats (32.9 KB) stays under the 48 KB of static shared
// memory.
constexpr int kMaxIn = 128;
constexpr int kTileRows = 64;  // input rows staged at a time
constexpr int kWideMaxIn = 256;
constexpr int kWideTileRows = 32;
constexpr int kAnyIn = 0;  // the any-width instance: a dynamic tile
constexpr int kSmemLimit = 227 * 1024;  // shared memory a block may have

template <int kIn>
__host__ __device__ constexpr int tile_rows() {
  return kIn > kMaxIn ? kWideTileRows : kTileRows;
}
constexpr float kLeaky = 0.2f;
constexpr float kGpWeight = 10.0f;
constexpr float kGpEps = 1e-12f;
constexpr float kNormFloor = 1e-15f;
constexpr float kTanhClamp = 15.0f;
constexpr float kMaxNorm = (float)(1.0 - 4e-3);  // project, f32 eps
constexpr float kCxKeep = (float)(1.0 - 0.25);   // CriticX dropout
constexpr float kCzKeep = (float)(1.0 - 0.2);    // CriticZ dropout
constexpr float kDecKeep = (float)(1.0 - 0.2);   // decoder LSTM dropout

// Slots of the pointer array; the SLOT_* constants of
// hypad_tpu_torch/train/critic_kernel.py name the same positions.
enum Slot {
  X, ZX, AX, ZZ, AZ, MDEC, MCX, MCZ, BIGX, BIGZ,
  ENC = 10,   // lstm.0 w_ih, b_ih, b_hh, w_ih_rev, b_ih_rev, b_hh_rev, dense w, b
  DEC = 18,   // dense1 w, b, lstm.0 (6), lstm.1 (6), dense2 w, b, mw, mb
  CX = 36,    // critic_x dense1..dense5 (w, b)
  CZ = 46,    // critic_z dense1..dense3 (w, b)
  LOSS = 52,  // (2,) lx, lz
  GCX = 53,   // gradients, laid out as CX
  GCZ = 63,   // gradients, laid out as CZ
  WS = 69,
  kSlots = 70
};
enum Dim { DB, DW, DL, DHX, DHZ, DHE, DD1, DHD, kDims };

struct Args {
  void* p[kSlots];
  long long stride[kSlots];  // bytes from one signal's slice to the next
  int B, W, L, Hx, Hz, He, D1, Hd;
  int full, hyperbolic;
};

struct Lstm {
  const float *w, *bi, *bh;  // one direction: w_ih (4H, in), b_ih, b_hh
};

// The rows one block of a cluster owns: rows [b0, b0 + nb) of a (B, .)
// array when segs is 1; those rows of each third of a (3B, .) array when
// segs is 3.
struct Rows {
  int b0, nb, B, segs;
  __device__ int count() const { return segs * nb; }
  // The t-th owned row, ascending, for t < count().
  __device__ int at(int t) const {
    const int s = t / nb;
    return s * B + b0 + (t - s * nb);
  }
};

__device__ Rows rank_rows(int B, int rank, int segs) {
  const int per = (B + kClusterBlocks - 1) / kClusterBlocks;
  const int b0 = min(rank * per, B);
  return Rows{b0, min(per, B - b0), B, segs};
}

// f(r) for every owned row r, ascending.
template <typename F>
__device__ __forceinline__ void each_row(const Rows& rows, F f) {
  for (int s = 0; s < rows.segs; ++s) {
    const int r0 = s * rows.B + rows.b0;
    for (int r = r0; r < r0 + rows.nb; ++r) f(r);
  }
}

// Floats of one critic's parameters (and gradient): (w, b) of `L` hidden
// layers of width H on an `in`-wide input, then the scalar output layer.
__host__ __device__ int critic_params(int in, int H, int L) {
  return H * in + H + (L - 1) * (H * H + H) + H + 1;
}
__host__ __device__ size_t critic_ws(int R, int B, int in, int H, int L) {
  const int wide = in > H ? in : H;
  return (size_t)2 * L * R * H + R + (size_t)L * B * H + (size_t)2 * B * wide +
         (size_t)2 * R * H +
         (size_t)2 * kClusterBlocks * (critic_params(in, H, L) + 1);
}
__host__ __device__ size_t decoder_ws(const Args& a) {
  return (size_t)a.B * a.D1 + (size_t)4 * a.B * a.Hd + (size_t)2 * a.B * a.W;
}
__host__ __device__ size_t encoder_ws(const Args& a) {
  return (size_t)2 * a.B * a.He;
}
// Workspace layout: [critic_x][decoder][critic_z][encoder].
__host__ __device__ size_t side_x_ws(const Args& a) {
  return critic_ws(3 * a.B, a.B, a.W, a.Hx, 4) + decoder_ws(a);
}
__host__ __device__ size_t total_ws(const Args& a) {
  return side_x_ws(a) + critic_ws(3 * a.B, a.B, a.L, a.Hz, 2) + encoder_ws(a);
}

// Slot s of this block's signal (blockIdx.y).
__device__ __forceinline__ void* slot(const Args& a, int s) {
  return static_cast<char*>(a.p[s]) + (long long)blockIdx.y * a.stride[s];
}
__device__ __forceinline__ const float* in_ptr(const Args& a, int s) {
  return static_cast<const float*>(slot(a, s));
}
__device__ __forceinline__ float* out_ptr(const Args& a, int s) {
  return static_cast<float*>(slot(a, s));
}

// Sum of v over the block, the same bits on every thread and every launch.
__device__ float block_sum(float v, float* red) {
  v = hypad::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.0f;
    t = hypad::warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  return red[kWarps];
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The layers with a weight matrix of the generator, and the critics' forward
// and u-chain products, stage up to kTileRows input rows at a time in
// shared memory (row stride din | 1, odd, so the 32 rows a warp reads fall in
// 32 banks) and give each thread one (row, output) pair, rows fastest: the
// lanes of a warp share one weight row, so each weight load is a broadcast,
// and each thread sums its input row in ascending order. (A thread per
// output with the output index fastest read 32 weight rows a load, 32
// sectors each: K5 took 2.61 ms a launch at B = 64 on an H100 80GB HBM3 at
// 700 W; a warp per output with a shuffle sum, 1.62 ms.)

// Bytes of dynamic shared memory this launch has (the any-width tile).
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned bytes;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
  return bytes;
}

// Stage the owned rows of in (., din) into `tile`, up to kTileRows at a
// time (the any-width instance: as many as its dynamic tile holds, at most
// kWideTileRows), and run body(t0, n, ld, src) on each stage: row r of src
// (= tile, stride ld) holds owned row rows.at(t0 + r).
template <int kIn, typename Body>
__device__ void for_row_tiles(const float* in, const Rows& rows, int din,
                              float* tile, Body body) {
  const int ld = din | 1;
  int at_a_time = tile_rows<kIn>();
  if constexpr (kIn == kAnyIn)
    at_a_time = min(kWideTileRows, (int)(dynamic_smem_bytes() / (4u * ld)));
  for (int t0 = 0; t0 < rows.count(); t0 += at_a_time) {
    const int n = min(rows.count() - t0, at_a_time);
    __syncthreads();  // the previous stage's readers are done
    for (int idx = threadIdx.x; idx < n * din; idx += blockDim.x) {
      const int r = idx / din, k = idx - r * din;
      tile[r * ld + k] = in[(size_t)rows.at(t0 + r) * din + k];
    }
    __syncthreads();
    body(t0, n, ld, static_cast<const float*>(tile));
  }
}

// out (rows, dout) = in (rows, din) W^T (+ b), tanh'd when `act_tanh`.
template <int kIn>
__device__ void linear(const float* in, const Rows& rows, int din,
                       const float* W, const float* b, float* out, int dout,
                       bool act_tanh, float* tile) {
  for_row_tiles<kIn>(in, rows, din, tile,
                     [&](int t0, int n, int ld, const float* src) {
    for (int idx = threadIdx.x; idx < n * dout; idx += blockDim.x) {
      const int j = idx / n, r = idx - j * n;
      const float* x = src + r * ld;
      const float* w = W + (size_t)j * din;
      float acc = 0.0f;
      for (int k = 0; k < din; ++k) acc = fmaf(x[k], w[k], acc);
      if (b) acc = acc + b[j];
      out[(size_t)rows.at(t0 + r) * dout + j] = act_tanh ? tanhf(acc) : acc;
    }
  });
}

// One bidirectional LSTM layer at T = 1 with zero state: out (rows, 2H),
// [forward, reverse] on the feature axis; inverted dropout when `keep`.
template <int kIn>
__device__ void bilstm_t1(const float* in, const Rows& rows, int din, Lstm fw,
                          Lstm bw, int H, const uint8_t* keep, float kscale,
                          float* out, float* tile) {
  const int width = 2 * H;
  for_row_tiles<kIn>(in, rows, din, tile,
                     [&](int t0, int n, int ld, const float* src) {
    for (int idx = threadIdx.x; idx < n * width; idx += blockDim.x) {
      const int c = idx / n, r = idx - c * n;
      const bool rev = c >= H;
      const int j = rev ? c - H : c;
      const Lstm d = rev ? bw : fw;
      const float* x = src + r * ld;
      const float* wi = d.w + (size_t)j * din;
      const float* wg = d.w + (size_t)(2 * H + j) * din;
      const float* wo = d.w + (size_t)(3 * H + j) * din;
      float gi = 0.0f, gg = 0.0f, go = 0.0f;
      for (int k = 0; k < din; ++k) {
        const float xk = x[k];
        gi = fmaf(xk, wi[k], gi);
        gg = fmaf(xk, wg[k], gg);
        go = fmaf(xk, wo[k], go);
      }
      gi = gi + d.bi[j] + d.bh[j];
      gg = gg + d.bi[2 * H + j] + d.bh[2 * H + j];
      go = go + d.bi[3 * H + j] + d.bh[3 * H + j];
      const size_t o = (size_t)rows.at(t0 + r) * width + c;
      float h = sigmoid(go) * tanhf(sigmoid(gi) * tanhf(gg));
      if (keep) h = keep[o] ? h / kscale : 0.0f;
      out[o] = h;
    }
  });
}

// mobius_rows for any W: lane l takes entries l, l + 32, ... of a row, in
// the order the register form holds them, and reads the row from `u` again
// for each pass instead of keeping it in registers.
__device__ void mobius_rows_any(const float* u, const Rows& rows, int W,
                                const float* mb, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float b2 = 0.0f;
  for (int j = lane; j < W; j += 32) b2 += mb[j] * mb[j];
  b2 = hypad::warp_sum(b2);
  for (int i = warp; i < rows.count(); i += kWarps) {
    const int r = rows.at(i);
    const float* ur = u + (size_t)r * W;
    float sq = 0.0f;
    for (int j = lane; j < W; j += 32) sq += ur[j] * ur[j];
    const float un = fmaxf(sqrtf(hypad::warp_sum(sq)), kNormFloor);
    const float t = tanhf(fminf(fmaxf(un, -kTanhClamp), kTanhClamp));
    float x2 = 0.0f, xy = 0.0f;
    for (int j = lane; j < W; j += 32) {
      const float e = t * (ur[j] / un);
      x2 += e * e;
      xy += e * mb[j];
    }
    x2 = hypad::warp_sum(x2);
    xy = hypad::warp_sum(xy);
    const float ce = 1.0f + 2.0f * xy + b2;
    const float cb = 1.0f - x2;
    const float den = fmaxf(1.0f + 2.0f * xy + x2 * b2, kNormFloor);
    float s2 = 0.0f;
    for (int j = lane; j < W; j += 32) {
      const float e = (ce * (t * (ur[j] / un)) + cb * mb[j]) / den;
      s2 += e * e;
    }
    const float sn = fmaxf(sqrtf(hypad::warp_sum(s2)), kNormFloor);
    float* orow = out + (size_t)r * W;
    for (int j = lane; j < W; j += 32) {
      const float e = (ce * (t * (ur[j] / un)) + cb * mb[j]) / den;
      orow[j] = sn > kMaxNorm ? e / sn * kMaxNorm : e;
    }
  }
}

// MobiusLinear's clamp chain on u = x W^T (rows, W), one warp a row:
// expmap0, mobius_add(b) at k = -1, project; as K1 (csrc/mobius_linear.cu).
template <int kIn>
__device__ void mobius_rows(const float* u, const Rows& rows, int W,
                            const float* mb, float* out) {
  if constexpr (kIn == kAnyIn) {
    mobius_rows_any(u, rows, W, mb, out);
    return;
  }
  constexpr int kPer = kIn == kAnyIn ? 1 : kIn / 32;  // never 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float bj[kPer];
  float b2 = 0.0f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = lane + 32 * q;
    bj[q] = j < W ? mb[j] : 0.0f;
    b2 += bj[q] * bj[q];
  }
  b2 = hypad::warp_sum(b2);
  for (int i = warp; i < rows.count(); i += kWarps) {
    const int r = rows.at(i);
    const float* ur = u + (size_t)r * W;
    float e[kPer];
    float sq = 0.0f;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = lane + 32 * q;
      e[q] = j < W ? ur[j] : 0.0f;
      sq += e[q] * e[q];
    }
    const float un = fmaxf(sqrtf(hypad::warp_sum(sq)), kNormFloor);
    const float t = tanhf(fminf(fmaxf(un, -kTanhClamp), kTanhClamp));
    float x2 = 0.0f, xy = 0.0f;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      e[q] = t * (e[q] / un);
      x2 += e[q] * e[q];
      xy += e[q] * bj[q];
    }
    x2 = hypad::warp_sum(x2);
    xy = hypad::warp_sum(xy);
    const float ce = 1.0f + 2.0f * xy + b2;
    const float cb = 1.0f - x2;
    const float den = fmaxf(1.0f + 2.0f * xy + x2 * b2, kNormFloor);
    float s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      e[q] = (ce * e[q] + cb * bj[q]) / den;
      s2 += e[q] * e[q];
    }
    const float sn = fmaxf(sqrtf(hypad::warp_sum(s2)), kNormFloor);
    float* orow = out + (size_t)r * W;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = lane + 32 * q;
      if (j < W) orow[j] = sn > kMaxNorm ? e[q] / sn * kMaxNorm : e[q];
    }
  }
}

// Cluster 0 of K5: the decoder on the block's rows of z_x, then those rows
// of bigx = [x, x_fake, interp_x].
template <int kIn>
__device__ void decoder_side(const Args& a, const Rows& rows, float* ws,
                             float* bigx, float* tile) {
  const int B = a.B, W = a.W, Hd = a.Hd;
  float* d1 = ws;
  float* h1 = d1 + (size_t)B * a.D1;
  float* h2 = h1 + (size_t)2 * B * Hd;
  float* xdec = h2 + (size_t)2 * B * Hd;
  float* u = xdec + (size_t)B * W;
  float* xfake = bigx + (size_t)B * W;
  const Lstm l0f{in_ptr(a, DEC + 2), in_ptr(a, DEC + 3), in_ptr(a, DEC + 4)};
  const Lstm l0b{in_ptr(a, DEC + 5), in_ptr(a, DEC + 6), in_ptr(a, DEC + 7)};
  const Lstm l1f{in_ptr(a, DEC + 8), in_ptr(a, DEC + 9), in_ptr(a, DEC + 10)};
  const Lstm l1b{in_ptr(a, DEC + 11), in_ptr(a, DEC + 12),
                 in_ptr(a, DEC + 13)};

  linear<kIn>(in_ptr(a, ZX), rows, a.L, in_ptr(a, DEC), in_ptr(a, DEC + 1), d1,
         a.D1, false, tile);
  __syncthreads();
  bilstm_t1<kIn>(d1, rows, a.D1, l0f, l0b, Hd,
            static_cast<const uint8_t*>(slot(a, MDEC)), kDecKeep, h1, tile);
  __syncthreads();
  bilstm_t1<kIn>(h1, rows, 2 * Hd, l1f, l1b, Hd, nullptr, 1.0f, h2, tile);
  __syncthreads();
  linear<kIn>(h2, rows, 2 * Hd, in_ptr(a, DEC + 14), in_ptr(a, DEC + 15),
         a.hyperbolic ? xdec : xfake, W, true, tile);
  __syncthreads();
  if (a.hyperbolic) {
    linear<kIn>(xdec, rows, W, in_ptr(a, DEC + 16), nullptr, u, W, false, tile);
    __syncthreads();
    mobius_rows<kIn>(u, rows, W, in_ptr(a, DEC + 17), xfake);
    __syncthreads();
  }
  const float* x = in_ptr(a, X);
  const float* ax = in_ptr(a, AX);
  for (int idx = threadIdx.x; idx < rows.nb * W; idx += blockDim.x) {
    const size_t o = (size_t)rows.b0 * W + idx;
    const float xv = x[o], al = ax[o];
    bigx[o] = xv;
    bigx[(size_t)2 * B * W + o] = al * xv + (1.0f - al) * xfake[o];
  }
  __syncthreads();
}

// Cluster 1 of K5: the encoder on the block's rows of x, then those rows of
// bigz = [z_enc, z_z, interp_z].
template <int kIn>
__device__ void encoder_side(const Args& a, const Rows& rows, float* ws,
                             float* bigz, float* tile) {
  const int B = a.B, L = a.L;
  const Lstm f{in_ptr(a, ENC), in_ptr(a, ENC + 1), in_ptr(a, ENC + 2)};
  const Lstm b{in_ptr(a, ENC + 3), in_ptr(a, ENC + 4), in_ptr(a, ENC + 5)};
  bilstm_t1<kIn>(in_ptr(a, X), rows, a.W, f, b, a.He, nullptr, 1.0f, ws, tile);
  __syncthreads();
  linear<kIn>(ws, rows, 2 * a.He, in_ptr(a, ENC + 6), in_ptr(a, ENC + 7), bigz, L,
         false, tile);
  __syncthreads();
  const float* zz = in_ptr(a, ZZ);
  const float* az = in_ptr(a, AZ);
  for (int idx = threadIdx.x; idx < rows.nb * L; idx += blockDim.x) {
    const size_t o = (size_t)rows.b0 * L + idx;
    const float z = zz[o], al = az[o];
    bigz[(size_t)B * L + o] = z;
    bigz[(size_t)2 * B * L + o] = al * z + (1.0f - al) * bigz[o];
  }
  __syncthreads();
}

// One critic's loss and parameter gradients on stacked rows `big` (3B, in):
// `nl` hidden layers of width H, then the scalar output layer. Parameters
// and gradients at slots [first, first + 2 (nl + 1)), (w, b) per layer.
// Every block of the cluster calls it; `rank` is the block's rank.
template <int kIn>
__device__ void critic(const Args& a, int rank, const float* big, int in,
                       int H, int nl, int pslot, int gslot,
                       const uint8_t* masks, float keep, float sign,
                       float* loss, float* ws, float* red, float* tile) {
  const int B = a.B, R = 3 * B;
  const int wide = in > H ? in : H;
  const Rows rows = rank_rows(B, rank, 3);   // stacked rows b, B + b, 2B + b
  const Rows brows = rank_rows(B, rank, 1);  // batch rows b
  const float* Wl[5];
  const float* bl[5];
  float* gW[5];
  float* gb[5];
  int off[6] = {0};  // layer i's w in the flat (P,) gradient, then its b
  for (int i = 0; i <= nl; ++i) {
    Wl[i] = in_ptr(a, pslot + 2 * i);
    bl[i] = in_ptr(a, pslot + 2 * i + 1);
    gW[i] = out_ptr(a, gslot + 2 * i);
    gb[i] = out_ptr(a, gslot + 2 * i + 1);
    off[i + 1] = off[i] + (i < nl ? H * (i == 0 ? in : H) + H : H + 1);
  }
  const int P = off[nl + 1];
  float* hs = ws;                                // nl x (R, H)
  float* Ds = hs + (size_t)nl * R * H;           // nl x (R, H)
  float* out = Ds + (size_t)nl * R * H;          // (R,)
  float* wgp = out + R;                          // nl x (B, H)
  float* v0 = wgp + (size_t)nl * B * H;          // (B, wide)
  float* v1 = v0 + (size_t)B * wide;             // (B, wide)
  float* e0 = v1 + (size_t)B * wide;             // (R, H)
  float* e1 = e0 + (size_t)R * H;                // (R, H)
  float* wlp = e1 + (size_t)R * H;               // kClusterBlocks x (P,)
  float* gpp = wlp + (size_t)kClusterBlocks * P;   // kClusterBlocks x (P,)
  float* scal = gpp + (size_t)kClusterBlocks * P;  // wl, then sum g^2, by rank
  float* my_wl = wlp + (size_t)rank * P;  // this rank's wl-path partials
  float* my_gp = gpp + (size_t)rank * P;  // this rank's GP-path partials
  auto h_in = [&](int i) { return i == 0 ? big : hs + (size_t)(i - 1) * R * H; };
  auto d_in = [&](int i) { return i == 0 ? in : H; };
  const float* Wo = Wl[nl];
  const float csc = (float)((double)sign / (double)B);
  auto c_of = [&](int r) { return r < B ? -csc : (r < 2 * B ? csc : 0.0f); };

  // forward, with the backward diagonals
  for (int i = 0; i < nl; ++i) {
    const int din = d_in(i);
    float* hi = hs + (size_t)i * R * H;
    float* Di = Ds + (size_t)i * R * H;
    const uint8_t* mi = masks + (size_t)i * R * H;
    for_row_tiles<kIn>(h_in(i), rows, din, tile,
                       [&](int t0, int n, int ld, const float* src) {
      for (int idx = threadIdx.x; idx < n * H; idx += blockDim.x) {
        const int j = idx / n, r = idx - j * n;
        const float* x = src + r * ld;
        const float* w = Wl[i] + (size_t)j * din;
        float acc = 0.0f;
        for (int k = 0; k < din; ++k) acc = fmaf(x[k], w[k], acc);
        const float pre = acc + bl[i][j];
        const bool pos = pre >= 0.0f;
        const size_t o = (size_t)rows.at(t0 + r) * H + j;
        const bool kept = mi[o] != 0;
        hi[o] = kept ? (pos ? pre : kLeaky * pre) / keep : 0.0f;
        Di[o] = kept ? (pos ? 1.0f : kLeaky) / keep : 0.0f;
      }
    });
    __syncthreads();
  }
  const float* hL = hs + (size_t)(nl - 1) * R * H;
  for (int t = threadIdx.x; t < rows.count(); t += blockDim.x) {
    const int r = rows.at(t);
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) acc = fmaf(hL[(size_t)r * H + j], Wo[j], acc);
    out[r] = acc + bl[nl][0];
  }
  __syncthreads();
  float part = 0.0f;
  for (int t = threadIdx.x; t < rows.count(); t += blockDim.x) {
    const int r = rows.at(t);
    part += out[r] * c_of(r);
  }
  const float wl_part = block_sum(part, red);

  // GP input gradient: the backward chain on the interpolate rows
  const float* v = nullptr;  // null: Wo broadcast over the rows
  float* vbuf[2] = {v0, v1};
  for (int i = nl - 1; i >= 0; --i) {
    const float* Di = Ds + (size_t)i * R * H + (size_t)2 * B * H;
    float* wi = wgp + (size_t)i * B * H;
    for (int idx = threadIdx.x; idx < brows.nb * H; idx += blockDim.x) {
      const size_t o = (size_t)brows.b0 * H + idx;
      const int j = idx % H;
      wi[o] = (v ? v[o] : Wo[j]) * Di[o];
    }
    __syncthreads();
    const int din = d_in(i);
    float* vn = vbuf[i & 1];
    for (int idx = threadIdx.x; idx < brows.nb * din; idx += blockDim.x) {
      const int o = brows.b0 * din + idx;
      const int r = o / din, k = o - r * din;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j)
        acc = fmaf(wi[(size_t)r * H + j], Wl[i][(size_t)j * din + k], acc);
      vn[o] = acc;
    }
    __syncthreads();
    v = vn;
  }
  float* g = vbuf[0];  // the chain ends at i = 0
  part = 0.0f;
  for (int idx = threadIdx.x; idx < brows.nb * in; idx += blockDim.x) {
    const float gv = g[(size_t)brows.b0 * in + idx];
    part += gv * gv;
  }
  const float gsq_part = block_sum(part, red);
  if (threadIdx.x == 0) {
    scal[rank] = wl_part;
    scal[kClusterBlocks + rank] = gsq_part;
  }

  // wl-path gradient partials: backprop of the cotangent c over the owned
  // rows; they need no other rank's data, so they run before the barrier
  for (int idx = threadIdx.x; idx <= H; idx += blockDim.x) {
    float acc = 0.0f;
    if (idx < H)
      each_row(rows, [&](int r) {
        acc = fmaf(c_of(r), hL[(size_t)r * H + idx], acc);
      });
    else
      each_row(rows, [&](int r) { acc += c_of(r); });
    my_wl[off[nl] + idx] = acc;
  }
  float* ebuf[2] = {e0, e1};
  const float* e = nullptr;  // null: the per-row cotangent c (R, 1)
  for (int i = nl - 1; i >= 0; --i) {
    const float* Di = Ds + (size_t)i * R * H;
    float* en = ebuf[i & 1];
    for (int idx = threadIdx.x; idx < rows.count() * H; idx += blockDim.x) {
      const int t = idx / H, j = idx - t * H;
      const int r = rows.at(t);
      const size_t o = (size_t)r * H + j;
      float acc;
      if (e) {
        acc = 0.0f;
        const float* Wn = Wl[i + 1];
        for (int m = 0; m < H; ++m)
          acc = fmaf(e[(size_t)r * H + m], Wn[(size_t)m * H + j], acc);
      } else {
        acc = c_of(r) * Wo[j];
      }
      en[o] = acc * Di[o];
    }
    __syncthreads();
    const float* hp = h_in(i);
    const int din = d_in(i);
    for (int idx = threadIdx.x; idx < H * din + H; idx += blockDim.x) {
      float acc = 0.0f;
      if (idx < H * din) {
        const int j = idx / din, k = idx - j * din;
        each_row(rows, [&](int r) {
          acc = fmaf(en[(size_t)r * H + j], hp[(size_t)r * din + k], acc);
        });
      } else {
        const int j = idx - H * din;
        each_row(rows, [&](int r) { acc += en[(size_t)r * H + j]; });
      }
      my_wl[off[i] + idx] = acc;
    }
    __syncthreads();
    e = en;
  }

  // Barrier 1: every rank's wl and sum g^2 partials are written.
  cg::this_cluster().sync();
  float wl = __ldcg(scal), gsq = __ldcg(scal + kClusterBlocks);
  for (int q = 1; q < kClusterBlocks; ++q) {
    wl = wl + __ldcg(scal + q);
    gsq = gsq + __ldcg(scal + kClusterBlocks + q);
  }
  const float gn = sqrtf(gsq + kGpEps);
  const float gd = gn - 1.0f;
  if (rank == 0 && threadIdx.x == 0) *loss = wl + kGpWeight * (gd * gd);

  // GP-path gradient partials: the forward chain run on
  // u_0 = 20 (gn - 1) / gn * g over the owned batch rows
  const float coef = (2.0f * kGpWeight * gd) / gn;
  for (int idx = threadIdx.x; idx < brows.nb * in; idx += blockDim.x) {
    const size_t o = (size_t)brows.b0 * in + idx;
    g[o] = coef * g[o];
  }
  __syncthreads();
  float* u = g;
  for (int i = 0; i < nl; ++i) {
    const int din = d_in(i);
    const float* wi = wgp + (size_t)i * B * H;
    const float* Di = Ds + (size_t)i * R * H + (size_t)2 * B * H;
    float* un = u == v0 ? v1 : v0;
    for (int idx = threadIdx.x; idx < H * din; idx += blockDim.x) {
      const int j = idx / din, k = idx - j * din;
      float acc = 0.0f;
      each_row(brows, [&](int r) {
        acc = fmaf(wi[(size_t)r * H + j], u[(size_t)r * din + k], acc);
      });
      my_gp[off[i] + idx] = acc;
    }
    for_row_tiles<kIn>(u, brows, din, tile,
                       [&](int t0, int n, int ld, const float* src) {
      for (int idx = threadIdx.x; idx < n * H; idx += blockDim.x) {
        const int j = idx / n, r = idx - j * n;
        const float* x = src + r * ld;
        const float* w = Wl[i] + (size_t)j * din;
        float acc = 0.0f;
        for (int k = 0; k < din; ++k) acc = fmaf(x[k], w[k], acc);
        const size_t o = (size_t)brows.at(t0 + r) * H + j;
        un[o] = Di[o] * acc;
      }
    });
    __syncthreads();
    u = un;
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float acc = 0.0f;
    each_row(brows, [&](int r) { acc += u[(size_t)r * H + j]; });
    my_gp[off[nl] + j] = acc;
  }

  // Barrier 2: every partial is written. Each gradient entry has one owner
  // thread in the cluster, which adds the ranks' partials in rank order:
  // (wl-path sum) + (GP-path sum) for a weight, the wl-path sum for a bias.
  // Entry f of the flat (P,) layout belongs to cluster thread f mod
  // (kClusterBlocks blockDim). The layer loop has a constant bound, so the
  // pointer arrays stay in registers.
  cg::this_cluster().sync();
  const int me = rank * blockDim.x + threadIdx.x;
  const int stride = kClusterBlocks * blockDim.x;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i > nl) break;
    const int wsize = i < nl ? H * d_in(i) : H;
    for (int f = off[i] + ((me - off[i]) % stride + stride) % stride;
         f < off[i + 1]; f += stride) {
      const int k = f - off[i];
      float acc = __ldcg(wlp + f);
      for (int q = 1; q < kClusterBlocks; ++q)
        acc = acc + __ldcg(wlp + (size_t)q * P + f);
      if (k < wsize) {
        float gp = __ldcg(gpp + f);
        for (int q = 1; q < kClusterBlocks; ++q)
          gp = gp + __ldcg(gpp + (size_t)q * P + f);
        gW[i][k] = acc + gp;
      } else {
        gb[i][k - wsize] = acc;
      }
    }
  }
}

// Blocks [0, kClusterBlocks) form cluster 0 (the decoder, then critic_x),
// the rest cluster 1 (the encoder, then critic_z).
template <int kIn>
__global__ void __launch_bounds__(kThreads) critic_step_kernel(Args a) {
  __shared__ float red[kWarps + 1];
  // 33,024 bytes narrow, 32,896 wide; the any-width instance's tile is
  // dynamic shared memory
  __shared__ float static_tile[kIn == kAnyIn ? 1
                                             : tile_rows<kIn>() * (kIn + 1)];
  extern __shared__ float dynamic_tile[];
  float* tile = kIn == kAnyIn ? dynamic_tile : static_tile;
  const int rank = (int)cg::this_cluster().block_rank();
  const Rows rows = rank_rows(a.B, rank, 1);
  float* ws = out_ptr(a, WS);
  float* loss = out_ptr(a, LOSS);
  if (blockIdx.x < kClusterBlocks) {
    float* bigx = out_ptr(a, BIGX);
    float* cws = ws;
    if (a.full)
      decoder_side<kIn>(a, rows, cws + critic_ws(3 * a.B, a.B, a.W, a.Hx, 4),
                   bigx, tile);
    critic<kIn>(a, rank, bigx, a.W, a.Hx, 4, CX, GCX,
           static_cast<const uint8_t*>(slot(a, MCX)), kCxKeep, +1.0f, loss,
           cws, red, tile);
  } else {
    float* bigz = out_ptr(a, BIGZ);
    float* cws = ws + side_x_ws(a);
    if (a.full)
      encoder_side<kIn>(a, rows, cws + critic_ws(3 * a.B, a.B, a.L, a.Hz, 2),
                   bigz, tile);
    critic<kIn>(a, rank, bigz, a.L, a.Hz, 2, CZ, GCZ,
           static_cast<const uint8_t*>(slot(a, MCZ)), kCzKeep, -1.0f,
           loss + 1, cws, red, tile);
  }
}

// The widest layer input (or MobiusLinear head) a launch stages: the
// critics' inputs and hidden widths, and under K5 the generator's.
int widest(const Args& a) {
  int w = 0;
  const int in[] = {a.W, a.L, a.Hx, a.Hz};
  const int gen[] = {a.D1, 2 * a.Hd, 2 * a.He};
  for (int v : in) w = v > w ? v : w;
  if (a.full)
    for (int v : gen) w = v > w ? v : w;
  return w;
}

bool fill(Args* a, void* const* ptrs, const long long* strides,
          const int* dims, int full, int hyperbolic) {
  for (int s = 0; s < kSlots; ++s) {
    a->p[s] = ptrs[s];
    a->stride[s] = strides ? strides[s] : 0;
  }
  a->B = dims[DB];
  a->W = dims[DW];
  a->L = dims[DL];
  a->Hx = dims[DHX];
  a->Hz = dims[DHZ];
  a->He = dims[DHE];
  a->D1 = dims[DD1];
  a->Hd = dims[DHD];
  a->full = full;
  a->hyperbolic = hyperbolic;
  for (int d = 0; d < kDims; ++d)
    if (dims[d] < 1) return false;
  return true;
}

// Two clusters of kClusterBlocks blocks for each of `signals` signals
// (blockIdx.y). A refused launch (a cluster the card cannot place, for
// one) comes back as its error code.
int launch(void* const* ptrs, const long long* strides, const int* dims,
           int signals, int full, int hyperbolic, void* stream) {
  Args a;
  if (signals < 1 || signals > 65535 ||
      !fill(&a, ptrs, strides, dims, full, hyperbolic))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kClusterBlocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * kClusterBlocks, signals);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  // the narrow instance up to kMaxIn, the wide one up to kWideMaxIn, the
  // any-width one above, with a dynamic tile of up to kWideTileRows rows of
  // the widest input (stride | 1), at least one
  const int w = widest(a);
  void (*kernel)(Args) = w > kWideMaxIn ? critic_step_kernel<kAnyIn>
                         : w > kMaxIn   ? critic_step_kernel<kWideMaxIn>
                                        : critic_step_kernel<kMaxIn>;
  if (w > kWideMaxIn) {
    const size_t row = sizeof(float) * (size_t)(w | 1);
    const size_t room = kSmemLimit - sizeof(float) * (kWarps + 2);
    if (row > room) return cudaErrorInvalidValue;
    const size_t rows = room / row < kWideTileRows ? room / row
                                                   : kWideTileRows;
    cfg.dynamicSmemBytes = rows * row;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (attr != cudaSuccess) return attr;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Floats of global workspace one launch needs, for dims
// [B, W, L, Hx, Hz, He, D1, Hd].
extern "C" long long critic_step_workspace_floats(const int* dims) {
  Args a;
  a.B = dims[DB];
  a.W = dims[DW];
  a.L = dims[DL];
  a.Hx = dims[DHX];
  a.Hz = dims[DHZ];
  a.He = dims[DHE];
  a.D1 = dims[DD1];
  a.Hd = dims[DHD];
  return (long long)total_ws(a);
}

// The launch shape of K4 and K5: clusters, blocks a cluster, threads a block.
extern "C" void critic_step_launch_shape(int* shape) {
  shape[0] = 2;
  shape[1] = kClusterBlocks;
  shape[2] = kThreads;
}

// K4: both critics' losses and gradients from bigx, bigz, mx, mz. `ptrs`
// holds the 70 slots of `Slot` (the generator slots are not read). Returns
// the launch's error code (cudaGetLastError() after it) on `stream`.
extern "C" int critics_fused_grads_forward(void* const* ptrs, const int* dims,
                                           void* stream) {
  return launch(ptrs, nullptr, dims, 1, 0, 0, stream);
}

// K5: the generator forwards, then K4; bigx and bigz are written.
extern "C" int critic_step_full_forward(void* const* ptrs, const int* dims,
                                        int hyperbolic, void* stream) {
  return launch(ptrs, nullptr, dims, 1, 1, hyperbolic, stream);
}

// K4 and K5 for `signals` signals in one launch (the fleet): slot s of
// signal i lies at ptrs[s] + i * strides[s] bytes, the workspace slot
// included (`strides[WS]` at least critic_step_workspace_floats floats).
// Each signal runs the single-signal launch's blocks and arithmetic.
extern "C" int critics_fused_grads_signals_forward(void* const* ptrs,
                                                   const long long* strides,
                                                   const int* dims,
                                                   int signals, void* stream) {
  return launch(ptrs, strides, dims, signals, 0, 0, stream);
}

extern "C" int critic_step_full_signals_forward(void* const* ptrs,
                                                const long long* strides,
                                                const int* dims, int signals,
                                                int hyperbolic, void* stream) {
  return launch(ptrs, strides, dims, signals, 1, hyperbolic, stream);
}
