// IW1: MIWAE's importance-weighted evaluation step over B x K samples, for
// sm_90a.
//
// For the rows x, mask [B, D] of a stream, the noise eps [B, K, L], the
// encoder's three dense layers (widths D-128-128-2L) and the Student-t
// decoder's three (L-128-128-3D), each as w [fan_in, fan_out], b [fan_out]:
//
//     mean_b, a_b = split(MLP_enc(x_b * mask_b)),  scale_b = softplus(a_b)
//     z      = mean_b + scale_b * eps_s                      (s = (b, k))
//     h1     = relu(z W1 + b1),  h2 = relu(h1 W2 + b2),  o = h2 W3 + b3
//     loc    = sigmoid(o[:D]),   sc = softplus(o[D:2D]) + 0.001,
//     df     = softplus(o[2D:]) + 3
//     lp_d   = log StudentT(x_bd; loc_d, sc_d, df_d)
//     log_w  = sum_d mask_bd lp_d + sum_l log N(z_l; 0, 1)
//              - sum_l log N(z_l; mean_bl, scale_bl)
//
// and, for every row b, the reductions over its K samples:
//
//     x_imputed_b = sum_k softmax_k(log_w)_k loc_k                    [D]
//     per_row     = [-logsumexp_k log_w,
//                    sum_k sum_d (1 - mask_bd) lp_d / divisor,
//                    mean_k sum_d extra_bd lp_d (rows b < B_extra; else 0)]
//     mean_b, scale_b                                                  [L]
//
// These are what models/miwae.eval_step returns (the regularized types add
// their KL of the mean and scale rows on the host). Nothing of size B x K
// reaches device memory: h1, h2, o, loc, lp and log_w stay on chip, and each
// range of tiles leaves only its partial reductions. The formulas are those of
// models/miwae.encode, forward, _branch_terms and ops/fused_iw.reduce_over_k
// in float32 (torch's softplus with threshold 20, sigmoid as 1 / (1 +
// exp(-x)), lgammaf, log1pf, logsumexp with a max of +-inf taken as 0);
// products and sums that PyTorch rounds apart are rounded apart. Every
// tensor carries a leading replica axis R (an ensemble's replicas, R = 1 for
// one run), each replica with its own encoder and decoder.
//
// It replaces no TPU kernel: the JAX package computes MIWAE in plain jnp. It
// was added because that composition, ported as it was, spent a
// `miwae_wine.eval` batch first moving bytes (each 128-wide hidden layer
// wrote a [B*K, 128] float32 tensor, 164 MB at B = 64, K = 5000), then,
// once the decoder and the density were fused, dispatching the encoder's
// and the reductions' two dozen small operations from the host.
//
// Bound. A sample costs 2 * (10*128 + 128*128 + 128*39) = 45,312 FLOP of
// dense products at L = 10, D = 13, against about 16 bytes it must move (its
// eps). So operations bound it: 14.50 GFLOP at B = 64, K = 5000, or 0.216 ms
// at the H100's 67 TFLOP/s of float32 FMA outside the tensor cores (TF32
// stays off: the configuration states float32). The density adds about 13
// transcendental-heavy evaluations a sample on the SFUs; the encoder is
// 2 * (13*128 + 128*128 + 128*20) FLOP a row, under 0.1% of the rest.
//
// Design. Two launches on the caller's stream, from one call:
//
// 1. The encoder, a block of 512 threads for every 4 rows of every replica:
//    a hidden unit's dot product in four slices of FMA chains, joined in
//    order, its bias added after, as a float32 GEMM then the bias add round
//    it. It writes mean and scale and zeroes the replica's ticket.
// 2. The body, a persistent grid (about one block an SM; replicas on grid
//    y): each block copies its replica's decoder (W2 [128][128], W1
//    [L][128], the biases: 71 KB at L = 10) into shared memory once. Its 512
//    threads are two groups of 8 warps that work apart, each on its own
//    tiles of 64 consecutive samples of the flattened B*K axis (a tile may
//    straddle rows: each sample reads its row as s / K) and synchronised by
//    a named barrier of its own, so one group's barriers, loads and
//    transcendentals overlap the other's products. A tile's z goes to
//    shared memory; layers 1 and 2 are register-blocked SIMT products, 4
//    samples x 8 units a thread, with bias and ReLU in the epilogue, h1 and
//    h2 kept in one [64][132] buffer a group whose padded pitch keeps the
//    head's loads free of bank conflicts. The head stages W3 transposed in
//    chunks of 16 features and takes 4 samples x 1 feature x 3 outputs a
//    thread, then the activations and the log-density in registers, and
//    sums over the features by warp shuffles. D <= 16 stages W3 once and
//    keeps the tile's loc in shared memory; larger D loops over chunks,
//    staging each anew a tile, and parks loc in a global scratch of the
//    tile group's own.
//    The tiles are cut into `parts` ranges of consecutive tiles, one a tile
//    group on one replica (a group takes every W-th range where the grid
//    has fewer groups); the ranges, and so the sums, depend on the shapes
//    and the card's SM count alone, not on the number of replicas.
//    Epilogue: for each row segment of the tile (the samples of one row it
//    holds) a warp takes the segment's max of log_w and its weights
//    exp(log_w - max); then eight lanes a (segment, field) sum the field
//    over the segment: the weights, the two plain sums, and weight x loc for
//    each of the D features. A segment that continues the row of the
//    range's previous tile takes the max of both and rescales the running
//    sums by exp(old max - new max). The range's partials of a row (max,
//    then those D + 3 sums) go to slot range + row of a workspace: slots are
//    distinct, since rows never decrease along the ranges, and a row's slots
//    are adjacent, about K / (64 x tiles a range) + 1 of them. The last
//    block of a replica to finish (an atomic ticket says which) merges
//    every row's slots in range order, rescaling each by exp(its max - the
//    row's max): it stages the slots of as many rows as fit into its shared
//    memory, then a warp a row reads them there (a row too large for it is
//    read from device memory by the whole block). Ranges keep that serial
//    tail short: slots a tile would be 79 a row at K = 5000, and merges by
//    the group that finished a row's last tile pile up on the groups they
//    delay, which then finish the next rows last too.
//
// Float32 FMA throughout; every sum runs in an order fixed by the shapes
// alone, never by which block finishes first, so the same inputs give the
// same bits every run. Nothing is allocated; the caller owns every buffer
// (the workspace included: `work_floats` floats, which the entry point
// checks against its own count) and the stream.

#include <cuda_runtime.h>

#include <math.h>

#include "vpc_common.cuh"

namespace {

constexpr int kH = 128;            // the hidden width of both networks
constexpr int kT = 64;             // samples a tile
constexpr int kGroups = 2;         // thread groups a block, each on its tiles
constexpr int kGroupThreads = 256;
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kPitch = kH + 4;     // row pitch of h and of W3's chunk
constexpr int kChunkF = 16;        // features a chunk of the head
constexpr int kCols = 3 * kChunkF; // W3 columns a chunk stages
constexpr int kSlotHead = 4;       // a slot: max, sum of weights, the two
                                   // plain sums, then D weighted loc sums
constexpr int kEncRows = 4;        // rows an encoder block
constexpr int kEncSlices = 4;      // slices of its dot products
static_assert(kEncSlices == kEncRows, "the encoder joins a row a slice");
constexpr int kEncThreads = kEncSlices * kH;
constexpr int kLocPitch = kChunkF + 1;  // row pitch of a tile's loc, D <= 16
constexpr int kMaxL = 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.918938533204672742f;  // 0.5 * log(2 pi)
constexpr float kPi = 3.14159265358979323846f;

}  // namespace

// The C interface (ops/fused_iw.py mirrors these three structs with ctypes).
// Rows have stride ld_*, replicas stride rs_* (0: one tensor shared by every
// replica); columns are contiguous, and so are eps and the networks' leaves
// within a replica. The outputs are contiguous.
extern "C" {
struct IwPointers {
  const float* x;      // [R, B, D]
  const float* mask;   // [R, B, D]
  const float* extra;  // [R, B_extra, D], or null
  const float* eps;    // [R, B, K, L]
  const float* ew1;    // the encoder: [R, D, 128]
  const float* eb1;    // [R, 128]
  const float* ew2;    // [R, 128, 128]
  const float* eb2;    // [R, 128]
  const float* ew3;    // [R, 128, 2L]
  const float* eb3;    // [R, 2L]
  const float* w1;     // the decoder: [R, L, 128]
  const float* b1;     // [R, 128]
  const float* w2;     // [R, 128, 128]
  const float* b2;     // [R, 128]
  const float* w3;     // [R, 128, 3D]
  const float* b3;     // [R, 3D]
  float* x_imputed;    // [R, B, D]
  float* per_row;      // [R, 3, B]
  float* mean;         // [R, B, L]
  float* scale;        // [R, B, L]
  float* work;         // the workspace, work_floats floats
};
struct IwStrides {
  long long ld_x, ld_mask, ld_extra;
  long long rs_x, rs_mask, rs_extra, rs_eps;
  long long rs_ew1, rs_eb1, rs_ew2, rs_eb2, rs_ew3, rs_eb3;
  long long rs_w1, rs_b1, rs_w2, rs_b2, rs_w3, rs_b3;
};
struct IwDims {
  int R, B, K, D, L, B_extra;
  int blocks;            // blocks a replica of the body (grid x)
  int parts;             // ranges of tiles, at most the tiles
  float divisor;         // per_row[1] = sum_k logpx_imp / divisor
  long long work_floats; // the workspace's size (ops/fused_iw._work_floats)
};
}

namespace {

// A replica's workspace: (parts + B) slots of D + 4 floats, then, for D > 16,
// a scratch for each tile group: the tile's loc [64][D] and two running
// slots; the R tickets follow the replicas' workspaces.
__host__ __device__ long long replica_floats(const IwDims& d) {
  const long long F = d.D + kSlotHead;
  const long long slots = (static_cast<long long>(d.parts) + d.B) * F;
  const long long scratch =
      d.D > kChunkF
          ? static_cast<long long>(d.blocks) * kGroups * (kT * d.D + 2 * F)
          : 0;
  return slots + scratch;
}

long long work_floats(const IwDims& d) {
  return d.R * replica_floats(d) + d.R;  // the tickets, one float's room each
}

__device__ __forceinline__ float relu(float v) {
  // torch's relu keeps a NaN
  return (v > 0.f || v != v) ? v : 0.f;
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// the larger, a NaN on either side kept, as torch's max keeps it
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    v = nan_max(v, __shfl_xor_sync(kFullWarp, v, m));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFullWarp, v, m);
  return v;
}

// ops/math.student_t_logpdf, its products rounded as PyTorch rounds them
__device__ __forceinline__ float student_t_logpdf(float x, float loc,
                                                  float sc, float df) {
  const float y = (x - loc) / sc;
  const float half_df1 = __fmul_rn(0.5f, df + 1.f);
  const float a = lgammaf(half_df1) - lgammaf(__fmul_rn(0.5f, df));
  const float b = __fmul_rn(0.5f, logf(__fmul_rn(df, kPi)));
  const float c = __fmul_rn(half_df1, log1pf(__fmul_rn(y, y) / df));
  return ((a - b) - logf(sc)) - c;
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The barrier of group g's 256 threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads)
               : "memory");
}

// W3's chunk c transposed into sW3 [48][kPitch] (row j*16 + f for output j of
// feature c*16 + f, zero past D) and its biases into sB3 [48], by the 256
// threads of a group (gt their index).
__device__ void stage_head(float* sW3, float* sB3, const float* w3,
                           const float* b3, int c, int D, int gt) {
  const int D3 = 3 * D;
  for (int i = gt; i < kCols * kH; i += kGroupThreads) {
    const int row = i / kH, k = i - row * kH;
    const int j = row / kChunkF, f = c * kChunkF + row % kChunkF;
    sW3[row * kPitch + k] = f < D ? w3[k * D3 + j * D + f] : 0.f;
  }
  for (int i = gt; i < kCols; i += kGroupThreads) {
    const int j = i / kChunkF, f = c * kChunkF + i % kChunkF;
    sB3[i] = f < D ? b3[j * D + f] : 0.f;
  }
}

// acc += a * (w0, w1): one row of a thread's 4 x 8 block of layers 1 and 2,
// whose rows are samples ty*4 + i and whose columns are units tx*4 + j and
// 64 + tx*4 + j (two groups of four, so a warp's 128-bit loads of W never
// collide)
__device__ __forceinline__ void fma_row(float (&acc)[8], float a,
                                        const float4& w0, const float4& w1) {
  acc[0] = fmaf(a, w0.x, acc[0]);
  acc[1] = fmaf(a, w0.y, acc[1]);
  acc[2] = fmaf(a, w0.z, acc[2]);
  acc[3] = fmaf(a, w0.w, acc[3]);
  acc[4] = fmaf(a, w1.x, acc[4]);
  acc[5] = fmaf(a, w1.y, acc[5]);
  acc[6] = fmaf(a, w1.z, acc[6]);
  acc[7] = fmaf(a, w1.w, acc[7]);
}

// relu(acc + bias) of a thread's 4 x 8 block into sAct [64][kPitch]
__device__ __forceinline__ void store_hidden(const float (&acc)[4][8],
                                             const float* bias, float* sAct,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = sAct + (ty * 4 + i) * kPitch;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 64 + tx * 4;
      float4 v;
      v.x = relu(acc[i][h * 4 + 0] + bias[col + 0]);
      v.y = relu(acc[i][h * 4 + 1] + bias[col + 1]);
      v.z = relu(acc[i][h * 4 + 2] + bias[col + 2]);
      v.w = relu(acc[i][h * 4 + 3] + bias[col + 3]);
      *reinterpret_cast<float4*>(row + col) = v;
    }
  }
}

// The range that holds tile t: the last whose first tile is at most t
__device__ __forceinline__ long long range_of(long long t, const IwDims& d,
                                             long long tiles) {
  return ((t + 1) * d.parts - 1) / tiles;
}
// Row b's slots: those of the ranges q0 .. q1 that hold its first and last
// tiles, slot q + b
__device__ __forceinline__ long long slot_begin(int b, const IwDims& d,
                                               long long tiles) {
  return range_of(static_cast<long long>(b) * d.K / kT, d, tiles) + b;
}
__device__ __forceinline__ long long slot_end(int b, const IwDims& d,
                                             long long tiles) {
  return range_of((static_cast<long long>(b + 1) * d.K - 1) / kT, d, tiles) +
         b + 1;
}

// Row b's per_row values from its max M and the sums of its slots' fields
// 1, 2, 3 (S, P, E)
__device__ __forceinline__ void row_out(const IwDims& dm, int b, float M,
                                        float S, float P, float E,
                                        float* per_row) {
  per_row[b] = -(logf(S) + M);
  per_row[dm.B + b] = P / dm.divisor;
  per_row[2 * dm.B + b] =
      b < dm.B_extra ? E / static_cast<float>(dm.K) : 0.f;
}

// Row b merged by one warp from its slots staged in shared memory at s:
// the row's max M (its slots' maxes, +-inf taken as 0 as torch's logsumexp
// takes them), each slot's max replaced by its weight exp(max - M), then
// field f by lane f - 1 (+ 32 c) over the slots in tile order: the weights'
// sum and the loc sums rescaled, the plain sums as they are.
__device__ void merge_row_warp(float* s, int b, int ns, const IwDims& dm,
                               float* x_imputed, float* per_row, int lane) {
  const int D = dm.D, F = D + kSlotHead;
  float M = -INFINITY;
  for (int j = lane; j < ns; j += 32) M = nan_max(M, s[j * F]);
  M = warp_max(M);
  if (isinf(M)) M = 0.f;
  for (int j = lane; j < ns; j += 32) s[j * F] = expf(s[j * F] - M);
  __syncwarp();
  float S = 0.f;
  for (int f0 = 1; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    float a = 0.f;
    if (f == 2 || f == 3) {
      for (int j = 0; j < ns; ++j) a += s[j * F + f];
    } else if (f < F) {
#pragma unroll 4
      for (int j = 0; j < ns; ++j) a = fmaf(s[j * F], s[j * F + f], a);
    }
    if (f0 == 1) {
      S = __shfl_sync(kFullWarp, a, 0);
      const float P = __shfl_sync(kFullWarp, a, 1);
      const float E = __shfl_sync(kFullWarp, a, 2);
      if (lane == 0) row_out(dm, b, M, S, P, E, per_row);
    }
    if (f >= kSlotHead && f < F) x_imputed[b * D + f - kSlotHead] = a / S;
  }
}

// Row b merged by the whole block straight from device memory (its slots at
// g, more than shared memory holds), in the same order as merge_row_warp;
// sM [32] is scratch.
__device__ void merge_row_block(const float* g, int b, int ns,
                                const IwDims& dm, float* x_imputed,
                                float* per_row, float* sM) {
  const int D = dm.D, F = D + kSlotHead;
  const int tid = threadIdx.x, lane = tid & 31;
  float M = -INFINITY;
  for (int j = tid; j < ns; j += kThreads) {
    M = nan_max(M, __ldcg(g + static_cast<long long>(j) * F));
  }
  M = warp_max(M);
  if (lane == 0) sM[tid >> 5] = M;
  __syncthreads();
  M = -INFINITY;
  for (int w = 0; w < kThreads / 32; ++w) M = nan_max(M, sM[w]);
  if (isinf(M)) M = 0.f;
  for (int f0 = 1; f0 < F; f0 += kThreads) {
    const int f = f0 + tid;
    float a = 0.f;
    for (int j = 0; f < F && j < ns; ++j) {
      const float* slot = g + static_cast<long long>(j) * F;
      const float v = __ldcg(slot + f);
      a = f == 2 || f == 3 ? a + v : fmaf(expf(__ldcg(slot) - M), v, a);
    }
    if (f0 == 1 && tid < 3) sM[kThreads / 32 + tid] = a;
    __syncthreads();
    const float S = sM[kThreads / 32];
    if (f0 == 1 && tid == 0) {
      row_out(dm, b, M, S, sM[kThreads / 32 + 1], sM[kThreads / 32 + 2],
              per_row);
    }
    if (f >= kSlotHead && f < F) x_imputed[b * D + f - kSlotHead] = a / S;
    __syncthreads();
  }
}

// The encoder: mean and scale [R, B, L] for rows blockIdx.x * 4 + r of replica
// blockIdx.y. Thread (ks, u) sums slice ks of hidden unit u's dot products for
// the block's rows (inputs ks, ks + 4, ... of layer 1; a quarter of layer 2's
// 128), the four slices are joined in order and the bias added after; the
// head's (row, output) pairs take its 128 inputs in two halves. Block
// (0, rep) zeroes rep's ticket.
__global__ void __launch_bounds__(kEncThreads)
    iw_encode_kernel(IwPointers p, IwStrides st, IwDims dm,
                     unsigned* tickets) {
  __shared__ float sPart[kEncSlices][kEncRows][kH];
  __shared__ float sH[kEncRows][kH];
  const int D = dm.D, L2 = 2 * dm.L, tid = threadIdx.x;
  const int ks = tid / kH, u = tid % kH;
  const long long rep = blockIdx.y;
  const int b0 = blockIdx.x * kEncRows;
  const int rows = min(kEncRows, dm.B - b0);
  if (blockIdx.x == 0 && tid == 0) tickets[rep] = 0u;
  const float* x = p.x + rep * st.rs_x + b0 * st.ld_x;
  const float* mask = p.mask + rep * st.rs_mask + b0 * st.ld_mask;
  const float* w1 = p.ew1 + rep * st.rs_ew1;
  const float* w2 = p.ew2 + rep * st.rs_ew2;
  const float* w3 = p.ew3 + rep * st.rs_ew3;
  const float* b3 = p.eb3 + rep * st.rs_eb3;
  // slice ks's partial sums, joined by thread (r, u) into relu(sum + bias)
  auto join = [&](const float* bias) {
    const int r = ks;  // one row a slice's threads
    const float h = ((sPart[0][r][u] + sPart[1][r][u]) + sPart[2][r][u]) +
                    sPart[3][r][u];
    sH[r][u] = relu(h + bias[u]);
  };

  float acc[kEncRows];
#pragma unroll
  for (int r = 0; r < kEncRows; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int d = ks; d < D; d += kEncSlices) {
    const float w = w1[d * kH + u];
#pragma unroll
    for (int r = 0; r < kEncRows; ++r) {
      if (r < rows) {
        acc[r] = fmaf(__fmul_rn(x[r * st.ld_x + d], mask[r * st.ld_mask + d]),
                      w, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kEncRows; ++r) sPart[ks][r][u] = acc[r];
  __syncthreads();
  join(p.eb1 + rep * st.rs_eb1);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kEncRows; ++r) acc[r] = 0.f;
  constexpr int kSlice = kH / kEncSlices;
#pragma unroll
  for (int kk = 0; kk < kSlice; ++kk) {
    const int k = ks * kSlice + kk;
    const float w = w2[k * kH + u];
#pragma unroll
    for (int r = 0; r < kEncRows; ++r) acc[r] = fmaf(sH[r][k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kEncRows; ++r) sPart[ks][r][u] = acc[r];
  __syncthreads();
  join(p.eb2 + rep * st.rs_eb2);
  __syncthreads();
  // the head: pair i = (row, output) by threads i and 256 + i, each over
  // half of the inputs; mean, then softplus of the scale half
  const int i = tid % 256, half = tid / 256;
  float a = 0.f;
  if (i < rows * L2) {
    const int r = i / L2, o = i - r * L2;
#pragma unroll 16
    for (int kk = 0; kk < kH / 2; ++kk) {
      const int k = half * (kH / 2) + kk;
      a = fmaf(sH[r][k], w3[k * L2 + o], a);
    }
  }
  float* part = &sPart[0][0][0];
  part[tid] = a;
  __syncthreads();
  if (half == 0 && i < rows * L2) {
    const int r = i / L2, o = i - r * L2;
    const float v = (part[i] + part[256 + i]) + b3[o];
    const long long row = (rep * dm.B + b0 + r) * dm.L;
    if (o < dm.L) {
      p.mean[row + o] = v;
    } else {
      p.scale[row + o - dm.L] = softplus(v);
    }
  }
}

// The floats of one group's part of shared memory
__host__ __device__ constexpr int group_floats(int L) {
  // sW3, sB3, sAct, sZ, sLoc, six [64] vectors, two running slots (D <= 16)
  return kCols * kPitch + kCols + kT * kPitch + kT * L + kT * kLocPitch +
         6 * kT + 2 * (kChunkF + kSlotHead);
}

// The body's dynamic shared memory: the decoder, then the groups' parts
__host__ __device__ constexpr int smem_bytes(int L) {
  return static_cast<int>(sizeof(float)) *
         (kH * kH + L * kH + 2 * kH + kGroups * group_floats(L));
}

__global__ void __launch_bounds__(kThreads, 1)
    iw_decode_kernel(IwPointers p, IwStrides st, IwDims dm, int n_chunks,
                     unsigned* tickets) {
  extern __shared__ float4 smem4[];
  const int L = dm.L, D = dm.D, K = dm.K, B = dm.B;
  const int F = D + kSlotHead;  // a slot's floats
  // samples; the wrapper keeps n * max(D, L, 5) below 2^31, so a replica's
  // indices fit an int
  const int n = B * K;
  const int tiles = (n + kT - 1) / kT;
  // this block's replica (grid y): its slices of every tensor
  const long long rep = blockIdx.y;
  const float* x = p.x + rep * st.rs_x;
  const float* mask = p.mask + rep * st.rs_mask;
  const float* extra = p.extra != nullptr ? p.extra + rep * st.rs_extra
                                          : nullptr;
  const float* mean = p.mean + rep * B * L;
  const float* scale = p.scale + rep * B * L;
  const float* eps = p.eps + rep * st.rs_eps;
  const float* w3 = p.w3 + rep * st.rs_w3;
  const float* b3 = p.b3 + rep * st.rs_b3;
  float* slots = p.work + rep * replica_floats(dm);
  const int n_extra = dm.B_extra * K;

  // the block's decoder, then each group's head chunk, activations and the
  // tile's per-sample vectors
  float* sW2 = reinterpret_cast<float*>(smem4);  // [128][128]
  float* sW1 = sW2 + kH * kH;                    // [L][128]
  float* sB1 = sW1 + L * kH;                     // [128]
  float* sB2 = sB1 + kH;                         // [128]
  const int g = threadIdx.x / kGroupThreads;     // this thread's group
  const int gt = threadIdx.x % kGroupThreads;    // its index in the group
  float* sW3 = sB2 + kH + g * group_floats(L);
  float* sB3 = sW3 + kCols * kPitch;             // [48]
  float* sAct = sB3 + kCols;                     // [64 samples][kPitch]
  float* sZ = sAct + kT * kPitch;                // [64 samples][L]
  float* sLoc = sZ + kT * L;                     // [64 samples][17], D <= 16
  float* sPz = sLoc + kT * kLocPitch;            // log p(z) a sample
  float* sQ = sPz + kT;                          // log q(z | x)
  float* sLw = sQ + kT;                          // log_w
  float* sImp = sLw + kT;                        // sum_d (1 - mask) lp
  float* sExt = sImp + kT;                       // sum_d extra lp
  float* sE = sExt + kT;                         // exp(log_w - segment max)
  float* sRun = sE + kT;                         // [2][20] running slots
  float* sSegM = sPz;  // a segment's max, once log_w is taken: sPz, sQ free
  float* sSegC = sQ;   // the rescale of its range's running sums
  // where the tile's loc and the running slots go: shared memory for one
  // chunk of features, the tile group's own global scratch for more
  const int worker = blockIdx.x * kGroups + g;
  float* scratch = slots + (static_cast<long long>(dm.parts) + B) * F +
                   static_cast<long long>(worker) * (kT * D + 2 * F);
  float* loc_buf = n_chunks == 1 ? sLoc : scratch;
  const int loc_pitch = n_chunks == 1 ? kLocPitch : D;
  float* run = n_chunks == 1 ? sRun : scratch + kT * D;  // [2][F]
  int cur = 0;  // the running slot read; the other is written

  {
    const float* w1 = p.w1 + rep * st.rs_w1;
    const float* b1 = p.b1 + rep * st.rs_b1;
    const float* w2 = p.w2 + rep * st.rs_w2;
    const float* b2 = p.b2 + rep * st.rs_b2;
    for (int i = threadIdx.x; i < kH * kH; i += kThreads) sW2[i] = w2[i];
    for (int i = threadIdx.x; i < L * kH; i += kThreads) sW1[i] = w1[i];
    for (int i = threadIdx.x; i < kH; i += kThreads) {
      sB1[i] = b1[i];
      sB2[i] = b2[i];
    }
    if (n_chunks == 1) stage_head(sW3, sB3, w3, b3, 0, D, gt);
  }
  __syncthreads();

  const int ty = gt >> 4, tx = gt & 15;  // layers 1 and 2
  const int fg = gt & 15, sg = gt >> 4;  // the head: feature, samples
  const int wg = gt >> 5, lane = gt & 31;  // the epilogue: warp, lane
  for (int q = worker; q < dm.parts; q += gridDim.x * kGroups) {
    const int t_lo = static_cast<int>(static_cast<long long>(q) * tiles /
                                      dm.parts);
    const int t_hi = static_cast<int>(static_cast<long long>(q + 1) * tiles /
                                      dm.parts);
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int s0 = tile * kT;
      // z, rounded as mean + (scale * eps); zero past the last sample
      for (int i = gt; i < kT * L; i += kGroupThreads) {
        const int sl = i / L, l = i - sl * L;
        const int s = s0 + sl;
        float z = 0.f;
        if (s < n) {
          const int b = s / K;
          z = __fadd_rn(mean[b * L + l],
                        __fmul_rn(scale[b * L + l], eps[s * L + l]));
        }
        sZ[i] = z;
      }
      group_sync(g);
      // log p(z) and log q(z | x): four threads a sample, each over every
      // fourth latent, their sums joined by two shuffles
      {
        const int sl = gt >> 2, s = s0 + sl, q4 = gt & 3;
        float pz = 0.f, q = 0.f;
        if (s < n) {
          const int b = s / K;
          for (int l = q4; l < L; l += 4) {
            const float z = sZ[sl * L + l];
            const float m = mean[b * L + l];
            const float sc = scale[b * L + l];
            pz += __fmul_rn(-0.5f, __fmul_rn(z, z)) - kLogSqrt2Pi;
            const float u = (z - m) / sc;
            q += (__fmul_rn(-0.5f, __fmul_rn(u, u)) - logf(sc)) - kLogSqrt2Pi;
          }
        }
#pragma unroll
        for (int m = 1; m < 4; m <<= 1) {
          pz += __shfl_xor_sync(kFullWarp, pz, m);
          q += __shfl_xor_sync(kFullWarp, q, m);
        }
        if (q4 == 0) {
          sPz[sl] = pz;
          sQ[sl] = q;
        }
      }

      // layer 1: h1 = relu(z W1 + b1)
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
      for (int l = 0; l < L; ++l) {
        const float4 w0 = *reinterpret_cast<const float4*>(sW1 + l * kH +
                                                           tx * 4);
        const float4 w1 = *reinterpret_cast<const float4*>(sW1 + l * kH + 64 +
                                                           tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma_row(acc[i], sZ[(ty * 4 + i) * L + l], w0, w1);
        }
      }
      store_hidden(acc, sB1, sAct, ty, tx);
      group_sync(g);

      // layer 2: h2 = relu(h1 W2 + b2)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < kH; k += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(sAct + (ty * 4 + i) * kPitch +
                                                  k);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wrow = sW2 + (k + kk) * kH + tx * 4;
          const float4 w0 = *reinterpret_cast<const float4*>(wrow);
          const float4 w1 = *reinterpret_cast<const float4*>(wrow + 64);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma_row(acc[i], part(a[i], kk), w0, w1);
        }
      }
      group_sync(g);  // every thread of the group has read h1
      store_hidden(acc, sB2, sAct, ty, tx);
      group_sync(g);

      // the head, the Student-t log-density and its sums, a chunk of 16
      // features at a time; thread (sg, fg) takes samples sg + 16 i and
      // feature fg of the chunk
      float sums[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i) sums[i][0] = sums[i][1] = sums[i][2] = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        if (n_chunks > 1) {
          if (c > 0) group_sync(g);  // the group is done with chunk c-1
          stage_head(sW3, sB3, w3, b3, c, D, gt);
          group_sync(g);
        }
        float o[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = 0.f;
#pragma unroll 2
        for (int k = 0; k < kH; k += 4) {
          float4 a[4], w[3];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = *reinterpret_cast<const float4*>(
                sAct + (sg + 16 * i) * kPitch + k);
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            w[j] = *reinterpret_cast<const float4*>(
                sW3 + (j * kChunkF + fg) * kPitch + k);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float av = part(a[i], kk);
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                o[i][j] = fmaf(av, part(w[j], kk), o[i][j]);
              }
            }
          }
        }
        const int f = c * kChunkF + fg;
        if (f < D) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int sl = sg + 16 * i, s = s0 + sl;
            if (s >= n) continue;
            const int b = s / K;
            const float loc = sigmoid(o[i][0] + sB3[fg]);
            const float sc = softplus(o[i][1] + sB3[kChunkF + fg]) + 0.001f;
            const float df = softplus(o[i][2] + sB3[2 * kChunkF + fg]) + 3.f;
            const float lp = student_t_logpdf(x[b * st.ld_x + f], loc, sc, df);
            loc_buf[sl * loc_pitch + f] = loc;
            const float m = mask[b * st.ld_mask + f];
            sums[i][0] += __fmul_rn(lp, m);
            sums[i][1] += __fmul_rn(lp, 1.f - m);
            if (extra != nullptr && s < n_extra) {
              sums[i][2] += __fmul_rn(lp, extra[b * st.ld_extra + f]);
            }
          }
        }
      }
      // the sums over a sample's features (its 16 lanes, fg, are adjacent),
      // then log_w = (logpxobs + log p(z)) - log q
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float v = sums[i][q];
#pragma unroll
          for (int m = 1; m < 16; m <<= 1) {
            v += __shfl_xor_sync(kFullWarp, v, m);
          }
          sums[i][q] = v;
        }
      }
      if (fg == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sl = sg + 16 * i;
          sLw[sl] = __fsub_rn(__fadd_rn(sums[i][0], sPz[sl]), sQ[sl]);
          sImp[sl] = sums[i][1];
          sExt[sl] = s0 + sl < n_extra ? sums[i][2] : 0.f;
        }
      }
      group_sync(g);

      // the tile's row segments: rows b_first .. b_last, segment j the
      // samples [lo, hi) of row b_first + j; segment 0 continues the range's
      // running sums where the previous tile of the range ended inside its
      // row. A warp a segment takes its max (with the running max where it
      // continues) and the weights
      const int s_end = min(s0 + kT, n);
      const int b_first = s0 / K;
      const int n_seg = (s_end - 1) / K - b_first + 1;
      const bool cont = tile > t_lo && s0 % K != 0;
      const float* run_rd = run + cur * F;
      float* run_wr = run + (cur ^ 1) * F;
      for (int j = wg; j < n_seg; j += kGroupWarps) {
        const int b = b_first + j;
        const int lo = max(s0, b * K) - s0, hi = min(s_end, (b + 1) * K) - s0;
        float m = -INFINITY;
        for (int sl = lo + lane; sl < hi; sl += 32) m = nan_max(m, sLw[sl]);
        m = warp_max(m);
        if (isinf(m)) m = 0.f;  // as torch's logsumexp
        float c = 0.f;
        if (j == 0 && cont) {
          const float old = run_rd[0];
          const float m_new = nan_max(old, m);
          c = expf(old - m_new);
          m = m_new;
        }
        for (int sl = lo + lane; sl < hi; sl += 32) sE[sl] = expf(sLw[sl] - m);
        if (lane == 0) {
          sSegM[j] = m;
          sSegC[j] = c;
          slots[static_cast<long long>(q + b) * F] = m;
          if (j == n_seg - 1) run_wr[0] = m;
        }
      }
      group_sync(g);
      // eight lanes a (segment, field) pair, fields 1 .. F-1 (the weights, the
      // plain sums, weight x loc a feature): lane q8 sums samples lo + q8,
      // lo + q8 + 8, ..., three shuffles join the eight
      const int pairs = n_seg * (F - 1), q8 = lane & 7;
      for (int i0 = wg * 4; i0 < pairs; i0 += kGroupWarps * 4) {
        const int i = i0 + (lane >> 3);
        const int j = i / (F - 1), f = i - j * (F - 1) + 1, b = b_first + j;
        // (sSegM and sSegC, read below, hold the segments' max and rescale)
        float a = 0.f;
        if (i < pairs) {
          const int lo = max(s0, b * K) - s0, hi = min(s_end, (b + 1) * K) - s0;
          if (f < kSlotHead) {
            const float* v = f == 1 ? sE : f == 2 ? sImp : sExt;
            for (int sl = lo + q8; sl < hi; sl += 8) a += v[sl];
          } else {
            for (int sl = lo + q8; sl < hi; sl += 8) {
              a = fmaf(sE[sl], loc_buf[sl * loc_pitch + f - kSlotHead], a);
            }
          }
        }
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) a += __shfl_xor_sync(kFullWarp, a, m);
        if (i < pairs && q8 == 0) {
          if (j == 0 && cont) {
            const float old = run_rd[f];
            a = f == 2 || f == 3 ? old + a : fmaf(old, sSegC[0], a);
          }
          slots[static_cast<long long>(q + b) * F + f] = a;
          if (j == n_seg - 1) run_wr[f] = a;
        }
      }
      cur ^= 1;
      group_sync(g);  // sZ, sAct, the vectors (and a restaged sW3) are free
    }
  }

  // The last block of the replica to finish merges every row: the slots of
  // rows r0 .. r1-1 staged in shared memory (all of it: the decoder's and
  // the groups' buffers are free), a warp a row; a row whose slots alone do
  // not fit, by the whole block from device memory
  __threadfence();  // this block's slots, before its ticket
  __syncthreads();
  float* sm = reinterpret_cast<float*>(smem4);
  if (threadIdx.x == 0) {
    sm[0] = atomicAdd(tickets + rep, 1u) == gridDim.x - 1 ? 1.f : 0.f;
  }
  __syncthreads();
  if (sm[0] == 0.f) return;
  __syncthreads();  // every thread has read the flag
  __threadfence();
  float* x_imputed = p.x_imputed + rep * B * D;
  float* per_row = p.per_row + rep * 3 * B;
  const long long cap = smem_bytes(L) / static_cast<int>(sizeof(float));
  // rows a chunk, from a bound on a row's slots: a row spans at most
  // ceil(K / 64) + 1 tiles, and a range holds at least tiles / parts
  const long long row_slots =
      ((K + kT - 1) / kT + 1) / max(1, tiles / dm.parts) + 2;
  const int chunk_rows = static_cast<int>(max(1LL, cap / (row_slots * F)));
  for (int r0 = 0, r1; r0 < B; r0 = r1) {
    r1 = min(B, r0 + chunk_rows);
    const long long first = slot_begin(r0, dm, tiles);
    const long long span = (slot_end(r1 - 1, dm, tiles) - first) * F;
    if (span > cap) {  // one row (chunk_rows is 1) larger than the memory
      merge_row_block(slots + first * F, r0,
                      static_cast<int>(span / F), dm, x_imputed, per_row, sm);
      continue;
    }
    // sixteen loads in flight a thread
    const float* src = slots + first * F;
    for (long long i0 = threadIdx.x; i0 < span; i0 += 16 * kThreads) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long i = i0 + k * kThreads;
        v[k] = i < span ? __ldcg(src + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long i = i0 + k * kThreads;
        if (i < span) sm[i] = v[k];
      }
    }
    __syncthreads();
    for (int b = r0 + (threadIdx.x >> 5); b < r1; b += kThreads / 32) {
      const long long sb = slot_begin(b, dm, tiles);
      merge_row_warp(sm + (sb - first) * F, b,
                     static_cast<int>(slot_end(b, dm, tiles) - sb), dm,
                     x_imputed, per_row, threadIdx.x & 31);
    }
    __syncthreads();
  }
}

}  // namespace

// Launches IW1 on `stream`: the encoder, grid (ceil(B / 4), R), then the
// body, grid (dims.blocks, R); returns the first cudaGetLastError() that is
// not a success (a launch the card refuses never runs, and only this reports
// it). The caller's current device is restored before returning.
extern "C" int vpc_iw_decode(const IwPointers* p, const IwStrides* s,
                             const IwDims* d, int device, void* stream) {
  if (d->R < 1 || d->R > 65535 || d->B < 1 || d->K < 1 || d->D < 1 ||
      d->L < 1 || d->L > kMaxL || d->B_extra < 0 || d->B_extra > d->B ||
      d->blocks < 1 || d->parts < 1 ||
      static_cast<long long>(d->parts) * kT >
          static_cast<long long>(d->B) * d->K + kT - 1 ||
      (d->B_extra > 0) != (p->extra != nullptr) ||
      d->work_floats != work_floats(*d) || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  static int allowed[kMaxDevices] = {};
  const int bytes = smem_bytes(d->L);
  if (allowed[device] < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        iw_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = bytes;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  unsigned* tickets =
      reinterpret_cast<unsigned*>(p->work + d->R * replica_floats(*d));
  iw_encode_kernel<<<dim3((d->B + kEncRows - 1) / kEncRows, d->R),
                     kEncThreads, 0, st>>>(*p, *s, *d, tickets);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (d->D + kChunkF - 1) / kChunkF;
  iw_decode_kernel<<<dim3(d->blocks, d->R), kThreads, bytes, st>>>(
      *p, *s, *d, n_chunks, tickets);
  return static_cast<int>(cudaGetLastError());
}
