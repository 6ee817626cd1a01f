// Fused EDDI embed + masked pool, forward and backward, for sm_90a.
//
//     out[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])
//
// Replaces the two Pallas TPU kernels in vae_posterior_consistency_tpu/ops/
// fused_embed_pool.py: `_fwd_kernel` (run by `_fwd_call`) and `_bwd_kernel`
// (run by `_bwd_call`).
//
// Forward.
// Bound. The function has to move x [B,D], masks [S,B,D], A and C [D,K] and
// out [S,B,K] once. At the serving shape (B=512, S=1, D=784, K=10) that is
// about 3.3 MB, or about 1 us at the H100's 3.35 TB/s. Its (3+2S)*B*D*K
// float32 operations take about 0.3 us at 67 TFLOP/s. So bytes bound it, and
// at these sizes the launch costs more than either.
//
// Design. One block per batch row handles all S masks, so each embed value is
// computed once per (d, k) and multiplied by each mask; the [B, D, K] embed
// never exists in memory. Threads stride over d and keep S*K partial sums in
// registers, as many as the smallest of 8, 16 or 32 that holds K (a template
// argument, so the sums stay in registers and the block keeps few of them
// live). A warp-shuffle reduction and one shared-memory pass across warps
// finish the sum over d. A and C arrive transposed as a_t, c_t [K, D], so
// neighbouring threads read neighbouring addresses for every k. The loop over
// d is bounded by D itself, so nothing is padded. The kernel allocates
// nothing; the caller owns every buffer and the stream.
//
// Backward, given g = d loss / d out [S,B,K], with the embed recomputed:
//     gsum[b,d,k] = sum_s masks[s,b,d] * g[s,b,k] * (pre[b,d,k] > 0)
//     dx[b,d]     = sum_k gsum[b,d,k] * A[d,k]
//     dm[s,b,d]   = sum_k relu(pre[b,d,k]) * g[s,b,k]
//     dA[d,k]     = sum_b x[b,d] * gsum[b,d,k],  dC[d,k] = sum_b gsum[b,d,k]
// Bound. It reads x, masks, A, C and g and writes dx, dm, dA and dC once:
// about 1.3 MB at the training shape (S=2, B=64, D=784, K=10), or about
// 0.4 us at 3.35 TB/s; its (9+4S)*B*D*K float32 operations (17 a cell at
// S=2) take about 0.13 us at 67 TFLOP/s. So bytes bound it.
// Design. The TPU kernel accumulates dA and dC in one VMEM block across a
// sequential grid. Blocks on Hopper run in no order, so the backward is two
// passes without atomics. Pass 1: a 2-D grid, one block per (128 values of
// d, tile of kTileRows rows); each thread owns one d, keeps that d's
// A[d,:] and C[d,:] and its dA/dC partial sums in registers, and walks the
// tile's rows, with the tile's g[:, b, :] staged in shared memory. It writes
// dx and dm directly (coalesced over d) and its partial sums to a scratch
// buffer [n_tiles, 2, K, D]. Pass 2 sums the scratch over tiles in a fixed
// order into [2, K, D] (dA_t, dC_t), so the result is the same from run to
// run. dm may be skipped (a null pointer) when the masks need no gradient.

#include <cuda_runtime.h>

#include "vpc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kMaxS = 2;

template <int S, int KMAX>
__global__ void __launch_bounds__(kThreads)
    embed_pool_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ masks,
                          const float* __restrict__ a_t,
                          const float* __restrict__ c_t,
                          float* __restrict__ out, int B, int D, int K) {
  const int b = blockIdx.x;
  float acc[S][KMAX];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[s][k] = 0.f;
  }

  const float* x_row = x + static_cast<size_t>(b) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float xv = x_row[d];
    float m[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = masks[(static_cast<size_t>(s) * B + b) * D + d];
    }
    // fully unrolled with a guard, so acc stays in registers for any K <= KMAX
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const size_t kd = static_cast<size_t>(k) * D + d;
        const float e = fmaxf(xv * a_t[kd] + c_t[kd], 0.f);
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s][k] += m[s] * e;
      }
    }
  }

  __shared__ float partial[kWarps][S * KMAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      // K is the same for the whole block, so every lane takes this branch
      // together and the full-warp shuffle is safe
      if (k < K) {
        float v = acc[s][k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) partial[warp][s * K + k] = v;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * K; i += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += partial[w][i];
    const int s = i / K;
    const int k = i - s * K;
    out[(static_cast<size_t>(s) * B + b) * K + k] = v;
  }
}

template <int S>
void launch(const float* x, const float* masks, const float* a_t,
            const float* c_t, float* out, int B, int D, int K,
            cudaStream_t st) {
  if (K <= 8) {
    embed_pool_fwd_kernel<S, 8><<<B, kThreads, 0, st>>>(x, masks, a_t, c_t,
                                                        out, B, D, K);
  } else if (K <= 16) {
    embed_pool_fwd_kernel<S, 16><<<B, kThreads, 0, st>>>(x, masks, a_t, c_t,
                                                         out, B, D, K);
  } else {
    embed_pool_fwd_kernel<S, kMaxK><<<B, kThreads, 0, st>>>(x, masks, a_t,
                                                            c_t, out, B, D, K);
  }
}

constexpr int kBwdThreads = 128;
constexpr int kTileRows = 8;

template <int S, int KMAX>
__global__ void __launch_bounds__(kBwdThreads)
    embed_pool_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ masks,
                          const float* __restrict__ a_t,
                          const float* __restrict__ c_t,
                          const float* __restrict__ g,
                          float* __restrict__ dx, float* __restrict__ dm,
                          float* __restrict__ partial, int B, int D, int K) {
  __shared__ float g_tile[S][kTileRows][KMAX];
  const int tile = blockIdx.y;
  const int b0 = tile * kTileRows;
  const int rows = min(kTileRows, B - b0);
  for (int i = threadIdx.x; i < S * kTileRows * KMAX; i += kBwdThreads) {
    const int s = i / (kTileRows * KMAX);
    const int r = (i / KMAX) % kTileRows;
    const int k = i % KMAX;
    g_tile[s][r][k] = (r < rows && k < K)
                          ? g[(static_cast<size_t>(s) * B + b0 + r) * K + k]
                          : 0.f;
  }
  __syncthreads();

  const int d = blockIdx.x * kBwdThreads + threadIdx.x;
  if (d >= D) return;  // no block-wide sync below this point
  float a[KMAX], c[KMAX], da[KMAX], dc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const size_t kd = static_cast<size_t>(k) * D + d;
    a[k] = k < K ? a_t[kd] : 0.f;
    c[k] = k < K ? c_t[kd] : 0.f;
    da[k] = 0.f;
    dc[k] = 0.f;
  }
  for (int r = 0; r < rows; ++r) {
    const size_t bd = static_cast<size_t>(b0 + r) * D + d;
    const float xv = x[bd];
    float m[S], dms[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = masks[static_cast<size_t>(s) * B * D + bd];
      dms[s] = 0.f;
    }
    float dxv = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float pre = xv * a[k] + c[k];
        const float e = fmaxf(pre, 0.f);
        float gsum = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          gsum += m[s] * g_tile[s][r][k];
          dms[s] += e * g_tile[s][r][k];
        }
        const float gact = pre > 0.f ? gsum : 0.f;
        dxv += gact * a[k];
        da[k] += xv * gact;
        dc[k] += gact;
      }
    }
    dx[bd] = dxv;
    if (dm != nullptr) {
#pragma unroll
      for (int s = 0; s < S; ++s) dm[static_cast<size_t>(s) * B * D + bd] = dms[s];
    }
  }
  float* p = partial + static_cast<size_t>(tile) * 2 * K * D;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) {
      p[static_cast<size_t>(k) * D + d] = da[k];
      p[static_cast<size_t>(K + k) * D + d] = dc[k];
    }
  }
}

// dac[i] = sum over tiles t, in order, of partial[t, i], i < 2*K*D.
__global__ void __launch_bounds__(256)
    sum_tiles_kernel(const float* __restrict__ partial,
                     float* __restrict__ dac, int n, int n_tiles) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int t = 0; t < n_tiles; ++t) v += partial[static_cast<size_t>(t) * n + i];
  dac[i] = v;
}

template <int S>
void launch_bwd(const float* x, const float* masks, const float* a_t,
                const float* c_t, const float* g, float* dx, float* dm,
                float* partial, int B, int D, int K, cudaStream_t st) {
  const dim3 grid((D + kBwdThreads - 1) / kBwdThreads,
                  (B + kTileRows - 1) / kTileRows);
  if (K <= 8) {
    embed_pool_bwd_kernel<S, 8><<<grid, kBwdThreads, 0, st>>>(
        x, masks, a_t, c_t, g, dx, dm, partial, B, D, K);
  } else if (K <= 16) {
    embed_pool_bwd_kernel<S, 16><<<grid, kBwdThreads, 0, st>>>(
        x, masks, a_t, c_t, g, dx, dm, partial, B, D, K);
  } else {
    embed_pool_bwd_kernel<S, kMaxK><<<grid, kBwdThreads, 0, st>>>(
        x, masks, a_t, c_t, g, dx, dm, partial, B, D, K);
  }
}

}  // namespace

// The number of row tiles of the backward, and so the leading dimension of
// its scratch buffer `partial` ([n_tiles, 2, K, D] float32).
extern "C" int vpc_embed_pool_bwd_tiles(int B) {
  return (B + kTileRows - 1) / kTileRows;
}

// x [B,D], masks [S,B,D], a_t and c_t [K,D], g [S,B,K]; outputs dx [B,D],
// dm [S,B,D] (or null to skip it), dac [2,K,D] (dA transposed, then dC
// transposed); partial: scratch [vpc_embed_pool_bwd_tiles(B), 2, K, D].
// Float32, contiguous, on `device`. Launches both passes on `stream` and
// returns cudaGetLastError().
extern "C" int vpc_embed_pool_bwd(const float* x, const float* masks,
                                  const float* a_t, const float* c_t,
                                  const float* g, float* dx, float* dm,
                                  float* partial, float* dac, int S, int B,
                                  int D, int K, int device, void* stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxK || B < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    launch_bwd<1>(x, masks, a_t, c_t, g, dx, dm, partial, B, D, K, st);
  } else {
    launch_bwd<2>(x, masks, a_t, c_t, g, dx, dm, partial, B, D, K, st);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 2 * K * D;
  sum_tiles_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      partial, dac, n, vpc_embed_pool_bwd_tiles(B));
  return static_cast<int>(cudaGetLastError());
}

// x [B,D], masks [S,B,D], a_t and c_t [K,D], out [S,B,K]: float32, contiguous,
// on `device`. Launches on `stream` and returns cudaGetLastError(): a launch
// the card refuses never runs, and only this return value reports it.
extern "C" int vpc_embed_pool_fwd(const float* x, const float* masks,
                                  const float* a_t, const float* c_t,
                                  float* out, int S, int B, int D, int K,
                                  int device, void* stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxK || B < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    launch<1>(x, masks, a_t, c_t, out, B, D, K, st);
  } else {
    launch<2>(x, masks, a_t, c_t, out, B, D, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}
