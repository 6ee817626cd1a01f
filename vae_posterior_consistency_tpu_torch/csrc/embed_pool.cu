// Fused EDDI embed + masked pool, forward, for sm_90a.
//
//     out[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])
//
// Replaces the Pallas TPU kernel in vae_posterior_consistency_tpu/ops/
// fused_embed_pool.py (`_fwd_kernel`, run by `_fwd_call`). The backward
// (`_bwd_kernel`) is not ported here.
//
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

}  // namespace

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
