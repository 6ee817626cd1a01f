// Fused posterior tail, forward, for sm_90a.
//
//     z_q = mean_q + eps_q * exp(logvar_q / 2),  z_p likewise,
//     kl[0] = sum KL(N(mean_q, e^logvar_q) || N(0, I)),
//     kl[1] = the same for the p branch,
//     kl[2] = sum KL(q || p)
//
// over all B*L cells. Replaces the Pallas TPU kernel in
// vae_posterior_consistency_tpu/ops/fused_posterior.py (`_kernel`, run by
// `_fused_forward_impl`). The backward is closed form and elementwise; the
// JAX package computes it outside any Pallas call, and so does the port
// (ops/fused_posterior.py).
//
// Bound. The function reads six [B,L] float32 inputs and writes two [B,L]
// outputs and three scalars once: 32*B*L bytes, about 20 KB at the training
// shape (B=64, L=10), or 6 ns at the H100's 3.35 TB/s. Its roughly 30
// float32 operations a cell (three of them exponentials) take less. So
// bytes bound it, and at these sizes the two launches cost far more.
//
// Design. The TPU kernel walks row blocks in order and carries the three sums
// in SMEM from one grid step to the next. Blocks on Hopper run in no order,
// so here a grid-stride pass over the cells writes z_q and z_p and keeps
// three partial sums per thread; a warp-shuffle and shared-memory reduction
// per block writes [n_blocks, 3] partials to a scratch buffer; a second
// one-block launch sums them in a fixed order. No atomics, so the result is
// the same from run to run. The loop bounds itself, so nothing is padded.
// Each input may have its own row stride (the statistics arrive as column
// halves of the encoder's output); columns are contiguous. The kernel
// allocates nothing: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include "vpc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
//: at most two blocks per SM on the H100's 132 SMs
constexpr int kMaxBlocks = 264;

struct Inputs {
  const float* mq;
  const float* lq;
  const float* mp;
  const float* lp;
  const float* eq;
  const float* ep;
  int ld_mq, ld_lq, ld_mp, ld_lp, ld_eq, ld_ep;
};

// Sums v[0..2] over the block; thread 0 holds the result.
__device__ void block_sum3(float v[3]) {
  __shared__ float partial[kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
    }
    if (lane == 0) partial[warp][j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += partial[w][j];
      v[j] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_posterior_kernel(Inputs in, float* __restrict__ z_q,
                           float* __restrict__ z_p,
                           float* __restrict__ partials, int B, int L) {
  float acc[3] = {0.f, 0.f, 0.f};
  const long long n = static_cast<long long>(B) * L;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / L;
    const long long c = i - r * L;
    const float mq = in.mq[r * in.ld_mq + c];
    const float lq = in.lq[r * in.ld_lq + c];
    const float mp = in.mp[r * in.ld_mp + c];
    const float lp = in.lp[r * in.ld_lp + c];
    const float eq = in.eq[r * in.ld_eq + c];
    const float ep = in.ep[r * in.ld_ep + c];
    z_q[i] = mq + eq * expf(0.5f * lq);
    z_p[i] = mp + ep * expf(0.5f * lp);
    const float e_lq = expf(lq);
    const float e_lp = expf(lp);
    acc[0] += 0.5f * (e_lq + mq * mq - 1.f - lq);
    acc[1] += 0.5f * (e_lp + mp * mp - 1.f - lp);
    const float dm = mq - mp;
    acc[2] += 0.5f * (lp - lq + (e_lq + dm * dm) * expf(-lp) - 1.f);
  }
  block_sum3(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) partials[blockIdx.x * 3 + j] = acc[j];
  }
}

// One block: kl[j] = sum over blocks of partials[block, j], in a fixed order.
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ partials,
                        float* __restrict__ kl, int n_blocks) {
  float acc[3] = {0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[j] += partials[b * 3 + j];
  }
  block_sum3(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) kl[j] = acc[j];
  }
}

}  // namespace

// The number of blocks of the first pass, and so the rows of `partials`
// ([n_blocks, 3] float32) that the caller allocates for B*L cells.
extern "C" int vpc_fused_posterior_blocks(int B, int L) {
  const long long n = static_cast<long long>(B) * L;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// mq, lq, mp, lp, eq, ep: [B,L] float32 with row strides ld_* and contiguous
// columns; z_q, z_p: [B,L] contiguous; partials: [n_blocks, 3] scratch with
// n_blocks = vpc_fused_posterior_blocks(B, L); kl: [3]. All on `device`.
// Launches both passes on `stream` and returns cudaGetLastError().
extern "C" int vpc_fused_posterior_fwd(
    const float* mq, const float* lq, const float* mp, const float* lp,
    const float* eq, const float* ep, int ld_mq, int ld_lq, int ld_mp,
    int ld_lp, int ld_eq, int ld_ep, float* z_q, float* z_p, float* partials,
    float* kl, int B, int L, int device, void* stream) {
  if (B < 1 || L < 1 || ld_mq < L || ld_lq < L || ld_mp < L || ld_lp < L ||
      ld_eq < L || ld_ep < L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = vpc_fused_posterior_blocks(B, L);
  Inputs in{mq, lq, mp, lp, eq, ep, ld_mq, ld_lq, ld_mp, ld_lp, ld_eq, ld_ep};
  fused_posterior_kernel<<<n_blocks, kThreads, 0, st>>>(in, z_q, z_p,
                                                        partials, B, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, st>>>(partials, kl, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
