// Fused posterior tail, forward and backward, for sm_90a.
//
//     z_q = mean_q + eps_q * exp(logvar_q / 2),  z_p likewise,
//     kl[0] = sum KL(N(mean_q, e^logvar_q) || N(0, I)),
//     kl[1] = the same for the p branch,
//     kl[2] = sum KL(q || p)
//
// over all B*L cells. The forward replaces the Pallas TPU kernel in
// vae_posterior_consistency_tpu/ops/fused_posterior.py (`_kernel`, run by
// `_fused_forward_impl`). The backward is the closed form of the same file's
// `_bwd`, which the JAX package computes in jnp outside any Pallas call and
// XLA fuses into one elementwise pass; here it is one hand-written launch.
//
// Forward bound. Six [B,L] float32 inputs read and two [B,L] outputs and
// three scalars written once: 32*B*L bytes, about 20 KB at the training shape
// (B=64, L=10), or 6 ns at the H100's 3.35 TB/s. Its roughly 31 float32
// operations a cell (three of them exponentials) take less. So bytes bound
// it, and at these sizes the launch costs far more.
//
// Forward design. The TPU kernel walks row blocks in order and carries the
// three sums in SMEM from one grid step to the next. Here one block of 1024
// threads walks all the cells, one a thread a turn: it writes z_q and z_p
// and keeps three partial sums per thread, then warp shuffles and shared
// memory sum the block in a fixed order and thread 0 writes kl. One launch
// at every size, the same bits every run, and no state kept between calls.
// At the training shape (640 cells) each thread takes at most one cell, so
// its serial chain (index, six loads, five exponentials) is as short as it
// can be and 32 warps hide each other's latency. Larger inputs only add
// turns; a cross-block sum would pay for itself only far beyond the sizes
// the repo's configurations give (batch 64, latent 10).
//
// Backward bound. Six statistics, dz_q and dz_p read, and four gradients
// written (six with the eps gradients, which training never asks for): 48*B*L
// bytes (56*B*L), about 31 KB or 9 ns at [64, 10]; about 44 operations a cell,
// five of them exponentials, each computed once. Launch-bound at these shapes:
// the plain PyTorch closed form is 47 launches.
//
// Backward design. One grid-stride elementwise pass; dkl is read from device
// memory, so nothing waits on the host. dz_q and dz_p may have any strides,
// 0 included (a `.sum()` upstream hands them over expanded); dkl any stride.
// A null gradient pointer skips that output.
//
// Both: each statistic may have its own row stride (they arrive as column and
// row halves of the encoder's output); its columns are contiguous. The loops
// bound themselves, so nothing is padded. The kernels allocate nothing: the
// caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include "vpc_common.cuh"

namespace {

//: threads of the forward's one block, one cell each a turn
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
//: threads of a backward block, and at most eight blocks per SM
constexpr int kBwdThreads = 256;
constexpr int kMaxBwdBlocks = 1056;

struct Inputs {
  const float* mq;
  const float* lq;
  const float* mp;
  const float* lp;
  const float* eq;
  const float* ep;
  int ld_mq, ld_lq, ld_mp, ld_lp, ld_eq, ld_ep;
};

struct Cotangents {
  const float* dz_q;
  const float* dz_p;
  const float* dkl;
  // dz_q[r, c] = dz_q[r * rq + c * cq], dz_p likewise; dkl[j] = dkl[j * s]
  int rq, cq, rp, cp, s;
};

// Any pointer may be null: that gradient is not written.
struct Grads {
  float* mq;
  float* lq;
  float* mp;
  float* lp;
  float* eq;
  float* ep;
};

__device__ void warp_sum3(float v[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
    }
  }
}

// Sums v[0..2] over the forward block, each warp by shuffles, then the 32
// warps' sums by warp 0 in the same fixed order; thread 0 holds the result.
// Every thread of the block calls it.
__device__ void block_sum3(float v[3]) {
  static_assert(kWarps == 32, "warp 0 sums one value per warp");
  __shared__ float partial[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sum3(v);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) partial[j][warp] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = partial[j][lane];
    warp_sum3(v);
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_posterior_kernel(Inputs in, float* __restrict__ z_q,
                           float* __restrict__ z_p, float* __restrict__ kl,
                           int B, int L) {
  float acc[3] = {0.f, 0.f, 0.f};
  const long long n = static_cast<long long>(B) * L;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
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
    for (int j = 0; j < 3; ++j) kl[j] = acc[j];
  }
}

__global__ void __launch_bounds__(kBwdThreads)
    fused_posterior_bwd_kernel(Inputs in, Cotangents ct, Grads g, int B,
                               int L) {
  const float dklq = ct.dkl[0];
  const float dklp = ct.dkl[ct.s];
  const float dklreg = ct.dkl[2 * ct.s];
  const long long n = static_cast<long long>(B) * L;
  for (long long i = blockIdx.x * static_cast<long long>(kBwdThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kBwdThreads) {
    const long long r = i / L;
    const long long c = i - r * L;
    const float mq = in.mq[r * in.ld_mq + c];
    const float lq = in.lq[r * in.ld_lq + c];
    const float mp = in.mp[r * in.ld_mp + c];
    const float lp = in.lp[r * in.ld_lp + c];
    const float eq = in.eq[r * in.ld_eq + c];
    const float ep = in.ep[r * in.ld_ep + c];
    const float dz_q = ct.dz_q[r * ct.rq + c * ct.cq];
    const float dz_p = ct.dz_p[r * ct.rp + c * ct.cp];
    const float std_q = expf(0.5f * lq);
    const float std_p = expf(0.5f * lp);
    const float e_lq = expf(lq);
    const float e_lp = expf(lp);
    const float inv_e_lp = expf(-lp);
    const float dm = mq - mp;
    const float reg_m = dklreg * dm * inv_e_lp;
    if (g.mq) g.mq[i] = dz_q + dklq * mq + reg_m;
    if (g.lq) {
      g.lq[i] = dz_q * 0.5f * eq * std_q + dklq * 0.5f * (e_lq - 1.f) +
                dklreg * 0.5f * (e_lq * inv_e_lp - 1.f);
    }
    if (g.mp) g.mp[i] = dz_p + dklp * mp - reg_m;
    if (g.lp) {
      g.lp[i] = dz_p * 0.5f * ep * std_p + dklp * 0.5f * (e_lp - 1.f) +
                dklreg * 0.5f * (1.f - (e_lq + dm * dm) * inv_e_lp);
    }
    if (g.eq) g.eq[i] = dz_q * std_q;
    if (g.ep) g.ep[i] = dz_p * std_p;
  }
}

bool strides_ok(const Inputs& in, int L) {
  return in.ld_mq >= L && in.ld_lq >= L && in.ld_mp >= L && in.ld_lp >= L &&
         in.ld_eq >= L && in.ld_ep >= L;
}

}  // namespace

// mq, lq, mp, lp, eq, ep: [B,L] float32 with row strides ld_* and contiguous
// columns; z_q, z_p: [B,L] contiguous; kl: [3]. All on `device`. One launch
// of one block on `stream`; returns cudaGetLastError().
extern "C" int vpc_fused_posterior_fwd(
    const float* mq, const float* lq, const float* mp, const float* lp,
    const float* eq, const float* ep, int ld_mq, int ld_lq, int ld_mp,
    int ld_lp, int ld_eq, int ld_ep, float* z_q, float* z_p, float* kl, int B,
    int L, int device, void* stream) {
  Inputs in{mq, lq, mp, lp, eq, ep, ld_mq, ld_lq, ld_mp, ld_lp, ld_eq, ld_ep};
  if (B < 1 || L < 1 || !strides_ok(in, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  fused_posterior_kernel<<<1, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(in, z_q, z_p,
                                                                kl, B, L);
  return static_cast<int>(cudaGetLastError());
}

// The six statistics as for the forward; dz_q, dz_p: [B,L] float32 with
// strides (rq, cq) and (rp, cp), 0 allowed; dkl: [3] float32 with stride s;
// g_*: [B,L] contiguous, or null to skip that gradient. All on `device`.
// One launch on `stream`; returns cudaGetLastError().
extern "C" int vpc_fused_posterior_bwd(
    const float* mq, const float* lq, const float* mp, const float* lp,
    const float* eq, const float* ep, int ld_mq, int ld_lq, int ld_mp,
    int ld_lp, int ld_eq, int ld_ep, const float* dz_q, const float* dz_p,
    int rq, int cq, int rp, int cp, const float* dkl, int s, float* g_mq,
    float* g_lq, float* g_mp, float* g_lp, float* g_eq, float* g_ep, int B,
    int L, int device, void* stream) {
  Inputs in{mq, lq, mp, lp, eq, ep, ld_mq, ld_lq, ld_mp, ld_lp, ld_eq, ld_ep};
  if (B < 1 || L < 1 || !strides_ok(in, L) || rq < 0 || cq < 0 || rp < 0 ||
      cp < 0 || s < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const long long n = static_cast<long long>(B) * L;
  long long blocks = (n + kBwdThreads - 1) / kBwdThreads;
  if (blocks > kMaxBwdBlocks) blocks = kMaxBwdBlocks;
  Cotangents ct{dz_q, dz_p, dkl, rq, cq, rp, cp, s};
  Grads g{g_mq, g_lq, g_mp, g_lp, g_eq, g_ep};
  fused_posterior_bwd_kernel<<<static_cast<int>(blocks), kBwdThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      in, ct, g, B, L);
  return static_cast<int>(cudaGetLastError());
}
