// Fused posterior tail, forward and backward, for sm_90a.
//
//     z_q = mean_q + eps_q * exp(logvar_q / 2),  z_p likewise,
//     kl[0] = sum KL(N(mean_q, e^logvar_q) || N(0, I)),
//     kl[1] = the same for the p branch,
//     kl[2] = sum KL(q || p)
//
// over all B*L cells of each replica. Every tensor carries a leading replica
// axis R (an ensemble's replicas, or R = 1 for one run): the inputs and z_q,
// z_p are [R, B, L] and kl is [R, 3]. The forward replaces the Pallas TPU kernel in
// vae_posterior_consistency_tpu/ops/fused_posterior.py (`_kernel`, run by
// `_fused_forward_impl`). The backward is the closed form of the same file's
// `_bwd`, which the JAX package computes in jnp outside any Pallas call and
// XLA fuses into one elementwise pass; here it is one hand-written launch.
//
// Forward bound. Six [B,L] float32 inputs read and two [B,L] outputs and
// three scalars written once: 32*B*L bytes, about 20 KB at the training shape
// (B=64, L=10), or 6 ns at the H100's 3.35 TB/s, R times that for R
// replicas. Its roughly 31 float32 operations a cell (three of them
// exponentials) take less. So bytes bound it, and at these sizes the launch
// costs far more.
//
// Forward design. The TPU kernel walks row blocks in order and carries the
// three sums in SMEM from one grid step to the next. Here one block of 1024
// threads walks all the cells of one replica, one a thread a turn: it writes
// z_q and z_p and keeps three partial sums per thread, then warp shuffles and
// shared memory sum the block in a fixed order and thread 0 writes that
// replica's kl. The grid has one block a replica, so a block sums only its
// own replica's cells (folding R into B would add the replicas' KLs
// together), and R = 1 is the one-block kernel of a single run, bit for bit.
// One launch at every size and every R, the same bits every run, and no state
// kept between calls.
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
// Backward design. One grid-stride elementwise pass over the R*B*L cells;
// each cell reads its replica's row of dkl from device memory, so nothing
// waits on the host. dz_q and dz_p may have any strides, 0 included (a
// `.sum()` upstream hands them over expanded); dkl any strides. A null
// gradient pointer skips that output.
//
// Both: each statistic may have its own replica and row strides (they arrive
// as column and row halves of the encoder's output; a replica stride of 0
// shares one tensor across replicas, as an ensemble whose replicas share
// their noise has it); its columns are contiguous. The loops bound
// themselves, so nothing is padded. The kernels allocate nothing: the
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

// statistic x of replica i, row r, column c: x[i * rs_x + r * ld_x + c]
struct Inputs {
  const float* mq;
  const float* lq;
  const float* mp;
  const float* lp;
  const float* eq;
  const float* ep;
  int ld_mq, ld_lq, ld_mp, ld_lp, ld_eq, ld_ep;
  long long rs_mq, rs_lq, rs_mp, rs_lp, rs_eq, rs_ep;
};

struct Cotangents {
  const float* dz_q;
  const float* dz_p;
  const float* dkl;
  // dz_q[i, r, c] = dz_q[i * iq + r * rq + c * cq], dz_p likewise;
  // dkl[i, j] = dkl[i * si + j * s]
  long long iq, ip, si;
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

// Block i takes replica i: its z_q, z_p cells and its row of kl.
__global__ void __launch_bounds__(kThreads)
    fused_posterior_kernel(Inputs in, float* __restrict__ z_q,
                           float* __restrict__ z_p, float* __restrict__ kl,
                           int B, int L) {
  float acc[3] = {0.f, 0.f, 0.f};
  const long long rep = blockIdx.x;
  const long long n = static_cast<long long>(B) * L;
  const float* mq_ = in.mq + rep * in.rs_mq;
  const float* lq_ = in.lq + rep * in.rs_lq;
  const float* mp_ = in.mp + rep * in.rs_mp;
  const float* lp_ = in.lp + rep * in.rs_lp;
  const float* eq_ = in.eq + rep * in.rs_eq;
  const float* ep_ = in.ep + rep * in.rs_ep;
  z_q += rep * n;
  z_p += rep * n;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const long long r = i / L;
    const long long c = i - r * L;
    const float mq = mq_[r * in.ld_mq + c];
    const float lq = lq_[r * in.ld_lq + c];
    const float mp = mp_[r * in.ld_mp + c];
    const float lp = lp_[r * in.ld_lp + c];
    const float eq = eq_[r * in.ld_eq + c];
    const float ep = ep_[r * in.ld_ep + c];
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
    for (int j = 0; j < 3; ++j) kl[rep * 3 + j] = acc[j];
  }
}

// Cell i of the R*B*L cells: replica i / (B*L), then row and column.
__global__ void __launch_bounds__(kBwdThreads)
    fused_posterior_bwd_kernel(Inputs in, Cotangents ct, Grads g, int R,
                               int B, int L) {
  const long long per = static_cast<long long>(B) * L;
  const long long n = per * R;
  for (long long i = blockIdx.x * static_cast<long long>(kBwdThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kBwdThreads) {
    const long long rep = i / per;
    const long long cell = i - rep * per;
    const long long r = cell / L;
    const long long c = cell - r * L;
    const float* dkl = ct.dkl + rep * ct.si;
    const float dklq = dkl[0];
    const float dklp = dkl[ct.s];
    const float dklreg = dkl[2 * ct.s];
    const float mq = in.mq[rep * in.rs_mq + r * in.ld_mq + c];
    const float lq = in.lq[rep * in.rs_lq + r * in.ld_lq + c];
    const float mp = in.mp[rep * in.rs_mp + r * in.ld_mp + c];
    const float lp = in.lp[rep * in.rs_lp + r * in.ld_lp + c];
    const float eq = in.eq[rep * in.rs_eq + r * in.ld_eq + c];
    const float ep = in.ep[rep * in.rs_ep + r * in.ld_ep + c];
    const float dz_q = ct.dz_q[rep * ct.iq + r * ct.rq + c * ct.cq];
    const float dz_p = ct.dz_p[rep * ct.ip + r * ct.rp + c * ct.cp];
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
         in.ld_eq >= L && in.ld_ep >= L && in.rs_mq >= 0 && in.rs_lq >= 0 &&
         in.rs_mp >= 0 && in.rs_lp >= 0 && in.rs_eq >= 0 && in.rs_ep >= 0;
}

}  // namespace

// mq, lq, mp, lp, eq, ep: [R,B,L] float32 with replica strides rs_* (0
// allowed), row strides ld_* and contiguous columns; z_q, z_p: [R,B,L]
// contiguous; kl: [R,3] contiguous. All on `device`. One launch of R blocks
// on `stream`; returns cudaGetLastError().
extern "C" int vpc_fused_posterior_fwd(
    const float* mq, const float* lq, const float* mp, const float* lp,
    const float* eq, const float* ep, int ld_mq, int ld_lq, int ld_mp,
    int ld_lp, int ld_eq, int ld_ep, long long rs_mq, long long rs_lq,
    long long rs_mp, long long rs_lp, long long rs_eq, long long rs_ep,
    float* z_q, float* z_p, float* kl, int R, int B, int L, int device,
    void* stream) {
  Inputs in{mq,    lq,    mp,    lp,    eq,    ep,    ld_mq, ld_lq, ld_mp,
            ld_lp, ld_eq, ld_ep, rs_mq, rs_lq, rs_mp, rs_lp, rs_eq, rs_ep};
  if (R < 1 || B < 1 || L < 1 || !strides_ok(in, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  fused_posterior_kernel<<<R, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(in, z_q, z_p,
                                                                kl, B, L);
  return static_cast<int>(cudaGetLastError());
}

// The six statistics as for the forward; dz_q, dz_p: [R,B,L] float32 with
// strides (iq, rq, cq) and (ip, rp, cp), 0 allowed; dkl: [R,3] float32 with
// strides (si, s); g_*: [R,B,L] contiguous, or null to skip that gradient.
// All on `device`. One launch on `stream`; returns cudaGetLastError().
extern "C" int vpc_fused_posterior_bwd(
    const float* mq, const float* lq, const float* mp, const float* lp,
    const float* eq, const float* ep, int ld_mq, int ld_lq, int ld_mp,
    int ld_lp, int ld_eq, int ld_ep, long long rs_mq, long long rs_lq,
    long long rs_mp, long long rs_lp, long long rs_eq, long long rs_ep,
    const float* dz_q, const float* dz_p, long long iq, int rq, int cq,
    long long ip, int rp, int cp, const float* dkl, long long si, int s,
    float* g_mq, float* g_lq, float* g_mp, float* g_lp, float* g_eq,
    float* g_ep, int R, int B, int L, int device, void* stream) {
  Inputs in{mq,    lq,    mp,    lp,    eq,    ep,    ld_mq, ld_lq, ld_mp,
            ld_lp, ld_eq, ld_ep, rs_mq, rs_lq, rs_mp, rs_lp, rs_eq, rs_ep};
  if (R < 1 || B < 1 || L < 1 || !strides_ok(in, L) || iq < 0 || rq < 0 ||
      cq < 0 || ip < 0 || rp < 0 || cp < 0 || si < 0 || s < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const long long n = static_cast<long long>(R) * B * L;
  long long blocks = (n + kBwdThreads - 1) / kBwdThreads;
  if (blocks > kMaxBwdBlocks) blocks = kMaxBwdBlocks;
  Cotangents ct{dz_q, dz_p, dkl, iq, ip, si, rq, cq, rp, cp, s};
  Grads g{g_mq, g_lq, g_mp, g_lp, g_eq, g_ep};
  fused_posterior_bwd_kernel<<<static_cast<int>(blocks), kBwdThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      in, ct, g, R, B, L);
  return static_cast<int>(cudaGetLastError());
}
