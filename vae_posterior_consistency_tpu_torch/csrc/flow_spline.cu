// F1: the flow posterior's forward spline stack in one launch, for sm_90a.
//
//     log_prob = -0.5 * z^2 - log sqrt(2 pi)                 (z = eps)
//     three times:  inside = -1 <= z <= 1,  s = inside ? z : 0,
//                   pos = ((s + 1) / 2) * nb,  b = clamp(floor(pos), 0, nb-1),
//                   alpha = pos - b,
//                   y = hardtanh(cdf[b] + alpha * pdf[b], 0, 1) * 2 - 1,
//                   l = log(pdf[b]) - log(1 / nb),
//                   'linear' tails: y = inside ? y : z,  l = inside ? l : 0,
//                   z = y,  log_det += l
//     returns z and log_prob - log_det
//
// per cell (row, latent dim) of eps [N, L], over the cell's bin tables pdf
// [N, L, nb] and cdf [N, L, nb + 1] (the softmax of the context's bin logits
// and its cumulative sum with exact 0 and 1 edges, which the caller computes
// once with torch's own operations). It is nn/flow.flow_forward without
// ActNorm: the three `unconstrained_linear_spline` layers, which share their
// tables (reference: src/models/VAE.py:1754-1774, 1829-1841). It replaces no
// TPU kernel: the JAX package computes the flow in plain jnp.
//
// Bits. The output equals the eager composition's bit for bit, so every
// spline bin the eager path picks, F1 picks. Eager PyTorch rounds after every
// operation, each its own kernel; nvcc at -O3 would contract a product and a
// sum into one FMA, which rounds once. So every product and sum here is an
// explicitly rounded __fmul_rn / __fadd_rn / __fsub_rn. Torch's CUDA kernels
// divide by a Python scalar as a product with its reciprocal; the only such
// division, by 2, is exact either way. The constants arrive as the float32
// values torch makes of the Python scalars (the wrapper's c_float). `logf` is
// the accurate logarithm torch's `log` calls, and the clip returns the quiet
// NaN torch.maximum returns for a NaN.
//
// Bound. Each cell reads eps, six table floats and writes two floats: about
// 36 bytes, 23 KB at the evaluation batch [64, 10] (nb = 10), or 7 ns at the
// H100's 3.35 TB/s; its ~60 float32 operations take less. A launch costs far
// more, so the launch bounds it at these sizes. The eager stack is about 84
// launches.
//
// Design. One thread a cell, one grid-stride pass; the three layers stay in
// registers and each reads its two gathered table floats through the
// read-only cache (the tables of one cell are 21 floats, one or two cache
// lines). No shared memory, no atomics, the same bits every run. It allocates
// nothing: the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include "vpc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLayers = 3;
constexpr long long kMaxBlocks = 1 << 20;

struct Consts {
  float log_sqrt_2pi;  // ops/math._LOG_SQRT_2PI as float32
  float log_bin;       // log(1 / nb) as float32
};

// torch.minimum(torch.maximum(v, 0), 1) (nn/core.hardtanh)
__device__ __forceinline__ float clip01(float v) {
  if (v != v) return __int_as_float(0x7fc00000);
  return fminf(fmaxf(v, 0.f), 1.f);
}

__global__ void __launch_bounds__(kThreads)
    flow_spline_kernel(const float* __restrict__ eps,
                       const float* __restrict__ pdf,
                       const float* __restrict__ cdf, float* __restrict__ z_out,
                       float* __restrict__ lp_out, long long n, int nb,
                       int linear, Consts k) {
  const float nbf = static_cast<float>(nb);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float* p_row = pdf + i * nb;
    const float* c_row = cdf + i * (nb + 1);
    float z = eps[i];
    const float log_prob =
        __fsub_rn(__fmul_rn(-0.5f, __fmul_rn(z, z)), k.log_sqrt_2pi);
    float log_det = 0.f;
#pragma unroll
    for (int layer = 0; layer < kLayers; ++layer) {
      const bool inside = z >= -1.f && z <= 1.f;
      const float s = inside ? z : 0.f;
      const float pos = __fmul_rn(__fmul_rn(__fadd_rn(s, 1.f), 0.5f), nbf);
      int b = static_cast<int>(floorf(pos));
      b = b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b);
      const float alpha = __fsub_rn(pos, static_cast<float>(b));
      const float p = __ldg(p_row + b);
      const float c = __ldg(c_row + b);
      const float y = clip01(__fadd_rn(c, __fmul_rn(alpha, p)));
      float out = __fadd_rn(__fmul_rn(y, 2.f), -1.f);
      float l = __fsub_rn(logf(p), k.log_bin);
      if (linear) {
        out = inside ? out : z;
        l = inside ? l : 0.f;
      }
      z = out;
      log_det = __fadd_rn(log_det, l);
    }
    z_out[i] = z;
    lp_out[i] = __fsub_rn(log_prob, log_det);
  }
}

}  // namespace

// eps: [n] float32 (n = N * L cells); pdf: [n, nb], cdf: [n, nb + 1]; z,
// log_prob: [n]; all contiguous on `device`. `linear` 1 for the 'linear'
// tails, 0 for 'clamp'. One launch on `stream` (none for n = 0); returns
// cudaGetLastError().
extern "C" int vpc_flow_spline(const float* eps, const float* pdf,
                               const float* cdf, float* z, float* log_prob,
                               long long n, int nb, int linear,
                               float log_sqrt_2pi, float log_bin, int device,
                               void* stream) {
  if (n < 0 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  flow_spline_kernel<<<static_cast<int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      eps, pdf, cdf, z, log_prob, n, nb, linear,
      Consts{log_sqrt_2pi, log_bin});
  return static_cast<int>(cudaGetLastError());
}
