// Fused EDDI embed + masked pool, forward and backward, for sm_90a.
//
//     out[s,b,k] = sum_d masks[s,b,d] * relu(x[b,d] * A[d,k] + C[d,k])
//
// Replaces the two Pallas TPU kernels in vae_posterior_consistency_tpu/ops/
// fused_embed_pool.py: `_fwd_kernel` (run by `_fwd_call`) and `_bwd_kernel`
// (run by `_bwd_call`). Both kernels take A and C in the [D, K] row-major
// layout that models/layers._pointnet_affine gives, take any S >= 1, B >= 1,
// D >= 1 and K >= 1, launch once per call, and use no atomics: every output
// gets the same bits from run to run. They allocate nothing; the caller owns
// every buffer and the stream.
//
// Replicas. Every tensor carries a leading replica axis R (an ensemble's
// replicas, R = 1 for one run): x [R,B,D], masks [R,S,B,D], A and C [R,D,K],
// out [R,S,B,K], and the backward's dx, dm, dA, dC likewise. A and C are each
// replica's own weights, so R can fold neither into B nor into S; it is the
// grid's last axis, each block works on one replica's slices exactly as the
// one-replica kernel does (R = 1 is that kernel, bit for bit), and dA, dC sum
// over that replica's rows only. x and masks may have a replica stride of 0
// (one table shared by every replica).
//
// Forward.
// Bound. The function has to move x [B,D], masks [S,B,D], A and C [D,K] and
// out [S,B,K] once: about 3.3 MB at the serving shape (B=512, S=1, D=784,
// K=10), or about 1 us at the H100's 3.35 TB/s; its (3+2S)*B*D*K float32
// operations take about 0.3 us at 67 TFLOP/s. So bytes bound it.
// Design. A block takes a tile of rows and one chunk of at most 16 values of
// k (K > 16 puts further chunks on grid y). It copies its chunk of A and C
// into shared memory once with cp.async, interleaved as float2 (A, C) pairs
// [D][pitch], the pitch odd so a half-warp's 64-bit reads over d hit 16
// distinct bank pairs, and reuses them for every row of the tile: A and C
// cross from L2 once per block, not once per row. The block's 8 warps split
// into row slots x d segments (the wrapper picks both, and the tile, from
// B, D and K so that about one wave of blocks fills the card); a warp walks
// its row's segment with lanes over d, so reads of x and masks coalesce, and
// keeps SC*16 partial sums in registers (SC = 1 or 2 masks at a time; larger
// S loops over chunks of masks, recomputing the embed). At these sizes the
// latency of the loads, not their bytes, sets the time, so each lane loads
// x and masks for 4 values of d a chunk ahead of the arithmetic, and the
// first chunk's loads fly while A and C are copied in. Warp shuffles and
// one fixed-order pass over the segments in shared memory finish the sum
// over d. A tile of one row reads each value of A and C once, so there the
// kernel reads them from global memory instead of copying them first (which
// measured faster, engine/sweep_embed_pool.py), as it does when a chunk of
// them does not fit in shared memory (very large D).
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
// sequential grid; blocks on Hopper run in no order, and a reduction across
// blocks costs a second launch, atomics, or a cluster's synchronisations.
// So each block owns whole columns of dA and dC and walks every row: a warp's
// lanes take (d, k) pairs, floor(32 / kc) values of d times kc values of k
// (kc = K split into chunks of at most 32), so reads of A and C and writes
// of dA and dC coalesce, and a block of 8 warps covers those few d with its
// warps over the rows. Each lane keeps one dA and one dC partial sum in a
// register; the 8 warps' partials are added in shared memory in warp order.
// At D=784, K=10 that is 262 blocks of 3 d. A warp loads x, two masks and
// two rows of g for 8 rows at once before their arithmetic, so their
// latency is paid once per 8 rows. dx and dm are sums over k: the lanes of
// one d add their terms by shuffles in lane order and the first of them
// writes the result. K > 32 loops over chunks of k inside the kernel (dx
// and dm accumulate across chunks in the lane that writes them). dx and dm
// may each be skipped (a null pointer) when that input needs no gradient,
// which in training is both.

#include <cuda_runtime.h>

#include "vpc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
// values of k a thread keeps in registers at once
constexpr int kChunkK = 16;
// devices whose shared memory limit launch_fwd remembers having raised
constexpr int kMaxDevices = 64;
// values of d a forward lane loads at once, a chunk ahead of its arithmetic
constexpr int kFwdAhead = 4;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <int SC, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    embed_pool_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ masks,
                          const float* __restrict__ A,
                          const float* __restrict__ C,
                          float* __restrict__ out, int S, int B, int D, int K,
                          int k_chunk, int segments, int rows_per_block,
                          long long x_rs, long long m_rs) {
  extern __shared__ float2 ac[];  // [D][pitch]: (A, C) of this k chunk
  __shared__ float red[kWarps][SC * kChunkK];
  // this block's replica: its slices of every tensor
  const long long rep = blockIdx.z;
  x += rep * x_rs;
  masks += rep * m_rs;
  A += rep * D * static_cast<long long>(K);
  C += rep * D * static_cast<long long>(K);
  out += rep * S * static_cast<long long>(B) * K;
  const int kc0 = blockIdx.y * k_chunk;
  const int kw = min(k_chunk, K - kc0);
  const int pitch = kw | 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = warp % segments;
  const int slot = warp / segments;
  const int slots = kWarps / segments;
  const int seg_len = (D + segments - 1) / segments;
  const int d_lo = seg * seg_len;
  const int d_hi = min(D, d_lo + seg_len);
  const int b_begin = blockIdx.x * rows_per_block;
  const int b_end = min(B, b_begin + rows_per_block);

  // x and masks of kFwdAhead values of d a lane, loaded a chunk ahead of
  // the arithmetic, so a warp keeps 2 * kFwdAhead * (1 + SC) loads in flight
  float xv[kFwdAhead], mv[kFwdAhead][SC];
  auto load = [&](int b, int s0, int sw, int d0) {
#pragma unroll
    for (int j = 0; j < kFwdAhead; ++j) {
      const int d = d0 + lane + 32 * j;
      const bool ok = b < b_end && d < d_hi;
      xv[j] = ok ? x[static_cast<size_t>(b) * D + d] : 0.f;
#pragma unroll
      for (int s = 0; s < SC; ++s) {
        mv[j][s] = ok && s < sw
                       ? masks[(static_cast<size_t>(s0 + s) * B + b) * D + d]
                       : 0.f;
      }
    }
  };
  // the first chunk's loads fly while A and C are copied in
  load(b_begin + slot, 0, min(SC, S), d_lo);
  bool loaded = true;
  if (kStaged) {
    float* acf = reinterpret_cast<float*>(ac);
    for (int i = threadIdx.x; i < D * kw; i += kThreads) {
      const int d = i / kw;
      const int k = i - d * kw;
      const size_t src = static_cast<size_t>(d) * K + kc0 + k;
      float* dst = acf + 2 * (d * pitch + k);
      cp_async4(dst, A + src);
      cp_async4(dst + 1, C + src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  // every bound below is the same for the whole block, so each thread
  // reaches every __syncthreads and every lane of a warp every shuffle
  for (int b0 = b_begin; b0 < b_end; b0 += slots) {
    const int b = b0 + slot;
    for (int s0 = 0; s0 < S; s0 += SC) {
      const int sw = min(SC, S - s0);
      float acc[SC][kChunkK];
#pragma unroll
      for (int s = 0; s < SC; ++s) {
#pragma unroll
        for (int k = 0; k < kChunkK; ++k) acc[s][k] = 0.f;
      }
      for (int d0 = d_lo; d0 < d_hi; d0 += 32 * kFwdAhead) {
        if (!loaded) load(b, s0, sw, d0);
        float xc[kFwdAhead], mc[kFwdAhead][SC];
#pragma unroll
        for (int j = 0; j < kFwdAhead; ++j) {
          xc[j] = xv[j];
#pragma unroll
          for (int s = 0; s < SC; ++s) mc[j][s] = mv[j][s];
        }
        loaded = d0 + 32 * kFwdAhead < d_hi;
        if (loaded) load(b, s0, sw, d0 + 32 * kFwdAhead);
#pragma unroll
        for (int j = 0; j < kFwdAhead; ++j) {
          const int d = min(d0 + lane + 32 * j, D - 1);  // masked lanes: m=0
#pragma unroll
          for (int k = 0; k < kChunkK; ++k) {
            if (k < kw) {
              float a, c;
              if (kStaged) {
                const float2 v = ac[d * pitch + k];
                a = v.x;
                c = v.y;
              } else {
                const size_t i = static_cast<size_t>(d) * K + kc0 + k;
                a = __ldg(A + i);
                c = __ldg(C + i);
              }
              const float e = fmaxf(fmaf(xc[j], a, c), 0.f);
#pragma unroll
              for (int s = 0; s < SC; ++s) {
                acc[s][k] = fmaf(mc[j][s], e, acc[s][k]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < SC; ++s) {
#pragma unroll
        for (int k = 0; k < kChunkK; ++k) {
          if (k < kw) {
            float v = acc[s][k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              v += __shfl_xor_sync(kFullWarp, v, off);
            }
            if (lane == 0) red[warp][s * kChunkK + k] = v;
          }
        }
      }
      __syncthreads();
      // one output per thread: the row slot's segments summed in order
      for (int i = threadIdx.x; i < slots * SC * kw; i += kThreads) {
        const int sl = i / (SC * kw);
        const int r = i - sl * SC * kw;
        const int s = r / kw;
        const int k = r - s * kw;
        const int bb = b0 + sl;
        if (bb < b_end && s < sw) {
          float v = 0.f;
          for (int q = 0; q < segments; ++q) {
            v += red[sl * segments + q][s * kChunkK + k];
          }
          out[(static_cast<size_t>(s0 + s) * B + bb) * K + kc0 + k] = v;
        }
      }
      __syncthreads();
    }
  }
}

// Raises the kernel's dynamic shared memory limit on `device` once, to at
// least `bytes`.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int* allowed, int device, int bytes) {
  if (bytes <= 48 * 1024 || device < 0 || device >= kMaxDevices ||
      allowed[device] >= bytes) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[device] = bytes;
  return err;
}

template <int SC, bool kStaged>
cudaError_t launch_fwd(const float* x, const float* masks, const float* A,
                       const float* C, float* out, int S, int B, int D, int K,
                       int k_chunk, int segments, int rows_per_block,
                       long long x_rs, long long m_rs, int R, int device,
                       cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = embed_pool_fwd_kernel<SC, kStaged>;
  const int smem =
      kStaged ? D * (k_chunk | 1) * static_cast<int>(sizeof(float2)) : 0;
  cudaError_t err = allow_smem(kernel, allowed, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + rows_per_block - 1) / rows_per_block,
                  (K + k_chunk - 1) / k_chunk, R);
  kernel<<<grid, kThreads, smem, st>>>(x, masks, A, C, out, S, B, D, K,
                                       k_chunk, segments, rows_per_block,
                                       x_rs, m_rs);
  return cudaGetLastError();
}

// values of k the lanes of a backward warp take at once: one lane per (d, k)
constexpr int kBwdLanesK = 32;
// rows a backward warp loads at once, ahead of their arithmetic
constexpr int kBwdAhead = 8;

// The sum of v over the `width` lanes of this lane's segment, in lane order,
// in every lane (lanes past the last whole segment get a sum they ignore).
__device__ __forceinline__ float segment_sum(float v, int first, int width) {
  float t = 0.f;
  for (int j = 0; j < width; ++j) {
    t += __shfl_sync(kFullWarp, v, first + j);
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
    embed_pool_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ masks,
                          const float* __restrict__ A,
                          const float* __restrict__ C,
                          const float* __restrict__ g, float* __restrict__ dx,
                          float* __restrict__ dm, float* __restrict__ dA,
                          float* __restrict__ dC, int S, int B, int D, int K,
                          int k_chunk, long long x_rs, long long m_rs) {
  __shared__ float red[2][kWarps][32];  // the warps' dA, dC partials
  // this block's replica (grid y): its slices of every tensor
  {
    const long long rep = blockIdx.y;
    const long long DK = static_cast<long long>(D) * K;
    const long long BD = static_cast<long long>(B) * D;
    x += rep * x_rs;
    masks += rep * m_rs;
    A += rep * DK;
    C += rep * DK;
    g += rep * S * static_cast<long long>(B) * K;
    if (dx != nullptr) dx += rep * BD;
    if (dm != nullptr) dm += rep * S * BD;
    dA += rep * DK;
    dC += rep * DK;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = 32 / k_chunk;  // values of d a warp's lanes take
  const int dl = lane / k_chunk;
  const int first = dl * k_chunk;  // this lane's segment: lanes of one d
  const int d = blockIdx.x * per_warp + dl;
  const bool live = dl < per_warp && d < D;
  const bool leader = live && lane == first;
  const size_t BD = static_cast<size_t>(B) * D;

  for (int kc0 = 0; kc0 < K; kc0 += k_chunk) {
    const int k = kc0 + lane - first;
    const bool on = live && k < min(K, kc0 + k_chunk);
    const size_t dk = static_cast<size_t>(d) * K + k;
    const float a = on ? A[dk] : 0.f;
    const float c = on ? C[dk] : 0.f;
    float da = 0.f, dc = 0.f;
    for (int b0 = warp; b0 < B; b0 += kWarps * kBwdAhead) {
      // the loads of kBwdAhead rows fly together
      float xv[kBwdAhead], m0[kBwdAhead], m1[kBwdAhead], g0[kBwdAhead],
          g1[kBwdAhead];
#pragma unroll
      for (int r = 0; r < kBwdAhead; ++r) {
        const int b = b0 + r * kWarps;
        const bool ok = live && b < B;
        const size_t bd = static_cast<size_t>(b) * D + d;
        const size_t bk = static_cast<size_t>(b) * K + k;
        xv[r] = ok ? x[bd] : 0.f;
        m0[r] = ok ? masks[bd] : 0.f;
        m1[r] = ok && S > 1 ? masks[BD + bd] : 0.f;
        g0[r] = ok && on ? g[bk] : 0.f;
        g1[r] = ok && on && S > 1 ? g[static_cast<size_t>(B) * K + bk] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBwdAhead; ++r) {
        const int b = b0 + r * kWarps;
        if (b >= B) break;  // the same for the whole warp
        const size_t bd = static_cast<size_t>(b) * D + d;
        const size_t bk = static_cast<size_t>(b) * K + k;
        const float pre = fmaf(xv[r], a, c);
        float gsum = fmaf(m0[r], g0[r], m1[r] * g1[r]);
        for (int s = 2; s < S; ++s) {
          const float gv = on ? g[s * static_cast<size_t>(B) * K + bk] : 0.f;
          const float ms = live ? masks[s * BD + bd] : 0.f;
          gsum = fmaf(ms, gv, gsum);
        }
        const float gact = pre > 0.f ? gsum : 0.f;
        da = fmaf(xv[r], gact, da);
        dc += gact;
        // dx and dm are sums over k: over the lanes of this lane's d
        if (dx != nullptr) {
          const float v = segment_sum(gact * a, first, k_chunk);
          if (leader) dx[bd] = kc0 == 0 ? v : dx[bd] + v;
        }
        if (dm != nullptr) {
          const float e = fmaxf(pre, 0.f);
          for (int s = 0; s < S; ++s) {
            const float gv =
                s == 0 ? g0[r]
                : s == 1 ? g1[r]
                : on ? g[s * static_cast<size_t>(B) * K + bk] : 0.f;
            const float v = segment_sum(e * gv, first, k_chunk);
            if (leader) {
              const size_t sbd = s * BD + bd;
              dm[sbd] = kc0 == 0 ? v : dm[sbd] + v;
            }
          }
        }
      }
    }
    // dA, dC: the 8 warps' partials summed in warp order
    red[0][warp][lane] = da;
    red[1][warp][lane] = dc;
    __syncthreads();
    if (threadIdx.x < 64) {
      const int q = threadIdx.x >> 5;  // 0: dA, 1: dC
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[q][w][lane];
      if (on) (q == 0 ? dA : dC)[dk] = v;
    }
    __syncthreads();  // `red` is free for the next chunk of k
  }
}

// The chunk of k that a backward warp's lanes take: K split into the fewest
// chunks of at most kBwdLanesK, as even as can be.
int bwd_k_chunk(int K) {
  const int n = (K + kBwdLanesK - 1) / kBwdLanesK;
  return (K + n - 1) / n;
}

}  // namespace

// x [R,B,D] with replica stride x_rs, masks [R,S,B,D] with replica stride
// m_rs (0 allowed: shared), A and C [R,D,K], g [R,S,B,K]; outputs dx [R,B,D]
// (or null to skip it), dm [R,S,B,D] (or null), dA and dC [R,D,K]. Float32,
// each replica's slice contiguous, on `device`; the caller's current device
// is restored before returning. Launches one kernel on `stream` and returns
// cudaGetLastError().
extern "C" int vpc_embed_pool_bwd(const float* x, const float* masks,
                                  const float* A, const float* C,
                                  const float* g, float* dx, float* dm,
                                  float* dA, float* dC, int S, int B, int D,
                                  int K, long long x_rs, long long m_rs,
                                  int R, int device, void* stream) {
  if (S < 1 || B < 1 || D < 1 || K < 1 || R < 1 || R > 65535 || x_rs < 0 ||
      m_rs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int k_chunk = bwd_k_chunk(K);
  const int per_block = 32 / k_chunk;
  const dim3 grid((D + per_block - 1) / per_block, R);
  embed_pool_bwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, masks, A, C, g, dx, dm, dA, dC, S, B, D, K, k_chunk, x_rs, m_rs);
  return static_cast<int>(cudaGetLastError());
}

// x [R,B,D] with replica stride x_rs, masks [R,S,B,D] with replica stride
// m_rs (0 allowed: shared), A and C [R,D,K], out [R,S,B,K]: float32, each
// replica's slice contiguous, on `device`; the caller's current device is
// restored before returning.
// The tiling comes from the wrapper (ops/fused_embed_pool.py `fwd_plan`):
// k_chunk (1..16) values of k per block, `segments` (1, 2, 4 or 8) d
// segments per row, rows_per_block rows per block, and whether A and C are
// staged in shared memory (`staged` 1) or read from global memory (0).
// Launches one kernel on `stream` and returns cudaGetLastError(): a launch
// the card refuses never runs, and only this return value reports it.
extern "C" int vpc_embed_pool_fwd(const float* x, const float* masks,
                                  const float* A, const float* C, float* out,
                                  int S, int B, int D, int K, int k_chunk,
                                  int segments, int rows_per_block, int staged,
                                  long long x_rs, long long m_rs, int R,
                                  int device, void* stream) {
  if (S < 1 || B < 1 || D < 1 || K < 1 || k_chunk < 1 || k_chunk > kChunkK ||
      rows_per_block < 1 || segments < 1 || kWarps % segments != 0 ||
      (K + k_chunk - 1) / k_chunk > 65535 || R < 1 || R > 65535 ||
      x_rs < 0 || m_rs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (S == 1) {
    err = staged ? launch_fwd<1, true>(x, masks, A, C, out, S, B, D, K,
                                       k_chunk, segments, rows_per_block,
                                       x_rs, m_rs, R, device, st)
                 : launch_fwd<1, false>(x, masks, A, C, out, S, B, D, K,
                                        k_chunk, segments, rows_per_block,
                                        x_rs, m_rs, R, device, st);
  } else {
    err = staged ? launch_fwd<2, true>(x, masks, A, C, out, S, B, D, K,
                                       k_chunk, segments, rows_per_block,
                                       x_rs, m_rs, R, device, st)
                 : launch_fwd<2, false>(x, masks, A, C, out, S, B, D, K,
                                        k_chunk, segments, rows_per_block,
                                        x_rs, m_rs, R, device, st);
  }
  return static_cast<int>(err);
}
