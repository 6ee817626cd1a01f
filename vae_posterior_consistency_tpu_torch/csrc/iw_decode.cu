// IW1: the importance-weighted MIWAE terms over B x K samples, for sm_90a.
//
// For every sample s = (b, k) of a [B, K] stream, with the encoder's mean and
// scale [B, L], the noise eps [B, K, L] and the Student-t decoder's three
// dense layers (w [fan_in, fan_out], b [fan_out], widths L-128-128-3D):
//
//     z      = mean_b + scale_b * eps_s
//     h1     = relu(z W1 + b1),  h2 = relu(h1 W2 + b2),  o = h2 W3 + b3
//     loc    = sigmoid(o[:D]),   sc = softplus(o[D:2D]) + 0.001,
//     df     = softplus(o[2D:]) + 3
//     lp_d   = log StudentT(x_bd; loc_d, sc_d, df_d)
//     terms  = [sum_d mask_bd lp_d, sum_d (1 - mask_bd) lp_d,
//               sum_l log N(z_l; 0, 1), sum_l log N(z_l; mean_bl, scale_bl),
//               sum_d extra_bd lp_d (rows b < B_extra; 0 on the others)]
//
// written out as x_mean = loc [B, K, D] and terms [4 or 5, B, K] (the fifth
// only where `extra` is given). h1, h2, o and lp never reach device memory.
// The formulas are those of models/miwae.forward and _branch_terms in float32
// (torch's softplus with threshold 20, sigmoid as 1 / (1 + exp(-x)), lgammaf,
// log1pf); z's product and sum are rounded apart, as the two PyTorch
// operations round them. Every tensor carries a leading replica axis R (an
// ensemble's replicas, R = 1 for one run), each replica with its own decoder.
//
// It replaces no TPU kernel: the JAX package computes MIWAE in plain jnp. It
// was added because that composition, ported as it was, spent most of a
// `miwae_wine.eval` batch moving bytes: each 128-wide hidden layer wrote a
// [B*K, 128] float32 tensor (164 MB at B = 64, K = 5000) and read and wrote
// it twice more for the bias and the ReLU, and the head and the density made
// a dozen more passes, in about 40 launches.
//
// Bound. A sample costs 2 * (10*128 + 128*128 + 128*39) = 45,312 FLOP of
// dense products at L = 10, D = 13, against about 100 bytes it must move (eps
// in, x_mean and its sums out). So operations bound it: 14.50 GFLOP at
// B = 64, K = 5000, or 0.216 ms at the H100's 67 TFLOP/s of float32 FMA
// outside the tensor cores (TF32 stays off: the configuration states
// float32). The density adds about 13 transcendental-heavy evaluations a
// sample on the SFUs.
//
// Design. A persistent grid (about one block an SM; replicas on grid y): each
// block copies its replica's decoder (W2 [128][128], W1 [L][128], the biases:
// 71 KB at L = 10) into shared memory once. Its 512 threads are two groups
// of 8 warps that work apart, each on its own tiles of 64 consecutive samples
// of the flattened B*K axis (a tile may straddle rows: each sample reads its
// row as s / K) and synchronised by a named barrier of its own, so one
// group's barriers, loads and transcendentals overlap the other's products:
// with one group the SM's FMA pipes waited on those phases. A tile's z goes
// to shared memory; layers 1 and 2 are register-blocked SIMT products, 4
// samples x 8 units a thread (about 11 FMAs a 128-bit shared load), with bias
// and ReLU in the epilogue, h1 and h2 kept in one [64][132] buffer a group
// whose padded pitch keeps the head's loads free of bank conflicts. The head
// stages W3 transposed in chunks of 16 features (a buffer a group) and takes 4
// samples x 1 feature x 3 outputs a thread (a feature's location, scale and
// degrees of freedom together), then the activations and the log-density in
// registers, and sums over the features by warp shuffles. D <= 16 stages W3
// once; larger D loops over chunks, staging each anew a tile. Float32 FMA
// throughout, no atomics: the same inputs give the same bits every run.
// Nothing is allocated; the caller owns every buffer and the stream.

#include <cuda_runtime.h>

#include "vpc_common.cuh"

namespace {

constexpr int kH = 128;            // the decoder's hidden width
constexpr int kT = 64;             // samples a tile
constexpr int kGroups = 2;         // thread groups a block, each on its tiles
constexpr int kGroupThreads = 256;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kPitch = kH + 4;     // row pitch of h and of W3's chunk
constexpr int kChunkF = 16;        // features a chunk of the head
constexpr int kCols = 3 * kChunkF; // W3 columns a chunk stages
constexpr int kMaxL = 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.918938533204672742f;  // 0.5 * log(2 pi)
constexpr float kPi = 3.14159265358979323846f;

}  // namespace

// The C interface (ops/fused_iw.py mirrors these three structs with ctypes).
// Rows have stride ld_*, replicas stride rs_* (0: one tensor shared by every
// replica); columns are contiguous, and so are eps and the decoder's leaves
// within a replica.
extern "C" {
struct IwPointers {
  const float* x;      // [R, B, D]
  const float* mask;   // [R, B, D]
  const float* extra;  // [R, B_extra, D], or null
  const float* mean;   // [R, B, L]
  const float* scale;  // [R, B, L]
  const float* eps;    // [R, B, K, L]
  const float* w1;     // [R, L, 128]
  const float* b1;     // [R, 128]
  const float* w2;     // [R, 128, 128]
  const float* b2;     // [R, 128]
  const float* w3;     // [R, 128, 3D]
  const float* b3;     // [R, 3D]
  float* x_mean;       // [R, B, K, D], contiguous
  float* terms;        // [R, 4 or 5, B, K], contiguous
};
struct IwStrides {
  long long ld_x, ld_mask, ld_extra, ld_mean, ld_scale;
  long long rs_x, rs_mask, rs_extra, rs_mean, rs_scale, rs_eps;
  long long rs_w1, rs_b1, rs_w2, rs_b2, rs_w3, rs_b3;
};
struct IwDims {
  int R, B, K, D, L, B_extra;
  int blocks;  // blocks a replica (grid x)
};
}

namespace {

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

__global__ void __launch_bounds__(kThreads, 1)
    iw_decode_kernel(IwPointers p, IwStrides st, IwDims dm, int n_chunks) {
  extern __shared__ float4 smem4[];
  const int L = dm.L, D = dm.D, K = dm.K;
  // samples; the wrapper keeps n * max(D, L, 5) below 2^31, so a replica's
  // indices fit an int
  const int n = dm.B * K;
  const int n_terms = p.extra != nullptr ? 5 : 4;
  // this block's replica (grid y): its slices of every tensor
  const long long rep = blockIdx.y;
  const float* x = p.x + rep * st.rs_x;
  const float* mask = p.mask + rep * st.rs_mask;
  const float* extra = p.extra != nullptr ? p.extra + rep * st.rs_extra
                                          : nullptr;
  const float* mean = p.mean + rep * st.rs_mean;
  const float* scale = p.scale + rep * st.rs_scale;
  const float* eps = p.eps + rep * st.rs_eps;
  const float* w3 = p.w3 + rep * st.rs_w3;
  const float* b3 = p.b3 + rep * st.rs_b3;
  float* x_mean = p.x_mean + rep * n * D;
  float* terms = p.terms + rep * n_terms * n;
  const int n_extra = dm.B_extra * K;

  // the block's decoder, then each group's head chunk and activations
  float* sW2 = reinterpret_cast<float*>(smem4);  // [128][128]
  float* sW1 = sW2 + kH * kH;                    // [L][128]
  float* sB1 = sW1 + L * kH;                     // [128]
  float* sB2 = sB1 + kH;                         // [128]
  const int g = threadIdx.x / kGroupThreads;     // this thread's group
  const int gt = threadIdx.x % kGroupThreads;    // its index in the group
  float* sW3 = sB2 + kH + g * (kCols * kPitch + kCols + kT * kPitch + kT * L);
  float* sB3 = sW3 + kCols * kPitch;             // [48]
  float* sAct = sB3 + kCols;                     // [64 samples][kPitch]
  float* sZ = sAct + kT * kPitch;                // [64 samples][L]

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
  const int tiles = (n + kT - 1) / kT;
  for (int tile = blockIdx.x * kGroups + g; tile < tiles;
       tile += gridDim.x * kGroups) {
    const int s0 = tile * kT;
    // z, rounded as mean + (scale * eps); zero past the last sample
    for (int i = gt; i < kT * L; i += kGroupThreads) {
      const int sl = i / L, l = i - sl * L;
      const int s = s0 + sl;
      float z = 0.f;
      if (s < n) {
        const int b = s / K;
        z = __fadd_rn(mean[b * st.ld_mean + l],
                      __fmul_rn(scale[b * st.ld_scale + l], eps[s * L + l]));
      }
      sZ[i] = z;
    }
    group_sync(g);
    // log p(z) and log q(z | x): four threads a sample, each over every
    // fourth latent, their sums joined by two shuffles
    {
      const int s = s0 + (gt >> 2), q4 = gt & 3;
      float pz = 0.f, q = 0.f;
      if (s < n) {
        const int b = s / K;
        for (int l = q4; l < L; l += 4) {
          const float z = sZ[(gt >> 2) * L + l];
          const float m = mean[b * st.ld_mean + l];
          const float sc = scale[b * st.ld_scale + l];
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
      if (q4 == 0 && s < n) {
        terms[2 * n + s] = pz;
        terms[3 * n + s] = q;
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
          const int s = s0 + sg + 16 * i;
          if (s >= n) continue;
          const int b = s / K;
          const float loc = sigmoid(o[i][0] + sB3[fg]);
          const float sc = softplus(o[i][1] + sB3[kChunkF + fg]) + 0.001f;
          const float df = softplus(o[i][2] + sB3[2 * kChunkF + fg]) + 3.f;
          const float lp = student_t_logpdf(x[b * st.ld_x + f], loc, sc, df);
          x_mean[s * D + f] = loc;
          const float m = mask[b * st.ld_mask + f];
          sums[i][0] += __fmul_rn(lp, m);
          sums[i][1] += __fmul_rn(lp, 1.f - m);
          if (extra != nullptr && s < n_extra) {
            sums[i][2] += __fmul_rn(lp, extra[b * st.ld_extra + f]);
          }
        }
      }
    }
    // the sums over a sample's features: its 16 lanes (fg) are adjacent
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
        const int s = s0 + sg + 16 * i;
        if (s >= n) continue;
        terms[s] = sums[i][0];
        terms[n + s] = sums[i][1];
        if (extra != nullptr) terms[4 * n + s] = s < n_extra ? sums[i][2] : 0.f;
      }
    }
    group_sync(g);  // sZ, sAct (and a restaged sW3) are free for the next
  }
}

int smem_bytes(int L) {
  return static_cast<int>(sizeof(float)) *
         (kH * kH + L * kH + 2 * kH +
          kGroups * (kCols * kPitch + kCols + kT * kPitch + kT * L));
}

}  // namespace

// Launches IW1 once on `stream`, grid (dims.blocks, dims.R), and returns
// cudaGetLastError() (a launch the card refuses never runs, and only this
// reports it); the caller's current device is restored before returning.
extern "C" int vpc_iw_decode(const IwPointers* p, const IwStrides* s,
                             const IwDims* d, int device, void* stream) {
  if (d->R < 1 || d->R > 65535 || d->B < 1 || d->K < 1 || d->D < 1 ||
      d->L < 1 || d->L > kMaxL || d->B_extra < 0 || d->B_extra > d->B ||
      d->blocks < 1 || (d->B_extra > 0) != (p->extra != nullptr) ||
      device < 0 || device >= kMaxDevices) {
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
  const int n_chunks = (d->D + kChunkF - 1) / kChunkF;
  iw_decode_kernel<<<dim3(d->blocks, d->R), kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(*p, *s, *d,
                                                          n_chunks);
  return static_cast<int>(cudaGetLastError());
}
