// IW1 and IW2: the importance-weighted evaluation steps of MIWAE (IW1) and of
// notMIWAE (IW2) over B x K samples, for sm_90a. One skeleton (the encoder
// launch, the body's tile schedule, its layer-1/2 products, the segment
// epilogue and the slot merge) is instantiated for each model by a policy
// (`Miwae`, `NotMiwae<Author>`) that holds what the models do not share: the
// networks' activation and heads, the per-sample terms and each row's fields.
//
// IW1. For the rows x, mask [B, D] of a stream, the noise eps [B, K, L], the
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
// their KL of the mean and scale rows on the host).
//
// IW2. For the rows x, mask [B, D], the noise eps [B, K, L], the encoder's
// trunk (D-128-128) and its mean and log-variance heads (128-L each), the
// decoder's trunk (L-128-128) and its mean and log-variance heads (128-D
// each), and the self-masking-known missingness model's W, b [D]; act is ELU
// ('changed') or tanh ('author'):
//
//     h      = act(act(x_b * mask_b E1 + e1) E2 + e2)
//     mean_b = h Em + em,  logvar_b = h Ev + ev   ('author': hardtanh(-10, 10))
//     z      = mean_b + exp(0.5 logvar_b) * eps_s
//     h1     = act(z W1 + b1),  h2 = act(h1 W2 + b2)
//     'changed': xm = sigmoid(h2 Wm + bm),  xv = hardtanh(h2 Wv + bv, -10, 0)
//     'author':  xm = h2 Wm + bm,           xv = log(softplus(h2 Wv + bv)^2)
//     RE     = -sum_d log N(x_bd m_bd; xm_d m_bd, exp(xv_d m_bd))
//     logit_d = -softplus(W_d) (xm_d (1 - m_bd) + x_bd m_bd - b_d)
//     log_ps = sum_d log Bernoulli(m_bd; sigmoid(logit_d))
//     l_w    = (RE + (log q(z) - log p(z))) - log_ps
//
// and for every row b, over its K samples (sign = -1 under fixed_iwae_bound,
// else +1):
//
//     x_imputed_b = sum_k softmax_k(-l_w)_k xm_k                      [D]
//     per_row     = [sign (logsumexp_k(sign l_w) - log K), mean_k RE]
//     mean_b, logvar_b                                                 [L]
//
// which models/notmiwae.eval_step returns. The imputation's weights and the
// bound take opposite signs of l_w unless the bound is fixed, so IW2 keeps two
// running maxima and two rescaled sums where IW1 keeps one.
//
// Nothing of size B x K reaches device memory: h1, h2, o, the per-feature
// terms and the weights stay on chip, and each range of tiles leaves only its
// partial reductions. The formulas are those of the models' eager modules in
// float32 (torch's softplus with threshold 20, ELU as expm1f below 0, sigmoid
// as 1 / (1 + exp(-x)), lgammaf, log1pf, logsumexp with a max of +-inf taken
// as 0); products and sums that PyTorch rounds apart are rounded apart. Every
// tensor carries a leading replica axis R (an ensemble's replicas, R = 1 for
// one run), each replica with its own networks.
//
// Neither replaces a TPU kernel: the JAX package computes both models in
// plain jnp. IW1 was added because that composition, ported as it was, spent
// a `miwae_wine.eval` batch first moving bytes (each 128-wide hidden layer
// wrote a [B*K, 128] float32 tensor, 164 MB at B = 64, K = 5000), then, once
// the decoder and the density were fused, dispatching the encoder's and the
// reductions' two dozen small operations from the host. IW2 for the same
// reason at 178 rows x 10,000 samples: each eager layer wrote 911 MB, its bias
// add and ELU read and wrote it again, and a dozen elementwise passes of the
// missingness model and the density followed.
//
// Bound. An IW1 sample costs 2 * (10*128 + 128*128 + 128*39) = 45,312 FLOP of
// dense products at L = 10, D = 13, against about 16 bytes it must move (its
// eps): 14.50 GFLOP at B = 64, K = 5000, or 0.216 ms at the H100's 67 TFLOP/s
// of float32 FMA outside the tensor cores (TF32 stays off: the configurations
// state float32). An IW2 sample costs 2 * (10*128 + 128*128 + 128*24) =
// 41,472 FLOP at L = 10, D = 12 (73.8 GFLOP, 1.10 ms at B = 178, K = 10,000),
// plus 256 ELUs (expm1f where negative) and a dozen transcendentals a feature
// on the SFUs. The encoders are under 0.1% of the rest.
//
// Design. Two launches on the caller's stream, from one call:
//
// 1. The encoder, a block of 512 threads for every 4 rows of every replica:
//    a hidden unit's dot product in four slices of FMA chains, joined in
//    order, its bias added after, as a float32 GEMM then the bias add round
//    it. It writes the posterior statistics and zeroes the replica's ticket
//    (IW2's block 0 also writes -softplus(W) to the workspace).
// 2. The body, a persistent grid (about one block an SM; replicas on grid
//    y): each block copies its replica's decoder trunk (W2 [128][128], W1
//    [L][128], the biases: 71 KB at L = 10) into shared memory once. Its 512
//    threads are two groups of 8 warps that work apart, each on its own
//    tiles of 64 consecutive samples of the flattened B*K axis (a tile may
//    straddle rows: each sample reads its row as s / K) and synchronised by
//    a named barrier of its own, so one group's barriers, loads and
//    transcendentals overlap the other's products. A tile's z goes to
//    shared memory; layers 1 and 2 are register-blocked SIMT products, 4
//    samples x 8 units a thread, with bias and activation in the epilogue,
//    h1 and h2 kept in one [64][132] buffer a group whose padded pitch keeps
//    the head's loads free of bank conflicts. The head stages its weights
//    transposed in chunks of 16 features (3 outputs a feature for IW1, 2 for
//    IW2) and takes 4 samples x 1 feature x every output a thread, then the
//    activations and the per-feature terms in registers, and sums over the
//    features by warp shuffles. D <= 16 stages the head once and keeps the
//    tile's imputation means in shared memory; larger D loops over chunks,
//    staging each anew a tile, and parks them in a global scratch of the
//    tile group's own.
//    The tiles are cut into `parts` ranges of consecutive tiles, one a tile
//    group on one replica (a group takes every W-th range where the grid
//    has fewer groups); the ranges, and so the sums, depend on the shapes
//    and the card's SM count alone, not on the number of replicas.
//    Epilogue: for each row segment of the tile (the samples of one row it
//    holds) a warp takes, for each weight family (IW1: log_w; IW2: -l_w and
//    sign l_w), the segment's max and its weights exp(arg - max); then eight
//    lanes a (segment, field) sum the field over the segment: each family's
//    weights, the plain sums, and the first family's weight x mean for each
//    of the D features. A segment that continues the row of the range's
//    previous tile takes the max of both and rescales the running sums by
//    exp(old max - new max). The range's partials of a row (the maxima, then
//    the sums) go to slot range + row of a workspace: slots are distinct,
//    since rows never decrease along the ranges, and a row's slots are
//    adjacent, about K / (64 x tiles a range) + 1 of them. The last block of
//    a replica to finish (an atomic ticket says which) merges every row's
//    slots in range order, rescaling each by exp(its max - the row's max):
//    it stages the slots of as many rows as fit into its shared memory, then
//    a warp a row reads them there (a row too large for it is read from
//    device memory by the whole block). Ranges keep that serial tail short:
//    slots a tile would be 79 a row at K = 5000, and merges by the group
//    that finished a row's last tile pile up on the groups they delay, which
//    then finish the next rows last too.
//
// Float32 FMA throughout; every sum runs in an order fixed by the shapes
// alone, never by which block finishes first, so the same inputs give the
// same bits every run. Nothing is allocated; the caller owns every buffer
// (the workspace included: `work_floats` floats, which the entry points
// check against their own count) and the stream.

#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

#include "vpc_common.cuh"

namespace {

constexpr int kH = 128;            // the hidden width of every network
constexpr int kT = 64;             // samples a tile
constexpr int kGroups = 2;         // thread groups a block, each on its tiles
constexpr int kGroupThreads = 256;
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kPitch = kH + 4;     // row pitch of h and of the head's chunk
constexpr int kChunkF = 16;        // features a chunk of the head
constexpr int kEncRows = 4;        // rows an encoder block
constexpr int kEncSlices = 4;      // slices of its dot products
static_assert(kEncSlices == kEncRows, "the encoder joins a row a slice");
constexpr int kEncThreads = kEncSlices * kH;
constexpr int kLocPitch = kChunkF + 1;  // row pitch of a tile's means, D <= 16
constexpr int kMaxL = 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kLogSqrt2Pi = 0.918938533204672742f;  // 0.5 * log(2 pi)
constexpr float kPi = 3.14159265358979323846f;

}  // namespace

// The C interface (ops/fused_iw.py and ops/fused_iw_mnar.py mirror these
// structs with ctypes). Rows have stride ld_*, replicas stride rs_* (0: one
// tensor shared by every replica); columns are contiguous, and so are eps and
// the networks' leaves within a replica. The outputs are contiguous.
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

struct MnarPointers {
  const float* x;      // [R, B, D]
  const float* mask;   // [R, B, D]
  const float* eps;    // [R, B, K, L]
  const float* ew1;    // the encoder's trunk: [R, D, 128]
  const float* eb1;    // [R, 128]
  const float* ew2;    // [R, 128, 128]
  const float* eb2;    // [R, 128]
  const float* emw;    // its mean head: [R, 128, L]
  const float* emb;    // [R, L]
  const float* evw;    // its log-variance head: [R, 128, L]
  const float* evb;    // [R, L]
  const float* w1;     // the decoder's trunk: [R, L, 128]
  const float* b1;     // [R, 128]
  const float* w2;     // [R, 128, 128]
  const float* b2;     // [R, 128]
  const float* xmw;    // its mean head: [R, 128, D]
  const float* xmb;    // [R, D]
  const float* xvw;    // its log-variance head: [R, 128, D]
  const float* xvb;    // [R, D]
  const float* W;      // the missingness model: [R, D]
  const float* Wb;     // [R, D]
  float* x_imputed;    // [R, B, D]
  float* per_row;      // [R, 2, B]
  float* mean;         // [R, B, L]
  float* logvar;       // [R, B, L]
  float* work;         // the workspace, work_floats floats
};
struct MnarStrides {
  long long ld_x, ld_mask;
  long long rs_x, rs_mask, rs_eps;
  long long rs_ew1, rs_eb1, rs_ew2, rs_eb2, rs_emw, rs_emb, rs_evw, rs_evb;
  long long rs_w1, rs_b1, rs_w2, rs_b2, rs_xmw, rs_xmb, rs_xvw, rs_xvb;
  long long rs_W, rs_Wb;
};
struct MnarDims {
  int R, B, K, D, L;
  int blocks;            // blocks a replica of the body (grid x)
  int parts;             // ranges of tiles, at most the tiles
  int author;            // not_miwae_type 'author' (1) or 'changed' (0)
  int fixed;             // fixed_iwae_bound: the bound's sign is -1
  float log_k;           // log K, rounded to float32 as PyTorch rounds it
  long long work_floats; // the workspace's size (ops/fused_iw_mnar)
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

// the larger, a NaN on either side kept, as torch's max keeps it
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.minimum(torch.maximum(v, lo), hi), a NaN kept
__device__ __forceinline__ float hardtanh(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    v = nan_max(v, __shfl_xor_sync(kFullWarp, v, m));
  }
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

// ops/math.normal_logpdf(x, mean, logvar) from d = x - mean, logvar and
// exp(-logvar): ((-0.5 d^2) exp(-logvar) - 0.5 logvar) - log sqrt(2 pi)
__device__ __forceinline__ float normal_logpdf(float d, float lv, float iv) {
  return __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, __fmul_rn(d, d)), iv),
                   __fmul_rn(0.5f, lv)) -
         kLogSqrt2Pi;
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The barrier of group g's 256 threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroupThreads)
               : "memory");
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

// The networks' hidden activations, as torch computes them
struct Relu {
  __device__ __forceinline__ static float apply(float v) { return relu(v); }
};
struct Elu {  // F.elu: expm1 below 0, a NaN kept
  __device__ __forceinline__ static float apply(float v) {
    return v > 0.f ? v : expm1f(v);
  }
};
struct Tanh {
  __device__ __forceinline__ static float apply(float v) { return tanhf(v); }
};

// ---------------------------------------------------------------------------
// The policies. Each names its C structs and its activation, and fixes:
//   kOuts   the head's outputs a feature;
//   kSums   a sample's sums over its features;
//   kExps   the weight families, each with its running max and weight sum;
//   kPlain  the plain sums a row (summed over K as they are);
//   kHead   a slot's floats before the D weighted means: the kExps maxima,
//           the kExps weight sums, the kPlain plain sums;
//   kPerRow the rows of its per_row output;
// and `stat_floats`, the floats of a replica's workspace after its slots and
// scratch that the model keeps there. Its `Rows` is a replica's view of the
// inputs inside the body; `EncHead` the encoder's head and outputs.

// IW1: one family (softmax of log_w), the sums over 1 - mask and `extra`
struct Miwae {
  using Ptrs = IwPointers;
  using Strides = IwStrides;
  using Dims = IwDims;
  using Act = Relu;
  static constexpr int kOuts = 3;   // loc, scale, df
  static constexpr int kSums = 3;   // lp under mask, 1 - mask, extra
  static constexpr int kExps = 1;   // log_w
  static constexpr int kPlain = 2;  // logpx_imp, the sum under extra
  static constexpr int kHead = 2 * kExps + kPlain;
  static constexpr int kPerRow = 3;  // per_row's rows

  __host__ __device__ static long long stat_floats(const Dims&) { return 0; }

  struct EncHead {
    const float* w3;  // [128, 2L]
    const float* b3;
    int L2;
    __device__ EncHead(const Ptrs& p, const Strides& st, const Dims& d,
                       long long rep, float*)
        : w3(p.ew3 + rep * st.rs_ew3), b3(p.eb3 + rep * st.rs_eb3),
          L2(2 * d.L) {}
    __device__ float w(int k, int o) const { return w3[k * L2 + o]; }
    __device__ float b(int o) const { return b3[o]; }
    // output o of row b: the mean, then softplus of the scale half
    __device__ void out(const Ptrs& p, const Dims& d, long long rep, int b,
                        int o, float v) const {
      const long long row = (rep * d.B + b) * d.L;
      if (o < d.L) {
        p.mean[row + o] = v;
      } else {
        p.scale[row + o - d.L] = softplus(v);
      }
    }
  };

  // the encoder's once-a-replica work, by block (0, rep)
  __device__ static void encode_once(const Ptrs&, const Strides&,
                                     const Dims&, long long rep, float*,
                                     unsigned* tickets) {
    if (threadIdx.x == 0) tickets[rep] = 0u;
  }

  struct Rows {
    const float* x;
    const float* mask;
    const float* extra;
    const float* mean;
    const float* scale;
    const float* w3;
    const float* b3;
    long long ld_x, ld_mask, ld_extra;
    int D, n_extra;
    __device__ Rows(const Ptrs& p, const Strides& st, const Dims& d,
                    long long rep, const float*)
        : x(p.x + rep * st.rs_x), mask(p.mask + rep * st.rs_mask),
          extra(p.extra != nullptr ? p.extra + rep * st.rs_extra : nullptr),
          mean(p.mean + rep * d.B * d.L), scale(p.scale + rep * d.B * d.L),
          w3(p.w3 + rep * st.rs_w3), b3(p.b3 + rep * st.rs_b3),
          ld_x(st.ld_x), ld_mask(st.ld_mask), ld_extra(st.ld_extra), D(d.D),
          n_extra(d.B_extra * d.K) {}

    // the head's weight of input k for output j of feature f, and its bias
    __device__ float head_w(int j, int f, int k) const {
      return w3[k * (3 * D) + j * D + f];
    }
    __device__ float head_b(int j, int f) const { return b3[j * D + f]; }

    // log N(z; mean_i, scale_i) of latent entry i
    __device__ float logq(int i, float z) const {
      const float sc = scale[i];
      const float u = (z - mean[i]) / sc;
      return (__fmul_rn(-0.5f, __fmul_rn(u, u)) - logf(sc)) - kLogSqrt2Pi;
    }

    // feature f of sample s (row b) from its head outputs o (biases at
    // sB3[j * 16 + fg]): its sums, and the mean the imputation weighs
    __device__ float feature(const float (&o)[kOuts], const float* sB3,
                             int fg, int f, int b, int s,
                             float (&sums)[kSums]) const {
      const float loc = sigmoid(o[0] + sB3[fg]);
      const float sc = softplus(o[1] + sB3[kChunkF + fg]) + 0.001f;
      const float df = softplus(o[2] + sB3[2 * kChunkF + fg]) + 3.f;
      const float lp = student_t_logpdf(x[b * ld_x + f], loc, sc, df);
      const float m = mask[b * ld_mask + f];
      sums[0] += __fmul_rn(lp, m);
      sums[1] += __fmul_rn(lp, 1.f - m);
      if (extra != nullptr && s < n_extra) {
        sums[2] += __fmul_rn(lp, extra[b * ld_extra + f]);
      }
      return loc;
    }

    // sample s's log_w and plain terms (plain[p * 64]) from its sums,
    // log p(z) and log q: log_w = (logpxobs + log p(z)) - log q
    __device__ void sample(const float (&sums)[kSums], float pz, float q,
                           int s, float* lw, float* plain) const {
      *lw = __fsub_rn(__fadd_rn(sums[0], pz), q);
      plain[0] = sums[1];
      plain[kT] = s < n_extra ? sums[2] : 0.f;
    }

    __device__ float weight_arg(int, float lw) const { return lw; }
  };

  // row b's per_row from the family's max M[0] and the sums h: the
  // weights', the plain ones
  __device__ static void row_out(const Dims& dm, int b, const float* M,
                                 const float* h, float* per_row) {
    per_row[b] = -(logf(h[0]) + M[0]);
    per_row[dm.B + b] = h[1] / dm.divisor;
    per_row[2 * dm.B + b] =
        b < dm.B_extra ? h[2] / static_cast<float>(dm.K) : 0.f;
  }
};

// IW2: the families -l_w (the imputation's softmax) and sign l_w (the
// bound's logsumexp), the plain sum of RE
template <bool Author>
struct NotMiwae {
  using Ptrs = MnarPointers;
  using Strides = MnarStrides;
  using Dims = MnarDims;
  using Act = typename std::conditional<Author, Tanh, Elu>::type;
  static constexpr int kOuts = 2;   // x_mean, x_logvar
  static constexpr int kSums = 2;   // the RE terms, the Bernoulli log-pmf
  static constexpr int kExps = 2;   // -l_w, sign l_w
  static constexpr int kPlain = 1;  // RE
  static constexpr int kHead = 2 * kExps + kPlain;
  static constexpr int kPerRow = 2;  // per_row's rows

  // exp(0.5 logvar) and exp(-logvar) [B, L], then -softplus(W) [D]
  __host__ __device__ static long long stat_floats(const Dims& d) {
    return 2LL * d.B * d.L + d.D;
  }

  struct EncHead {
    const float* wm;  // [128, L]
    const float* bm;
    const float* wv;
    const float* bv;
    float* stats;     // the replica's scale, exp(-logvar)
    int L;
    __device__ EncHead(const Ptrs& p, const Strides& st, const Dims& d,
                       long long rep, float* stats_)
        : wm(p.emw + rep * st.rs_emw), bm(p.emb + rep * st.rs_emb),
          wv(p.evw + rep * st.rs_evw), bv(p.evb + rep * st.rs_evb),
          stats(stats_), L(d.L) {}
    __device__ float w(int k, int o) const {
      return o < L ? wm[k * L + o] : wv[k * L + o - L];
    }
    __device__ float b(int o) const { return o < L ? bm[o] : bv[o - L]; }
    // output o of row b: the mean, then the log-variance with
    // exp(0.5 logvar) (z's scale, as torch.exp(0.5 * logvar)) and
    // exp(-logvar) (log q's)
    __device__ void out(const Ptrs& p, const Dims& d, long long rep, int b,
                        int o, float v) const {
      const long long row = (rep * d.B + b) * d.L;
      if (o < d.L) {
        p.mean[row + o] = v;
        return;
      }
      const float lv = Author ? hardtanh(v, -10.f, 10.f) : v;
      const int i = b * d.L + o - d.L;
      p.logvar[row + o - d.L] = lv;
      stats[i] = expf(__fmul_rn(0.5f, lv));
      stats[d.B * d.L + i] = expf(-lv);
    }
  };

  __device__ static void encode_once(const Ptrs& p, const Strides& st,
                                     const Dims& d, long long rep,
                                     float* stats, unsigned* tickets) {
    if (threadIdx.x == 0) tickets[rep] = 0u;
    const float* W = p.W + rep * st.rs_W;
    float* negsp = stats + 2LL * d.B * d.L;
    for (int f = threadIdx.x; f < d.D; f += blockDim.x) {
      negsp[f] = -softplus(W[f]);
    }
  }

  struct Rows {
    const float* x;
    const float* mask;
    const float* mean;
    const float* scale;
    const float* logvar;
    const float* ivar;
    const float* negsp;
    const float* Wb;
    const float* xmw;
    const float* xmb;
    const float* xvw;
    const float* xvb;
    long long ld_x, ld_mask;
    int D;
    float sign;
    __device__ Rows(const Ptrs& p, const Strides& st, const Dims& d,
                    long long rep, const float* stats)
        : x(p.x + rep * st.rs_x), mask(p.mask + rep * st.rs_mask),
          mean(p.mean + rep * d.B * d.L), scale(stats),
          logvar(p.logvar + rep * d.B * d.L), ivar(stats + d.B * d.L),
          negsp(stats + 2LL * d.B * d.L), Wb(p.Wb + rep * st.rs_Wb),
          xmw(p.xmw + rep * st.rs_xmw), xmb(p.xmb + rep * st.rs_xmb),
          xvw(p.xvw + rep * st.rs_xvw), xvb(p.xvb + rep * st.rs_xvb),
          ld_x(st.ld_x), ld_mask(st.ld_mask), D(d.D),
          sign(d.fixed ? -1.f : 1.f) {}

    __device__ float head_w(int j, int f, int k) const {
      return (j == 0 ? xmw : xvw)[k * D + f];
    }
    __device__ float head_b(int j, int f) const {
      return (j == 0 ? xmb : xvb)[f];
    }

    // log N(z; mean_i, exp(logvar_i)) of latent entry i
    __device__ float logq(int i, float z) const {
      return normal_logpdf(z - mean[i], logvar[i], ivar[i]);
    }

    // feature f of sample s (row b): the RE term log N(x m; xm m, xv m)
    // and the log-pmf of the mask under the self-masking logits of x_mixed
    // = xm (1 - m) + x m; returns xm, the mean the imputation weighs
    __device__ float feature(const float (&o)[kOuts], const float* sB3,
                             int fg, int f, int b, int,
                             float (&sums)[kSums]) const {
      const float vm = o[0] + sB3[fg];
      const float vv = o[1] + sB3[kChunkF + fg];
      float xm, xv;
      if (Author) {
        xm = vm;
        const float sd = softplus(vv);
        xv = logf(__fmul_rn(sd, sd));
      } else {
        xm = sigmoid(vm);
        xv = hardtanh(vv, -10.f, 0.f);
      }
      const float xb = x[b * ld_x + f];
      const float m = mask[b * ld_mask + f];
      const float lv = __fmul_rn(xv, m);
      sums[0] += normal_logpdf(__fsub_rn(__fmul_rn(xb, m), __fmul_rn(xm, m)),
                               lv, expf(-lv));
      const float mixed = __fadd_rn(__fmul_rn(xm, 1.f - m), __fmul_rn(xb, m));
      const float logit = __fmul_rn(negsp[f], mixed - Wb[f]);
      sums[1] += __fsub_rn(__fmul_rn(m, logit) - nan_max(logit, 0.f),
                           log1pf(expf(-fabsf(logit))));
      return xm;
    }

    // l_w = (RE + (log q - log p(z))) - log p(s|x), RE = -(its terms' sum)
    __device__ void sample(const float (&sums)[kSums], float pz, float q,
                           int, float* lw, float* plain) const {
      const float re = -sums[0];
      *lw = __fsub_rn(__fadd_rn(re, __fsub_rn(q, pz)), sums[1]);
      plain[0] = re;
    }

    __device__ float weight_arg(int e, float lw) const {
      return e == 0 ? -lw : sign * lw;
    }
  };

  // row b's per_row: sign (logsumexp_k(sign l_w) - log K) from the second
  // family's max and weight sum, and the mean of RE over K
  __device__ static void row_out(const Dims& dm, int b, const float* M,
                                 const float* h, float* per_row) {
    const float lse = (logf(h[1]) + M[1]) - dm.log_k;
    per_row[b] = dm.fixed ? -lse : lse;
    per_row[dm.B + b] = h[2] / static_cast<float>(dm.K);
  }
};

// ---------------------------------------------------------------------------
// The skeleton

// A replica's workspace: (parts + B) slots of D + kHead floats, then, for
// D > 16, a scratch for each tile group: the tile's means [64][D] and two
// running slots; then the model's statistics (`stat_floats`). The R tickets
// follow the replicas' workspaces.
template <class P>
__host__ __device__ long long slot_scratch_floats(const typename P::Dims& d) {
  const long long F = d.D + P::kHead;
  const long long slots = (static_cast<long long>(d.parts) + d.B) * F;
  const long long scratch =
      d.D > kChunkF
          ? static_cast<long long>(d.blocks) * kGroups * (kT * d.D + 2 * F)
          : 0;
  return slots + scratch;
}

template <class P>
__host__ __device__ long long replica_floats(const typename P::Dims& d) {
  return slot_scratch_floats<P>(d) + P::stat_floats(d);
}

template <class P>
long long work_floats(const typename P::Dims& d) {
  return d.R * replica_floats<P>(d) + d.R;  // the tickets, a float's room each
}

// The head's chunk c transposed into sW3 [kOuts * 16][kPitch] (row j*16 + f
// for output j of feature c*16 + f, zero past D) and its biases into sB3, by
// the 256 threads of a group (gt their index).
template <class P>
__device__ void stage_head(float* sW3, float* sB3,
                           const typename P::Rows& rows, int c, int D,
                           int gt) {
  constexpr int kCols = P::kOuts * kChunkF;
  for (int i = gt; i < kCols * kH; i += kGroupThreads) {
    const int row = i / kH, k = i - row * kH;
    const int j = row / kChunkF, f = c * kChunkF + row % kChunkF;
    sW3[row * kPitch + k] = f < D ? rows.head_w(j, f, k) : 0.f;
  }
  for (int i = gt; i < kCols; i += kGroupThreads) {
    const int j = i / kChunkF, f = c * kChunkF + i % kChunkF;
    sB3[i] = f < D ? rows.head_b(j, f) : 0.f;
  }
}

// act(acc + bias) of a thread's 4 x 8 block into sAct [64][kPitch]
template <class Act>
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
      v.x = Act::apply(acc[i][h * 4 + 0] + bias[col + 0]);
      v.y = Act::apply(acc[i][h * 4 + 1] + bias[col + 1]);
      v.z = Act::apply(acc[i][h * 4 + 2] + bias[col + 2]);
      v.w = Act::apply(acc[i][h * 4 + 3] + bias[col + 3]);
      *reinterpret_cast<float4*>(row + col) = v;
    }
  }
}

// The range that holds tile t: the last whose first tile is at most t
__device__ __forceinline__ long long range_of(long long t, int parts,
                                             long long tiles) {
  return ((t + 1) * parts - 1) / tiles;
}
// Row b's slots: those of the ranges q0 .. q1 that hold its first and last
// tiles, slot q + b
__device__ __forceinline__ long long slot_begin(int b, int K, int parts,
                                               long long tiles) {
  return range_of(static_cast<long long>(b) * K / kT, parts, tiles) + b;
}
__device__ __forceinline__ long long slot_end(int b, int K, int parts,
                                             long long tiles) {
  return range_of((static_cast<long long>(b + 1) * K - 1) / kT, parts,
                  tiles) +
         b + 1;
}

// Row b merged by one warp from its slots staged in shared memory at s:
// each family's max M (its slots' maxes, +-inf taken as 0 as torch's
// logsumexp takes them), each slot's max replaced by its weight exp(max -
// M), then field f by lane f - kExps (+ 32 c) over the slots in tile order:
// the weight sums and the means rescaled by their family's weights, the
// plain sums as they are.
template <class P>
__device__ void merge_row_warp(float* s, int b, int ns,
                               const typename P::Dims& dm, float* x_imputed,
                               float* per_row, int lane) {
  constexpr int kE = P::kExps;
  const int D = dm.D, F = D + P::kHead;
  float M[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    float m = -INFINITY;
    for (int j = lane; j < ns; j += 32) m = nan_max(m, s[j * F + e]);
    m = warp_max(m);
    if (isinf(m)) m = 0.f;
    M[e] = m;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    for (int j = lane; j < ns; j += 32) {
      s[j * F + e] = expf(s[j * F + e] - M[e]);
    }
  }
  __syncwarp();
  float S = 0.f;
  for (int f0 = kE; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    float a = 0.f;
    if (f >= 2 * kE && f < P::kHead) {
      for (int j = 0; j < ns; ++j) a += s[j * F + f];
    } else if (f < F) {
      const int e = f < 2 * kE ? f - kE : 0;
#pragma unroll 4
      for (int j = 0; j < ns; ++j) a = fmaf(s[j * F + e], s[j * F + f], a);
    }
    if (f0 == kE) {
      float h[P::kHead - kE];
#pragma unroll
      for (int t = 0; t < P::kHead - kE; ++t) {
        h[t] = __shfl_sync(kFullWarp, a, t);
      }
      S = h[0];
      if (lane == 0) P::row_out(dm, b, M, h, per_row);
    }
    if (f >= P::kHead && f < F) x_imputed[b * D + f - P::kHead] = a / S;
  }
}

// Row b merged by the whole block straight from device memory (its slots at
// g, more than shared memory holds), in the same order as merge_row_warp;
// sM [32] is scratch.
template <class P>
__device__ void merge_row_block(const float* g, int b, int ns,
                                const typename P::Dims& dm, float* x_imputed,
                                float* per_row, float* sM) {
  constexpr int kE = P::kExps;
  constexpr int kW = kThreads / 32;
  const int D = dm.D, F = D + P::kHead;
  const int tid = threadIdx.x, lane = tid & 31;
  float M[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    float m = -INFINITY;
    for (int j = tid; j < ns; j += kThreads) {
      m = nan_max(m, __ldcg(g + static_cast<long long>(j) * F + e));
    }
    m = warp_max(m);
    if (lane == 0) sM[tid >> 5] = m;
    __syncthreads();
    m = -INFINITY;
    for (int w = 0; w < kW; ++w) m = nan_max(m, sM[w]);
    if (isinf(m)) m = 0.f;
    M[e] = m;
    __syncthreads();  // every thread has read the warps' maxima
  }
  for (int f0 = kE; f0 < F; f0 += kThreads) {
    const int f = f0 + tid;
    const bool plain = f >= 2 * kE && f < P::kHead;
    const int e = f < 2 * kE ? f - kE : 0;
    float Me = M[0];
#pragma unroll
    for (int i = 1; i < kE; ++i) Me = e == i ? M[i] : Me;
    float a = 0.f;
    for (int j = 0; f < F && j < ns; ++j) {
      const float* slot = g + static_cast<long long>(j) * F;
      const float v = __ldcg(slot + f);
      a = plain ? a + v : fmaf(expf(__ldcg(slot + e) - Me), v, a);
    }
    if (f0 == kE && tid < P::kHead - kE) sM[kW + tid] = a;
    __syncthreads();
    const float S = sM[kW];
    if (f0 == kE && tid == 0) {
      float h[P::kHead - kE];
#pragma unroll
      for (int t = 0; t < P::kHead - kE; ++t) h[t] = sM[kW + t];
      P::row_out(dm, b, M, h, per_row);
    }
    if (f >= P::kHead && f < F) x_imputed[b * D + f - P::kHead] = a / S;
    __syncthreads();
  }
}

// The encoder: the posterior statistics [R, B, L] for rows blockIdx.x * 4 + r
// of replica blockIdx.y. Thread (ks, u) sums slice ks of hidden unit u's dot
// products for the block's rows (inputs ks, ks + 4, ... of layer 1; a quarter
// of layer 2's 128), the four slices are joined in order and the bias added
// after; the head's (row, output) pairs take its 128 inputs in two halves.
// Block (0, rep) does the replica's once-only work (its ticket).
template <class P>
__global__ void __launch_bounds__(kEncThreads)
    iw_encode_kernel(typename P::Ptrs p, typename P::Strides st,
                     typename P::Dims dm, unsigned* tickets) {
  __shared__ float sPart[kEncSlices][kEncRows][kH];
  __shared__ float sH[kEncRows][kH];
  const int D = dm.D, L2 = 2 * dm.L, tid = threadIdx.x;
  const int ks = tid / kH, u = tid % kH;
  const long long rep = blockIdx.y;
  const int b0 = blockIdx.x * kEncRows;
  const int rows = min(kEncRows, dm.B - b0);
  float* stats = p.work + rep * replica_floats<P>(dm) +
                 slot_scratch_floats<P>(dm);
  if (blockIdx.x == 0) P::encode_once(p, st, dm, rep, stats, tickets);
  const float* x = p.x + rep * st.rs_x + b0 * st.ld_x;
  const float* mask = p.mask + rep * st.rs_mask + b0 * st.ld_mask;
  const float* w1 = p.ew1 + rep * st.rs_ew1;
  const float* w2 = p.ew2 + rep * st.rs_ew2;
  const typename P::EncHead head(p, st, dm, rep, stats);
  // slice ks's partial sums, joined by thread (r, u) into act(sum + bias)
  auto join = [&](const float* bias) {
    const int r = ks;  // one row a slice's threads
    const float h = ((sPart[0][r][u] + sPart[1][r][u]) + sPart[2][r][u]) +
                    sPart[3][r][u];
    sH[r][u] = P::Act::apply(h + bias[u]);
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
  // half of the inputs
  const int i = tid % 256, half = tid / 256;
  float a = 0.f;
  if (i < rows * L2) {
    const int r = i / L2, o = i - r * L2;
#pragma unroll 16
    for (int kk = 0; kk < kH / 2; ++kk) {
      const int k = half * (kH / 2) + kk;
      a = fmaf(sH[r][k], head.w(k, o), a);
    }
  }
  float* part = &sPart[0][0][0];
  part[tid] = a;
  __syncthreads();
  if (half == 0 && i < rows * L2) {
    const int r = i / L2, o = i - r * L2;
    head.out(p, dm, rep, b0 + r, o, (part[i] + part[256 + i]) + head.b(o));
  }
}

// Two running slots (D <= 16), rounded up to whole float4s so that the next
// group's part starts 16-byte aligned
template <class P>
__host__ __device__ constexpr int run_floats() {
  return (2 * (kChunkF + P::kHead) + 3) / 4 * 4;
}

// The floats of one group's part of shared memory, a multiple of 4
template <class P>
__host__ __device__ constexpr int group_floats(int L) {
  // the head's chunk and biases, sAct, sZ, sLoc, the [64] vectors (log p(z),
  // log q, log_w, the plain terms, the families' weights), the running slots
  return P::kOuts * kChunkF * kPitch + P::kOuts * kChunkF + kT * kPitch +
         kT * L + kT * kLocPitch + (3 + P::kPlain + P::kExps) * kT +
         run_floats<P>();
}

// The body's dynamic shared memory: the decoder's trunk, then the groups'
// parts
template <class P>
__host__ __device__ constexpr int smem_bytes(int L) {
  return static_cast<int>(sizeof(float)) *
         (kH * kH + L * kH + 2 * kH + kGroups * group_floats<P>(L));
}

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    iw_decode_kernel(typename P::Ptrs p, typename P::Strides st,
                     typename P::Dims dm, int n_chunks, unsigned* tickets) {
  constexpr int kE = P::kExps;
  constexpr int kCols = P::kOuts * kChunkF;
  extern __shared__ float4 smem4[];
  const int L = dm.L, D = dm.D, K = dm.K, B = dm.B;
  const int F = D + P::kHead;  // a slot's floats
  // samples; the wrappers keep n * max(D, L, 5) below 2^31, so a replica's
  // indices fit an int
  const int n = B * K;
  const int tiles = (n + kT - 1) / kT;
  // this block's replica (grid y): its slices of every tensor
  const long long rep = blockIdx.y;
  float* slots = p.work + rep * replica_floats<P>(dm);
  const typename P::Rows rows(p, st, dm, rep,
                              slots + slot_scratch_floats<P>(dm));
  const float* eps = p.eps + rep * st.rs_eps;

  // the block's decoder trunk, then each group's head chunk, activations
  // and the tile's per-sample vectors
  float* sW2 = reinterpret_cast<float*>(smem4);  // [128][128]
  float* sW1 = sW2 + kH * kH;                    // [L][128]
  float* sB1 = sW1 + L * kH;                     // [128]
  float* sB2 = sB1 + kH;                         // [128]
  const int g = threadIdx.x / kGroupThreads;     // this thread's group
  const int gt = threadIdx.x % kGroupThreads;    // its index in the group
  float* sW3 = sB2 + kH + g * group_floats<P>(L);
  float* sB3 = sW3 + kCols * kPitch;             // [kCols]
  float* sAct = sB3 + kCols;                     // [64 samples][kPitch]
  float* sZ = sAct + kT * kPitch;                // [64 samples][L]
  float* sLoc = sZ + kT * L;                     // [64 samples][17], D <= 16
  float* sPz = sLoc + kT * kLocPitch;            // log p(z) a sample
  float* sQ = sPz + kT;                          // log q(z | x)
  float* sLw = sQ + kT;                          // log_w (IW2: l_w)
  float* sPlain = sLw + kT;                      // [kPlain][64] plain terms
  float* sE = sPlain + P::kPlain * kT;           // [kExps][64] the weights
  float* sRun = sE + kE * kT;                    // [2][16 + kHead]
  // the rescale of a segment's running sums by family, once log_w is taken
  // (sQ and sPz are free then)
  auto seg_c = [&](int e) { return e == 0 ? sQ : sPz; };
  // where the tile's means and the running slots go: shared memory for one
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
    if (n_chunks == 1) stage_head<P>(sW3, sB3, rows, 0, D, gt);
  }
  __syncthreads();

  const float* mean = rows.mean;
  const float* scale = rows.scale;
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
            pz += __fmul_rn(-0.5f, __fmul_rn(z, z)) - kLogSqrt2Pi;
            q += rows.logq(b * L + l, z);
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

      // layer 1: h1 = act(z W1 + b1)
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
      store_hidden<typename P::Act>(acc, sB1, sAct, ty, tx);
      group_sync(g);

      // layer 2: h2 = act(h1 W2 + b2)
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
      store_hidden<typename P::Act>(acc, sB2, sAct, ty, tx);
      group_sync(g);

      // the head and the per-feature terms and their sums, a chunk of 16
      // features at a time; thread (sg, fg) takes samples sg + 16 i and
      // feature fg of the chunk
      float sums[4][P::kSums];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int t = 0; t < P::kSums; ++t) sums[i][t] = 0.f;
      }
      for (int c = 0; c < n_chunks; ++c) {
        if (n_chunks > 1) {
          if (c > 0) group_sync(g);  // the group is done with chunk c-1
          stage_head<P>(sW3, sB3, rows, c, D, gt);
          group_sync(g);
        }
        float o[4][P::kOuts];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < P::kOuts; ++j) o[i][j] = 0.f;
        }
#pragma unroll 2
        for (int k = 0; k < kH; k += 4) {
          float4 a[4], w[P::kOuts];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = *reinterpret_cast<const float4*>(
                sAct + (sg + 16 * i) * kPitch + k);
          }
#pragma unroll
          for (int j = 0; j < P::kOuts; ++j) {
            w[j] = *reinterpret_cast<const float4*>(
                sW3 + (j * kChunkF + fg) * kPitch + k);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float av = part(a[i], kk);
#pragma unroll
              for (int j = 0; j < P::kOuts; ++j) {
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
            loc_buf[sl * loc_pitch + f] =
                rows.feature(o[i], sB3, fg, f, s / K, s, sums[i]);
          }
        }
      }
      // the sums over a sample's features (its 16 lanes, fg, are adjacent),
      // then the sample's weight argument and plain terms
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int t = 0; t < P::kSums; ++t) {
          float v = sums[i][t];
#pragma unroll
          for (int m = 1; m < 16; m <<= 1) {
            v += __shfl_xor_sync(kFullWarp, v, m);
          }
          sums[i][t] = v;
        }
      }
      if (fg == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sl = sg + 16 * i;
          rows.sample(sums[i], sPz[sl], sQ[sl], s0 + sl, sLw + sl,
                      sPlain + sl);
        }
      }
      group_sync(g);

      // the tile's row segments: rows b_first .. b_last, segment j the
      // samples [lo, hi) of row b_first + j; segment 0 continues the range's
      // running sums where the previous tile of the range ended inside its
      // row. A warp a segment takes, for each family, its max (with the
      // running max where it continues) and the weights
      const int s_end = min(s0 + kT, n);
      const int b_first = s0 / K;
      const int n_seg = (s_end - 1) / K - b_first + 1;
      const bool cont = tile > t_lo && s0 % K != 0;
      const float* run_rd = run + cur * F;
      float* run_wr = run + (cur ^ 1) * F;
      for (int j = wg; j < n_seg; j += kGroupWarps) {
        const int b = b_first + j;
        const int lo = max(s0, b * K) - s0, hi = min(s_end, (b + 1) * K) - s0;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          float m = -INFINITY;
          for (int sl = lo + lane; sl < hi; sl += 32) {
            m = nan_max(m, rows.weight_arg(e, sLw[sl]));
          }
          m = warp_max(m);
          if (isinf(m)) m = 0.f;  // as torch's logsumexp
          float c = 0.f;
          if (j == 0 && cont) {
            const float old = run_rd[e];
            const float m_new = nan_max(old, m);
            c = expf(old - m_new);
            m = m_new;
          }
          float* sEe = sE + e * kT;
          for (int sl = lo + lane; sl < hi; sl += 32) {
            sEe[sl] = expf(rows.weight_arg(e, sLw[sl]) - m);
          }
          if (lane == 0) {
            seg_c(e)[j] = c;
            slots[static_cast<long long>(q + b) * F + e] = m;
            if (j == n_seg - 1) run_wr[e] = m;
          }
        }
      }
      group_sync(g);
      // eight lanes a (segment, field) pair, fields kExps .. F-1 (the
      // families' weights, the plain terms, the first family's weight x mean
      // a feature): lane q8 sums samples lo + q8, lo + q8 + 8, ..., three
      // shuffles join the eight
      const int per = F - kE;
      const int pairs = n_seg * per, q8 = lane & 7;
      for (int i0 = wg * 4; i0 < pairs; i0 += kGroupWarps * 4) {
        const int i = i0 + (lane >> 3);
        const int j = i / per, f = i - j * per + kE, b = b_first + j;
        const bool plain = f >= 2 * kE && f < P::kHead;
        float a = 0.f;
        if (i < pairs) {
          const int lo = max(s0, b * K) - s0, hi = min(s_end, (b + 1) * K) - s0;
          if (f < P::kHead) {
            const float* v = plain ? sPlain + (f - 2 * kE) * kT
                                   : sE + (f - kE) * kT;
            for (int sl = lo + q8; sl < hi; sl += 8) a += v[sl];
          } else {
            for (int sl = lo + q8; sl < hi; sl += 8) {
              a = fmaf(sE[sl], loc_buf[sl * loc_pitch + f - P::kHead], a);
            }
          }
        }
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) a += __shfl_xor_sync(kFullWarp, a, m);
        if (i < pairs && q8 == 0) {
          if (j == 0 && cont) {
            const float old = run_rd[f];
            a = plain ? old + a
                      : fmaf(old, seg_c(f < 2 * kE ? f - kE : 0)[0], a);
          }
          slots[static_cast<long long>(q + b) * F + f] = a;
          if (j == n_seg - 1) run_wr[f] = a;
        }
      }
      cur ^= 1;
      group_sync(g);  // sZ, sAct, the vectors (and a restaged head) are free
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
  float* per_row = p.per_row + rep * P::kPerRow * B;
  const long long cap = smem_bytes<P>(L) / static_cast<int>(sizeof(float));
  // rows a chunk, from a bound on a row's slots: a row spans at most
  // ceil(K / 64) + 1 tiles, and a range holds at least tiles / parts
  const long long row_slots =
      ((K + kT - 1) / kT + 1) / max(1, tiles / dm.parts) + 2;
  const int chunk_rows = static_cast<int>(max(1LL, cap / (row_slots * F)));
  for (int r0 = 0, r1; r0 < B; r0 = r1) {
    r1 = min(B, r0 + chunk_rows);
    const long long first = slot_begin(r0, K, dm.parts, tiles);
    const long long span =
        (slot_end(r1 - 1, K, dm.parts, tiles) - first) * F;
    if (span > cap) {  // one row (chunk_rows is 1) larger than the memory
      merge_row_block<P>(slots + first * F, r0, static_cast<int>(span / F),
                         dm, x_imputed, per_row, sm);
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
      const long long sb = slot_begin(b, K, dm.parts, tiles);
      merge_row_warp<P>(sm + (sb - first) * F, b,
                        static_cast<int>(slot_end(b, K, dm.parts, tiles) - sb),
                        dm, x_imputed, per_row, threadIdx.x & 31);
    }
    __syncthreads();
  }
}

// Both launches of model P on `stream`: the encoder, grid (ceil(B / 4), R),
// then the body, grid (dims.blocks, R); returns the first cudaGetLastError()
// that is not a success (a launch the card refuses never runs, and only this
// reports it). The caller's current device is restored before returning.
template <class P>
int launch(const typename P::Ptrs* p, const typename P::Strides* s,
           const typename P::Dims* d, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  static int allowed[kMaxDevices] = {};
  const int bytes = smem_bytes<P>(d->L);
  if (allowed[device] < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        iw_decode_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = bytes;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  unsigned* tickets =
      reinterpret_cast<unsigned*>(p->work + d->R * replica_floats<P>(*d));
  iw_encode_kernel<P><<<dim3((d->B + kEncRows - 1) / kEncRows, d->R),
                        kEncThreads, 0, st>>>(*p, *s, *d, tickets);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (d->D + kChunkF - 1) / kChunkF;
  iw_decode_kernel<P><<<dim3(d->blocks, d->R), kThreads, bytes, st>>>(
      *p, *s, *d, n_chunks, tickets);
  return static_cast<int>(cudaGetLastError());
}

// The dimensions both models share, checked before a launch
template <class Dims>
bool bad_dims(const Dims* d, int device) {
  return d->R < 1 || d->R > 65535 || d->B < 1 || d->K < 1 || d->D < 1 ||
         d->L < 1 || d->L > kMaxL || d->blocks < 1 || d->parts < 1 ||
         static_cast<long long>(d->parts) * kT >
             static_cast<long long>(d->B) * d->K + kT - 1 ||
         device < 0 || device >= kMaxDevices;
}

}  // namespace

// Launches IW1 on `stream` (see `launch`).
extern "C" int vpc_iw_decode(const IwPointers* p, const IwStrides* s,
                             const IwDims* d, int device, void* stream) {
  if (bad_dims(d, device) || d->B_extra < 0 || d->B_extra > d->B ||
      (d->B_extra > 0) != (p->extra != nullptr) ||
      d->work_floats != work_floats<Miwae>(*d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<Miwae>(p, s, d, device, stream);
}

// Launches IW2 on `stream` (see `launch`): the 'author' or the 'changed'
// network.
extern "C" int vpc_iw_mnar(const MnarPointers* p, const MnarStrides* s,
                           const MnarDims* d, int device, void* stream) {
  if (bad_dims(d, device) || (d->author != 0 && d->author != 1) ||
      (d->fixed != 0 && d->fixed != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d->author) {
    if (d->work_floats != work_floats<NotMiwae<true>>(*d)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<NotMiwae<true>>(p, s, d, device, stream);
  }
  if (d->work_floats != work_floats<NotMiwae<false>>(*d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<NotMiwae<false>>(p, s, d, device, stream);
}
