"""Time the embed+pool kernels (B2f, B2b) on the card over the forward's
tilings, beside the launch floor and a few probe kernels that price the
steps the kernels are made of, to choose `ops.fused_embed_pool.fwd_plan`.

    python -m vae_posterior_consistency_tpu_torch.engine.sweep_embed_pool

Needs a CUDA card. Each line of output is one JSON object: the kernel, the
shape (S, B, D, K), the tiling for the forward, and its time in ms from CUDA
events around 10 back-to-back calls after a busy-wait (the method of
chip_smoke.py), the median of `--runs` such windows. The card's name and
power limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from vae_posterior_consistency_tpu_torch.ops import _build
from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep

#: probe kernels, each the skeleton of one step of B2f or B2b, 256 threads a
#: block: nothing; one read and one write a thread; a read whose address
#: comes from another read; 64 blocks with 68,992 B of dynamic shared memory
#: filled by cp.async; 20 values summed across a warp by shuffles; a
#: cluster of 8 blocks that synchronises twice; 68,992 B of dynamic shared
#: memory left empty; the forward's reads of A and C from global memory at
#: one row a block (lanes over d, a stride of K=10 floats)
PROBES = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void empty_k() {}
__global__ void copy_k(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i];
}
__global__ void chain_k(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = static_cast<int>(x[i]);
  y[i] = x[j];
}
__global__ void stage_k(const float* x, float* y, int n) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(a),
                 "l"(x + i) : "memory");
  }
  asm volatile("cp.async.commit_group;");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) y[blockIdx.x] = s[n - 1];
}
__global__ void shuffle_k(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[20];
  for (int k = 0; k < 20; ++k) v[k] = x[i] * k;
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < 20; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    t += v[k];
  }
  y[i] = t;
}
__global__ void smem_k(float* y) {
  extern __shared__ float s[];
  if (threadIdx.x == 0) y[blockIdx.x] = s[0];
}
__global__ void strided_k(const float* x, float* y) {
  // 4 values of d a lane, 10 of k each, A and C: 80 loads at a stride of 10
  const int lane = threadIdx.x & 31;
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 20; ++k) t += __ldg(x + (lane + 32 * j) * 10 + k);
  }
  y[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
__global__ void __cluster_dims__(1, 8, 1) cluster_k(float* y) {
  __shared__ float s[32];
  cg::cluster_group c = cg::this_cluster();
  if (threadIdx.x < 32) s[threadIdx.x] = threadIdx.x;
  c.sync();
  if (threadIdx.x < 32)
    y[blockIdx.x * 32 + threadIdx.x] = c.map_shared_rank(s, 0)[threadIdx.x];
  c.sync();
}
extern "C" int probe(int which, const float* x, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: empty_k<<<1, 256, 0, st>>>(); break;
    case 1: empty_k<<<64, 256, 0, st>>>(); break;
    case 2: copy_k<<<64, 256, 0, st>>>(x, y); break;
    case 3: chain_k<<<64, 256, 0, st>>>(x, y); break;
    case 4:
      cudaFuncSetAttribute(stage_k,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           68992);
      stage_k<<<64, 256, 68992, st>>>(x, y, 68992 / 4);
      break;
    case 5: shuffle_k<<<64, 256, 0, st>>>(x, y); break;
    case 6: cluster_k<<<dim3(25, 8), 256, 0, st>>>(y); break;
    case 7:
      cudaFuncSetAttribute(smem_k,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           68992);
      smem_k<<<64, 256, 68992, st>>>(y);
      break;
    case 8: strided_k<<<64, 256, 0, st>>>(x, y); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
PROBE_NAMES = ("empty, 1 block", "empty, 64 blocks", "read + write",
               "read, then a read at its value", "cp.async 68,992 B a block",
               "20 warp sums by shuffles", "cluster of 8, two syncs, 25 "
               "clusters", "empty, 64 blocks, 68,992 B dynamic shared memory",
               "80 loads a lane at a stride of 10 floats, 64 blocks")


def _probes():
    """Build PROBES with nvcc into the kernels' build directory; returns the
    C entry point `probe(which, x, y, stream)`."""
    out = _build.BUILD_DIR / "libsweep_probes.so"
    src = _build.BUILD_DIR / "sweep_probes.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBES)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, timeout=_build.NVCC_TIMEOUT_S)
    fn = ctypes.CDLL(str(out)).probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def event_ms(fn, runs, per_run=10):
    times = []
    for _ in range(runs):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _inputs(S, B, D, K, gen):
    x = torch.rand(B, D, device="cuda", generator=gen)
    masks = (torch.rand(S, B, D, device="cuda", generator=gen) < 0.7).float()
    A = torch.randn(D, K, device="cuda", generator=gen) * 0.3
    C = torch.randn(D, K, device="cuda", generator=gen) * 0.3
    return x, masks, A, C


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_embed_pool: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"kernel": "launch floor (1-element add_)",
                      "ms": event_ms(lambda: one.add_(1.0), args.runs)}),
          flush=True)
    probe = _probes()
    px = torch.zeros(1 << 20, device="cuda")  # zeros: chain_k reads x[0]
    py = torch.empty(1 << 20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for which, name in enumerate(PROBE_NAMES):
        if probe(which, px.data_ptr(), py.data_ptr(), stream) != 0:
            raise RuntimeError(f"probe {name} did not launch")
        print(json.dumps({"kernel": f"probe: {name}", "ms": event_ms(
            lambda: probe(which, px.data_ptr(), py.data_ptr(), stream),
            args.runs)}), flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    D, K = 784, 10
    for S, B in ((1, 512), (2, 64), (2, 4096), (2, 1)):
        x, masks, A, C = _inputs(S, B, D, K, gen)
        want = fep.embed_pool_reference(x, masks, A, C)
        chosen = fep.fwd_plan(B, D, K, n_sm)
        for rows in (1, 2, 4, 8, 16, 32, 64):
            if rows > B:
                continue
            for segments in (1, 2, 4, 8):
                for staged in (False, True):
                    plan = (chosen[0], segments, rows, staged)

                    def run():
                        return fep._embed_pool_fwd_kernel(
                            x, masks, A, C, S, B, D, K, plan)

                    torch.testing.assert_close(run(), want, rtol=1e-5,
                                               atol=1e-4)
                    print(json.dumps({
                        "kernel": "embed_pool_fwd", "S": S, "B": B, "D": D,
                        "K": K, "k_chunk": plan[0], "segments": segments,
                        "rows_per_block": rows, "staged": staged,
                        "blocks": -(-B // rows), "chosen": plan == chosen,
                        "ms": event_ms(run, args.runs)}), flush=True)
        g = torch.randn(S, B, K, device="cuda", generator=gen)
        for want_dx, want_dm in ((False, False), (True, True)):
            ms = event_ms(lambda: fep._embed_pool_bwd_kernel(
                x, masks, A, C, g, S, B, D, K, want_dx=want_dx,
                want_dm=want_dm), args.runs)
            print(json.dumps({"kernel": "embed_pool_bwd", "S": S, "B": B,
                              "D": D, "K": K, "dx": want_dx, "dm": want_dm,
                              "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
