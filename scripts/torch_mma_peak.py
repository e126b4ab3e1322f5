"""Peak rates of the tensor-core instructions the port's GEMM core could
issue, on one NVIDIA GPU: warp-level mma.sync.m16n8k8 TF32 (the earlier
core) and warpgroup wgmma.mma_async m64n128k8 TF32 and m64n128k16 bf16 with
A from registers and B from shared memory (the instructions of
ardae_tpu_torch/csrc/dsm_sgemm.cuh, which issues three TF32 products for
each fp32 product, or one bf16 product).

    python3 scripts/torch_mma_peak.py

Builds a small library with nvcc for sm_90a into build/. mma.sync: 132 x
BLOCKS_PER_SM blocks of 8 warps, each warp issuing ITERS rounds of 16
independent m16n8k8 products from registers. wgmma: 132 x BLOCKS_PER_SM
blocks of WARPGROUPS warpgroups, each issuing ITERS groups of 16 dependent
products into one accumulator (B a zeroed 128 x 32 tile, no memory traffic),
waiting for each group. Prints each rate in TFLOP/s over a CUDA-event timed
launch, with the card's name and power limit. Needs a CUDA device and nvcc;
exits 2 without a device.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + threadIdx.x * q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(0.5f + q);
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D64 D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
#define DREGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
    "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63}"

// groups of 16 wgmma products from registers into one accumulator per
// warpgroup; BF16 selects m64n128k16 bf16 over m64n128k8 tf32
template <int BF16>
__global__ void __launch_bounds__(384) wgmma_loop(float* out, int iters) {
  __shared__ __align__(1024) uint8_t bs[128 * 128];
  for (int i = threadIdx.x; i < 128 * 128 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(bs)[i] = 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(bs));
  // K-major, 128-byte swizzle (tf32: rows of 32) or 64-byte (bf16: 32)
  const uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
                        ((uint64_t)((BF16 ? 512 : 1024) >> 4) << 32) |
                        ((uint64_t)(BF16 ? 2 : 1) << 62);
  uint32_t a[4];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + threadIdx.x * q);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (BF16)
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DREGS
                     ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                     : D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                       "r"(1));
      else
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " DREGS
                     ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                     : D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                       "r"(1));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(float* out, int blocks, int iters, cudaStream_t stream) {
  mma_loop<<<blocks, 256, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int launch_wgmma(int bf16, float* out, int blocks, int warpgroups,
                            int iters, cudaStream_t stream) {
  if (bf16)
    wgmma_loop<1><<<blocks, 128 * warpgroups, 0, stream>>>(out, iters);
  else
    wgmma_loop<0><<<blocks, 128 * warpgroups, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def timed(torch, run):
    """ms of one launch ``run(iters)``, after a short warm-up launch."""
    if run(16):
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    if run(ITERS):
        raise RuntimeError("launch failed")
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    src, lib = os.path.join(build, "mma_peak.cu"), os.path.join(build, "libmma_peak.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    so.launch.argtypes = [p, i, i, p]
    so.launch_wgmma.argtypes = [i, p, i, i, i, p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    for per_sm in (1, 2):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        ms = timed(torch, lambda n: so.launch(out.data_ptr(), blocks, n, stream))
        flop = blocks * 8 * ITERS * 16 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32, {blocks} blocks of 8 warps ({per_sm} a SM), "
              f"16 independent products a warp: {flop / ms / 1e9:.1f} TFLOP/s "
              f"({ms:.3f} ms) | {card}", flush=True)
    for bf16, name, k in ((0, "m64n128k8 TF32", 8), (1, "m64n128k16 bf16", 16)):
        for warpgroups in (2, 3):
            blocks = 132
            out = torch.empty(blocks * 128 * warpgroups, device="cuda")
            ms = timed(torch, lambda n: so.launch_wgmma(
                bf16, out.data_ptr(), blocks, warpgroups, n, stream))
            flop = blocks * warpgroups * ITERS * 16 * 2 * 64 * 128 * k
            print(f"wgmma {name}, A from registers, {blocks} blocks of "
                  f"{warpgroups} warpgroups, groups of 16 products: "
                  f"{flop / ms / 1e9:.1f} TFLOP/s ({ms:.3f} ms) | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
