"""Peak rate of warp-level mma.sync.m16n8k8 TF32 on one NVIDIA GPU: the
ceiling of the port's 3xTF32 GEMM core (ardae_tpu_torch/csrc/dsm_sgemm.cuh),
which issues three of these products for each fp32 product.

    python3 scripts/torch_mma_peak.py

Builds a small kernel with nvcc for sm_90a into build/, launches 132 x
BLOCKS_PER_SM blocks of 8 warps, each warp issuing ITERS rounds of 16
independent m16n8k8 products from registers (no memory traffic), and prints
the TF32 TFLOP/s over a CUDA-event timed launch, with the card's name and
power limit. Needs a CUDA device and nvcc; exits 2 without a device.
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
extern "C" int launch(float* out, int blocks, int iters, cudaStream_t stream) {
  mma_loop<<<blocks, 256, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


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
    so.launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    for per_sm in (1, 2):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        so.launch(out.data_ptr(), blocks, 16, stream)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        if so.launch(out.data_ptr(), blocks, ITERS, stream):
            raise RuntimeError("launch failed")
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        flop = blocks * 8 * ITERS * 16 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32, {blocks} blocks of 8 warps ({per_sm} a SM), "
              f"16 independent products a warp: {flop / ms / 1e9:.1f} TFLOP/s "
              f"({ms:.3f} ms) | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
