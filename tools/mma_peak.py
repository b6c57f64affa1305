"""The tensor-core rate that ``mma.sync`` reaches on this card: TF32
m16n8k8 (the tf32 flash route's instruction) and bf16 m16n8k16, each as
independent accumulator chains in registers, every SM busy, no memory
traffic. It is the ceiling of a kernel built on ``mma.sync`` (the published
dense rates, 495 TFLOP/s TF32 and 989 bf16 on an H100 SXM, are wgmma's).

    python tools/mma_peak.py

Needs ``nvcc`` and a card; builds into ``build/tools/`` and prints one line a
configuration, then the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

template <int KIND, int CHAINS>
__global__ void bench(float* out, int iters) {
  float d[CHAINS][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  uint32_t b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 0) {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int i = 0; i < 4; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int KIND, int CHAINS>
void run(int sms, int warps) {
  const int blocks = sms * 4, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps * 32);
  bench<KIND, CHAINS><<<blocks, warps * 32>>>(out, 16);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  bench<KIND, CHAINS><<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const cudaError_t err = cudaGetLastError();
  const double flops = 2.0 * 16 * 8 * (KIND == 0 ? 8 : 16) * CHAINS * double(iters) * warps * blocks;
  printf("%s: %d chains, %d warps a block, 4 blocks an SM: %.1f TFLOP/s (%s)\n",
         KIND == 0 ? "mma.sync m16n8k8 tf32" : "mma.sync m16n8k16 bf16", CHAINS, warps,
         flops / ms / 1e9, cudaGetErrorString(err));
  cudaFree(out);
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<0, 4>(sms, 4); run<0, 8>(sms, 4); run<0, 16>(sms, 8);
  run<1, 4>(sms, 4); run<1, 8>(sms, 4); run<1, 16>(sms, 8);
  return 0;
}
"""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise SystemExit("mma_peak: nvcc not found on PATH or under CUDA_HOME")
    return found


def main() -> int:
    out = Path(__file__).resolve().parents[1] / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "mma_peak.cu", out / "mma_peak"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(src)], check=True)
    subprocess.run([str(exe)], check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
