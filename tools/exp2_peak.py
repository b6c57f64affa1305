"""The rate at which this card's SMs compute the flash kernels' softmax, one
element (a (q, k) pair) at a time, on registers alone: the exponent's FFMA
and the running sum's FADD; then with ``ex2.approx.ftz.f32`` (MUFU.EX2);
then with the row max's FMNMX; then with p packed to bf16x2 (one
``cvt.rn.bf16x2.f32`` per two). Every SM busy, 64 warps an SM, no memory
traffic. CUDA's throughput table gives compute capability 9.0 16 exp2 a
cycle per SM; ``chip_smoke.EXP2_PER_S`` takes that rate at 132 SMs and the
SM's highest clock, 1.98 GHz, as the flash kernels' exponentials bound, so
a mix with ex2 should stay at or under 16 a cycle there.

    python tools/exp2_peak.py

Needs ``nvcc`` and a card; builds into ``build/tools/`` and prints one line a
mix (elements a cycle per SM at 1.98 GHz, and a second per SM), then the SM
clock ``nvidia-smi`` reads after the run, its highest clock, and the card's
name and power limit.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// MIX: 0 FFMA + FADD, 1 + ex2, 2 + FMNMX, 3 + a bf16x2 pack per two elements
template <int MIX>
__global__ void __launch_bounds__(256) mix(float* out, int iters) {
  float a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = -0.001f * (threadIdx.x + i);
  float l0 = 0.f, l1 = 0.f, mx0 = -1e30f, mx1 = -1e30f;
  uint32_t pk = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (MIX >= 2) {
        if (i & 1) mx1 = fmaxf(mx1, a[i]); else mx0 = fmaxf(mx0, a[i]);
      }
      const float x = fmaf(a[i], 0.36f, -0.25f);
      const float e = MIX >= 1 ? ex2(x) : x;
      if (i & 1) l1 += e; else l0 += e;
      a[i] = e - 1.0f;
    }
    if (MIX >= 3) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        __nv_bfloat162 v = __floats2bfloat162_rn(a[i], a[i + 1]);
        pk ^= *reinterpret_cast<uint32_t*>(&v);
      }
    }
  }
  if (l0 + l1 + mx0 + mx1 + static_cast<float>(pk) == 12345.f) out[threadIdx.x] = l0;  // never true
}

template <int MIX>
void row(const char* name, int sms, float* out) {
  const int iters = 2000, blocks = sms * 8, threads = 256;
  mix<MIX><<<blocks, threads>>>(out, 16);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  mix<MIX><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const double per_s = 32.0 * iters * threads * blocks / (ms * 1e-3) / sms;
  printf("%-36s %.3f ms, %.2f elements a cycle per SM at 1.98 GHz, %.4e per s per SM\n", name, ms,
         per_s / 1.98e9, per_s);
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, 1024 * sizeof(float));
  row<0>("FFMA + FADD", sms, out);
  row<1>("FFMA + FADD + ex2", sms, out);
  row<2>("FFMA + FADD + ex2 + FMNMX", sms, out);
  row<3>("FFMA + FADD + ex2 + FMNMX + pack", sms, out);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise SystemExit("exp2_peak: nvcc not found on PATH or under CUDA_HOME")
    return found


def main() -> int:
    out = Path(__file__).resolve().parents[1] / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "exp2_peak.cu", out / "exp2_peak"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-o",
                    str(exe), str(src)], check=True)
    subprocess.run([str(exe)], check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,name,power.limit", "--format=csv,noheader"],
                   check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
