"""The tensor-core rate that ``wgmma`` reaches on this card in each form the
two Hopper flash kernels issue. The sm90 kernel (bf16): S = Q K^T as
m64n64k16 and m64n128k16 with both operands in shared memory, O += P V as
m64n16k16, m64n32k16, m64n64k16, m64n80k16 and m64n128k16 with P in
registers and V read through the transpose bit. The sm90_tf32 kernel (float32 on TF32 operands): S = Q K^T
as m64n32k8, m64n64k8, m64n80k8 and m64n128k8 with both operands in shared
memory, P V as m64n64k8, m64n80k8 and m64n128k8 with P in registers and V^T
K-major in shared memory (TF32 has no transpose bit). Each warpgroup issues
groups of 8 (Q K^T) or 4 (P V) instructions into one accumulator, waiting
for each group (wait_group 0) or keeping one in flight (wait_group 1); one or
two warpgroups an SM, every SM busy, operands fixed in shared memory and
registers (no memory traffic). The published dense rates of an H100 SXM are
989 TFLOP/s bf16 and 495 TF32.

    python tools/wgmma_peak.py

Needs ``nvcc`` and a card; builds into ``build/tools/`` and prints one line a
form, then the card's name and power limit.
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

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define ACC8(d, o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
    "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// FORM: 0 ss m64n64k16, 1 ss m64n128k16, 2 rs m64n64k16 tnspB, 3 rs m64n80k16 tnspB,
// 4 rs m64n128k16 tnspB (bf16); 5-8 ss m64n32k8, m64n64k8, m64n80k8, m64n128k8 and 9-11 rs
// m64n64k8, m64n80k8, m64n128k8 (tf32, both operands K-major); 12-13 rs m64n16k16 and
// m64n32k16 tnspB (bf16)
template <int FORM>
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t da, uint64_t db) {
  if constexpr (FORM == 0) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
                 "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
                 : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24) : "l"(da), "l"(db));
  } else if constexpr (FORM == 1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
                 "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
                 "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
                 "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
                 "%59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}"
                 : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
                   ACC8(d, 48), ACC8(d, 56)
                 : "l"(da), "l"(db));
  } else if constexpr (FORM == 2) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
                 "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
                 : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  } else if constexpr (FORM == 3) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
                 "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
                 "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}"
                 : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  } else if constexpr (FORM == 12) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}"
                 : ACC8(d, 0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  } else if constexpr (FORM == 13) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
                 "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
                 : ACC8(d, 0), ACC8(d, 8) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  }@TF32_FORMS@ else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
                 "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
                 "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
                 "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
                 "%59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
                 : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
                   ACC8(d, 48), ACC8(d, 56)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  }
}

// the form's N and K, and its instructions a group (8 for Q.K^T, 4 for P.V)
__host__ __device__ constexpr int n_of(int form) {
  return form >= 12 ? 16 * (form - 11)
         : form < 5 ? (form == 1 || form == 4 ? 128 : form == 3 ? 80 : 64)
                    : (form == 5 ? 32 : form == 6 || form == 9 ? 64 : form == 7 || form == 10 ? 80 : 128);
}
__host__ __device__ constexpr int k_of(int form) { return form < 5 || form >= 12 ? 16 : 8; }
__host__ __device__ constexpr bool ss(int form) { return form < 2 || (form >= 5 && form <= 8); }
__host__ __device__ constexpr int group_of(int form) { return ss(form) ? 8 : 4; }
constexpr int kSmem = 64 * 1024;

template <int FORM, int INFLIGHT>
__global__ void __launch_bounds__(256, 1) bench(float* out, int iters) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023u) & ~1023u;
  float d[64] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int g = 0; g < group_of(FORM); ++g) {
      const uint64_t da = desc(base + (g % 4) * 32, 16, 1024);
      const uint64_t db = FORM < 2 || (FORM >= 5 && FORM < 12) ? desc(base + 16384 + (g % 4) * 32, 16, 1024)
                                                : desc(base + 16384 + g * 2048, 8192, 1024);
      mma<FORM>(d, a, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (INFLIGHT == 0) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the products; never true
}

template <int FORM, int INFLIGHT>
double tflops(int sms, int warpgroups) {
  const int iters = 20000;
  auto k = bench<FORM, INFLIGHT>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  float* out;
  cudaMalloc(&out, 1024 * sizeof(float));
  k<<<sms, 128 * warpgroups, kSmem>>>(out, 16);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  k<<<sms, 128 * warpgroups, kSmem>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1.0;
  return 2.0 * 64 * n_of(FORM) * k_of(FORM) * group_of(FORM) * double(iters) * warpgroups * sms / (ms * 1e-3) / 1e12;
}

template <int FORM>
void row(const char* name, int sms) {
  printf("%-30s one warpgroup an SM %6.1f / %6.1f, two %6.1f / %6.1f TFLOP/s (wait_group 0 / 1)\n", name,
         tflops<FORM, 0>(sms, 1), tflops<FORM, 1>(sms, 1), tflops<FORM, 0>(sms, 2), tflops<FORM, 1>(sms, 2));
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  row<0>("ss m64n64k16 (Q.K^T, 64 keys)", sms);
  row<1>("ss m64n128k16 (Q.K^T, 128 keys)", sms);
  row<12>("rs m64n16k16 tnspB (P.V, D 16)", sms);
  row<13>("rs m64n32k16 tnspB (P.V, D 32)", sms);
  row<2>("rs m64n64k16 tnspB (P.V, D 64)", sms);
  row<3>("rs m64n80k16 tnspB (P.V, D 80)", sms);
  row<4>("rs m64n128k16 tnspB (P.V, D 128)", sms);
  row<5>("tf32 ss m64n32k8 (Q.K^T, 32 keys)", sms);
  row<6>("tf32 ss m64n64k8 (Q.K^T, 64 keys)", sms);
  row<7>("tf32 ss m64n80k8", sms);
  row<8>("tf32 ss m64n128k8", sms);
  row<9>("tf32 rs m64n64k8 (P.V, D 64)", sms);
  row<10>("tf32 rs m64n80k8 (P.V, D 80)", sms);
  row<11>("tf32 rs m64n128k8 (P.V, D 128)", sms);
  return 0;
}
"""


def _tf32_forms() -> str:
    """The source of the TF32 forms' branches of mma<FORM> (5-11)."""
    out = []
    for form, (kind, n) in enumerate([("ss", 32), ("ss", 64), ("ss", 80), ("ss", 128),
                                      ("rs", 64), ("rs", 80), ("rs", 128)], start=5):
        acc = ", ".join(f"%{i}" for i in range(n // 2))
        accs = ", ".join(f"ACC8(d, {o})" for o in range(0, n // 2, 8))
        if kind == "ss":
            ops, ins = f"%{n // 2}, %{n // 2 + 1}", '"l"(da), "l"(db)'
        else:
            a = ", ".join(f"%{n // 2 + i}" for i in range(4))
            ops = f"{{{a}}}, %{n // 2 + 4}"
            ins = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)'
        out.append(f' else if constexpr (FORM == {form}) {{\n'
                   f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, 1, 0;\\n'
                   f'wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{acc}}}, {ops}, p, 1, 1;'
                   f'\\n}}" : {accs} : {ins});\n  }}')
    return "".join(out)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise SystemExit("wgmma_peak: nvcc not found on PATH or under CUDA_HOME")
    return found


def main() -> int:
    out = Path(__file__).resolve().parents[1] / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "wgmma_peak.cu", out / "wgmma_peak"
    src.write_text(SOURCE.replace("@TF32_FORMS@", _tf32_forms()))
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-o",
                    str(exe), str(src)], check=True)
    subprocess.run([str(exe)], check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
