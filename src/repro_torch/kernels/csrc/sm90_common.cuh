// Helpers the two Hopper flash-attention kernels share (flash_attention_sm90.cu,
// bf16; flash_attention_sm90_tf32.cu, float32): mbarriers, TMA loads through
// 4-D tensor maps, wgmma descriptors and fences, and the online softmax on the
// fragments of a 64-row wgmma accumulator. Included by each source on its
// own; everything lives in an anonymous namespace.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value

struct Strides {
  int64_t b, s, h;  // element strides of a (B, S, H, D) operand; D is contiguous
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase with this parity has completed; kCluster
// acquires at cluster scope (for what another block of the cluster wrote).
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    if constexpr (kCluster) {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    }
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// One TMA box {128 bytes of columns, rows, 1, 1} at (column, row, head, batch) into
// shared memory; completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head),
        "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor of rows swizzled in `row` bytes (128,
// 64 or 32: layout type 1, 2 or 3): start address, leading and stride byte
// offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t swizzle_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t row) {
  const uint64_t layout = row == 128 ? 1 : row == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return swizzle_desc(addr, lbo, sbo, 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr uint32_t kRowBytes = 128;  // one swizzled row of a panel (one TMA box of a row)

// The descriptor of the same layout at addr + bytes (bytes a multiple of 16;
// the address field, in 16-byte units, does not overflow below 256 KB)
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

// The new running max m of a thread's two rows from their maxima over this
// tile (reduced over the 4 threads of a row), the factor corr that rescales
// O and l to it, and l rescaled.
__device__ __forceinline__ void update_max(float (&mx)[2], float (&m)[2], float (&l)[2], float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
}

// A thread's kS / 2 values of each of its two rows are reduced in 4
// independent chains (element i feeds chain ((i >> 2) & 1) * 2 + (i & 1) of
// row (i >> 1) & 1), so the reductions wait on a quarter of the latencies one
// chain would.
__device__ __forceinline__ int chain(int i) { return ((i >> 2) & 1) * 2 + (i & 1); }

template <int kS>
__device__ __forceinline__ void row_max(const float (&acc_s)[kS], float (&mx)[2]) {
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kS; ++i) part[(i >> 1) & 1][chain(i)] = fmaxf(part[(i >> 1) & 1][chain(i)], acc_s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
}

template <int kS>
__device__ __forceinline__ void add_rows(const float (&acc_s)[kS], float (&l)[2]) {
  float part[2][4] = {};
#pragma unroll
  for (int i = 0; i < kS; ++i) part[(i >> 1) & 1][chain(i)] += acc_s[i];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
}

// The online softmax of one S tile, in place: scale in float32, then mask in
// the scaled units, then p = 2^(s - m) over the new running max m; l takes
// p's float32 sum (this thread's columns; the 4 threads of a row add theirs at
// the end), corr the factor that rescales O to the new max. Accumulator
// element i is row row0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + col0 +
// (i & 1); edge says whether any key of the tile can be masked for these rows.
// A tile with no masked key takes the max of the unscaled scores (scaling by
// a positive float keeps the max) and folds the scale into the exponent's
// FFMA: one instruction per score fewer on the path that bounds the kernel.
template <int kS>
__device__ __forceinline__ void softmax_tile(float (&acc_s)[kS], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge, int k0, int row0, int col0,
                                             int Sk, int causal, int window, float scale_log2) {
  float mx[2];
  if (!edge) {
    row_max(acc_s, mx);
    mx[0] *= scale_log2;
    mx[1] *= scale_log2;
    update_max(mx, m, l, corr);
#pragma unroll
    for (int i = 0; i < kS; ++i) acc_s[i] = ex2(fmaf(acc_s[i], scale_log2, -m[(i >> 1) & 1]));
    add_rows(acc_s, l);
    return;
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int kp = k0 + 8 * (i >> 2) + col0 + (i & 1), qp = row0 + 8 * ((i >> 1) & 1);
    float x = acc_s[i] * scale_log2;
    if (kp >= Sk) {
      x = -INFINITY;  // past the last key: no weight, even in a fully masked row
    } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
      x = kNegInf;
    }
    acc_s[i] = x;
  }
  row_max(acc_s, mx);
  update_max(mx, m, l, corr);
#pragma unroll
  for (int i = 0; i < kS; ++i) acc_s[i] = ex2(acc_s[i] - m[(i >> 1) & 1]);
  add_rows(acc_s, l);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, S, H, B) of an operand of `elem`-byte elements of type
// `type` with the given element strides; boxes of {`row` bytes of columns,
// rows, 1, 1}, swizzled in `row` bytes (128, 64 or 32), zero fill out of
// bounds. A dim of extent 1 is only read at coordinate 0, so its stride is
// free and gets one TMA accepts.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t H, int64_t D,
                     Strides st, int rows, CUtensorMapDataType type, int elem, uint32_t row = kRowBytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto bytes = [D, elem](int64_t extent, int64_t stride) {
    return static_cast<cuuint64_t>((extent == 1 ? D : stride) * elem);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(S, st.s), bytes(H, st.h), bytes(B, st.b)};
  const cuuint32_t box[4] = {row / static_cast<cuuint32_t>(elem), static_cast<cuuint32_t>(rows), 1, 1};
  const CUtensorMapSwizzle swizzle = row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
