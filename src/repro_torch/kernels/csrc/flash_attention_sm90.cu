// Hopper (sm_90a) flash-attention forward pass for bf16 q, k and v with head
// dim 64 or 128: the tensor-core route of the port's transformer prefill.
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel and its pallas_call) for those calls; every other
// call (float32, head dims 16/32/256, operands TMA cannot address) keeps the
// SIMT kernel of flash_attention.cu. kernels/flash_attention.py::route picks.
//
// What it computes is the SIMT kernel's function, in the same order of
// arithmetic where it matters: scores q.k accumulated in float32 from the bf16
// operands; the scale applied to the float32 scores after the product (folded
// with log2(e), so the softmax runs on exp2; in a tile with no masked key the
// scale is folded into the exponent's FFMA); then the mask, in those scaled
// units: the finite -1e30 for keys the causal mask or the sliding window
// (k_pos > q_pos - window) removes, so a row whose keys are all masked averages
// v uniformly, and -inf for keys past Sk; online softmax with a running max,
// a running sum of the unrounded p and a rescale of the accumulator; p rounded
// to bf16 before the PV product, as the reference rounds p to v's type; the
// output acc / max(l, 1e-30) in bf16. KV tiles wholly above the diagonal are
// skipped and the heaviest q tiles start first; tiles below a sliding window
// are not skipped (a bidirectional windowed row with Sq > Sk can be fully
// masked). Rows past Sq are not stored.
//
// What bounds it: at the serving path's larger prefill (B 4, S 2032, H 28,
// D 128, causal) the two products over the unmasked (q, k) pairs are 120 GFLOP
// against 0.23 GB of q, k, v and o, so the bound is the bf16 tensor cores:
// 0.12 ms at 989 TFLOP/s (the bytes take 0.07 ms at 3.35 TB/s).
//
// What the design does about it (FA3-shaped, one block per 128 query rows of
// one (batch, head); grid (q tiles, H, B), q tiles reversed when causal):
// - q, k and v stay bf16 in shared memory, loaded by TMA through 4-D tensor
//   maps over (D, S, H, B) with the operands' own byte strides (a strided slice
//   of a fused projection needs no copy), 128-byte swizzled. A box holds 64
//   bf16 columns, so a D-128 row is two boxes, two 128-byte panels in shared
//   memory, and the wgmma descriptors walk both. TMA zero-fills rows past Sq
//   and Sk; those keys still score -inf by position.
// - K and V go through a ring of kStages stages with a "full" and an "empty"
//   mbarrier each for K and for V: the consumers start Q.K^T while V is in
//   flight, and free a stage's K as soon as Q.K^T has read it.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues every
//   TMA load), warpgroups 1 and 2 are consumers, 64 query rows apiece. Each
//   consumer runs Q.K^T, softmax, P.V in turn; the two groups overlap each
//   other. ptxas allocates every thread of this 384-thread block within 168
//   registers, and setmaxnreg (a producer giving its registers to the
//   consumers at run time) did not change that allocation, so the kernel does
//   without it. FA3's overlap of a tile's Q.K^T with the previous tile's P.V
//   inside one group (S, O and P in flight at once) needs about 240 registers
//   a thread and, under 168, spills and serialises its wgmmas; the serial
//   order keeps every live register under 168.
// - S = Q.K^T is wgmma.m64n128k16 with A (Q) and B (K) both K-major in shared
//   memory; O += P.V is wgmma.m64nDk16 with P taken from registers as the A
//   operand (the S accumulator's layout is the A fragment's, so P needs no
//   shuffle) and V as the B operand in its natural (keys, D) layout, read
//   MN-major through the transpose bit wgmma has for 16-bit B.
// - The online softmax runs on the accumulator fragments in registers: each
//   thread holds two rows; a row's max and sum reduce over the 4 threads that
//   share it. It, not the tensor cores, sets the pace, so it is lean: the
//   scale folded into the exponent's FFMA where no key is masked, the mask
//   tests only on tiles that can hold a masked key, and no rescale of O when
//   no row of a warp changed its max.
// - A mbarrier wait that lasts 4 s traps, so a fault in the pipeline fails the
//   launch instead of hanging the card.
//
// What it leaves for later: a persistent grid with a tile scheduler (one
// tile's prologue and epilogue under another's compute), overlapping one
// warpgroup's softmax with its own next wgmma (it needs more than 168
// registers a thread), a TMA store of O, fp8, and native grouped-query
// indexing (the TPU kernel takes expanded heads, and so does this interface).
//
// The launcher is a plain C function with zllm_flash_attention's signature;
// the tensor maps are encoded on the host at each call with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int kBKV = 128;         // keys per K/V stage
constexpr int kStages = 3;        // K/V ring depth
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;   // consumer threads: arrivals that free a stage
constexpr int kPanelCols = 64;    // bf16 columns in one 128-byte swizzled row (one TMA box)
constexpr float kNegInf = -1e30f; // the reference's finite mask value

// Shared memory of one block, offsets from a 1024-byte-aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes). A tile of R rows and D
// columns is D / 64 panels of R x 128 bytes.
template <int D>
struct Layout {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBKV * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  // mbarriers: q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the dynamic base
};

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

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
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

// One TMA box {64 columns, rows, 1, 1} at (column, row, head, batch) into
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

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16, shared memory, K-major) * B (16 x 128, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16 bf16, registers) * B (16 x 128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}


// O (64 x D) += P (64 x 16, registers) * V (16 x D, shared memory, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc_v) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, desc_v, 1);
  } else {
    wgmma_rs_n64(d, a, desc_v, 1);
  }
}

constexpr uint32_t kRowBytes = kPanelCols * 2;  // 128: one swizzled row of a panel

// Issue S = Q K^T for one warpgroup's 64 query rows and one KV tile, as one
// wgmma group: D / 16 steps of 16 columns; a step within a panel moves the
// descriptors 32 bytes along the swizzled row, the next panel starts anew.
template <int D>
__device__ __forceinline__ void issue_qk(float (&acc_s)[kBKV / 2], uint32_t q_rows, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col_bytes = (kk % 4) * 32;
    wgmma_ss_n128(acc_s, sw128_desc(q_rows + (kk / 4) * kBQ * kRowBytes + col_bytes, 16, 8 * kRowBytes),
                  sw128_desc(k_tile + (kk / 4) * kBKV * kRowBytes + col_bytes, 16, 8 * kRowBytes), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V as one wgmma group: kBKV / 16 steps of 16 keys, each 16 rows
// of 128 bytes on; a D-128 row of V spans two panels, kBKV rows apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc_o)[D / 2], const uint32_t (&pa)[kBKV / 16][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
    wgmma_pv<D>(acc_o, pa[kk], sw128_desc(v_tile + kk * 16 * kRowBytes, kBKV * kRowBytes, 8 * kRowBytes));
  wgmma_commit();
}

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

// The online softmax of one S tile, in place: scale in float32, then mask in
// the scaled units, then p = 2^(s - m) over the new running max m; l takes
// p's float32 sum (this thread's columns; the 4 threads of a row add theirs at
// the end), corr the factor that rescales O to the new max. Accumulator
// element i is row row0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + col0 +
// (i & 1); edge says whether any key of the tile can be masked for these rows.
// A tile with no masked key takes the max of the unscaled scores (scaling by
// a positive float keeps the max) and folds the scale into the exponent's
// FFMA: one instruction per score fewer on the path that bounds the kernel.
__device__ __forceinline__ void softmax_tile(float (&acc_s)[kBKV / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge, int k0, int row0, int col0,
                                             int Sk, int causal, int window, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (!edge) {
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc_s[i]);
    mx[0] *= scale_log2;
    mx[1] *= scale_log2;
    update_max(mx, m, l, corr);
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      acc_s[i] = ex2(fmaf(acc_s[i], scale_log2, -m[r]));
      l[r] += acc_s[i];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kBKV / 2; ++i) {
    const int r = (i >> 1) & 1;
    const int kp = k0 + 8 * (i >> 2) + col0 + (i & 1), qp = row0 + 8 * r;
    float x = acc_s[i] * scale_log2;
    if (kp >= Sk) {
      x = -INFINITY;  // past the last key: no weight, even in a fully masked row
    } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
      x = kNegInf;
    }
    acc_s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  update_max(mx, m, l, corr);
#pragma unroll
  for (int i = 0; i < kBKV / 2; ++i) {
    const int r = (i >> 1) & 1;
    acc_s[i] = ex2(acc_s[i] - m[r]);
    l[r] += acc_s[i];
  }
}

// p rounded to bf16, packed straight into the A fragments of the PV product:
// the S accumulator's layout is the A operand's, 16 keys per fragment.
__device__ __forceinline__ void pack_p(const float (&acc_s)[kBKV / 2], uint32_t (&pa)[kBKV / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBKV / 2; i += 2) pa[i / 8][(i / 2) % 4] = pack_bf16(acc_s[i], acc_s[i + 1]);
}

// O *= corr per row; skipped when no row of the warp changed its max (the
// common case once a row has seen its largest scores)
template <int D>
__device__ __forceinline__ void rescale(float (&acc_o)[D / 2], const float (&corr)[2]) {
  if (__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] *= corr[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq,
                      int Sk, Strides so, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int kPanels = D / kPanelCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages, bar_v_empty = bar_k_empty + 8 * kStages;

  // q tiles of one (batch, head) are neighbours in launch order, so they run
  // together and share that head's K and V in L2; causal: within a head, the
  // q tiles with the most KV tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, Sq);              // one past the tile's last row
  const int kv_end = causal ? min(Sk, q_end) : Sk;  // later tiles lie above the diagonal
  const int n_tiles = (kv_end + kBKV - 1) / kBKV;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, kConsumers);
      mbar_init(bar_v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load, K and V of a tile
    // each into its stage as soon as the consumers have released it
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load(sQ + p * kBQ * kRowBytes, &tm_q, bar_q, p * kPanelCols, q0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t free_parity = ((n / kStages) & 1) ^ 1;  // the first pass finds it free
        const uint32_t k_dst = sK + s * L::kKVBytes, v_dst = sV + s * L::kKVBytes;
        mbar_wait(bar_k_empty + 8 * s, free_parity);
        mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load(k_dst + p * kBKV * kRowBytes, &tm_k, bar_k + 8 * s, p * kPanelCols, n * kBKV, h, b);
        mbar_wait(bar_v_empty + 8 * s, free_parity);
        mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load(v_dst + p * kBKV * kRowBytes, &tm_v, bar_v + 8 * s, p * kPanelCols, n * kBKV, h, b);
      }
    }
  } else {
    // consumer warpgroups 1 and 2: 64 query rows each; per KV tile S = Q K^T,
    // the online softmax, then O += P V
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int wg_row = q0 + 64 * c;                     // the group's first query row
    const int row0 = wg_row + 16 * warp + (lane >> 2);  // this thread's rows: row0 and row0 + 8
    const int col0 = 2 * (lane & 3);                    // and columns col0, col0 + 1 of every 8
    const uint32_t q_rows = sQ + 64 * c * kRowBytes;
    // whether any key of tile n can be masked for this group's rows
    auto edge = [&](int k0) {
      return k0 + kBKV > Sk || window > 0 || (causal && k0 + kBKV - 1 > wg_row);
    };

    float acc_o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    float acc_s[kBKV / 2];
    uint32_t pa[kBKV / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

    mbar_wait(bar_q, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      const uint32_t parity = (n / kStages) & 1;
      mbar_wait(bar_k + 8 * s, parity);
      issue_qk<D>(acc_s, q_rows, sK + s * L::kKVBytes);
      wgmma_wait<0>();
      fence_regs(acc_s);
      mbar_arrive(bar_k_empty + 8 * s);  // K of this stage is consumed
      softmax_tile(acc_s, m, l, corr, edge(n * kBKV), n * kBKV, row0, col0, Sk, causal, window,
                   scale_log2);
      pack_p(acc_s, pa);
      rescale<D>(acc_o, corr);
      mbar_wait(bar_v + 8 * s, parity);
      issue_pv<D>(acc_o, pa, sV + s * L::kKVBytes);
      wgmma_wait<0>();
      fence_regs(acc_o);
      mbar_arrive(bar_v_empty + 8 * s);  // and V
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp < Sq) {
        const float denom = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = ob + qp * so.s + col0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc_o[4 * j + 2 * r] / denom, acc_o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
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

// A 4-D map over (D, S, H, B) of a bf16 operand with the given element
// strides; boxes of {64, rows, 1, 1}, 128-byte swizzle, zero fill out of
// bounds. A dim of extent 1 is only read at coordinate 0, so its stride is
// free and gets one TMA accepts.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t H, int64_t D,
                     Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto bytes = [D](int64_t extent, int64_t stride) {
    return static_cast<cuuint64_t>(extent == 1 ? D * 2 : stride * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(S, st.s), bytes(H, st.h), bytes(B, st.b)};
  const cuuint32_t box[4] = {kPanelCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq, int64_t Sk,
                   int64_t H, Strides sq, Strides sk, Strides sv, Strides so, int causal, int window,
                   cudaStream_t stream) {
  constexpr int smem = Layout<D>::kAlloc;
  static_assert(smem <= 227 * 1024, "tiles do not fit in an H100 block's shared memory");
  const int64_t q_tiles = (Sq + kBQ - 1) / kBQ;
  if (B > 65535 || H > 65535 || Sq > 0x7fffffff || Sk > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, Sq, H, D, sq, kBQ);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Sk, H, D, sk, kBKV);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Sk, H, D, sv, kBKV);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_sm90_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the reference's scale 1 / D**0.5 with log2(e) folded in, in double, rounded once
  const float scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(H), static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<int>(Sq),
                                         static_cast<int>(Sk), so, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// zllm_flash_attention's signature. Takes bf16 (dtype 1) with D 64 or 128;
// the Python rule (kernels/flash_attention.py::route) also requires 16-byte
// aligned base pointers and B/S/H strides. Anything else is refused with
// cudaErrorInvalidValue.
int zllm_flash_attention_sm90(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
                              int64_t Sk, int64_t H, int64_t D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                              int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal, int window,
                              int dtype, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 128: return static_cast<int>(launch<128>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
