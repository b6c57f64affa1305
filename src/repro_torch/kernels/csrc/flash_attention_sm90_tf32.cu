// Hopper (sm_90a) flash-attention forward pass for float32 q, k and v with head
// dim 64, 80, 128 or 256 on the TF32 tensor cores through wgmma: the float32
// prefills of the port's families (D 128: phase 7's float32 model; D 80:
// zamba2-2.7b's shared attention; D 64: whisper-medium) and float32 at D 256,
// which no config reaches. Replaces
// src/repro/kernels/flash_attention.py::flash_attention (the Pallas TPU kernel
// _flash_kernel and its pallas_call) for those calls when TMA can address the
// operands; float32 at D 16 and 32, or in operands TMA cannot address, takes
// the tf32 kernel of flash_attention_tf32.cu, bf16 the sm90 kernel of
// flash_attention_sm90.cu. kernels/flash_attention.py::route picks.
//
// What it computes, as the tf32 kernel does (the reference's semantics):
// scores q.k in float32, the scale applied after the product (folded with
// log2(e), so the softmax runs on exp2; in a tile with no masked key the scale
// is folded into the exponent's FFMA); the causal mask and the sliding window
// (k_pos > q_pos - window) write the finite -1e30, so a row whose keys are all
// masked averages v uniformly; keys past Sk score -inf; online softmax with a
// running max, a running sum of the unrounded p and a rescale of the output;
// the output acc / max(l, 1e-30). KV tiles wholly above a block's diagonal are
// skipped and the heaviest q blocks start first. Rows past Sq are not stored.
//
// What bounds it: at phase 7's float32 prefill (B 4, S 2032, H 28, D 128,
// causal) the two products over the unmasked pairs are 118 GFLOP: 0.239 ms at
// the 495 TFLOP/s TF32 rate, and three passes (below) make the products'
// ceiling 0.718 ms; q, k, v and o take 0.16 ms at 3.35 TB/s. At whisper's
// encoder (S 1500, H 16, D 64, bidirectional) the passes' ceiling is 0.223
// ms, at zamba2's (S 1024, H 32, D 80, causal) 0.130 ms; at D 256 (B 4, S
// 2048, H 16, causal) 0.833 ms, the bytes 0.160 ms.
//
// What the design does about it:
// - Both products are wgmma.m64nNk8 with .tf32 operands and a float32
//   accumulator. TF32 keeps 11 significant bits, so each float32 operand is
//   split into hi and lo. The tensor cores read a TF32 operand's top 19 bits
//   (they truncate; phase 3 holds every case to 2e-5), so Q and K as loaded
//   are their own hi operands and lo = x - trunc(x), exact in float32, with
//   half a TF32 ulp added (the truncation then rounds lo to nearest, ties
//   away). V and P, which the kernel writes anyway, take hi = x rounded to
//   TF32 (half an ulp added, the 13 low bits cleared) and lo = x - hi the
//   same way. A product takes three passes, the small ones first: a_lo.b_hi,
//   a_hi.b_lo, then a_hi.b_hi, into one accumulator (the long sum of large
//   terms comes last, so the corrections are not truncated against it).
//   Three passes cap the kernel at a third of the TF32 rate.
// - wgmma's TF32 form has no transpose bit: both operands are K-major in
//   shared memory. Q and K are, as loaded (D contiguous). V is not: it is
//   staged as loaded and written transposed, (D, keys), for P.V's B operand.
// - Warpgroup 1 (128 threads) produces: one thread issues every TMA load, and
//   all of them split each tile once per block when it arrives: Q's and K's
//   lo beside them, V transposed into V^T hi and lo. The split's rate sets
//   the kernel's pace, so each thread first loads its whole share of a unit
//   (V, then K) into registers and only then stores: unrolled, its loads are
//   in flight together (a split item by item waits on each load's latency,
//   and ran the kernel 12-20% slower). They write through the generic proxy,
//   fence it (fence.proxy.async) and arrive on the unit's "ready" barrier,
//   which the consumer waits on.
// - Warpgroup 0 consumes: 64 query rows a block, so a thread holds O, the
//   per-tile P.V sum, S and P's fragments in up to 255 registers (two
//   warpgroups a block, 256 threads, one block an SM). Per KV tile n it issues
//   S_{n+1} = Q.K_{n+1}^T and then P_n.V_n as two wgmma groups; the softmax
//   of S_{n+1} runs while P_n.V_n is on the tensor cores (wait_group 1); after
//   wait_group 0, O joins P_n.V_n and P_{n+1} is split into the fragments.
// - P is taken from registers as P.V's A operand: the S accumulator's
//   elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of each
//   8-key step become the A fragment's a0, a2, a1, a3 when the step's logical
//   contraction index t is key 2t and t + 4 is key 2t + 1; V^T's columns are
//   written in that order within each 8 keys, so no shuffle is needed.
// - Each KV tile's P.V is summed from zero (scale-d 0 on its first wgmma) and
//   joined to O by one float32 FMA, o * corr + pv: no tensor-core accumulator
//   sums a whole row's keys (their float32 sums truncate, and across 2032 keys
//   that alone brought the tf32 kernel's output near the reference's 2e-5).
// - K and V travel in units: unit u holds K_u and V_{u-1} (unit 0 K_0 alone,
//   the last V alone), the two tiles step u - 1 of the loop reads, under one
//   "full" (TMA), one "ready" (split done) and one "empty" (consumed) barrier.
//   With three units (D 80) the loading thread issues unit u + 1 before its
//   share of unit u's split; with two (D 64, 128, 256) after it, since waiting
//   for unit u + 1's stage first would hold back unit u, which the consumer
//   needs at the moment that stage frees.
// - D 256 runs as two blocks of a cluster on the same 64 query rows, block r
//   owning columns 128r .. 128r + 127 of q, k, v and o: each has D 128's
//   tiles, registers and products (O and P.V at D 256 would be 128 floats a
//   thread each, past 255 registers with S and P). Block r's S_r = Q_r.K_r^T
//   is the partial sum over its half of the contraction, in the three
//   passes; each block writes its S_r into the other's shared memory
//   (st.async, completing on that block's "recv" barrier, which it armed for
//   the tile's 8 KB) and adds the other's partial to its own. Float32
//   addition commutes, so both hold the same S bit for bit, run the same
//   softmax and form the same P; each then computes P.V for its own 128
//   columns and stores them. No product is computed twice and no byte of K
//   or V is loaded twice; only the softmax runs in both blocks (its
//   exponentials take 0.03 ms at D 256's shape). The exchange costs 7%
//   (PERF.md).
//   The two receive buffers alternate by tile: a block writes tile n + 2's
//   partial into the buffer tile n used only after the other block's tile
//   n + 1 partial arrived, which each of its threads sent after reading tile
//   n's (st.async completes with release semantics at cluster scope, the
//   wait acquires at cluster scope). A cluster barrier after the barriers'
//   init and another before exit keep every remote write inside both blocks'
//   lifetimes.
// - Shared memory (one block an SM, 227 KB at most; a 128-byte swizzled panel
//   row holds 32 floats, so a row of a block's columns is ceil(columns / 32)
//   panels): Q and Q lo, then a ring of units of K, K lo, V as loaded, V^T hi
//   and V^T lo.
//     D 128: 32-key tiles; Q 2 x 32 KB, a unit 5 x 16 KB, 2 units: 224 KB.
//     D 80: 32-key tiles; Q 2 x 24 KB, a unit 3 x 12 + 2 x 10 KB, 3 units: 216 KB.
//     D 64: 64-key tiles; Q 2 x 16 KB, a unit 5 x 16 KB, 2 units: 192 KB.
//     D 256 (a block's 128 columns): 32-key tiles; Q 2 x 32 KB, a unit 4 x 16
//       KB (V as loaded lands in V^T lo's bytes: every producer thread loads
//       its share of V into registers, the warpgroup meets at a named
//       barrier, then writes V^T hi and lo), 2 units, 2 receive buffers of
//       8 KB: 208 KB.
//   Registers (a consumer thread, floats): O D / 2, P.V D / 2, S keys / 2, P
//   hi and lo keys / 2: 176 at D 128 and at D 256 (a block's half), 128 at D
//   80 and 160 at D 64 before addresses.
// - A mbarrier wait that lasts 4 s traps, so a fault in the pipeline fails the
//   launch instead of hanging the card.
//
// Forms measured and not kept (each right against the plain version, timed on
// an H100 beside this one; PERF.md has the account): V staged in a ring of
// its own two tiles ahead; three rings (K, V^T, V as loaded) with K's slot
// freed when S is done and two warps splitting each ring; 32-key tiles in
// five units at D 64; every load issued before the split with two units; at
// D 256, the partial scores sent by plain remote stores with one remote
// arrive a thread or a warp in place of st.async (20% slower).
// What it leaves for later: two consumer warpgroups sharing each split tile
// (the registers above do not fit 168 a thread), a persistent grid.
//
// The launcher is a plain C function with the flash_attention signature of
// kernels/_build.py.

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 64;              // query rows per block: one consumer warpgroup
constexpr int kThreads = 256;        // warpgroup 0 consumes, warpgroup 1 loads and splits
constexpr int kProducers = 128;      // arrivals that make a unit ready: every producer thread
constexpr int kConsumers = kThreads - kProducers;
constexpr int kConsumerWarps = 4;    // arrivals that free a unit: one per consumer warp
constexpr int kPanelCols = 32;       // float32 columns in one 128-byte swizzled row (one TMA box)
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// Shared memory of one block, offsets from a 1024-byte-aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes; every panel starts on a
// multiple of 1024). A tile of R rows and a block's kDH columns is ceil(kDH /
// 32) panels of R x 128 bytes, the zero-filled columns past D included (what
// TMA counts on the barrier). V^T is keys / 32 panels of kDH rows.
template <int D>
struct Layout {
  static constexpr int kCluster = D == 256 ? 2 : 1;  // blocks that split D's columns
  static constexpr int kDH = D / kCluster;           // columns of q, k, v and o a block owns
  static constexpr int kPanels = (kDH + kPanelCols - 1) / kPanelCols;
  static constexpr int kBKV = D == 64 ? 64 : 32;  // keys per K/V tile
  static constexpr int kS = kBKV / 2;             // S accumulator floats a thread holds
  static constexpr int kSteps = kBKV / 8;         // 8-key steps of P.V
  static constexpr int kUnits = D == 80 ? 3 : 2;  // ring depth
  static constexpr bool kVInVtLo = kCluster > 1;  // V as loaded lands in V^T lo's bytes
  static constexpr int kQBytes = kPanels * kBQ * kRowBytes;
  static constexpr int kTileBytes = kPanels * kBKV * kRowBytes;           // K, K lo or V as loaded
  static constexpr int kVtBytes = (kBKV / kPanelCols) * kDH * kRowBytes;  // V^T hi or lo
  static_assert(!kVInVtLo || kVtBytes == kTileBytes, "V as loaded fills V^T lo's bytes");
  static constexpr int kUnitBytes = (kVInVtLo ? 2 : 3) * kTileBytes + 2 * kVtBytes;
  static constexpr int kRecvBytes = kBQ * kBKV * 4;  // one tile's partial S from the other block
  static constexpr int kQ = 0;
  static constexpr int kQlo = kQ + kQBytes;
  static constexpr int kU = kQlo + kQBytes;
  static constexpr int kRecv = kU + kUnits * kUnitBytes;  // two receive buffers in a cluster
  // mbarriers: q_full, q_ready, full[], ready[], empty[], and in a cluster recv[2]
  static constexpr int kBar = kRecv + (kCluster > 1 ? 2 * kRecvBytes : 0);
  static constexpr int kRecvBar = kBar + 8 * (2 + 3 * kUnits);
  static constexpr int kBytes = kRecvBar + (kCluster > 1 ? 2 * 8 : 0);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the dynamic base
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The producer warpgroup's own barrier (named barrier 1; 0 is __syncthreads')
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
}

// Clusters (D 256): this block's rank, the address of the same shared-memory
// offset in the block of rank `rank`, every thread of both blocks meeting
// (release, then acquire), an st.async of 16 bytes into the other block whose
// bytes complete on its barrier, and a 16-byte load of this block's own.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b, float c, float d, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// x as TF32 operands: hi rounded to nearest (ties away) with its low 13 bits
// cleared, lo = x - hi (exact) with half a TF32 ulp added, read as TF32 by the
// tensor cores (its top 19 bits). Operands are finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

#define ZLLM_ACC8(d, o)                                                                            \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// D (64 x 32, f32) (+)= A (64 x 8 tf32, shared memory, K-major) * B (8 x 32, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 8 tf32, shared memory) * B (8 x 64, shared memory), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8), ZLLM_ACC8(d, 16), ZLLM_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 8 tf32, registers) * B (8 x 64, shared memory, K-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8), ZLLM_ACC8(d, 16), ZLLM_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 80, f32) (+)= A (64 x 8 tf32, registers) * B (8 x 80, shared memory, K-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8), ZLLM_ACC8(d, 16), ZLLM_ACC8(d, 24), ZLLM_ACC8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 8 tf32, registers) * B (8 x 128, shared memory, K-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8), ZLLM_ACC8(d, 16), ZLLM_ACC8(d, 24), ZLLM_ACC8(d, 32),
        ZLLM_ACC8(d, 40), ZLLM_ACC8(d, 48), ZLLM_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// S (64 x N) (+)= Q (64 x 8) K^T (8 x N), both from shared memory
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n32(d, da, db, accumulate);
  }
}

// PV (64 x N) (+)= P (64 x 8, registers) V (8 x N, shared memory as V^T, K-major)
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db, accumulate);
  } else if constexpr (N == 80) {
    wgmma_rs_n80(d, a, db, accumulate);
  } else {
    wgmma_rs_n64(d, a, db, accumulate);
  }
}

// Issue S = Q K^T for the block's 64 rows and one K tile as one wgmma group:
// the three passes over kDH / 8 steps of 8 columns, small passes first (Q lo
// K hi, Q hi K lo, then Q hi K hi); a step within a panel moves the
// descriptors 32 bytes along the swizzled row, the next panel starts anew (at
// D 80 the tenth step reads columns 72-79, never the zero-filled rest). At D
// 256 it is the block's partial S over its 128 columns.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Layout<D>::kS], uint64_t dq, uint64_t dql, uint64_t dk,
                                         uint64_t dkl) {
  constexpr int N = Layout<D>::kBKV, kK = Layout<D>::kDH / 8;
  auto at_q = [](uint64_t d, int kk) { return desc_at(d, (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32); };
  auto at_k = [](uint64_t d, int kk) { return desc_at(d, (kk / 4) * N * kRowBytes + (kk % 4) * 32); };
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) wgmma_qk<N>(s, at_q(dql, kk), at_k(dk, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) wgmma_qk<N>(s, at_q(dq, kk), at_k(dkl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) wgmma_qk<N>(s, at_q(dq, kk), at_k(dk, kk), 1);
  wgmma_commit();
}

// Issue PV = P V for one KV tile as one wgmma group, from zero: the three
// passes over its 8-key steps (P lo V^T hi, P hi V^T lo, P hi V^T hi); V^T's
// key panels lie kDH rows apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&pv)[Layout<D>::kDH / 2],
                                         const uint32_t (&ph)[Layout<D>::kSteps][4],
                                         const uint32_t (&pl)[Layout<D>::kSteps][4], uint64_t dvt,
                                         uint64_t dvtl) {
  constexpr int kSteps = Layout<D>::kSteps, N = Layout<D>::kDH;
  auto at_v = [](uint64_t d, int kk) { return desc_at(d, (kk / 4) * N * kRowBytes + (kk % 4) * 32); };
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_pv<N>(pv, pl[kk], at_v(dvt, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_pv<N>(pv, ph[kk], at_v(dvtl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_pv<N>(pv, ph[kk], at_v(dvt, kk), 1);
  wgmma_commit();
}

// p split into the A fragments of P.V: accumulator element i (row g + 8 *
// ((i >> 1) & 1), key 8 * (i >> 2) + 2t + (i & 1)) is fragment i / 4's
// register a0, a2, a1, a3 for i % 4 = 0, 1, 2, 3 (logical k t = key 2t, t + 4 =
// key 2t + 1).
template <int kS>
__device__ __forceinline__ void split_p(const float (&s)[kS], uint32_t (&ph)[kS / 4][4],
                                        uint32_t (&pl)[kS / 4][4]) {
  constexpr int kA[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < kS; ++i) split_tf32(s[i], ph[i / 4][kA[i % 4]], pl[i / 4][kA[i % 4]]);
}

// O = O * corr + PV per row: one float32 FMA joins a KV tile's P.V to O (N
// columns: a block's)
template <int N>
__device__ __forceinline__ void join(float (&acc_o)[N / 2], const float (&pv)[N / 2], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc_o[i] = fmaf(acc_o[i], corr[(i >> 1) & 1], pv[i]);
}

// D 256's exchange of partial scores between the cluster's two blocks: S +=
// the other block's partial of tile n. This block sends its own into the
// other's receive buffer n % 2 (its bytes completing on the other's recv
// barrier n % 2), arms its own recv barrier for the 8 KB the other sends,
// waits and adds. The tile's 64 x 32 partial lies in a buffer as 4 slices of
// 128 x 16 bytes: consumer thread t's accumulator elements 4j .. 4j + 3 at
// slice j, 16 bytes at t (the same place in both blocks, whose threads hold
// the same elements). Every address is taken anew from the block's base and
// rank, so none is held in a register across the loop.
template <int D>
__device__ __forceinline__ void add_other(float (&s)[Layout<D>::kS], int n, uint32_t base) {
  using L = Layout<D>;
  const uint32_t other = cluster_rank() ^ 1;
  const uint32_t slot = base + L::kRecv + (n & 1) * L::kRecvBytes + threadIdx.x * 16;
  const uint32_t bar = base + L::kRecvBar + 8 * (n & 1);
  const uint32_t their_slot = cluster_addr(slot, other), their_bar = cluster_addr(bar, other);
#pragma unroll
  for (int j = 0; j < L::kS / 4; ++j)
    st_async_v4(their_slot + j * kConsumers * 16, s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3], their_bar);
  if (threadIdx.x == 0) mbar_expect_tx(bar, L::kRecvBytes);
  mbar_wait<true>(bar, (n >> 1) & 1);
#pragma unroll
  for (int j = 0; j < L::kS / 4; ++j) {
    const float4 x = ld_shared_v4(slot + j * kConsumers * 16);
    s[4 * j] += x.x;
    s[4 * j + 1] += x.y;
    s[4 * j + 2] += x.z;
    s[4 * j + 3] += x.w;
  }
}

// The producer's split of a tile that TMA loaded (Q or K): the tile is its
// own hi operand, which the tensor cores truncate to TF32, so lo = x -
// trunc(x), exact, with half a TF32 ulp added; lo goes to the same offset of
// `lo` (the swizzle moves both alike). 16 bytes a thread a step, every load
// first.
__device__ __forceinline__ uint32_t lo_of_loaded(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)) + 0x1000u;
}

template <int BYTES>
__device__ __forceinline__ void split_loaded(const char* tile, char* lo, int pt) {
  static_assert(BYTES % (16 * kProducers) == 0, "a tile is whole steps of every producer thread");
  constexpr int kIters = BYTES / (16 * kProducers);
  float4 x[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) x[i] = *reinterpret_cast<const float4*>(tile + 16 * (pt + i * kProducers));
#pragma unroll
  for (int i = 0; i < kIters; ++i)
    *reinterpret_cast<uint4*>(lo + 16 * (pt + i * kProducers)) =
        make_uint4(lo_of_loaded(x[i].x), lo_of_loaded(x[i].y), lo_of_loaded(x[i].z), lo_of_loaded(x[i].w));
}

// The producer's split and transpose of a V tile (kBKV keys x kDH, as loaded:
// panel p holds columns 32p .. 32p + 31, row r at r * 128 bytes, 16-byte chunk
// c at chunk c ^ (r & 7)) into V^T hi and lo (key panel j holds keys 32j ..
// 32j + 31 in kDH rows of 128 bytes, its 8-key steps' columns in the order of
// P's fragments: key 2t at column t, key 2t + 1 at column t + 4). A warp's
// item is 32 keys (a lane each) and one 16-byte chunk of columns: its reads
// hit 8 distinct chunks a quarter warp, its stores 32 distinct words of one
// row. load() brings a thread's items into registers, store() splits them.
template <int D>
struct VSplit {
  using L = Layout<D>;
  static constexpr int kChunks = L::kDH / 4;  // 16-byte chunks of a row's first kDH columns
  static constexpr int kItems = (L::kBKV / 32) * kChunks / (kProducers / 32);  // a warp's items
  static_assert((L::kBKV / 32) * kChunks % (kProducers / 32) == 0, "items divide among the warps");
  float4 x[kItems];

  __device__ __forceinline__ void load(const char* v, int pt) {
    const int warp = pt / 32, lane = pt % 32;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = warp + i * (kProducers / 32);
      const int j = item / kChunks, c = item % kChunks;
      const int r = 32 * j + lane;
      x[i] = *reinterpret_cast<const float4*>(v + (c / 8) * L::kBKV * kRowBytes + r * kRowBytes +
                                              (((c % 8) ^ (r & 7)) << 4));
    }
  }
  __device__ __forceinline__ void store(char* vt, char* vtl, int pt) const {
    const int warp = pt / 32, lane = pt % 32;
    const int e = lane & 7;
    const int col = (lane & ~7) + ((e & 1) ? 4 + (e >> 1) : (e >> 1));  // this key's column in V^T
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = warp + i * (kProducers / 32);
      const int j = item / kChunks, c = item % kChunks;
      const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = 4 * c + k;
        const int off = j * L::kDH * kRowBytes + d * kRowBytes + (((col >> 2) ^ (d & 7)) << 4) + (col & 3) * 4;
        uint32_t h, l;
        split_tf32(xs[k], h, l);
        *reinterpret_cast<uint32_t*>(vt + off) = h;
        *reinterpret_cast<uint32_t*>(vtl + off) = l;
      }
    }
  }
};

// The ring of units: unit u lives in stage u % kUnits; K_u as loaded (its own
// hi), K_u lo, V_{u-1} as loaded (at D 256 in V^T lo's bytes), V_{u-1}^T hi
// and lo. A block loads its columns c0 .. c0 + kDH - 1.
template <int D>
struct Units {
  using L = Layout<D>;
  uint32_t tiles, full, ready, empty;
  int c0;

  __device__ __forceinline__ uint32_t k(int u) const { return tiles + (u % L::kUnits) * L::kUnitBytes; }
  __device__ __forceinline__ uint32_t klo(int u) const { return k(u) + L::kTileBytes; }
  __device__ __forceinline__ uint32_t vt(int u) const { return k(u) + (L::kVInVtLo ? 2 : 3) * L::kTileBytes; }
  __device__ __forceinline__ uint32_t vtlo(int u) const { return vt(u) + L::kVtBytes; }
  __device__ __forceinline__ uint32_t v(int u) const { return L::kVInVtLo ? vtlo(u) : k(u) + 2 * L::kTileBytes; }
  __device__ __forceinline__ uint32_t phase(int u) const { return (u / L::kUnits) & 1; }
  __device__ __forceinline__ uint32_t bar(uint32_t first, int u) const { return first + 8 * (u % L::kUnits); }
  // the producer: unit u (of n + 1) into its stage once the consumer's four
  // warps released the unit that stage held before (the first pass finds
  // every stage free)
  __device__ __forceinline__ void load(const CUtensorMap* tm_k, const CUtensorMap* tm_v, int u, int n, int h,
                                       int b) const {
    mbar_wait(bar(empty, u), phase(u) ^ 1);
    mbar_expect_tx(bar(full, u), ((u > 0) + (u < n)) * L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      if (u < n)
        tma_load(k(u) + p * L::kBKV * kRowBytes, tm_k, bar(full, u), c0 + p * kPanelCols, u * L::kBKV, h, b);
      if (u > 0)
        tma_load(v(u) + p * L::kBKV * kRowBytes, tm_v, bar(full, u), c0 + p * kPanelCols, (u - 1) * L::kBKV, h,
                 b);
    }
  }
  // a consumer warp's wgmma reads of unit u are done once its wait_group returned
  __device__ __forceinline__ void release(int u) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar(empty, u));
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_tf32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int Sq, int Sk,
                           Strides so, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBKV = L::kBKV, kS = L::kS, kSteps = L::kSteps, kDH = L::kDH;
  constexpr bool kCluster = L::kCluster > 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  char* const gbase = reinterpret_cast<char*>(smem_raw) + (base - raw);  // the same bytes, generic
  auto ptr = [&](uint32_t addr) { return gbase + (addr - base); };
  const uint32_t sQ = base + L::kQ, sQlo = base + L::kQlo;
  const uint32_t q_full = base + L::kBar, q_ready = q_full + 8;
  const uint32_t recv = base + L::kRecvBar;  // recv[2], in a cluster
  // a cluster's block r owns columns kDH * r .. kDH * r + kDH - 1
  auto first_col = [] { return kCluster ? kDH * static_cast<int>(cluster_rank()) : 0; };
  const Units<D> units{base + L::kU, q_ready + 8, q_ready + 8 + 8 * L::kUnits, q_ready + 8 + 16 * L::kUnits,
                       first_col()};

  // q blocks of one (batch, head) are neighbours in launch order and share
  // its K and V in L2; causal: the q blocks with the most KV tiles start
  // first (a cluster's two blocks share their q block)
  const int n_q = gridDim.x / L::kCluster, qi = blockIdx.x / L::kCluster;
  const int qt = causal ? n_q - 1 - qi : qi;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  // the tiles up to the block's last row's diagonal (>= 1: Sk >= 1)
  const int n_tiles = ((causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk) + kBKV - 1) / kBKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, kProducers);
    for (int s = 0; s < L::kUnits; ++s) {
      mbar_init(units.full + 8 * s, 1);
      mbar_init(units.ready + 8 * s, kProducers);
      mbar_init(units.empty + 8 * s, kConsumerWarps);
    }
    if constexpr (kCluster) {
      mbar_init(recv, 1);  // armed by consumer thread 0 for each tile's bytes
      mbar_init(recv + 8, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // in a cluster the other block's barriers are initialised before any st.async reaches them
  if constexpr (kCluster) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: thread pt 0 issues the loads, Q and unit 0 first,
    // then unit u + 1 (before or after its share of unit u's split, by the
    // depth of the ring); every thread splits each arrival
    const int pt = threadIdx.x - kConsumers;
    if (pt == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sQ + p * kBQ * kRowBytes, &tm_q, q_full, units.c0 + p * kPanelCols, q0, h, b);
      units.load(&tm_k, &tm_v, 0, n_tiles, h, b);
    }
    mbar_wait(q_full, 0);
    split_loaded<L::kQBytes>(ptr(sQ), ptr(sQlo), pt);
    fence_proxy_async();
    mbar_arrive(q_ready);
    for (int u = 0; u <= n_tiles; ++u) {
      if (L::kUnits > 2 && pt == 0 && u < n_tiles) units.load(&tm_k, &tm_v, u + 1, n_tiles, h, b);
      mbar_wait(units.bar(units.full, u), units.phase(u));
      VSplit<D> vs;
      if (u > 0) vs.load(ptr(units.v(u)), pt);
      if (u < n_tiles) split_loaded<L::kTileBytes>(ptr(units.k(u)), ptr(units.klo(u)), pt);
      if (u > 0) {
        if constexpr (L::kVInVtLo) producer_sync();  // every share of V read before V^T lo is written
        vs.store(ptr(units.vt(u)), ptr(units.vtlo(u)), pt);
      }
      fence_proxy_async();  // the generic writes, before the consumer's wgmma reads them
      mbar_arrive(units.bar(units.ready, u));
      if (L::kUnits == 2 && pt == 0 && u < n_tiles) units.load(&tm_k, &tm_v, u + 1, n_tiles, h, b);
    }
    if constexpr (kCluster) cluster_sync();
    return;
  }

  // consumer warpgroup: the block's 64 rows, 16 a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane & 3);                // and columns col0, col0 + 1 of every 8
  const uint64_t dq = sw128_desc(sQ, 16, 8 * kRowBytes), dql = sw128_desc(sQlo, 16, 8 * kRowBytes);
  auto desc = [](uint32_t addr) { return sw128_desc(addr, 16, 8 * kRowBytes); };  // K-major
  // whether any key of the tile at k0 can be masked for the block's rows
  auto edge = [&](int k0) { return k0 + kBKV > Sk || window > 0 || (causal && k0 + kBKV - 1 > q0); };
  // the whole S of tile n: in a cluster, this block's partial plus the other's
  auto whole = [&](float(&s)[kS], int n) {
    if constexpr (kCluster) add_other<D>(s, n, base);
  };

  float acc_o[kDH / 2], acc_pv[kDH / 2];
#pragma unroll
  for (int i = 0; i < kDH / 2; ++i) acc_o[i] = acc_pv[i] = 0.f;
  float acc_s[kS], corr[2];
  uint32_t ph[kSteps][4], pl[kSteps][4];  // P_n's fragments, read by P_n V_n
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // S_0 and its softmax
  mbar_wait(q_ready, 0);
  mbar_wait(units.bar(units.ready, 0), units.phase(0));
  issue_qk<D>(acc_s, dq, dql, desc(units.k(0)), desc(units.klo(0)));
  wgmma_wait<0>();
  fence_regs(acc_s);
  units.release(0);
  whole(acc_s, 0);
  softmax_tile(acc_s, m, l, corr, edge(0), 0, row0, col0, Sk, causal, window, scale_log2);
  split_p(acc_s, ph, pl);

  // Per tile n, with unit n + 1 (V_n and K_{n+1}) ready: S_{n+1} = Q K_{n+1}^T
  // and P_n V_n as two groups; the softmax of S_{n+1} runs while P_n V_n is on
  // the tensor cores; then O = O * corr_n + P_n V_n, and P_{n+1} is split into
  // the fragments P_n V_n no longer reads. The last tile's step has P V alone.
  for (int n = 0; n + 1 < n_tiles; ++n) {
    mbar_wait(units.bar(units.ready, n + 1), units.phase(n + 1));
    issue_qk<D>(acc_s, dq, dql, desc(units.k(n + 1)), desc(units.klo(n + 1)));
    issue_pv<D>(acc_pv, ph, pl, desc(units.vt(n + 1)), desc(units.vtlo(n + 1)));
    const float cn[2] = {corr[0], corr[1]};  // tile n's rescale of O
    wgmma_wait<1>();  // S_{n+1} done, P_n V_n in flight
    fence_regs(acc_s);
    whole(acc_s, n + 1);
    softmax_tile(acc_s, m, l, corr, edge((n + 1) * kBKV), (n + 1) * kBKV, row0, col0, Sk, causal, window,
                 scale_log2);
    wgmma_wait<0>();
    fence_regs(acc_pv);
    units.release(n + 1);
    join<kDH>(acc_o, acc_pv, cn);
    split_p(acc_s, ph, pl);
  }
  mbar_wait(units.bar(units.ready, n_tiles), units.phase(n_tiles));
  issue_pv<D>(acc_pv, ph, pl, desc(units.vt(n_tiles)), desc(units.vtlo(n_tiles)));
  wgmma_wait<0>();
  fence_regs(acc_pv);
  units.release(n_tiles);
  join<kDH>(acc_o, acc_pv, corr);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = o + b * so.b + h * so.h + first_col();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp < Sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* orow = ob + qp * so.s + col0;
#pragma unroll
      for (int jj = 0; jj < kDH / 8; ++jj)
        *reinterpret_cast<float2*>(orow + 8 * jj) =
            make_float2(acc_o[4 * jj + 2 * r] / denom, acc_o[4 * jj + 2 * r + 1] / denom);
    }
  }
  if constexpr (kCluster) cluster_sync();  // no st.async of this block is still bound for the other
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq, int64_t Sk,
                   int64_t H, Strides sq, Strides sk, Strides sv, Strides so, int causal, int window,
                   cudaStream_t stream) {
  using L = Layout<D>;
  constexpr int smem = L::kAlloc;
  static_assert(smem <= 227 * 1024, "tiles do not fit in an H100 block's shared memory");
  if (B > 65535 || H > 65535 || Sq > 0x7fffffff || Sk > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, Sq, H, D, sq, kBQ, kMapType, 4);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Sk, H, D, sk, L::kBKV, kMapType, 4);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Sk, H, D, sv, L::kBKV, kMapType, 4);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_sm90_tf32_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the reference's scale 1 / D**0.5 with log2(e) folded in, in double, rounded once
  const float scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ * L::kCluster), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  if constexpr (L::kCluster > 1) {
    // the two blocks of a q block as one cluster along x
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L::kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kern, tq, tk, tv, static_cast<float*>(o), static_cast<int>(Sq),
                             static_cast<int>(Sk), so, causal, window, scale_log2);
    if (err != cudaSuccess) return err;
  } else {
    kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<float*>(o), static_cast<int>(Sq),
                                           static_cast<int>(Sk), so, causal, window, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The flash_attention signature of kernels/_build.py. Takes float32 (dtype 0)
// with D 64, 80, 128 or 256; the Python rule (kernels/flash_attention.py::route) also
// requires 16-byte aligned base pointers and B/S/H strides. Anything else is
// refused with cudaErrorInvalidValue.
int zllm_flash_attention_sm90_tf32(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
                                   int64_t Sk, int64_t H, int64_t D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                   int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                   int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                                   int window, int dtype, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 80: return static_cast<int>(launch<80>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 128: return static_cast<int>(launch<128>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 256: return static_cast<int>(launch<256>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A block's dynamic shared memory (bytes) and the blocks of a cluster (1, or
// 2 at D 256) of the instance for head dim D; cudaErrorInvalidValue for a D
// it is not built for.
int zllm_flash_attention_sm90_tf32_layout(int64_t D, int* smem, int* cluster) {
  auto take = [&](auto layout) {
    using L = decltype(layout);
    *smem = L::kAlloc;
    *cluster = L::kCluster;
    return static_cast<int>(cudaSuccess);
  };
  switch (D) {
    case 64: return take(Layout<64>{});
    case 80: return take(Layout<80>{});
    case 128: return take(Layout<128>{});
    case 256: return take(Layout<256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
