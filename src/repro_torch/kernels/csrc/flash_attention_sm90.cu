// Hopper (sm_90a) flash-attention forward pass for bf16 q, k and v with head
// dim 16, 32, 64, 80, 128 or 256: the tensor-core route of the port's bf16
// attention (D 128: the transformer families; D 80: zamba2-2.7b's shared
// attention; D 64: whisper; D 16 and 32: the configs' smoke variants; D 256
// and D 16: the reference kernel's own test sweep). Replaces
// src/repro/kernels/flash_attention.py::flash_attention (the Pallas TPU kernel
// _flash_kernel and its pallas_call) for those calls; float32 at D 64/80/128
// takes flash_attention_sm90_tf32.cu, and every other call (float32 at D
// 16/32/256, operands TMA cannot address) the TF32 kernel of
// flash_attention_tf32.cu. kernels/flash_attention.py::route picks.
//
// What it computes, in this order of arithmetic: scores q.k accumulated in
// float32 from the bf16 operands; the scale applied to the float32 scores
// after the product (folded with log2(e), so the softmax runs on exp2; in a
// tile with no masked key the scale is folded into the exponent's FFMA); then
// the mask, in those scaled units: the finite -1e30 for keys the causal mask
// or the sliding window (k_pos > q_pos - window) removes, so a row whose keys
// are all masked averages v uniformly, and -inf for keys past Sk; online
// softmax with a running max, a running sum of the unrounded p and a rescale
// of the accumulator; p rounded to bf16 before the PV product, as the
// reference rounds p to v's type; the output acc / max(l, 1e-30) in bf16. KV
// tiles wholly above a q block's diagonal are skipped and the heaviest q
// blocks start first; tiles below a sliding window are not skipped (a
// bidirectional windowed row with Sq > Sk can be fully masked). Rows past Sq
// are not stored.
//
// What bounds it: at the serving path's larger prefill (B 4, S 2032, H 28,
// D 128, causal) the two products over the unmasked (q, k) pairs are 120 GFLOP
// against 0.23 GB of q, k, v and o, so the bound is the bf16 tensor cores:
// 0.12 ms at 989 TFLOP/s (the bytes take 0.07 ms at 3.35 TB/s). At zamba2's
// prefill (B 4, S 1024, H 32, D 80, causal) it is 21 GFLOP against 0.084 GB,
// so the bytes bound it: 0.025 ms (the tensor cores need 0.022 ms). At D 256
// (B 4, S 2048, H 16, causal) the products are 137 GFLOP against 0.27 GB:
// 0.139 ms of tensor cores. Every unmasked pair also costs one exp2, and the
// SM's MUFU does 16 a cycle: at 132 SMs and the SM's highest clock, 1.98 GHz,
// that is as long as 4 flops a pair and D at 989 TFLOP/s take at D 59, so
// below D 60 the exponentials bound it. At D 16 and 32 (B 4, S 2048, H 16,
// causal) the 134.28 M pairs take 0.0321 ms, against 0.0087 / 0.0174 ms of
// products and 0.0050 / 0.0100 ms of bytes.
// Inside the SM the softmax competes with the products: a 64 x 64 tile's 4096
// exp2 take 256 cycles of the SM's 16 a cycle, against 512 cycles of wgmma at
// D 128 (320 at D 80, 256 at D 64, 1024 at D 256, 64 and 128 at D 16 and 32),
// so from D 64 the exp2 has to run under the products, and below it the
// products are what has to hide.
//
// What the design does about it (one block per 128 query rows of one (batch,
// head); grid (q blocks, H, B), q blocks reversed when causal):
// - Warpgroups 0 and 1 consume, 64 query rows apiece. At D 64, 80 and 128
//   warpgroup 2 produces (one thread issues every TMA load): 384 threads, one
//   block an SM, so ptxas gives a thread 168 registers. At D 16 and 32 one
//   warp produces: 288 threads, two blocks an SM, 112 registers a thread. The
//   two consumers share every K and V tile, so L2 sends each tile once per
//   128 query rows.
// - From D 64 the consumers take turns at the tensor cores through two named
//   barriers (FA3's ping-pong): one turn per KV tile issues S_{n+1} =
//   Q.K_{n+1}^T and O += P_n.V_n back to back; the softmax of S_{n+1} then
//   runs while P_n.V_n and the other warpgroup's turn are on the tensor cores.
//   wgmma.wait_group 1 lets S_{n+1} finish with P_n.V_n in flight, wait_group
//   0 retires P_n.V_n before P is repacked; O is rescaled before the next
//   turn, when no product holds it. Live at once: O (D / 2), S (a tile's
//   half), P (a quarter).
// - KV tiles are 64 keys at D 80 and 128 and 128 keys at D 64: the widest
//   that keeps O, S and P with S's product in flight inside 168 registers (at
//   D 128 a 128-key tile needs 64 + 64 + 32 and spills).
// - D 256 has no producer: O alone is 128 floats a thread, which 168
//   registers cannot hold beside S and P; 256 threads (8 warps, 2 a register
//   file) get 255, and ptxas uses 250 with 80-key tiles (O 128, S 40, P 20).
//   The first thread of warpgroup 1 loads: Q and the first units before the
//   loop, then each later unit as soon as its warpgroup released the stage,
//   which warpgroup 0 released half a turn before, so the wait is short and
//   its warpgroup's softmax window absorbs the issue. Q is 64 KB (four panels
//   a row) and an 80-key unit 80 KB, so two units fill 224 KB; 80 keys is also
//   where Q.K^T (m64n80k16) reads shared memory below its 128 bytes a cycle
//   (4.5 KB a 40-cycle product; n64 needs all 128, n48 and n32 more). P.V is
//   m64n256k16, B spanning all four panels of V.
// - D 16 and 32: the softmax sets the pace, and its chains of dependent
//   instructions, more than any unit, so more warps help. Two blocks an SM
//   (18 warps) with 64-key tiles fit O (8 or 16 floats), S (32) and P (16) in
//   112 registers beside S's product in flight (Q.K^T one or two m64n64k16,
//   P.V four m64n16k16 or m64n32k16). The warpgroups take no turns: each
//   issues as soon as its softmax is done. A tile row is D's own 32 or 64
//   bytes, swizzled in as many (TMA boxes of D columns), so shared memory
//   holds no zero columns: Q is 4 or 8 KB, a 64-key unit 4 or 8 KB, in a
//   ring of 24 or 12.
// - K and V travel in units: unit u holds V_{u-1} and K_u (unit 0 K_0 alone,
//   the last V alone), the two tiles one turn reads, under one "full" and one
//   "empty" mbarrier: one barrier wait and one release a turn, in a ring of 6
//   from D 64 to 128.
// - The causal skip works per 64-row warpgroup where tiles are 64 keys: the
//   upper warpgroup computes no tile past its own diagonal and passes the turn
//   of the lower one's diagonal tile without products.
// - q, k and v stay bf16 in shared memory, loaded by TMA through 4-D tensor
//   maps over (D, S, H, B) with the operands' own byte strides (a strided slice
//   of a fused projection needs no copy). From D 64 a row is 128-byte
//   swizzled and a box holds 64 bf16 columns, so a D-128 row is two boxes,
//   two 128-byte panels in shared memory, and the wgmma descriptors walk both.
//   A D-80 row is two boxes too: the second, at column 64, brings columns
//   64-79 and zero-fills 80-127 (past the map's D), so every tile is whole
//   128-byte panels and keeps the swizzle's alignment; Q.K^T reads five
//   k-steps (four in panel 0, one in panel 1) and P.V is one m64n80k16 per 16
//   keys whose B spans both panels. TMA zero-fills rows past Sq and Sk; those
//   keys still score -inf by position.
// - S = Q.K^T is wgmma.m64nNk16 (N the tile's keys) with A (Q) and B (K) both
//   K-major in shared memory; O += P.V is wgmma.m64nDk16 with P taken from
//   registers as the A operand (the S accumulator's layout is the A
//   fragment's, so P needs no shuffle) and V as the B operand in its natural
//   (keys, D) layout, read MN-major through the transpose bit wgmma has for
//   16-bit B. The descriptors derive from a warp-uniform warpgroup index, so
//   each step of a product adds an immediate to a uniform register.
// - The online softmax runs on the accumulator fragments in registers: each
//   thread holds two rows; a row's max and sum reduce over the 4 threads that
//   share it, in 4 independent chains a thread. The scale is folded into the
//   exponent's FFMA where no key is masked, and the mask tests run only on
//   tiles that can hold a masked key.
// - A mbarrier wait that lasts 4 s traps, so a fault in the pipeline fails the
//   launch instead of hanging the card.
//
// Forms measured and not kept (each checked right against the plain version,
// timed on an H100 beside the kept one; PERF.md has the account): at D 256,
// 64-key tiles in 2 units, 48 in 3 and 32 in 5. At D 64/80/128: 64-row
// blocks, two an SM, with a producer warp (160 threads) get 168 registers too
// (10 warps over 4 register files), and at D 128 ptxas spilled and serialised
// the wgmma; without the producer warp, the loads a consumer thread issues
// (expect_tx, TMA, the stage tests) stall its warpgroup every tile, and every
// 64-row block reads K and V from L2 again; setmaxnreg (producer 24-40,
// consumers 232-240 registers) left ptxas's allocation at 168. At D 16 and
// 32: D 64's layout (one block, producer warpgroup, turns, 128-key tiles,
// 128-byte boxes zero-filled past D) 31% and 28% slower; two blocks without a
// producer, the last releasing warp loading, at 128-key tiles (P_n.V_n
// retired before S_{n+1} is issued, to fit 128 registers) 5% slower at D 16
// and as fast at D 32, at 64-key tiles 10-15% slower; turns, 96-key tiles,
// P_n.V_n and S_{n+1} as one group, three or four blocks, 256-key tiles,
// all slower.
//
// What it leaves for later: D 128 at 128-key tiles, which needs more than
// 168 registers a thread (its softmax of a 64-key tile outlasts the other
// warpgroup's products, so the tensor cores idle part of each turn); at D 16
// and 32, the half of the exponentials' floor it misses (neither the MUFU nor
// the issue slots are busy most of the time; cut out of throwaway copies, the
// softmax without its exp2 still took 88% of the time); a persistent grid
// with a tile scheduler; a TMA store of O; at D 256, two blocks of a cluster
// sharing each K/V unit through TMA multicast; fp8; native grouped-query
// indexing (the TPU kernel takes expanded heads, and so does this interface).
//
// The launcher is a plain C function with the flash_attention signature of
// kernels/_build.py; the tensor maps are encoded on the host at each call with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int kConsumers = 256;   // consumer warpgroups 0 and 1 (the producer's threads follow)
constexpr int kWarps = 8;         // arrivals that free a stage: one per consumer warp
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// Shared memory of one block, offsets from a 1024-byte-aligned base (a
// swizzle repeats every 8 rows). A tile of R rows and D columns is panels of
// R rows of kRow bytes: at D 16 and 32 one panel of D's own width (32- or
// 64-byte swizzle); from D 64 ceil(D / 64) panels of 128 bytes, whole TMA
// boxes, the zero-filled columns past D included, which is also what TMA
// counts on the barrier. K and V travel in units: unit u holds V_{u-1} and
// K_u (unit 0 K_0 alone, the last V alone), the two tiles step n of the loop
// reads, under one barrier.
//
// Beside the two consumer warpgroups, a producer loads: a warpgroup at D 64,
// 80 and 128 (384 threads, one block an SM, 168 registers a thread), one warp
// at D 16 and 32 (288 threads, two blocks an SM, 112 registers). D 256 has no
// producer: 256 threads, 8 warps, so ptxas may give a thread 255 registers (O
// alone is 128 floats), and one consumer thread loads (kLoader).
template <int D>
struct Layout {
  static constexpr bool kProducer = D != 256;
  static constexpr int kThreads = !kProducer ? 256 : D <= 32 ? 288 : 384;
  // the thread that issues every load: the producer's first, or warpgroup
  // 1's first, which releases each unit after warpgroup 0 does
  static constexpr int kLoader = kProducer ? kConsumers : 128;
  static constexpr int kBlocks = D <= 32 ? 2 : 1;  // blocks an SM
  static constexpr int kRow = D <= 32 ? 2 * D : 128;  // bytes of a tile row in one panel
  static constexpr int kPanelCols = kRow / 2;         // bf16 columns of a panel (one TMA box)
  static constexpr int kPanels = (D + kPanelCols - 1) / kPanelCols;
  static constexpr int kSteps = kRow / 32;            // 16-column k-steps of Q.K^T in a panel
  // keys per K/V tile: 128 at D 64, where O, S and P of a tile fit a thread's
  // 168 registers beside the product in flight (32 + 64 + 32), 80 at D 256
  // (the most two units take beside Q; O + S + P 128 + 40 + 20), else 64 (at
  // D 16 and 32 in 112 registers)
  static constexpr int kBKV = D == 64 ? 128 : D == 256 ? 80 : 64;
  static constexpr int kS = kBKV / 2;  // S accumulator floats a thread holds for one tile
  // the consumers take turns at the tensor cores (below) where the products
  // are long; at D 16 and 32 each issues as soon as its softmax is done
  static constexpr bool kTurns = D > 32;
  // ring depth: 208-224 KB from D 64; at D 256 Q takes 64 KB and an 80-key
  // unit 80 KB, so two units fill 224 KB; at D 16 and 32 96 KB of units a
  // block (4 and 8 KB a unit), two blocks an SM
  static constexpr int kUnits = D == 256 ? 2 : D == 16 ? 24 : D == 32 ? 12 : 6;
  // without a producer, warpgroup 1's loading thread refills the stage of
  // unit u once warpgroup 0 released it too, for every u up to n_load -
  // kUnits. Warpgroup 0 releases units 0 .. n_tiles - 1, and its causal
  // n_tiles falls short of n_load by up to ceil(64 / kBKV): so kUnits - 1
  // tiles must cover its 64 rows, or that wait never ends.
  static_assert(kProducer || kBKV * (kUnits - 1) >= 64,
                "warpgroup 0 would never release a unit the loading thread waits on");
  static constexpr int kQBytes = kPanels * kBQ * kRow;
  static constexpr int kTileBytes = kPanels * kBKV * kRow;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kU = kQ + kQBytes;                  // unit s: V at kU + 2 s tiles, K after it
  // mbarriers: q_full, full[], empty[]
  static constexpr int kBar = kU + kUnits * 2 * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kUnits);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the dynamic base
};


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16, shared memory, K-major) * B (16 x 64, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 16, shared memory, K-major) * B (16 x 128, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
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

#define ZLLM_ACC8(d, o)                                                                            \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// D (64 x 80, f32) (+)= A (64 x 16, shared memory, K-major) * B (16 x 80, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8), ZLLM_ACC8(d, 16), ZLLM_ACC8(d, 24), ZLLM_ACC8(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// S (64 x N) (+)= Q (64 x 16) K^T (16 x N), both from shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss_s(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, desc_a, desc_b, accumulate);
  } else if constexpr (N == 80) {
    wgmma_ss_n80(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(N == 64, "no S product of this tile width");
    wgmma_ss_n64(d, desc_a, desc_b, accumulate);
  }
}

// D (64 x 256, f32) += A (64 x 16 bf16, registers) * B (16 x 256, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8), ZLLM_ACC8(d, 16), ZLLM_ACC8(d, 24), ZLLM_ACC8(d, 32), ZLLM_ACC8(d, 40), ZLLM_ACC8(d, 48), ZLLM_ACC8(d, 56), ZLLM_ACC8(d, 64), ZLLM_ACC8(d, 72), ZLLM_ACC8(d, 80), ZLLM_ACC8(d, 88), ZLLM_ACC8(d, 96), ZLLM_ACC8(d, 104), ZLLM_ACC8(d, 112), ZLLM_ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
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

// D (64 x 80, f32) += A (64 x 16 bf16, registers) * B (16 x 80, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
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


// D (64 x 32, f32) += A (64 x 16 bf16, registers) * B (16 x 32, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0), ZLLM_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 16, f32) += A (64 x 16 bf16, registers) * B (16 x 16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ZLLM_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// O (64 x D) += P (64 x 16, registers) * V (16 x D, shared memory, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc_v) {
  if constexpr (D == 256) {
    wgmma_rs_n256(d, a, desc_v, 1);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, desc_v, 1);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(d, a, desc_v, 1);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, desc_v, 1);
  } else if constexpr (D == 32) {
    wgmma_rs_n32(d, a, desc_v, 1);
  } else {
    static_assert(D == 16, "no P.V product of this head dim");
    wgmma_rs_n16(d, a, desc_v, 1);
  }
}


// Issue S = Q K^T for a warpgroup's 64 query rows (dq: the descriptor of its
// first row in Q's tile) and one KV tile (dk), as one wgmma group: D / 16
// steps of 16 columns; a step within a panel moves the descriptors 32 bytes
// along the swizzled row, the next panel starts anew (at D 80 the fifth step
// reads columns 64-79, never the zero-filled rest).
template <int D, int N = Layout<D>::kBKV>
__device__ __forceinline__ void issue_qk(float (&acc_s)[N / 2], uint64_t dq, uint64_t dk) {
  using L = Layout<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_s<N>(acc_s, desc_at(dq, (kk / L::kSteps) * kBQ * L::kRow + (kk % L::kSteps) * 32),
                  desc_at(dk, (kk / L::kSteps) * N * L::kRow + (kk % L::kSteps) * 32), kk > 0);
  wgmma_commit();
}

// Issue O += P V as one wgmma group (dv: V's tile of N keys, MN-major with
// its panels N rows apart): N / 16 steps of 16 keys, each 16 rows on; D 80
// reads 16 columns of the second panel.
template <int D, int N = Layout<D>::kBKV>
__device__ __forceinline__ void issue_pv(float (&acc_o)[D / 2], const uint32_t (&pa)[N / 16][4], uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_pv<D>(acc_o, pa[kk], desc_at(dv, kk * 16 * Layout<D>::kRow));
  wgmma_commit();
}


// p rounded to bf16, packed straight into the A fragments of the PV product:
// the S accumulator's layout is the A operand's, 16 keys per fragment.
template <int kS>
__device__ __forceinline__ void pack_p(const float (&acc_s)[kS], uint32_t (&pa)[kS / 8][4]) {
#pragma unroll
  for (int i = 0; i < kS; i += 2) pa[i / 8][(i / 2) % 4] = pack_bf16(acc_s[i], acc_s[i + 1]);
}

// O *= corr per row (a vote that skipped it when no row of a warp changed its
// max cost more than the multiplies)
template <int D>
__device__ __forceinline__ void rescale(float (&acc_o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] *= corr[(i >> 1) & 1];
}

// The ring of units: unit u lives in stage u % kUnits, V_{u-1} first, K_u
// after it.
template <int D>
struct Units {
  using L = Layout<D>;
  uint32_t tiles, full, empty;

  __device__ __forceinline__ uint32_t v_tile(int u) const { return tiles + (u % L::kUnits) * 2 * L::kTileBytes; }
  __device__ __forceinline__ uint32_t k_tile(int u) const { return v_tile(u) + L::kTileBytes; }
  __device__ __forceinline__ void wait(int u) const { mbar_wait(full + 8 * (u % L::kUnits), (u / L::kUnits) & 1); }
  // a warp's wgmma reads of unit u are done once its wait_group returned
  __device__ __forceinline__ void release(int u) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (u % L::kUnits));
  }
  // the loading thread: unit u (of n_load + 1) into its stage once all eight
  // consumer warps released the unit that stage held before (the first pass
  // finds every stage free)
  __device__ __forceinline__ void load(const CUtensorMap* tm_k, const CUtensorMap* tm_v, int u, int n_load,
                                       int h, int b) const {
    const int s = u % L::kUnits;
    mbar_wait(empty + 8 * s, ((u / L::kUnits) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, ((u > 0) + (u < n_load)) * L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      if (u > 0)
        tma_load(v_tile(u) + p * L::kBKV * L::kRow, tm_v, full + 8 * s, p * L::kPanelCols, (u - 1) * L::kBKV,
                 h, b);
      if (u < n_load)
        tma_load(k_tile(u) + p * L::kBKV * L::kRow, tm_k, full + 8 * s, p * L::kPanelCols, u * L::kBKV, h, b);
    }
  }
};

// The two consumer warpgroups take turns at the tensor cores (named barriers
// 1 and 2, 256 threads each): a warpgroup waits at its own barrier, issues
// its products, and arrives at the other's, so one warpgroup's softmax runs
// while the other's products do. Warpgroup 1 arrives once first, so
// warpgroup 0 has the first turn. Layouts without turns skip both.
template <int D>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (Layout<D>::kTurns) asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}
template <int D>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (Layout<D>::kTurns) asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(kConsumers) : "memory");
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, Layout<D>::kBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq,
                      int Sk, Strides so, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBKV = L::kBKV, kS = L::kS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t bar_q = base + L::kBar;
  const Units<D> units{base + L::kU, bar_q + 8, bar_q + 8 + 8 * L::kUnits};

  // q blocks of one (batch, head) are neighbours in launch order, so they run
  // together and share that head's K and V in L2; causal: within a head, the
  // q blocks with the most KV tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  // the block loads the tiles up to its last row's diagonal
  const int n_load = ((causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk) + kBKV - 1) / kBKV;  // >= 1: Sk >= 1

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kUnits; ++s) {
      mbar_init(units.full + 8 * s, 1);
      mbar_init(units.empty + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the loading thread issues Q and then the units in order, each into its
  // stage as soon as the consumers have released it: the producer's thread
  // all of them; warpgroup 1's thread (D 256) the first kUnits here and each
  // later one in refill below
  auto load_q = [&] {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(sQ + p * kBQ * L::kRow, &tm_q, bar_q, p * L::kPanelCols, q0, h, b);
  };
  if constexpr (L::kProducer) {
    if (threadIdx.x >= kConsumers) {
      if (threadIdx.x == L::kLoader) {
        load_q();
        for (int u = 0; u <= n_load; ++u) units.load(&tm_k, &tm_v, u, n_load, h, b);
      }
      return;
    }
  } else {
    if (threadIdx.x == L::kLoader) {
      load_q();
      for (int u = 0; u <= min(n_load, L::kUnits - 1); ++u) units.load(&tm_k, &tm_v, u, n_load, h, b);
    }
    __syncwarp();
  }

  // consumer warpgroup wg: 64 query rows. It walks the tiles up to its own
  // diagonal (the upper one has one tile fewer where the lower one's diagonal
  // has a tile of its own, and passes that turn without products), or all of
  // them if it has no row below Sq (rows past Sq are not stored).
  // the warpgroup index through a shuffle from lane 0, so that the compiler
  // knows it uniform and builds the wgmma descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int wg_q0 = q0 + 64 * wg;
  const int n_tiles = causal && wg_q0 < Sq ? (min(Sk, min(wg_q0 + 64, Sq)) + kBKV - 1) / kBKV : n_load;
  const int row0 = wg_q0 + 16 * warp + (lane >> 2);  // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane & 3);                   // and columns col0, col0 + 1 of every 8
  constexpr uint32_t kRow = L::kRow;
  const uint64_t dq = swizzle_desc(sQ + 64 * wg * kRow, 16, 8 * kRow, kRow);                    // K-major
  auto dk = [&](int u) { return swizzle_desc(units.k_tile(u), 16, 8 * kRow, kRow); };           // K-major
  auto dv = [&](int u) { return swizzle_desc(units.v_tile(u), kBKV * kRow, 8 * kRow, kRow); };  // MN-major
  // whether any key of the tile at k0 can be masked for the warpgroup's rows
  auto edge = [&](int k0) {
    return k0 + kBKV > Sk || window > 0 || (causal && k0 + kBKV - 1 > wg_q0);
  };
  // without a producer: once warpgroup 1 released unit u, its loading thread
  // waits for warpgroup 0's release (already made, as a rule) and loads unit
  // u + kUnits into that stage. Warpgroup 1 walks every unit; warpgroup 0
  // releases all that this waits on (Layout's static_assert).
  auto refill = [&](int u) {
    if constexpr (!L::kProducer) {
      if (threadIdx.x == L::kLoader && u + L::kUnits <= n_load)
        units.load(&tm_k, &tm_v, u + L::kUnits, n_load, h, b);
      __syncwarp();
    }
  };

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float acc_s[kS], corr[2];
  uint32_t pa[kBKV / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // S_0 in the first turn, then its softmax
  if (wg == 1) turn_pass<D>(wg);
  mbar_wait(bar_q, 0);
  units.wait(0);
  turn_wait<D>(wg);
  issue_qk<D>(acc_s, dq, dk(0));
  turn_pass<D>(wg);
  wgmma_wait<0>();
  fence_regs(acc_s);
  units.release(0);
  refill(0);
  softmax_tile(acc_s, m, l, corr, edge(0), 0, row0, col0, Sk, causal, window, scale_log2);
  pack_p(acc_s, pa);

  // Per tile n, with unit n + 1 (V_n and K_{n+1}) arrived, one turn issues
  // S_{n+1} = Q K_{n+1}^T and O += P_n V_n; the softmax of S_{n+1} then runs
  // while P_n V_n and the other warpgroup's turn are on the tensor cores. O is
  // rescaled before the turn, when no product holds it; P is repacked once
  // P_n V_n is done. The last tile's turn has P V alone.
  for (int n = 0; n + 1 < n_tiles; ++n) {
    units.wait(n + 1);
    rescale<D>(acc_o, corr);
    turn_wait<D>(wg);
    issue_qk<D>(acc_s, dq, dk(n + 1));
    issue_pv<D>(acc_o, pa, dv(n + 1));
    turn_pass<D>(wg);
    wgmma_wait<1>();  // S_{n+1} done, P_n V_n in flight
    fence_regs(acc_s);
    softmax_tile(acc_s, m, l, corr, edge((n + 1) * kBKV), (n + 1) * kBKV, row0, col0, Sk, causal, window,
                 scale_log2);
    wgmma_wait<0>();
    fence_regs(acc_o);
    units.release(n + 1);
    refill(n + 1);
    pack_p(acc_s, pa);
  }
  units.wait(n_tiles);
  rescale<D>(acc_o, corr);
  turn_wait<D>(wg);
  issue_pv<D>(acc_o, pa, dv(n_tiles));
  turn_pass<D>(wg);
  wgmma_wait<0>();
  fence_regs(acc_o);
  // the turns both warpgroups take are 1 + n_load: the upper one passes the
  // turn of the tile it does not need, and warpgroup 0 takes up the arrival
  // warpgroup 1 made last
  for (int n = n_tiles; n < n_load; ++n) {
    turn_wait<D>(wg);
    turn_pass<D>(wg);
  }
  if (wg == 0) turn_wait<D>(wg);

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
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
            pack_bf16(acc_o[4 * jj + 2 * r] / denom, acc_o[4 * jj + 2 * r + 1] / denom);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq, int64_t Sk,
                   int64_t H, Strides sq, Strides sk, Strides sv, Strides so, int causal, int window,
                   cudaStream_t stream) {
  constexpr int smem = Layout<D>::kAlloc;
  // an H100 SM has 228 KB of shared memory, 1 KB of it held for each block
  static_assert((smem + 1024) * Layout<D>::kBlocks <= 228 * 1024, "tiles do not fit in an H100 SM");
  const int64_t q_tiles = (Sq + kBQ - 1) / kBQ;
  if (B > 65535 || H > 65535 || Sq > 0x7fffffff || Sk > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  constexpr uint32_t row = Layout<D>::kRow;
  cudaError_t err = make_map(&tq, q, B, Sq, H, D, sq, kBQ, kMapType, 2, row);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Sk, H, D, sk, Layout<D>::kBKV, kMapType, 2, row);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Sk, H, D, sv, Layout<D>::kBKV, kMapType, 2, row);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_sm90_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the reference's scale 1 / D**0.5 with log2(e) folded in, in double, rounded once
  const float scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(H), static_cast<unsigned>(B));
  kern<<<grid, Layout<D>::kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<int>(Sq),
                                         static_cast<int>(Sk), so, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The flash_attention signature of kernels/_build.py. Takes bf16 (dtype 1)
// with D 16, 32, 64, 80, 128 or 256; the Python rule (kernels/flash_attention.py::route) also requires 16-byte
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
    case 16: return static_cast<int>(launch<16>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 32: return static_cast<int>(launch<32>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 64: return static_cast<int>(launch<64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 80: return static_cast<int>(launch<80>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 128: return static_cast<int>(launch<128>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    case 256: return static_cast<int>(launch<256>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
