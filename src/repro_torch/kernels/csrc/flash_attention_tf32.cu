// Hopper (sm_90a) flash-attention forward pass on the tensor cores for every
// call the sm90 and sm90_tf32 routes do not take: float32 q, k and v at head
// dims 16 and 32 (bf16 at every head dim takes sm90, float32 at 64, 80, 128
// and 256 sm90_tf32), or operands of
// either dtype a TMA tensor map cannot address (a base pointer off a 16-byte
// boundary, an odd S stride, heads broadcast with stride 0). Replaces
// src/repro/kernels/flash_attention.py::flash_attention (the Pallas TPU
// kernel _flash_kernel and its pallas_call, wrapper at :99) for those calls;
// kernels/flash_attention.py::route picks.
//
// What it computes, as the TPU kernel does: q (B, Sq, H, D), k and v
// (B, Sk, H, D) with grouped-query heads already expanded; scores q.k / sqrt(D)
// in float32 (the scale applied to the float32 scores after the product);
// positions start at 0 for both q and k; a causal mask (k_pos <= q_pos) and an
// optional sliding window (k_pos > q_pos - window) write the finite -1e30, not
// -inf, so a row whose keys are all masked averages v uniformly, as the
// references do; keys past Sk score -inf (weight 0); online softmax with a
// running max, a running sum of the unrounded p and a rescale of the
// accumulator; p rounded to v's type before the PV product; the output
// acc / max(l, 1e-30) in q's type. KV tiles wholly above the diagonal are
// skipped; ragged Sq and Sk are masked (rows past Sq are not stored).
//
// What bounds it: at the float32 prefills of the port's families (B 4; phase
// 7's S 2032, H 28, D 128, causal; whisper-medium's encoder, S 1500, H 16,
// D 64) the two products are 4 * D * pairs flops, 118 and 37 GFLOP against
// 0.53 and 0.10 GB of q, k, v and o: the TF32 tensor cores bound them (0.239
// and 0.075 ms at 495 TFLOP/s; the bytes take 0.16 and 0.03 ms at 3.35 TB/s).
// At zamba2-2.7b's shared attention (S 1024, H 32, D 80) the bytes do (0.050
// ms against 0.043). The SIMT kernel of flash_attention.cu (float32 FMAs from
// shared memory) reached 2.3% of its bound; this one runs both products on
// the tensor cores.
//
// What the design does about it:
// - Both products are mma.sync.m16n8k8 with TF32 operands and a float32
//   accumulator. One TF32 value keeps 11 significant bits, so a float32
//   operand is split when its fragment is formed: x_hi = tf32(x) and
//   x_lo = tf32(x - x_hi) (round to nearest, ties away, as cvt.rna does),
//   and each product takes three passes, a_hi b_hi + a_hi b_lo + a_lo b_hi,
//   which keeps the error near float32's (one pass misses the reference's
//   2e-5). A bf16 value, and p rounded to bf16, are exact in TF32: bf16 calls
//   take the first pass alone, exactly. The passes are a template parameter
//   (3 for float32, 1 for bf16); three passes cap the float32 kernel at a
//   third of the TF32 rate.
// - mma.sync takes both operands from registers, so the split is made in
//   registers and shared memory holds one copy of each tile in the operands'
//   own type (bf16 tiles stay 16-bit and are widened as fragments form), and
//   V's fragments come straight from its (keys, D) layout with no transpose.
// - No shuffle anywhere: the contraction index of each 8-deep k-step is
//   permuted (logical column t of the A fragment is physical column 2t,
//   t + 4 is 2t + 1, and the same for B). Q and K fragments are then adjacent
//   pairs (one 64-bit load of float32, one 32-bit load of bf16), and in P.V the
//   S accumulator's registers are already the A fragment of the next product.
// - Short chains of dependent mma: a product sums its k-steps into three
//   accumulators (a_hi b_hi alternating between two by k-step, the two
//   correction passes into the third), added at the end; O's P.V over one
//   KV tile accumulates from zero, 8 columns at a time, and joins O in one
//   float32 FMA (o * corr + pv), so no tensor-core accumulator sums a whole
//   row's keys (their float32 sums truncate, and across 2032 keys that alone
//   brought the float32 output near the reference's 2e-5).
// - One block of 4 warps per 64 query rows of one (batch, head), 16 rows a
//   warp; grid (q tiles, H, B), the heaviest causal q tiles first. KV tiles of
//   BKV keys (64; 32 in float32 from D 64 and at D 256, for registers and to
//   let two blocks share an SM where the shared memory allows, which
//   __launch_bounds__ then asks of ptxas) are double buffered and filled by
//   cp.async while the previous tile computes. The copy width is the
//   operands' common alignment, 16, 8 or 4 bytes (2-byte aligned bf16 slices
//   take plain loads); TMA's bulk copies need an alignment these operands
//   lack. Rows past Sq and Sk are zero-filled.
// - Q and K rows are padded by 8 elements (the pair loads of columns 2t and
//   2t + 1 in rows g = 0..7 then hit distinct banks) and V rows by 16 bytes
//   (rows 2t and 2t + 1 at column g), so fragment loads are free of bank
//   conflicts, and every row stays 16-byte aligned for cp.async.
// - The online softmax runs on the accumulator fragments in log2 units (the
//   scale carries log2(e); MUFU.EX2), masking only on tiles that can hold a
//   masked key for the warp's rows; the running max and sum stay in
//   registers, a row's reduced over the 4 lanes that share it.
//
// Where it stands (an H100 80GB HBM3 at 700 W; PERF.md): at phase 7's float32
// shape about a quarter of the three passes' ceiling and 1.7 times the SIMT
// kernel's speed. mma.sync reaches far less of the TF32 rate than wgmma, and
// with two blocks of 4 warps an SM the loop waits on its own latencies: tile
// width, launch bounds, accumulator count and unrolling each moved its time
// by under 10%. flash_attention_sm90_tf32.cu does the rest on wgmma for
// float32 at D 64, 80 and 128 (V staged transposed, each K and V element
// split once per block, a tile's softmax under the next tile's products), at
// about twice this kernel's speed; this one keeps the calls it cannot take.
//
// The launcher is a plain C function with zllm_flash_attention's signature
// (no PyTorch headers); cudaGetLastError() out.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kWarps = kBQ / 16;   // 16 rows a warp: one m16 tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

struct Strides {
  int64_t b, s, h;  // element strides of a (B, S, H, D) operand; D is contiguous
};

// 2^x (MUFU.EX2: relative error about 2^-22; flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row strides of the shared-memory tiles, in elements: Q and K rows padded by
// 8 elements, V rows by 16 bytes (bank analysis in the header).
template <typename T, int D>
struct Tile {
  static constexpr int kQK = D + 8;                    // Q and K rows
  static constexpr int kV = D + 16 / int(sizeof(T));  // V rows
};

template <typename T, int D, int BKV>
constexpr size_t smem_bytes() {
  return sizeof(T) * (static_cast<size_t>(kBQ) * Tile<T, D>::kQK + 2 * BKV * Tile<T, D>::kQK +
                      2 * BKV * Tile<T, D>::kV);
}

// Blocks an SM can hold by shared memory (two at most): ptxas then spends up
// to 65536 / (2 * 128) registers a thread where two fit
template <typename T, int D, int BKV>
constexpr int min_blocks() {
  return 2 * (smem_bytes<T, D, BKV>() + 1024) <= 228 * 1024 ? 2 : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = smem_addr(dst);
  const int n = valid ? BYTES : 0;  // a source size of 0 fills the destination with zeros
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy rows row0 .. row0 + R - 1 of one (batch, head) slice (row stride `rs`
// elements, D contiguous) into a shared tile of row stride LS, VEC bytes at a
// time; rows at or past `valid` are zero-filled. VEC 2 (bf16 slices 2 bytes
// off a 4-byte boundary) takes plain loads, which cp.async has no size for.
template <typename T, int D, int LS, int R, int VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t rs, int row0, int valid) {
  constexpr int kElems = VEC / int(sizeof(T));
  constexpr int kPerRow = D / kElems;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kElems;
    const bool in = row0 + r < valid;
    const T* s = in ? src + (row0 + r) * rs + c : src;
    if constexpr (VEC >= 4) {
      cp_async<VEC>(dst + r * LS + c, s, in);
    } else {
      dst[r * LS + c] = in ? *s : from_f32<T>(0.f);
    }
  }
}

template <typename T, int D, int LS, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t rs, int row0, int valid, int vec) {
  switch (vec) {
    case 16: load_rows<T, D, LS, R, 16>(dst, src, rs, row0, valid); break;
    case 8: load_rows<T, D, LS, R, 8>(dst, src, rs, row0, valid); break;
    case 4: load_rows<T, D, LS, R, 4>(dst, src, rs, row0, valid); break;
    default:
      if constexpr (sizeof(T) == 2) load_rows<T, D, LS, R, 2>(dst, src, rs, row0, valid);
      break;
  }
}

// Columns c and c + 1 of a shared row as two floats (one 64-bit load of
// float32, one 32-bit load of bf16; c is even).
__device__ __forceinline__ void load_pair(const float* p, float& x0, float& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = v.x;
  x1 = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& x0, float& x1) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  x0 = __uint_as_float(w << 16);
  x1 = __uint_as_float(w & 0xffff0000u);
}

// p rounded to v's type, as a float
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A fragment value as TF32 operands. Three passes: hi = x rounded to TF32
// (to nearest, ties away, as cvt.rna.tf32.f32: half a TF32 ulp added to the
// bits, the 13 low bits cleared) and lo = x - hi (exact in float32) rounded
// the same way; the tensor cores read a TF32 operand's top 19 bits and ignore
// the rest, so lo's rounding is the added half ulp alone (as nvcc lowers
// cvt.rna for an mma operand). Operands are finite, so neither add can carry
// into an infinity. One pass: x itself, exact in TF32 (a bf16 value, or p
// rounded to bf16).
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (PASSES == 3) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The passes of one product step into three accumulators, so that the
// chains of dependent mma stay short: a_hi b_hi into d[0] on even k-steps
// and d[1] on odd ones (`odd`), and with three passes a_hi b_lo and a_lo b_hi
// into d[2]. One pass thus sums in the same order as three passes whose lo
// parts are zero (bf16 operands): the two agree bit for bit.
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&d)[3][4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2], const uint32_t (&blo)[2], int odd) {
  mma_tf32(d[odd], ahi, bhi);
  if constexpr (PASSES == 3) {
    mma_tf32(d[2], ahi, blo);
    mma_tf32(d[2], alo, bhi);
  }
}

__device__ __forceinline__ float pass_sum(const float (&d)[3][4], int i) { return d[0][i] + (d[1][i] + d[2][i]); }

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4,
// n g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). The
// k index of every product is summed over, so logical k t is read from
// physical column 2t and t + 4 from 2t + 1, in A and B alike.
template <typename T, int D, int BKV, int PASSES>
__global__ void __launch_bounds__(kThreads, min_blocks<T, D, BKV>())
flash_fwd_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int Sq, int Sk, Strides sq, Strides sk, Strides sv, Strides so,
                      int causal, int window, float scale_log2, int vec) {
  constexpr int LQK = Tile<T, D>::kQK, LV = Tile<T, D>::kV;
  constexpr int NT = BKV / 8;  // 8-key column tiles of S; k-steps of P.V
  constexpr int ND = D / 8;    // k-steps of Q.K^T; 8-column tiles of O
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // (kBQ, LQK)
  T* sK = sQ + kBQ * LQK;                  // two stages of (BKV, LQK)
  T* sV = sK + 2 * BKV * LQK;              // two stages of (BKV, LV)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // causal: the q tiles with the most KV tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int q_end = min(q0 + kBQ, Sq);              // one past the tile's last row
  const int kv_end = causal ? min(Sk, q_end) : Sk;  // later tiles lie above the diagonal
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  load_tile<T, D, LQK, kBQ>(sQ, qb, sq.s, q0, Sq, vec);
  load_tile<T, D, LQK, BKV>(sK, kb, sk.s, 0, Sk, vec);
  load_tile<T, D, LV, BKV>(sV, vb, sv.s, 0, Sk, vec);
  cp_async_commit();

  const int row = 16 * warp + g;  // this thread's tile rows: row and row + 8
  float acc_o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & 1, k0 = n * BKV;
    if (n + 1 < n_tiles) {  // the next tile streams in while this one computes
      load_tile<T, D, LQK, BKV>(sK + (st ^ 1) * BKV * LQK, kb, sk.s, k0 + BKV, Sk, vec);
      load_tile<T, D, LV, BKV>(sV + (st ^ 1) * BKV * LV, vb, sv.s, k0 + BKV, Sk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tK = sK + st * BKV * LQK;
    const T* tV = sV + st * BKV * LV;

    // S = Q K^T: ND k-steps of 8 columns of D, NT tiles of 8 keys
    float sp[NT][3][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) sp[j][p][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      float x[4];
      load_pair(sQ + row * LQK + 8 * kk + 2 * t, x[0], x[2]);
      load_pair(sQ + (row + 8) * LQK + 8 * kk + 2 * t, x[1], x[3]);
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split<PASSES>(x[i], ahi[i], alo[i]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float y[2];
        load_pair(tK + (8 * j + g) * LQK + 8 * kk + 2 * t, y[0], y[1]);
        uint32_t bhi[2], blo[2];
        split<PASSES>(y[0], bhi[0], blo[0]);
        split<PASSES>(y[1], bhi[1], blo[1]);
        mma_passes<PASSES>(sp[j], ahi, alo, bhi, blo, kk & 1);
      }
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = pass_sum(sp[j], i);

    // online softmax on the accumulator fragments, in log2 units (the scale
    // carries log2(e), p = 2^(s - m)): scale, then mask, where a key of the
    // tile can be masked for this warp's rows; then the new running max
    const bool edge = k0 + BKV > Sk || window > 0 || (causal && k0 + BKV - 1 > q0 + 16 * warp);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float xs = s[j][i] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * j + 2 * t + (i & 1), qp = q0 + row + 8 * r;
          if (kp >= Sk) {
            xs = -INFINITY;  // past the last key: no weight, even in a fully masked row
          } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
            xs = kNegInf;
          }
        }
        s[j][i] = xs;
        mx[r] = fmaxf(mx[r], xs);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // p, its sum, and p rounded to v's type split into the A fragments of
    // P.V: the S fragment of keys 8kk .. 8kk + 7 is the A fragment of k-step
    // kk (logical k t = key 2t, t + 4 = key 2t + 1)
    // (accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) are A
    // a0, a2, a1, a3)
    constexpr int kA[4] = {0, 2, 1, 3};
    uint32_t phi[NT][4], plo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(s[j][i] - m[i >> 1]);
        l[i >> 1] += p;
        split<PASSES>(round_to(p, tV), phi[j][kA[i]], plo[j][kA[i]]);
      }

    // O = O * corr + P V, one 8-column tile of O at a time: its product over
    // this KV tile accumulates from zero on the tensor cores, and joins O in
    // one float32 FMA, so no accumulator sums a whole row's keys on the
    // tensor cores (their float32 sums truncate)
    const T* v0 = tV + 2 * t * LV + g;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      float pv[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[p][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t bhi[2], blo[2];
        split<PASSES>(to_f32(v0[8 * kk * LV + 8 * j]), bhi[0], blo[0]);
        split<PASSES>(to_f32(v0[(8 * kk + 1) * LV + 8 * j]), bhi[1], blo[1]);
        mma_passes<PASSES>(pv, phi[kk], plo[kk], bhi, blo, kk & 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_o[j][i] = fmaf(acc_o[j][i], corr[i >> 1], pass_sum(pv, i));
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row + 8 * r;
    if (qp < Sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* orow = ob + qp * so.s + 2 * t;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        orow[8 * j] = from_f32<T>(acc_o[j][2 * r] / denom);
        orow[8 * j + 1] = from_f32<T>(acc_o[j][2 * r + 1] / denom);
      }
    }
  }
}

// The largest copy width in bytes (16, 8, 4, or 2 for bf16) that divides every
// base pointer and every stride of a dim that is stepped (extent above 1).
int copy_width(const void* const (&ptrs)[3], const Strides (&st)[3], const int64_t (&extents)[3][3],
               int64_t elem) {
  uint64_t bits = 0;
  for (int i = 0; i < 3; ++i) {
    bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
    const int64_t strides[3] = {st[i].b, st[i].s, st[i].h};
    for (int d = 0; d < 3; ++d)
      if (extents[i][d] > 1) bits |= static_cast<uint64_t>(strides[d] * elem);
  }
  int vec = 16;
  while (vec > elem && (bits % vec) != 0) vec /= 2;
  return vec;
}

template <typename T, int D, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
                   int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides so,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, BKV>();
  static_assert(smem <= 227 * 1024, "tiles do not fit in an H100 block's shared memory");
  constexpr int kPasses = sizeof(T) == 4 ? 3 : 1;
  if (B > 65535 || H > 65535 || Sq > 0x7fffffff || Sk > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = flash_fwd_tf32_kernel<T, D, BKV, kPasses>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec = copy_width({q, k, v}, {sq, sk, sv}, {{B, Sq, H}, {B, Sk, H}, {B, Sk, H}},
                             static_cast<int64_t>(sizeof(T)));
  // the reference's scale 1 / D**0.5 with log2(e) folded in, in double, rounded once
  const float scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o),
                                         static_cast<int>(Sq), static_cast<int>(Sk), sq, sk, sv, so,
                                         causal, window, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T, int BKV_WIDE>
cudaError_t dispatch(int64_t D, const void* q, const void* k, const void* v, void* o, int64_t B,
                     int64_t Sq, int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv,
                     Strides so, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 32: return launch<T, 32, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 64: return launch<T, 64, BKV_WIDE>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 80: return launch<T, 80, BKV_WIDE>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 128:
      return launch<T, 128, BKV_WIDE>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 256: return launch<T, 256, 32>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// zllm_flash_attention's signature: q, k, v, o device pointers; strides in
// elements for the B, S and H dims of each operand (D has stride 1); dtype 0
// float32 (three passes), 1 bfloat16 (one pass). Shapes are validated by the
// Python wrapper; B, Sq, H >= 1 and Sk >= 1 here.
int zllm_flash_attention_tf32(const void* q, const void* k, const void* v, void* o, int64_t B,
                              int64_t Sq, int64_t Sk, int64_t H, int64_t D, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                              int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                              int causal, int window, int dtype, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    // float32 from D 64 takes 32-key tiles (at D 128 101 KB a block, two
    // blocks an SM; at D 64 and 80 fewer registers than 64-key tiles)
    case 0: return dispatch<float, 32>(D, q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st);
    case 1:
      return dispatch<__nv_bfloat16, 64>(D, q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
