// Hopper (sm_90a) flash-attention forward pass for the port's transformer
// prefill. Replaces src/repro/kernels/flash_attention.py::flash_attention
// (the Pallas TPU kernel _flash_kernel and its pallas_call).
//
// What it computes, as the TPU kernel does: q (B, Sq, H, D), k and v
// (B, Sk, H, D) with grouped-query heads already expanded; scores q.k / sqrt(D)
// in float32; positions start at 0 for both q and k; a causal mask
// (k_pos <= q_pos) and an optional sliding window (k_pos > q_pos - window)
// write the finite -1e30, not -inf, so a row whose keys are all masked averages
// v uniformly, as the references do; online softmax with a running max, a
// running sum and a rescale of the accumulator; p is rounded to v's type before
// the PV product; the output is acc / max(l, 1e-30) in q's type. KV tiles that
// lie wholly above the diagonal are skipped. What it does not carry over: the
// (B*H, S, D) transposes (operands are read in place through their strides,
// D contiguous), the divisibility asserts (ragged Sq and Sk tails are masked
// here: rows past Sq are not stored, keys past Sk get -inf and weight 0) and
// the TPU's 128/512 block sizes.
//
// The design is the simple one. One block of 256 threads per (q tile of 64
// rows, head, batch); a loop over KV tiles of 64 keys (32 for D >= 128) staged
// in shared memory as float32; per-row max and sum and a float32 accumulator in
// registers. The threads form a 16 x 16 grid: thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3, score columns tx + 16*c and output columns tx + 16*c, so each
// step of both products reads 4 + (columns) shared-memory words for 4 x
// (columns) FMAs, and a row's max and sum reduce over the 16 lanes of a
// half-warp with shuffles. Q and K rows are padded by one float so the 16
// column lanes hit 16 banks. D is a template parameter (16, 32, 64, 80, 128,
// 256): a multiple of 16, since the 16 column lanes own columns tx + 16*c. At
// D 80 (zamba2-2.7b's shared attention) a 64-key tile takes 78,592 bytes of
// shared memory, past the 48 KB default, so the launcher opts in.
//
// What bounds it: at the serving path's main shape (B 4, S 2048, H 28, D 128,
// bf16, causal) the work is 2*B*H*S^2*D = 120 GFLOP against 0.23 GB of q, k, v
// and o, so on an H100 the bound is tensor-core operations (0.12 ms at
// 989 TFLOP/s bf16; the bytes take 0.07 ms at 3.35 TB/s). This kernel never
// reaches the tensor cores: both products are float32 FMAs fed from shared
// memory, and it stages tiles with plain loads. What it leaves on the table
// is the tensor cores (mma.sync or wgmma on bf16 tiles), TMA loads into a ring
// of tiles overlapped with compute, warp specialisation and keeping K and V in
// their 16-bit type in shared memory; those are a later redesign.
//
// The launcher is a plain C function (no PyTorch headers): device pointers,
// the shapes, the element strides of each operand's B, S and H dims, causal,
// window, a dtype code (0 float32, 1 bfloat16) and the CUDA stream in;
// cudaGetLastError() out.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kThreads = 256;      // 16 row groups x 16 column lanes
constexpr int kRows = kBQ / 16;    // query rows per thread
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

struct Strides {
  int64_t b, s, h;  // element strides of a (B, S, H, D) operand; D is contiguous
};

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

template <int D, int BKV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + BKV * (D + 1) + BKV * D + kBQ * (BKV + 1));
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Sk, Strides sq, Strides sk, Strides sv,
                 Strides so, int causal, int window, float scale) {
  constexpr int QS = D + 1;     // padded row stride of sQ and sK
  constexpr int PS = BKV + 1;   // padded row stride of sP
  constexpr int CS = BKV / 16;  // score columns per thread
  constexpr int CD = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // (kBQ, QS): q * scale
  float* sK = sQ + kBQ * QS;     // (BKV, QS)
  float* sV = sK + BKV * QS;     // (BKV, D)
  float* sP = sV + BKV * D;      // (kBQ, PS): p rounded to v's type

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // causal: the q tiles with the most KV tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qp = q0 + r;
    sQ[r * QS + c] = qp < Sq ? to_f32(qb[qp * sq.s + c]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][CD];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  }

  const int q_end = min(q0 + kBQ, Sq);                 // one past the tile's last row
  const int kv_end = causal ? min(Sk, q_end) : Sk;     // later tiles lie above the diagonal
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    for (int i = tid; i < BKV * D; i += kThreads) {
      const int r = i / D, c = i % D, kp = k0 + r;
      const bool in = kp < Sk;
      sK[r * QS + c] = in ? to_f32(kb[kp * sk.s + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vb[kp * sv.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][CS];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[CS];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = sQ[(ty * kRows + r) * QS + d];
#pragma unroll
      for (int c = 0; c < CS; ++c) kv[c] = sK[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CS; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty * kRows + r, qp = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x = s[r][c];
        if (kp >= Sk) {
          x = -INFINITY;  // past the last key: no weight, even in a fully masked row
        } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
          x = kNegInf;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        sP[row * PS + tx + 16 * c] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pv[kRows], vv[CD];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = sP[(ty * kRows + r) * PS + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + ty * kRows + r;
    if (qp < Sq) {
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < CD; ++c) ob[qp * so.s + tx + 16 * c] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
                   int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides so,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BKV>();
  static_assert(smem <= 227 * 1024, "tile does not fit in an H100 block's shared memory");
  auto kern = flash_fwd_kernel<T, D, BKV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // the reference's scale, 1 / D**0.5 in double, rounded once to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o),
                                         static_cast<int>(Sq), static_cast<int>(Sk), sq, sk, sv, so,
                                         causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int64_t D, const void* q, const void* k, const void* v, void* o, int64_t B,
                     int64_t Sq, int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv,
                     Strides so, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 32: return launch<T, 32, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 64: return launch<T, 64, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 80: return launch<T, 80, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 128: return launch<T, 128, 32>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    case 256: return launch<T, 256, 32>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers; strides in elements for the B, S and H dims of
// each operand (D has stride 1). Shapes are validated by the Python wrapper;
// B, Sq, H >= 1 and Sk >= 1 here.
int zllm_flash_attention(const void* q, const void* k, const void* v, void* o, int64_t B,
                         int64_t Sq, int64_t Sk, int64_t H, int64_t D, int64_t q_sb, int64_t q_ss,
                         int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                         int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                         int causal, int window, int dtype, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh},
      so{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(D, q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st);
    case 1:
      return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
