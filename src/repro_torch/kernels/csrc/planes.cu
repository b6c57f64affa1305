// Hopper (sm_90a) kernels for the zLLM storage path: BitX XOR-delta byte planes,
// the ZipNN byte-plane shuffle, the plain word XOR and the bit-distance
// (XOR + popcount) reduction.
//
// Every buffer is flat. A tensor of n little-endian words of NB bytes (NB in
// {1, 2, 4, 8}) is a byte buffer of n*NB bytes; its planes are one (NB, n)
// uint8 buffer, plane k holding byte NB-1-k of every word (MSB plane first),
// exactly the layout of the numpy host path (`_xor_delta_planes_host` in
// core/bitx.py).
//
// All six kernels are memory-bound: a handful of integer operations per word
// against 2*NB or 3*NB bytes moved. The plane kernels and hamming take the
// simplest design that keeps neighbouring threads on neighbouring words: a
// grid-stride loop over words, one word per thread per step, the tail masked
// by the loop bound. Word loads and byte-plane stores are both coalesced (a
// warp reads 32 consecutive words and writes 32 consecutive bytes of each
// plane). The word XOR streams 16-byte vectors (see xor_bytes_kernel). Vector
// loads in the other five, a persistent grid and wider plane stores are left
// for later work.
//
// Each launcher is a plain C function (no PyTorch headers, so nvcc builds it in
// seconds): device pointers, the word count n, the word width nb and the CUDA
// stream in; cudaGetLastError() out. n == 0 launches nothing. zllm_grid(n)
// gives the grid every launcher uses, so the caller can size the hamming
// kernel's one-partial-per-block output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per H100 SM; the loop strides over the rest

inline unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Replaces src/repro/kernels/bitx_xor.py::xor_split_2d (_xor_split_kernel).
// Bound: reads 2*n*NB bytes, writes n*NB bytes -> 3*n*NB bytes over HBM.
template <typename W>
__global__ void xor_split_kernel(const W* __restrict__ base, const W* __restrict__ ft,
                                 uint8_t* __restrict__ planes, int64_t n) {
  constexpr int NB = sizeof(W);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const W w = static_cast<W>(base[i] ^ ft[i]);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      planes[k * n + i] = static_cast<uint8_t>(w >> (8 * (NB - 1 - k)));
    }
  }
}

// Replaces src/repro/kernels/bitx_xor.py::merge_xor_2d (_merge_xor_kernel).
// Bound: reads 2*n*NB bytes (planes + base), writes n*NB bytes -> 3*n*NB bytes.
template <typename W>
__global__ void merge_xor_kernel(const uint8_t* __restrict__ planes, const W* __restrict__ base,
                                 W* __restrict__ out, int64_t n) {
  constexpr int NB = sizeof(W);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    W w = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      w |= static_cast<W>(static_cast<W>(planes[k * n + i]) << (8 * (NB - 1 - k)));
    }
    out[i] = static_cast<W>(w ^ base[i]);
  }
}

// Replaces src/repro/kernels/byte_planes.py::split_2d (_split_kernel).
// Bound: reads n*NB bytes, writes n*NB bytes -> 2*n*NB bytes.
template <typename W>
__global__ void split_kernel(const W* __restrict__ x, uint8_t* __restrict__ planes, int64_t n) {
  constexpr int NB = sizeof(W);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const W w = x[i];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      planes[k * n + i] = static_cast<uint8_t>(w >> (8 * (NB - 1 - k)));
    }
  }
}

// Replaces src/repro/kernels/byte_planes.py::merge_2d (_merge_kernel).
// Bound: reads n*NB bytes, writes n*NB bytes -> 2*n*NB bytes.
template <typename W>
__global__ void merge_kernel(const uint8_t* __restrict__ planes, W* __restrict__ out, int64_t n) {
  constexpr int NB = sizeof(W);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    W w = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      w |= static_cast<W>(static_cast<W>(planes[k * n + i]) << (8 * (NB - 1 - k)));
    }
    out[i] = w;
  }
}

// Replaces src/repro/kernels/bitx_xor.py::xor_2d (_xor_kernel).
// Bound: reads 2*n*NB bytes, writes n*NB bytes -> 3*n*NB bytes.
// XOR does not depend on the word width, so the kernel streams bytes: where a,
// b and out share their offset from a 16-byte boundary, the `head` bytes up to
// that boundary and the tail past the last whole 16 bytes are XORed one byte a
// thread, and the body 16 bytes (uint4) per access, kXorVec independent
// accesses in flight per thread, one pass of blocks over the buffer (no
// grid-stride loop: on an H100 at the embedding shape that and plain loads
// beat a capped grid with streaming hints by 5%). Where they do not share it,
// head == nbytes and every byte takes the scalar path.
constexpr int kXorVec = 4;

__global__ void xor_bytes_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                                 uint8_t* __restrict__ out, int64_t nbytes, int64_t head) {
  const int64_t nvec = (nbytes - head) / 16;
  const int64_t tail = head + 16 * nvec;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid < head) out[tid] = a[tid] ^ b[tid];
  if (tid < nbytes - tail) out[tail + tid] = a[tail + tid] ^ b[tail + tid];
  const uint4* va = reinterpret_cast<const uint4*>(a + head);
  const uint4* vb = reinterpret_cast<const uint4*>(b + head);
  uint4* vo = reinterpret_cast<uint4*>(out + head);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x * kXorVec + threadIdx.x;
  uint4 x[kXorVec], y[kXorVec];
#pragma unroll
  for (int j = 0; j < kXorVec; ++j) {
    const int64_t i = i0 + static_cast<int64_t>(j) * blockDim.x;
    if (i < nvec) {
      x[j] = va[i];
      y[j] = vb[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kXorVec; ++j) {
    const int64_t i = i0 + static_cast<int64_t>(j) * blockDim.x;
    if (i < nvec) vo[i] = make_uint4(x[j].x ^ y[j].x, x[j].y ^ y[j].y, x[j].z ^ y[j].z, x[j].w ^ y[j].w);
  }
}

template <typename W>
__device__ __forceinline__ unsigned count_bits(W w) {
  if constexpr (sizeof(W) == 8) {
    return static_cast<unsigned>(__popcll(static_cast<unsigned long long>(w)));
  } else {
    return static_cast<unsigned>(__popc(static_cast<unsigned>(w)));
  }
}

// Replaces src/repro/kernels/hamming.py::hamming_partials_2d (_hamming_kernel).
// Bound: reads 2*n*NB bytes (plus gridDim.x 8-byte partials written, negligible).
// Each thread counts the differing bits of its grid-stride words in 64 bits,
// the warp sums with shuffles, the block sums its warps' totals through shared
// memory and writes one 64-bit partial; the caller sums the <= kMaxBlocks
// partials. No atomics, so the partials do not depend on scheduling. The TPU
// kernel keeps u32 partials because its blocks are bounded; a grid-stride
// block here covers n / gridDim.x words, and 64 bits leave the grid free.
template <typename W>
__global__ void hamming_partials_kernel(const W* __restrict__ a, const W* __restrict__ b,
                                        unsigned long long* __restrict__ partials, int64_t n) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned long long warp_sums[kWarps];
  unsigned long long acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    acc += count_bits<W>(static_cast<W>(a[i] ^ b[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warp_sums[lane] : 0ULL;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partials[blockIdx.x] = acc;
  }
}

cudaError_t launch_xor(const void* a, const void* b, void* out, int64_t nbytes, cudaStream_t stream) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(a) & 15;
  const bool shared = (reinterpret_cast<uintptr_t>(b) & 15) == off &&
                      (reinterpret_cast<uintptr_t>(out) & 15) == off;
  const int64_t to_boundary = static_cast<int64_t>((16 - off) & 15);
  const int64_t head = shared ? (to_boundary < nbytes ? to_boundary : nbytes) : nbytes;
  const int64_t nvec = (nbytes - head) / 16;
  const int64_t vec_threads = (nvec + kXorVec - 1) / kXorVec;
  const int64_t scalar = head + (nbytes - head) % 16;  // >= the head and the tail
  const int64_t threads = vec_threads > scalar ? vec_threads : scalar;  // >= 1 as nbytes >= 1
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  xor_bytes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<uint8_t*>(out),
      nbytes, head);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_hamming(const void* a, const void* b, void* partials, int64_t n,
                           cudaStream_t stream) {
  hamming_partials_kernel<W><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const W*>(a), static_cast<const W*>(b),
      static_cast<unsigned long long*>(partials), n);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_xor_split(const void* base, const void* ft, void* planes, int64_t n,
                             cudaStream_t stream) {
  xor_split_kernel<W><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const W*>(base), static_cast<const W*>(ft), static_cast<uint8_t*>(planes), n);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_merge_xor(const void* planes, const void* base, void* out, int64_t n,
                             cudaStream_t stream) {
  merge_xor_kernel<W><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(planes), static_cast<const W*>(base), static_cast<W*>(out), n);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_split(const void* x, void* planes, int64_t n, cudaStream_t stream) {
  split_kernel<W><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<uint8_t*>(planes), n);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_merge(const void* planes, void* out, int64_t n, cudaStream_t stream) {
  merge_kernel<W><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(planes), static_cast<W*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// Word-width dispatch shared by the launchers: W is the unsigned word
// type of width nb; any other nb is refused before a launch.
#define ZLLM_DISPATCH_NB(nb, CALL)                                   \
  switch (nb) {                                                      \
    case 1: { using W = uint8_t; return static_cast<int>(CALL); }    \
    case 2: { using W = uint16_t; return static_cast<int>(CALL); }   \
    case 4: { using W = uint32_t; return static_cast<int>(CALL); }   \
    case 8: { using W = uint64_t; return static_cast<int>(CALL); }   \
    default: return static_cast<int>(cudaErrorInvalidValue);         \
  }

extern "C" {

int zllm_xor_split(const void* base, const void* ft, void* planes, int64_t n, int nb,
                   void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ZLLM_DISPATCH_NB(nb, launch_xor_split<W>(base, ft, planes, n, static_cast<cudaStream_t>(stream)))
}

int zllm_merge_xor(const void* planes, const void* base, void* out, int64_t n, int nb,
                   void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ZLLM_DISPATCH_NB(nb, launch_merge_xor<W>(planes, base, out, n, static_cast<cudaStream_t>(stream)))
}

int zllm_split(const void* x, void* planes, int64_t n, int nb, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ZLLM_DISPATCH_NB(nb, launch_split<W>(x, planes, n, static_cast<cudaStream_t>(stream)))
}

int zllm_merge(const void* planes, void* out, int64_t n, int nb, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ZLLM_DISPATCH_NB(nb, launch_merge<W>(planes, out, n, static_cast<cudaStream_t>(stream)))
}

// The words are XORed as one byte stream: nb only sizes it.
int zllm_xor(const void* a, const void* b, void* out, int64_t n, int nb, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ZLLM_DISPATCH_NB(nb, launch_xor(a, b, out, n * static_cast<int64_t>(sizeof(W)),
                                  static_cast<cudaStream_t>(stream)))
}

// partials: zllm_grid(n) 64-bit slots, one per block.
int zllm_hamming(const void* a, const void* b, void* partials, int64_t n, int nb, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ZLLM_DISPATCH_NB(nb, launch_hamming<W>(a, b, partials, n, static_cast<cudaStream_t>(stream)))
}

int64_t zllm_grid(int64_t n) { return static_cast<int64_t>(grid_for(n)); }

const char* zllm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
