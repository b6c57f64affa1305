// Hopper (sm_90a) kernels for the zLLM storage path: BitX XOR-delta byte planes
// and the ZipNN byte-plane shuffle.
//
// Every buffer is flat. A tensor of n little-endian words of NB bytes (NB in
// {1, 2, 4, 8}) is a byte buffer of n*NB bytes; its planes are one (NB, n)
// uint8 buffer, plane k holding byte NB-1-k of every word (MSB plane first),
// exactly the layout of the numpy host path (`_xor_delta_planes_host` in
// core/bitx.py).
//
// All four kernels are memory-bound: a handful of integer operations per word
// against 2*NB or 3*NB bytes moved. The design is the simplest one that keeps
// neighbouring threads on neighbouring words: a grid-stride loop over words,
// one word per thread per step, the tail masked by the loop bound. Word loads
// and byte-plane stores are both coalesced (a warp reads 32 consecutive words
// and writes 32 consecutive bytes of each plane). Vector loads, a persistent
// grid and wider plane stores are left for later work.
//
// Each launcher is a plain C function (no PyTorch headers, so nvcc builds it in
// seconds): device pointers, the word count n, the word width nb and the CUDA
// stream in; cudaGetLastError() out. n == 0 launches nothing.

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

// Word-width dispatch shared by the four launchers: W is the unsigned word
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

const char* zllm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
