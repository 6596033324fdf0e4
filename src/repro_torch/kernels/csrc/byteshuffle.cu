// Byte transpose of one basket (Blosc "shuffle"): (N, I) bytes -> (I, N).
//
// Replaces the Pallas kernel src/repro/kernels/byteshuffle.py:_t_kernel, as
// called by byteshuffle and byteunshuffle, with the container's semantics
// from src/repro/core/precond.py:shuffle/unshuffle: any N (the reference's
// ops._pick_block fell to 1-element blocks for a prime N; there are no
// blocks to pick here) and the len % I tail passed through.
//
// Bound: pure data movement, N*I bytes read and N*I written, so the least
// time is 2*N*I / 3.35 TB/s on an H100 SXM.
//
// Design: one element per thread.  The element side moves as one I-byte
// load or store per thread (coalesced across the warp); the plane side moves
// as I byte accesses per thread, each a contiguous 32-byte run per warp.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int I>
__global__ void __launch_bounds__(kThreads)
byteshuffle_kernel(const typename UInt<I>::T* __restrict__ in,
                   uint8_t* __restrict__ out, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const auto v = in[e];
#pragma unroll
  for (int j = 0; j < I; ++j) out[j * n + e] = static_cast<uint8_t>(v >> (8 * j));
}

template <int I>
__global__ void __launch_bounds__(kThreads)
byteunshuffle_kernel(const uint8_t* __restrict__ in,
                     typename UInt<I>::T* __restrict__ out, int64_t n) {
  using T = typename UInt<I>::T;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  T v = 0;
#pragma unroll
  for (int j = 0; j < I; ++j) v |= static_cast<T>(in[j * n + e]) << (8 * j);
  out[e] = v;
}

}  // namespace

// in: n*itemsize + tail bytes (element-aligned); out: the same length.
extern "C" int rt_byteshuffle(const void* in, void* out, int64_t n, int itemsize,
                              int64_t tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    RT_DISPATCH_ITEMSIZE(itemsize,
      byteshuffle_kernel<I><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
          static_cast<const typename UInt<I>::T*>(in), static_cast<uint8_t*>(out), n));
    RT_CHECK_LAUNCH();
  }
  const cudaError_t err = copy_tail(in, n * itemsize, out, n * itemsize, tail, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// in: n*itemsize + tail bytes; out: the same length (element-aligned).
extern "C" int rt_byteunshuffle(const void* in, void* out, int64_t n,
                                int itemsize, int64_t tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    RT_DISPATCH_ITEMSIZE(itemsize,
      byteunshuffle_kernel<I><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
          static_cast<const uint8_t*>(in), static_cast<typename UInt<I>::T*>(out), n));
    RT_CHECK_LAUNCH();
  }
  const cudaError_t err = copy_tail(in, n * itemsize, out, n * itemsize, tail, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
