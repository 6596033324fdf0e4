// Bit-plane transpose of one basket (Blosc "bitshuffle", little-endian bits).
//
// Replaces the Pallas kernels src/repro/kernels/bitshuffle.py:bitshuffle
// (_bitshuffle_kernel) and :bitunshuffle (_bitunshuffle_kernel), with the
// container's semantics from src/repro/core/precond.py:bitshuffle: any
// element count N, each of the 8*I planes padded to ceil(N/8) bytes with zero
// bits, and the len % I tail passed through.
//
// Bound: pure data movement.  Each direction reads N*I bytes and writes
// about as many, so the least time is (bytes read + bytes written) / 3.35 TB/s
// on an H100 SXM.  There is no arithmetic worth counting.
//
// Design.  Forward: one warp owns 1024 consecutive elements.  For each group
// of 32 elements (one per lane, a coalesced load) a __ballot_sync per bit
// plane yields the 4 output bytes of that plane; lane g keeps the words of
// group g, so after 32 groups every plane gets one coalesced 128-byte store
// from the warp.  Inverse: one thread per element gathers its bit from each
// of the 8*I planes (neighbouring threads read the same bytes, which the L1
// serves) and writes the element with one store.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 32 * 32;  // elements per warp: 32 groups of 32 lanes
constexpr int kUnshuffleThreads = 256;

template <int I>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitshuffle_kernel(const typename UInt<I>::T* __restrict__ in,
                  uint8_t* __restrict__ out, int64_t n, int64_t plane_bytes,
                  bool word_stores) {
  using T = typename UInt<I>::T;
  constexpr int kPlanes = 8 * I;
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
      kChunk;
  if (base >= n) return;  // whole warp leaves together
  uint32_t word[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) word[p] = 0;
  for (int g = 0; g < 32; ++g) {
    const int64_t e = base + g * 32 + lane;
    const T v = e < n ? in[e] : T(0);  // padding elements give zero bits
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const uint32_t bits = __ballot_sync(kFullMask, (v >> p) & 1);
      if (lane == g) word[p] = bits;
    }
  }
  // lane g holds bytes [q, q+4) of every plane, q = base/8 + 4g
  const int64_t q = base / 8 + 4 * lane;
  if (word_stores) {
    if (q < plane_bytes) {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
        *reinterpret_cast<uint32_t*>(out + p * plane_bytes + q) = word[p];
    }
  } else {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (q + k < plane_bytes)
          out[p * plane_bytes + q + k] = static_cast<uint8_t>(word[p] >> (8 * k));
      }
    }
  }
}

template <int I>
__global__ void __launch_bounds__(kUnshuffleThreads)
bitunshuffle_kernel(const uint8_t* __restrict__ in,
                    typename UInt<I>::T* __restrict__ out, int64_t n,
                    int64_t plane_bytes) {
  using T = typename UInt<I>::T;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint8_t* src = in + (e >> 3);
  const int shift = static_cast<int>(e & 7);
  T v = 0;
#pragma unroll
  for (int p = 0; p < 8 * I; ++p)
    v |= static_cast<T>((__ldg(src + p * plane_bytes) >> shift) & 1) << p;
  out[e] = v;
}

}  // namespace

// in: n*itemsize + tail bytes (element-aligned); out: 8*itemsize*ceil(n/8) + tail.
extern "C" int rt_bitshuffle(const void* in, void* out, int64_t n, int itemsize,
                             int64_t tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane_bytes = (n + 7) / 8;
  if (n > 0) {
    const unsigned blocks = blocks_for(blocks_for(n, kChunk), kWarpsPerBlock);
    const bool word_stores =
        plane_bytes % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
    RT_DISPATCH_ITEMSIZE(itemsize,
      bitshuffle_kernel<I><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
          static_cast<const typename UInt<I>::T*>(in), static_cast<uint8_t*>(out),
          n, plane_bytes, word_stores));
    RT_CHECK_LAUNCH();
  }
  const cudaError_t err = copy_tail(in, n * itemsize, out,
                                    8 * itemsize * plane_bytes, tail, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// in: 8*itemsize*ceil(n/8) + tail bytes; out: n*itemsize + tail (element-aligned).
extern "C" int rt_bitunshuffle(const void* in, void* out, int64_t n,
                               int itemsize, int64_t tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane_bytes = (n + 7) / 8;
  if (n > 0) {
    const unsigned blocks = blocks_for(n, kUnshuffleThreads);
    RT_DISPATCH_ITEMSIZE(itemsize,
      bitunshuffle_kernel<I><<<blocks, kUnshuffleThreads, 0, s>>>(
          static_cast<const uint8_t*>(in),
          static_cast<typename UInt<I>::T*>(out), n, plane_bytes));
    RT_CHECK_LAUNCH();
  }
  const cudaError_t err = copy_tail(in, 8 * itemsize * plane_bytes, out,
                                    n * itemsize, tail, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
