// Delta and its inverse over one basket of little-endian unsigned integers,
// mod 2^(8*I): out[0] = x[0], out[i] = x[i] - x[i-1]; the inverse is the
// inclusive prefix sum.  Every basket restarts at its own first element.
//
// Replaces the Pallas kernels src/repro/kernels/delta.py:delta_block
// (_delta_kernel) and :undelta_block (_undelta_kernel).  Those are
// block-local, and the reference's ops.delta_u32/undelta_u32 glue them into
// one delta over a whole tensor; the container instead deltas each basket
// on its own (src/repro/core/precond.py:delta_encode/delta_decode, applied
// per basket by core/basket.py:pack_basket), which is what these compute,
// for I = 1, 2, 4 and 8, with the len % I tail passed through.
//
// Bound: data movement, N*I bytes read and N*I written: 2*N*I / 3.35 TB/s
// on an H100 SXM.  The adds are free beside the bytes.
//
// Design.  Delta: one element per thread, reading its left neighbour (the
// neighbour's load hits the L1).  Undelta: a basket can be one tensor of
// hundreds of MB, so the scan runs over many blocks with 64-bit offsets,
// reduce-then-scan: (1) each block sums its 4096-element tile, (2) one block
// turns the tile sums into exclusive carries, (3) each block scans its tile
// again from its carry: 8 warps, each scanning 16 rows of 32 elements with
// shuffles.  That reads the input twice (the second read mostly from L2
// for baskets under 50 MB) and writes it once.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 16;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kRowsPerWarp;  // 4096
constexpr int kCarryThreads = 1024;

// Sums wrap mod 2^32 for I <= 4 (the stored width divides it) and mod 2^64
// for I = 8.
template <int I>
using Acc = typename std::conditional<I == 8, unsigned long long, uint32_t>::type;

template <typename A>
__device__ __forceinline__ A warp_inclusive_scan(A x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const A y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(kFullMask, x, d);
  return x;
}

template <int I>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const typename UInt<I>::T* __restrict__ in,
             typename UInt<I>::T* __restrict__ out, int64_t n) {
  using T = typename UInt<I>::T;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const T prev = e > 0 ? in[e - 1] : T(0);
  out[e] = static_cast<T>(in[e] - prev);
}

// (1) sums[t] = sum of tile t
template <int I>
__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const typename UInt<I>::T* __restrict__ in,
                 unsigned long long* __restrict__ sums, int64_t n) {
  __shared__ Acc<I> part[kWarps];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  Acc<I> s = 0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t e = start + i;
    if (e < n) s += in[e];
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc<I> total = 0;
    for (int w = 0; w < kWarps; ++w) total += part[w];
    sums[blockIdx.x] = total;
  }
}

// (2) one block: sums[t] <- sum of tiles before t (exclusive), in place
__global__ void __launch_bounds__(kCarryThreads)
tile_carries_kernel(unsigned long long* __restrict__ sums, int64_t tiles) {
  __shared__ unsigned long long warp_prefix[32];
  __shared__ unsigned long long carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < tiles; base += kCarryThreads) {
    const int64_t i = base + threadIdx.x;
    const unsigned long long x = i < tiles ? sums[i] : 0ull;
    const unsigned long long inc = warp_inclusive_scan(x);
    if (lane == 31) warp_prefix[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long t = warp_prefix[lane];
      warp_prefix[lane] = warp_inclusive_scan(t) - t;
    }
    __syncthreads();
    const unsigned long long excl = carry + warp_prefix[warp] + inc - x;
    if (i < tiles) sums[i] = excl;
    __syncthreads();
    if (threadIdx.x == kCarryThreads - 1) carry = excl + x;
    __syncthreads();
  }
}

// (3) out = inclusive scan of the tile, offset by its carry (null: one tile)
template <int I>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const typename UInt<I>::T* __restrict__ in,
                 typename UInt<I>::T* __restrict__ out, int64_t n,
                 const unsigned long long* __restrict__ carries) {
  using T = typename UInt<I>::T;
  using A = Acc<I>;
  __shared__ A warp_prefix[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t seg =
      static_cast<int64_t>(blockIdx.x) * kTile + warp * (32 * kRowsPerWarp);
  A row[kRowsPerWarp];
  A run = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t e = seg + r * 32 + lane;
    const A v = e < n ? static_cast<A>(in[e]) : A(0);
    const A s = warp_inclusive_scan(v);
    row[r] = run + s;
    run += __shfl_sync(kFullMask, s, 31);
  }
  if (lane == 0) warp_prefix[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    A acc = carries != nullptr ? static_cast<A>(carries[blockIdx.x]) : A(0);
    for (int w = 0; w < kWarps; ++w) {
      const A t = warp_prefix[w];
      warp_prefix[w] = acc;
      acc += t;
    }
  }
  __syncthreads();
  const A off = warp_prefix[warp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t e = seg + r * 32 + lane;
    if (e < n) out[e] = static_cast<T>(off + row[r]);
  }
}

}  // namespace

// in/out: n*itemsize + tail bytes, element-aligned.
extern "C" int rt_delta(const void* in, void* out, int64_t n, int itemsize,
                        int64_t tail, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    RT_DISPATCH_ITEMSIZE(itemsize,
      delta_kernel<I><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
          static_cast<const typename UInt<I>::T*>(in),
          static_cast<typename UInt<I>::T*>(out), n));
    RT_CHECK_LAUNCH();
  }
  const cudaError_t err = copy_tail(in, n * itemsize, out, n * itemsize, tail, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Tiles of the undelta scan; the caller passes scratch for that many
// unsigned 64-bit tile sums when there is more than one.
extern "C" int64_t rt_undelta_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// in/out: n*itemsize + tail bytes, element-aligned; scratch: rt_undelta_tiles(n)
// 64-bit words (unused for a single tile).
extern "C" int rt_undelta(const void* in, void* out, int64_t n, int itemsize,
                          int64_t tail, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int64_t tiles = rt_undelta_tiles(n);
    auto* carries = tiles > 1 ? static_cast<unsigned long long*>(scratch) : nullptr;
    if (tiles > 1 && carries == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    RT_DISPATCH_ITEMSIZE(itemsize,
      using T = typename UInt<I>::T;
      if (carries != nullptr) {
        tile_sums_kernel<I><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
            static_cast<const T*>(in), carries, n);
        RT_CHECK_LAUNCH();
        tile_carries_kernel<<<1, kCarryThreads, 0, s>>>(carries, tiles);
        RT_CHECK_LAUNCH();
      }
      tile_scan_kernel<I><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          static_cast<const T*>(in), static_cast<T*>(out), n, carries));
    RT_CHECK_LAUNCH();
  }
  const cudaError_t err = copy_tail(in, n * itemsize, out, n * itemsize, tail, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
