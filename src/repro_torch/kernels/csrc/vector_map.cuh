// The vector path of the elementwise preconditioners over one basket: the
// forward delta (csrc/delta.cu), zigzag and unzigzag (csrc/zigzag.cu).
// Each maps n little-endian unsigned integers of I bytes to n of the same
// width, mod 2^(8*I), and passes the len % I tail through.
//
// Bound: data movement, n*I bytes read once and n*I written once:
// 2*n*I / 3.35 TB/s on an H100 SXM (0.63 us for a 1 MiB basket, 0.0597 ms
// for 100 MB).  A few integer operations an element are free beside the
// bytes.
//
// Design.  A block of kThreads threads owns kThreads * K consecutive
// 16-byte vectors (16/I elements each); its thread t takes vectors t,
// t + kThreads, ..., so every load and store of a warp covers 512
// contiguous bytes.  A thread issues all K loads (ld.global.nc.v4) before
// it uses any, so K vectors a thread are in flight at once: K = kDeepVecs
// once that grid still gives every SM two blocks (kDeepBlocks, 4.3 MB and
// up), else K = 1, so that a small basket spreads over more SMs (a 1 MiB
// one over 256 blocks).  At 100 MB the deep grid is 6 104 blocks, ~6 waves
// of 8 resident blocks an SM.
//
// The delta reads each vector's left neighbour, the last element of the
// vector before it: the previous lane's, by __shfl_up_sync; lane 0 loads it
// itself, one scalar load of I bytes issued before the vector loads
// (issued after them, it added ~0.2 us to a 1 MiB basket with I = 8 on an
// H100, tools/delta_probe.py).  Element 0 of the basket has none: out[0] =
// x[0].
//
// Hazards, and what the design does about each:
// 1. Ragged ends.  The last vector may hold fewer than 16/I elements; its
//    missing elements load as 0 and are not stored.  A vector past the end
//    loads and stores nothing, but its lane still takes part in the
//    shuffle (no thread returns early).
// 2. Alignment.  The callers require element-aligned pointers only.  When
//    either pointer is not 16-byte aligned the launch takes the
//    instantiation that loads and stores element by element, with the same
//    vectors, lanes and shuffles.
// 3. The tail.  The last block copies the len % I tail bytes, so a call is
//    one launch, a tail alone included (one block).
// 4. Aliasing.  The loads go through the non-coherent cache and the delta
//    reads its neighbour from another thread, so `out` must not overlap
//    `in`; the Python wrappers refuse such calls.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace vmap {

constexpr int kThreads = 256;
constexpr int kDeepVecs = 4;             // vectors a thread, large baskets
constexpr int64_t kDeepBlocks = 2 * 132; // two blocks an SM of an H100 SXM

enum class Op { kDelta, kZigzag, kUnzigzag };

// what a warp shuffle carries for an element of I bytes
template <int I>
using Lane = typename std::conditional<I == 8, unsigned long long, uint32_t>::type;

// elements [e0, e0 + 16/I) of p, zero from n on, one at a time
template <int I>
__device__ __forceinline__ void load_elements(
    const typename UInt<I>::T* __restrict__ p, int64_t e0, int64_t n,
    Chunk<I>& v) {
#pragma unroll
  for (int j = 0; j < 16 / I; ++j) v.e[j] = e0 + j < n ? p[e0 + j] : 0;
}

template <int I, bool kVec>
__device__ __forceinline__ void load(const typename UInt<I>::T* __restrict__ p,
                                     int64_t e0, int64_t n, Chunk<I>& v) {
  if constexpr (kVec) {
    if (e0 + 16 / I <= n) {
      v.u = __ldg(reinterpret_cast<const uint4*>(p + e0));
      return;
    }
  }
  load_elements<I>(p, e0, n, v);
}

// p[e0 : min(e0 + 16/I, n)] <- v
template <int I, bool kVec>
__device__ __forceinline__ void store(typename UInt<I>::T* __restrict__ p,
                                      int64_t e0, int64_t n, const Chunk<I>& v) {
  if constexpr (kVec) {
    if (e0 + 16 / I <= n) {
      *reinterpret_cast<uint4*>(p + e0) = v.u;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 16 / I; ++j)
    if (e0 + j < n) p[e0 + j] = v.e[j];
}

// zigzag on the signed view of width 8*I: (v << 1) ^ (v >> (8*I - 1)), and
// its inverse (u >> 1) ^ -(u & 1), both mod 2^(8*I)
template <Op M, int I>
__device__ __forceinline__ typename UInt<I>::T pointwise(typename UInt<I>::T x) {
  using T = typename UInt<I>::T;
  using S = typename std::make_signed<T>::type;
  if constexpr (M == Op::kZigzag)
    return static_cast<T>(static_cast<T>(x << 1) ^
                          static_cast<T>(static_cast<S>(x) >> (8 * I - 1)));
  else
    return static_cast<T>((x >> 1) ^ static_cast<T>(T(0) - (x & 1)));
}

// The body of every kernel of this path: K vectors a thread, as above.
template <Op M, int I, int K, bool kVec>
__device__ __forceinline__ void map_vectors(
    const typename UInt<I>::T* __restrict__ in,
    typename UInt<I>::T* __restrict__ out, int64_t n, int tail) {
  using T = typename UInt<I>::T;
  constexpr int V = 16 / I;
  copy_tail_in_kernel(reinterpret_cast<const uint8_t*>(in), n * I,
                      reinterpret_cast<uint8_t*>(out), n * I, tail);
  const int lane = threadIdx.x & 31;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (kThreads * K) + threadIdx.x;
  [[maybe_unused]] T left[K];  // lane 0's neighbours, issued first
  if constexpr (M == Op::kDelta) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int64_t e0 = (first + int64_t{r} * kThreads) * V;
      left[r] = lane == 0 && e0 > 0 && e0 <= n ? in[e0 - 1] : T(0);
    }
  }
  Chunk<I> v[K];
#pragma unroll
  for (int r = 0; r < K; ++r)
    load<I, kVec>(in, (first + int64_t{r} * kThreads) * V, n, v[r]);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if constexpr (M == Op::kDelta) {
      const Lane<I> up = __shfl_up_sync(kFullMask, Lane<I>(v[r].e[V - 1]), 1);
      T prev = lane == 0 ? left[r] : static_cast<T>(up);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T x = v[r].e[j];
        v[r].e[j] = static_cast<T>(x - prev);
        prev = x;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[r].e[j] = pointwise<M, I>(v[r].e[j]);
    }
    store<I, kVec>(out, (first + int64_t{r} * kThreads) * V, n, v[r]);
  }
}

// vectors a thread over n elements of `itemsize` bytes
inline int vecs_per_thread(int64_t n, int itemsize) {
  const int64_t vecs = (n * itemsize + 15) / 16;
  return blocks_for(vecs, int64_t{kThreads} * kDeepVecs) >= kDeepBlocks
             ? kDeepVecs : 1;
}

// blocks of a launch with k vectors a thread; a tail alone takes one
inline unsigned map_blocks(int64_t n, int itemsize, int k) {
  const int64_t vecs = (n * itemsize + 15) / 16;
  const unsigned b = blocks_for(vecs, int64_t{kThreads} * k);
  return b > 0 ? b : 1;
}

template <int I>
using Kernel = void (*)(const typename UInt<I>::T*, typename UInt<I>::T*,
                        int64_t, int);

// One launch over n elements of `itemsize` bytes and `tail` bytes.
// Kernels::get<I, K, kVec>() names the kernel of each instantiation.
template <class Kernels>
int launch(const void* in, void* out, int64_t n, int itemsize, int64_t tail,
           cudaStream_t s) {
  if (n < 0 || tail < 0 || tail >= itemsize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && tail == 0) return 0;
  const bool vec = aligned(in, 16) && aligned(out, 16);
  const int k = vecs_per_thread(n, itemsize);
  RT_DISPATCH_ITEMSIZE(itemsize,
    using T = typename UInt<I>::T;
    const Kernel<I> f =
        k == kDeepVecs
            ? (vec ? Kernels::template get<I, kDeepVecs, true>()
                   : Kernels::template get<I, kDeepVecs, false>())
            : (vec ? Kernels::template get<I, 1, true>()
                   : Kernels::template get<I, 1, false>());
    f<<<map_blocks(n, I, k), kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n,
        static_cast<int>(tail)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vmap
