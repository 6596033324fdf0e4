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
// on an H100 SXM (0.6 us for a 1 MiB basket, 0.12 ms for 201 MB).
//
// Design.  A warp owns a tile of kTileElems = 1024 elements; lane L owns the
// 32 consecutive elements [32L, 32L + 32) of it, and so bytes [4L, 4L + 4)
// of the tile's 128 bytes in every plane.  A lane turns its 32 elements into
// its 32 plane words (and back) with a 32x32 bit transpose in registers:
// five rounds of masked exchanges between words k and k|j (j = 16, 8, 4,
// 2, 1), 80 exchanges of about six instructions.  After it, word p holds bit
// p of element j in bit j: four plane bytes, little-endian bit order.  The
// transpose is its own inverse.  I = 8 runs it on the low and the high
// halves of the elements (planes 0-31 and 32-63); I = 1 and 2 on elements
// zero-extended to 32 bits, keeping the first 8*I words.
//
// Forward: the warp copies its whole tile into shared memory with 16-byte
// cp.async (all of it in flight at once, zero-filled past N: the planes'
// padding bits), then each lane reads its 32 elements as 2*I 16-byte
// vectors.  Shared memory is addressed in 16-byte chunks with an XOR
// swizzle, chunk k at k ^ ((k >> kSwizzleShift) & 7), so that both the
// copy (8 lanes a phase on consecutive chunks) and a lane's read of its own
// row (8 lanes a phase on chunk c of 8 rows) touch 32 distinct banks.  Each
// plane then gets one coalesced 128-byte store from the warp.
//
// Inverse: lane L loads its word of each of the 8*I planes (each a
// coalesced 128-byte load of the warp, all issued before the first use),
// transposes, and writes its elements into the swizzled shared tile, from
// which the warp stores the tile with coalesced 16-byte stores.
//
// Narrow paths, chosen at launch (never a branch per element in the wide
// path): a pointer not 16-byte aligned on the element side takes element
// loads or stores; planes whose start is not 4-byte aligned (ceil(N/8) % 4
// != 0, or the plane pointer itself) take byte stores or loads.  The
// len % I tail is copied inside the kernel by the last block, so every
// call is one device operation.
//
// Grid: one warp a block, one block a tile, so that the checkpoint's
// 0.6-1 MiB baskets (149-256 tiles) spread over the card's 132 SMs; at
// 201 MB four or eight warps a block were no faster.  kernels/bitshuffle.py
// :grid says the same, and the CPU tests hold the two together.
#include "common.cuh"

namespace {

constexpr int kLaneElems = 32;                  // one 32x32 bit transpose
constexpr int kTileElems = 32 * kLaneElems;     // a warp's tile, a block's
// the transpose's rounds: exchange distance 16 >> r under mask kMasks[r]
constexpr uint32_t kMasks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                                0x33333333u, 0x55555555u};

// 16-byte chunks of a lane's 32 elements
template <int I>
constexpr int kChunks = 2 * I;
// the swizzle's shift: one 8-chunk group of rows a phase of 8 lanes reads
template <int I>
constexpr int kSwizzleShift = I == 8 ? 4 : 3;

template <int I>
__device__ __forceinline__ int swizzle(int k) {
  return k ^ ((k >> kSwizzleShift<I>) & 7);
}

template <int R>
__device__ __forceinline__ void exchange(uint32_t (&a)[32]) {
  constexpr int j = 16 >> R;
  constexpr uint32_t m = kMasks[R];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & j) == 0) {
      const uint32_t t = ((a[k] >> j) ^ a[k | j]) & m;
      a[k] ^= t << j;
      a[k | j] ^= t;
    }
  }
}

// a[j] bit p <-> a[p] bit j
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  exchange<0>(a);
  exchange<1>(a);
  exchange<2>(a);
  exchange<3>(a);
  exchange<4>(a);
}

// a lane's row of chunks -> its 32 elements: the low 32 bits in lo, the high
// in hi (I = 8 only)
template <int I>
__device__ __forceinline__ void unpack(const Chunk<I> (&v)[kChunks<I>],
                                       uint32_t (&lo)[32], uint32_t (&hi)[32]) {
#pragma unroll
  for (int j = 0; j < kLaneElems; ++j) {
    if constexpr (I == 8) {
      lo[j] = v[j / 2].w[2 * (j % 2)];
      hi[j] = v[j / 2].w[2 * (j % 2) + 1];
    } else if constexpr (I == 4) {
      lo[j] = v[j / 4].w[j % 4];
    } else {
      constexpr int per_word = 4 / I;
      const uint32_t w = v[j / (4 * per_word)].w[(j / per_word) % 4];
      lo[j] = (w >> (8 * I * (j % per_word))) & ((1u << (8 * I)) - 1);
    }
  }
}

// the inverse of unpack (lo[j] < 2**(8*I) for I < 4)
template <int I>
__device__ __forceinline__ void pack(const uint32_t (&lo)[32],
                                     const uint32_t (&hi)[32],
                                     Chunk<I> (&v)[kChunks<I>]) {
#pragma unroll
  for (int c = 0; c < kChunks<I>; ++c)
#pragma unroll
    for (int w = 0; w < 4; ++w) v[c].w[w] = 0;
#pragma unroll
  for (int j = 0; j < kLaneElems; ++j) {
    if constexpr (I == 8) {
      v[j / 2].w[2 * (j % 2)] = lo[j];
      v[j / 2].w[2 * (j % 2) + 1] = hi[j];
    } else {
      constexpr int per_word = 4 / I;
      v[j / (4 * per_word)].w[(j / per_word) % 4] |= lo[j] << (8 * I * (j % per_word));
    }
  }
}

// bytes [q, q + 4) of a plane of `pb` bytes <- w, little-endian, those
// before pb only; kWord: one 4-byte store (plane and pb 4-byte aligned)
template <bool kWord>
__device__ __forceinline__ void store_word(uint8_t* plane, int64_t q,
                                           int64_t pb, uint32_t w) {
  if constexpr (kWord) {
    if (q < pb) *reinterpret_cast<uint32_t*>(plane + q) = w;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (q + b < pb) plane[q + b] = static_cast<uint8_t>(w >> (8 * b));
  }
}

// the inverse: bytes [q, q + 4) of a plane, zero from pb on
template <bool kWord>
__device__ __forceinline__ uint32_t load_word(const uint8_t* plane, int64_t q,
                                              int64_t pb) {
  if constexpr (kWord) {
    return q < pb ? __ldg(reinterpret_cast<const uint32_t*>(plane + q)) : 0u;
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (q + b < pb) w |= static_cast<uint32_t>(__ldg(plane + q + b)) << (8 * b);
    return w;
  }
}

// kVecLoads: `in` 16-byte aligned (cp.async); kWordStores: planes 4-byte
// aligned
template <int I, bool kVecLoads, bool kWordStores>
__global__ void __launch_bounds__(32)
bitshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int64_t n, int64_t pb, int tail) {
  using T = typename UInt<I>::T;
  constexpr int C = kChunks<I>;
  constexpr int V = 16 / I;  // elements a chunk
  __shared__ uint4 s[32 * C];
  copy_tail_in_kernel(in, n * I, out, 8 * I * pb, tail);
  const int lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileElems;
  if (base >= n) return;  // a tail alone

  // the whole tile into shared memory: chunk k, elements [base + k*V, +V)
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = i * 32 + lane;
    const int64_t e0 = base + k * V;
    if constexpr (kVecLoads) {
      const int64_t left = n - e0;
      const int bytes = left >= V ? 16 : left > 0 ? static_cast<int>(left) * I : 0;
      cp_async16(&s[swizzle<I>(k)], bytes > 0 ? in + e0 * I : in, bytes);
    } else {
      const T* p = reinterpret_cast<const T*>(in);
      Chunk<I> c;
#pragma unroll
      for (int j = 0; j < V; ++j) c.e[j] = e0 + j < n ? p[e0 + j] : T(0);
      s[swizzle<I>(k)] = c.u;
    }
  }
  if constexpr (kVecLoads) {
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncwarp();

  Chunk<I> v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c].u = s[swizzle<I>(lane * C + c)];
  uint32_t lo[32], hi[32];
  unpack<I>(v, lo, hi);
  transpose32(lo);
  if constexpr (I == 8) transpose32(hi);

  const int64_t q = base / 8 + 4 * lane;
#pragma unroll
  for (int p = 0; p < (I == 8 ? 32 : 8 * I); ++p)
    store_word<kWordStores>(out + p * pb, q, pb, lo[p]);
  if constexpr (I == 8) {
#pragma unroll
    for (int p = 0; p < 32; ++p)
      store_word<kWordStores>(out + (32 + p) * pb, q, pb, hi[p]);
  }
}

// kWordLoads: planes 4-byte aligned; kVecStores: `out` 16-byte aligned
template <int I, bool kWordLoads, bool kVecStores>
__global__ void __launch_bounds__(32)
bitunshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int64_t n, int64_t pb, int tail) {
  using T = typename UInt<I>::T;
  constexpr int C = kChunks<I>;
  constexpr int V = 16 / I;
  __shared__ uint4 s[32 * C];
  copy_tail_in_kernel(in, 8 * I * pb, out, n * I, tail);
  const int lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileElems;
  if (base >= n) return;

  const int64_t q = base / 8 + 4 * lane;
  uint32_t lo[32], hi[32];
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    lo[p] = p < 8 * I ? load_word<kWordLoads>(in + p * pb, q, pb) : 0u;
    if constexpr (I == 8) hi[p] = load_word<kWordLoads>(in + (32 + p) * pb, q, pb);
  }
  transpose32(lo);
  if constexpr (I == 8) transpose32(hi);
  Chunk<I> v[C];
  pack<I>(lo, hi, v);
#pragma unroll
  for (int c = 0; c < C; ++c) s[swizzle<I>(lane * C + c)] = v[c].u;
  __syncwarp();

  // the tile out of shared memory: chunk k, elements [base + k*V, +V)
  T* o = reinterpret_cast<T*>(out);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = i * 32 + lane;
    const int64_t e0 = base + k * V;
    Chunk<I> c;
    c.u = s[swizzle<I>(k)];
    if constexpr (kVecStores) {
      if (e0 + V <= n) {
        *reinterpret_cast<uint4*>(o + e0) = c.u;
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (e0 + j < n) o[e0 + j] = c.e[j];
  }
}

using Kernel = void (*)(const uint8_t*, uint8_t*, int64_t, int64_t, int);

// one block a tile; a tail alone takes one block
int launch(Kernel k, const void* in, void* out, int64_t n, int64_t tail,
           cudaStream_t s) {
  const int64_t tiles = (n + kTileElems - 1) / kTileElems;
  k<<<static_cast<unsigned>(tiles > 0 ? tiles : 1), 32, 0, s>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n,
      (n + 7) / 8, static_cast<int>(tail));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: n*itemsize + tail bytes (element-aligned); out: 8*itemsize*ceil(n/8) + tail.
extern "C" int rt_bitshuffle(const void* in, void* out, int64_t n, int itemsize,
                             int64_t tail, void* stream) {
  if (n < 0 || tail < 0 || tail >= itemsize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && tail == 0) return 0;
  const bool vec = aligned(in, 16);
  const bool word = (n + 7) / 8 % 4 == 0 && aligned(out, 4);
  Kernel k = nullptr;
  RT_DISPATCH_ITEMSIZE(itemsize,
    k = vec ? (word ? bitshuffle_kernel<I, true, true> : bitshuffle_kernel<I, true, false>)
            : (word ? bitshuffle_kernel<I, false, true> : bitshuffle_kernel<I, false, false>));
  return launch(k, in, out, n, tail, static_cast<cudaStream_t>(stream));
}

// in: 8*itemsize*ceil(n/8) + tail bytes; out: n*itemsize + tail (element-aligned).
extern "C" int rt_bitunshuffle(const void* in, void* out, int64_t n,
                               int itemsize, int64_t tail, void* stream) {
  if (n < 0 || tail < 0 || tail >= itemsize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && tail == 0) return 0;
  const bool word = (n + 7) / 8 % 4 == 0 && aligned(in, 4);
  const bool vec = aligned(out, 16);
  Kernel k = nullptr;
  RT_DISPATCH_ITEMSIZE(itemsize,
    k = word ? (vec ? bitunshuffle_kernel<I, true, true> : bitunshuffle_kernel<I, true, false>)
             : (vec ? bitunshuffle_kernel<I, false, true> : bitunshuffle_kernel<I, false, false>));
  return launch(k, in, out, n, tail, static_cast<cudaStream_t>(stream));
}
