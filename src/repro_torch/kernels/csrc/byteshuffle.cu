// Byte transpose of one basket (Blosc "shuffle"): (N, I) bytes -> (I, N).
//
// Replaces the Pallas kernel src/repro/kernels/byteshuffle.py:_t_kernel, as
// called by byteshuffle and byteunshuffle, with the container's semantics
// from src/repro/core/precond.py:shuffle/unshuffle: any N and the len % I
// tail passed through.
//
// Bound: pure data movement, N*I bytes read and N*I written, so the least
// time is 2*N*I / 3.35 TB/s on an H100 SXM (0.54 us for the checkpoint's
// 911 616-byte lm_head baskets, 0.060 ms for a 100.66 MB one).
//
// Design.  A warp owns a tile of kTileElems = 512 elements; lane L owns the
// 16 consecutive elements [16L, 16L + 16) of it: 16*I bytes on the element
// side, and exactly one 16-byte vector of each of the I planes.  So every
// access of the wide path is 16 bytes a lane, and the warp writes (forward)
// or reads (inverse) 512 contiguous bytes of each plane with one instruction
// a plane.  A lane turns its 4*I element words into its 4*I plane words (and
// back) with __byte_perm (PTX prmt) in registers: I = 2 splits even and odd
// bytes (kDeinterleave) and joins them back (kInterleave); I = 4 is a 4x4
// byte transpose, kInterleave on pairs of words then kHalves on pairs of
// those, 8 prmt for 16 bytes and its own inverse; I = 8 runs that on the
// elements' low words (planes 0-3) and high words (planes 4-7); I = 1 is the
// identity, through the same launch.
//
// Forward: the warp copies its whole tile into shared memory with 16-byte
// cp.async (all of it in flight at once, zero-filled past N), then each
// lane reads its row of I chunks.  Shared memory is addressed in 16-byte
// chunks with an XOR swizzle, chunk k at k ^ ((k >> kSwizzleShift) & 7), so
// that both the copy (8 lanes a phase on consecutive chunks) and the row
// reads (8 lanes a phase on chunk c of 8 rows, I chunks apart) touch 32
// distinct banks.  Each plane then gets one coalesced 512-byte store.
//
// Inverse: lane L loads its vector of each of the I planes (each a coalesced
// 512-byte load of the warp, all issued before the first use), transposes,
// and writes its row into the swizzled shared tile, from which the warp
// stores the tile with coalesced 16-byte stores.
//
// Narrow paths, chosen at launch (never a branch per element in the wide
// path): an element-side pointer that is not 16-byte aligned (only a
// multiple of I is required) takes element loads or stores; the planes,
// which start at j*N, take 16-byte accesses only when N % 16 == 0 and the
// plane pointer is 16-byte aligned, else 4-byte ones when N % 4 == 0 and
// it is 4-byte aligned, else byte ones (the golden's N = 77 100 takes
// 4-byte ones; the main path's baskets are all wide).  The len % I tail is
// copied inside the kernel by the last block, so every call is one device
// operation, and a tail alone is one block.
//
// Grid: warp w of block b owns tile b * warps + w.  From kWideTiles tiles
// on (two an SM) a block has kWideWarps warps, which holds enough tiles in
// flight on each SM at 100 MB (one warp a block, at most 32 blocks an SM,
// left I = 1 far below the copy's rate there) and took less device time
// at the checkpoint's 911 616-byte baskets (891 tiles, 223 blocks); fewer
// tiles take one warp a block, so that each has an SM of its own (the event
// tree's 1 MiB baskets of 8-byte elements, 256 tiles).  kernels/byteshuffle.py
// :grid says the same, and the CPU tests hold the two together.
#include "common.cuh"

namespace {

constexpr int kLaneElems = 16;                  // one 16-byte vector a plane
constexpr int kTileElems = 32 * kLaneElems;     // a warp's tile
constexpr int kWideWarps = 4;                   // warps a block from kWideTiles on
constexpr int64_t kWideTiles = 2 * 132;         // two tiles an SM of an H100 SXM
constexpr int kSwizzleShift = 3;

// __byte_perm(x, y, s) selectors: byte i of the result is byte
// (s >> 4i) & 7 of the eight bytes x (0-3), y (4-7)
constexpr unsigned kInterleave[2] = {0x5140u, 0x7362u};    // x0 y0 x1 y1, x2 y2 x3 y3
constexpr unsigned kDeinterleave[2] = {0x6420u, 0x7531u};  // x0 x2 y0 y2, x1 x3 y1 y3
constexpr unsigned kHalves[2] = {0x5410u, 0x7632u};        // x0 x1 y0 y1, x2 x3 y2 y3

__device__ __forceinline__ int swizzle(int k) {
  return k ^ ((k >> kSwizzleShift) & 7);
}

__device__ __forceinline__ void interleave(uint32_t x, uint32_t y, uint32_t& a,
                                           uint32_t& b) {
  constexpr unsigned s0 = kInterleave[0], s1 = kInterleave[1];
  a = __byte_perm(x, y, s0);
  b = __byte_perm(x, y, s1);
}

__device__ __forceinline__ void deinterleave(uint32_t x, uint32_t y,
                                             uint32_t& a, uint32_t& b) {
  constexpr unsigned s0 = kDeinterleave[0], s1 = kDeinterleave[1];
  a = __byte_perm(x, y, s0);
  b = __byte_perm(x, y, s1);
}

__device__ __forceinline__ void halves(uint32_t x, uint32_t y, uint32_t& a,
                                       uint32_t& b) {
  constexpr unsigned s0 = kHalves[0], s1 = kHalves[1];
  a = __byte_perm(x, y, s0);
  b = __byte_perm(x, y, s1);
}

// the 4x4 byte transpose: byte j of b_e = byte e of a_j; its own inverse
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t& b0, uint32_t& b1,
                                           uint32_t& b2, uint32_t& b3) {
  uint32_t t0, t1, t2, t3;
  interleave(a0, a1, t0, t1);
  interleave(a2, a3, t2, t3);
  halves(t0, t2, b0, b1);
  halves(t1, t3, b2, b3);
}

// a lane's row (w: its 16 elements, little-endian, 4*I words) -> its plane
// vectors (p[4j .. 4j + 3]: byte j of the 16 elements)
template <int I>
__device__ __forceinline__ void to_planes(const uint32_t (&w)[4 * I],
                                          uint32_t (&p)[4 * I]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // elements 4q .. 4q + 3
    if constexpr (I == 1) {
      p[q] = w[q];
    } else if constexpr (I == 2) {
      deinterleave(w[2 * q], w[2 * q + 1], p[q], p[4 + q]);
    } else if constexpr (I == 4) {
      transpose4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3],
                 p[q], p[4 + q], p[8 + q], p[12 + q]);
    } else {
      transpose4(w[8 * q], w[8 * q + 2], w[8 * q + 4], w[8 * q + 6],
                 p[q], p[4 + q], p[8 + q], p[12 + q]);
      transpose4(w[8 * q + 1], w[8 * q + 3], w[8 * q + 5], w[8 * q + 7],
                 p[16 + q], p[20 + q], p[24 + q], p[28 + q]);
    }
  }
}

// the inverse of to_planes
template <int I>
__device__ __forceinline__ void from_planes(const uint32_t (&p)[4 * I],
                                            uint32_t (&w)[4 * I]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (I == 1) {
      w[q] = p[q];
    } else if constexpr (I == 2) {
      interleave(p[q], p[4 + q], w[2 * q], w[2 * q + 1]);
    } else if constexpr (I == 4) {
      transpose4(p[q], p[4 + q], p[8 + q], p[12 + q],
                 w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    } else {
      transpose4(p[q], p[4 + q], p[8 + q], p[12 + q],
                 w[8 * q], w[8 * q + 2], w[8 * q + 4], w[8 * q + 6]);
      transpose4(p[16 + q], p[20 + q], p[24 + q], p[28 + q],
                 w[8 * q + 1], w[8 * q + 3], w[8 * q + 5], w[8 * q + 7]);
    }
  }
}

// plane bytes [e0, e0 + 16) <- v, those before n only, in accesses of kWidth
// bytes (16: n % 16 == 0, 4: n % 4 == 0, each with the plane aligned so)
template <int kWidth>
__device__ __forceinline__ void store_plane(uint8_t* plane, int64_t e0,
                                            int64_t n, const uint32_t* v) {
  if constexpr (kWidth == 16) {
    if (e0 < n) *reinterpret_cast<uint4*>(plane + e0) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kWidth == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (e0 + 4 * q < n) *reinterpret_cast<uint32_t*>(plane + e0 + 4 * q) = v[q];
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (e0 + b < n) plane[e0 + b] = static_cast<uint8_t>(v[b / 4] >> (8 * (b % 4)));
  }
}

// the inverse: plane bytes [e0, e0 + 16) into v, zero from n on
template <int kWidth>
__device__ __forceinline__ void load_plane(const uint8_t* plane, int64_t e0,
                                           int64_t n, uint32_t* v) {
  if constexpr (kWidth == 16) {
    const uint4 u = e0 < n ? __ldg(reinterpret_cast<const uint4*>(plane + e0))
                           : make_uint4(0, 0, 0, 0);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else if constexpr (kWidth == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = e0 + 4 * q < n ? __ldg(reinterpret_cast<const uint32_t*>(plane + e0 + 4 * q)) : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (e0 + 4 * q + b < n)
          v[q] |= static_cast<uint32_t>(__ldg(plane + e0 + 4 * q + b)) << (8 * b);
    }
  }
}

// the first element of this warp's tile (n or more: no tile)
__device__ __forceinline__ int64_t tile_base() {
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                       threadIdx.x / 32;
  return tile * kTileElems;
}

// kVecElems: `in` 16-byte aligned (cp.async); kWidth: the planes' access width
template <int I, bool kVecElems, int kWidth>
__global__ void __launch_bounds__(32 * kWideWarps)
byteshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   int64_t n, int tail) {
  using T = typename UInt<I>::T;
  constexpr int V = 16 / I;  // elements a chunk
  extern __shared__ uint4 smem[];
  copy_tail_in_kernel(in, n * I, out, n * I, tail);
  const int lane = threadIdx.x % 32;
  const int64_t base = tile_base();
  if (base >= n) return;  // a tail alone, or a warp past the last tile
  uint4* s = smem + (threadIdx.x / 32) * 32 * I;

  // the whole tile into shared memory: chunk k, elements [base + k*V, +V)
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int k = i * 32 + lane;
    const int64_t e0 = base + k * V;
    if constexpr (kVecElems) {
      const int64_t left = n - e0;
      const int bytes = left >= V ? 16 : left > 0 ? static_cast<int>(left) * I : 0;
      cp_async16(&s[swizzle(k)], bytes > 0 ? in + e0 * I : in, bytes);
    } else {
      const T* p = reinterpret_cast<const T*>(in);
      Chunk<I> c;
#pragma unroll
      for (int j = 0; j < V; ++j) c.e[j] = e0 + j < n ? p[e0 + j] : T(0);
      s[swizzle(k)] = c.u;
    }
  }
  if constexpr (kVecElems) {
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncwarp();

  uint32_t w[4 * I], p[4 * I];
#pragma unroll
  for (int c = 0; c < I; ++c) {
    Chunk<I> v;
    v.u = s[swizzle(lane * I + c)];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[4 * c + q] = v.w[q];
  }
  to_planes<I>(w, p);
  const int64_t e0 = base + kLaneElems * lane;
#pragma unroll
  for (int j = 0; j < I; ++j) store_plane<kWidth>(out + j * n, e0, n, &p[4 * j]);
}

// kWidth: the planes' access width; kVecElems: `out` 16-byte aligned
template <int I, bool kVecElems, int kWidth>
__global__ void __launch_bounds__(32 * kWideWarps)
byteunshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t n, int tail) {
  using T = typename UInt<I>::T;
  constexpr int V = 16 / I;
  extern __shared__ uint4 smem[];
  copy_tail_in_kernel(in, n * I, out, n * I, tail);
  const int lane = threadIdx.x % 32;
  const int64_t base = tile_base();
  if (base >= n) return;
  uint4* s = smem + (threadIdx.x / 32) * 32 * I;

  const int64_t e0 = base + kLaneElems * lane;
  uint32_t p[4 * I], w[4 * I];
#pragma unroll
  for (int j = 0; j < I; ++j) load_plane<kWidth>(in + j * n, e0, n, &p[4 * j]);
  from_planes<I>(p, w);
#pragma unroll
  for (int c = 0; c < I; ++c)
    s[swizzle(lane * I + c)] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  __syncwarp();

  // the tile out of shared memory: chunk k, elements [base + k*V, +V)
  T* o = reinterpret_cast<T*>(out);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int k = i * 32 + lane;
    const int64_t c0 = base + k * V;
    Chunk<I> c;
    c.u = s[swizzle(k)];
    if constexpr (kVecElems) {
      if (c0 + V <= n) {
        *reinterpret_cast<uint4*>(o + c0) = c.u;
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (c0 + j < n) o[c0 + j] = c.e[j];
  }
}

using Kernel = void (*)(const uint8_t*, uint8_t*, int64_t, int);

// the planes' access width: 16 or 4 bytes where every plane start j*N is
// aligned so, else 1
int plane_width(int64_t n, const void* planes) {
  if (n % 16 == 0 && aligned(planes, 16)) return 16;
  if (n % 4 == 0 && aligned(planes, 4)) return 4;
  return 1;
}

template <int I, bool kVecElems>
Kernel forward(int width) {
  return width == 16 ? byteshuffle_kernel<I, kVecElems, 16>
       : width == 4  ? byteshuffle_kernel<I, kVecElems, 4>
                     : byteshuffle_kernel<I, kVecElems, 1>;
}

template <int I, bool kVecElems>
Kernel inverse(int width) {
  return width == 16 ? byteunshuffle_kernel<I, kVecElems, 16>
       : width == 4  ? byteunshuffle_kernel<I, kVecElems, 4>
                     : byteunshuffle_kernel<I, kVecElems, 1>;
}

// warp w of block b owns tile b * warps + w; a tail alone takes one block
int launch(Kernel k, const void* in, void* out, int64_t n, int itemsize,
           int64_t tail, cudaStream_t s) {
  const int64_t tiles = (n + kTileElems - 1) / kTileElems;
  const int warps = tiles >= kWideTiles ? kWideWarps : 1;
  const int64_t blocks = (tiles + warps - 1) / warps;
  k<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), 32 * warps,
      32 * warps * itemsize * sizeof(uint4), s>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n,
      static_cast<int>(tail));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: n*itemsize + tail bytes (element-aligned); out: the same length.
extern "C" int rt_byteshuffle(const void* in, void* out, int64_t n, int itemsize,
                              int64_t tail, void* stream) {
  if (n < 0 || tail < 0 || tail >= itemsize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && tail == 0) return 0;
  const bool vec = aligned(in, 16);
  const int width = plane_width(n, out);
  Kernel k = nullptr;
  RT_DISPATCH_ITEMSIZE(itemsize,
    k = vec ? forward<I, true>(width) : forward<I, false>(width));
  return launch(k, in, out, n, itemsize, tail, static_cast<cudaStream_t>(stream));
}

// in: n*itemsize + tail bytes; out: the same length (element-aligned).
extern "C" int rt_byteunshuffle(const void* in, void* out, int64_t n,
                                int itemsize, int64_t tail, void* stream) {
  if (n < 0 || tail < 0 || tail >= itemsize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && tail == 0) return 0;
  const int width = plane_width(n, in);
  const bool vec = aligned(out, 16);
  Kernel k = nullptr;
  RT_DISPATCH_ITEMSIZE(itemsize,
    k = vec ? inverse<I, true>(width) : inverse<I, false>(width));
  return launch(k, in, out, n, itemsize, tail, static_cast<cudaStream_t>(stream));
}
