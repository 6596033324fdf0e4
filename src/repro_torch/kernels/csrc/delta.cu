// Delta and its inverse over one basket of little-endian unsigned integers,
// mod 2^(8*I): out[0] = x[0], out[i] = x[i] - x[i-1]; the inverse is the
// inclusive prefix sum.  Every basket restarts at its own first element, and
// the len % I tail bytes pass through.
//
// Replaces the Pallas kernels src/repro/kernels/delta.py:delta_block
// (_delta_kernel) and :undelta_block (_undelta_kernel).  Those are
// block-local, and the reference's ops.delta_u32/undelta_u32 glue them into
// one delta over a whole tensor; the container instead deltas each basket
// on its own (src/repro/core/precond.py:delta_encode/delta_decode, applied
// per basket by core/basket.py:pack_basket), which is what these compute,
// for I = 1, 2, 4 and 8.
//
// Bound: data movement, N*I bytes read once and N*I written once:
// 2*N*I / 3.35 TB/s on an H100 SXM (0.63 us for a 1 MiB basket, 0.0597 ms
// for 100 MB).  The adds are free beside the bytes.  At the checkpoint's
// 1 MiB baskets both kernels are a few microseconds of device work, so the
// host's launch path (kernels/_build.py:call) sets the time of a call.
//
// Delta: the vector path of csrc/vector_map.cuh, one launch a call with its
// tail.  Each thread loads whole 16-byte vectors (several a thread on large
// baskets, all in flight before the first is used) and takes each vector's
// left neighbour from the previous lane with __shfl_up_sync; lane 0 loads
// its own.  Its design, grid and hazards are described there.
//
// Undelta: one launch a call, its tail included, with no memcpy, no memset
// and nothing allocated.  A single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016): one block per 32 KiB tile.  The block copies its tile
// once into shared memory with 16-byte cp.async (zero-filled past the
// basket's end; scalar loads when a pointer is not 16-byte aligned), scans
// it per lane and then per 512-byte row with warp shuffles, and publishes
// the tile's sum as its aggregate.  Warp 0 then looks back: each lane reads
// one predecessor's status, 32 at a time, and sums aggregates down to the
// nearest inclusive prefix (tile 0's prefix is its aggregate).  The block
// publishes its own inclusive prefix, adds its exclusive prefix to the
// tile, and stores it.  So the input is read once and the output written
// once, where the reduce-then-scan of three kernels that this replaces
// read it twice.  Offsets are 64-bit throughout: one basket may be hundreds
// of MB.  The tile lives in shared memory, not registers, so a thread needs
// about 40 registers and six blocks share an SM: while one block waits in
// its look-back with nothing in flight, the others' copies keep the memory
// busy.
//
// Three hazards of the scan, and what the design does about each:
//
// 1. Forward progress.  A block takes its tile index from an atomic ticket,
//    not from blockIdx: blocks are not scheduled in index order, and a
//    100 MB basket has ~3 050 tiles, more than can be resident at once.  A
//    block that spun on a predecessor never scheduled would hang the card.
//    With the ticket, every lower tile belongs to a block that has already
//    started, and so will publish.
// 2. Publication of 64-bit sums.  For I = 8 the value cannot share one word
//    with its flag, so a status is the value written first, __threadfence(),
//    then the flag; a reader loads the flag with ld.acquire and only then
//    the value.  Sums wrap mod 2^32 for I <= 4 (the stored width divides
//    it) and mod 2^64 for I = 8.
// 3. The workspace.  The ticket and the tile statuses live in a workspace
//    that the caller keeps across launches, one per (device, stream)
//    (kernels/delta.py), zeroed once when it is made or grown and never
//    reset by the host.  Each flag carries the launch's epoch beside its
//    state, so a status left by an earlier launch reads as "not yet
//    published".  The last block to finish (a done counter) sets the ticket
//    and the counter back to 0 and advances the epoch, so the workspace is
//    ready for the next launch when this one ends.  Launches on one stream
//    run one after another, so threads that launch on one stream at once
//    (the checkpoint's restore threads) share its workspace safely.  Two
//    streams never share one: their launches may overlap, and their
//    tickets would mix.
#include "common.cuh"

#include <type_traits>

#include "vector_map.cuh"

namespace {

// the forward delta: the vector path
template <int I, int K, bool kVec>
__global__ void __launch_bounds__(vmap::kThreads)
delta_kernel(const typename UInt<I>::T* __restrict__ in,
             typename UInt<I>::T* __restrict__ out, int64_t n, int tail) {
  vmap::map_vectors<vmap::Op::kDelta, I, K, kVec>(in, out, n, tail);
}

struct DeltaKernels {
  template <int I, int K, bool kVec>
  static vmap::Kernel<I> get() { return delta_kernel<I, K, kVec>; }
};

// the inverse: the look-back scan

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecBytes = 16;
constexpr int kRows = 8;  // vectors per thread in an undelta tile
// ~40 registers a thread and 6 x 32 KiB of tiles in shared memory an SM
constexpr int kUndeltaBlocksPerSM = 6;
// undelta tile; kernels/delta.py TILE_BYTES must say the same
constexpr int64_t kTileBytes = 32768;
static_assert(kTileBytes == int64_t{kThreads} * kRows * kVecBytes, "tile size");

// workspace words: epoch, ticket, blocks done, unused; then `capacity` tile
// flags, `capacity` aggregates, `capacity` inclusive prefixes
// (kernels/delta.py HEADER_WORDS, workspace_words)
constexpr int kHeaderWords = 4;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;  // flag & 3; 0: none

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

// the warp's sum, in every lane
template <typename A>
__device__ __forceinline__ A warp_sum(A x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFullMask, x, d);
  return x;
}

// the len % I tail bytes after the n elements pass through (one block)
__device__ __forceinline__ void copy_tail_bytes(const void* in, void* out,
                                                int64_t at, int tail) {
  if (static_cast<int>(threadIdx.x) < tail)
    static_cast<uint8_t*>(out)[at + threadIdx.x] =
        static_cast<const uint8_t*>(in)[at + threadIdx.x];
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_volatile(unsigned long long* p,
                                            unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// a tile's status: its value, a fence, then the flag that makes it readable
__device__ __forceinline__ void publish(unsigned long long* flag,
                                        unsigned long long* slot,
                                        unsigned long long value,
                                        unsigned long long epoch,
                                        unsigned long long state) {
  st_volatile(slot, value);
  __threadfence();
  st_volatile(flag, (epoch << 2) | state);
}

// Warp 0 of the block that holds `tile` > 0: the sum of every tile before
// it, from the predecessors' statuses, 32 at a time from the nearest down
// to the first inclusive prefix.
template <typename A>
__device__ A look_back(const unsigned long long* flags,
                       const unsigned long long* aggs,
                       const unsigned long long* incls, int64_t tile,
                       unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  A excl = 0;
  for (int64_t nearest = tile - 1;; nearest -= 32) {
    const int64_t t = nearest - lane;
    bool prefix = true;  // before tile 0: an inclusive prefix of 0
    A value = 0;
    if (t >= 0) {
      unsigned long long f;
      do {
        f = ld_acquire(&flags[t]);
      } while ((f >> 2) != epoch || (f & 3) == 0);
      prefix = (f & 3) == kPrefix;
      value = static_cast<A>(ld_volatile(prefix ? &incls[t] : &aggs[t]));
    }
    const unsigned found = __ballot_sync(kFullMask, prefix);
    const int stop = found ? __ffs(found) - 1 : 31;  // nearest prefix's lane
    excl += warp_sum(lane <= stop ? value : A(0));
    if (found) return excl;
  }
}

template <int I, bool kVec>
__global__ void __launch_bounds__(kThreads, kUndeltaBlocksPerSM)
undelta_kernel(const typename UInt<I>::T* __restrict__ in,
               typename UInt<I>::T* __restrict__ out, int64_t n, int tail,
               unsigned long long* ws, int64_t capacity) {
  using T = typename UInt<I>::T;
  using A = Acc<I>;
  constexpr int V = kVecBytes / I;
  constexpr int64_t kTileElems = kTileBytes / I;
  __shared__ uint4 s_tile_data[kThreads * kRows];
  __shared__ unsigned long long s_tile, s_epoch;
  __shared__ A s_warp[kWarps];
  unsigned long long* flags = ws + kHeaderWords;
  unsigned long long* aggs = flags + capacity;
  unsigned long long* incls = aggs + capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) s_tile = atomicAdd(&ws[1], 1ull);
  if (threadIdx.x == 32) s_epoch = ld_volatile(&ws[0]);
  __syncthreads();
  const int64_t tile = static_cast<int64_t>(s_tile);
  const unsigned long long epoch = s_epoch;

  // this warp's kRows rows of 32 vectors; each thread only ever touches its
  // own vector of a row (row r at mine[32 * r])
  const int64_t seg = tile * kTileElems + int64_t{warp} * kRows * 32 * V;
  uint4* mine = s_tile_data + warp * kRows * 32 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t e0 = seg + (r * 32 + lane) * V;
    if constexpr (kVec) {
      const int64_t left = n - e0;
      const int bytes = left >= V ? kVecBytes : left > 0 ? static_cast<int>(left) * I : 0;
      cp_async16(&mine[32 * r], bytes > 0 ? in + e0 : in, bytes);
    } else {
      Chunk<I> v;
      vmap::load_elements<I>(in, e0, n, v);
      mine[32 * r] = v.u;
    }
  }
  if constexpr (kVec) {
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }

  A run = 0;  // the warp's sum over the rows before r
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    Chunk<I> v;
    v.u = mine[32 * r];
    A s = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s += v.e[j];
      v.e[j] = static_cast<T>(s);
    }
    const A inc = warp_inclusive_scan(s);
    const A off = run + inc - s;
#pragma unroll
    for (int j = 0; j < V; ++j) v.e[j] = static_cast<T>(v.e[j] + off);
    mine[32 * r] = v.u;
    run += __shfl_sync(kFullMask, inc, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  if (warp == 0) {
    const A total = lane < kWarps ? s_warp[lane] : A(0);
    const A inc = warp_inclusive_scan(total);
    const A agg = __shfl_sync(kFullMask, inc, kWarps - 1);
    A excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(&flags[0], &incls[0], agg, epoch, kPrefix);
    } else {
      if (lane == 0) publish(&flags[tile], &aggs[tile], agg, epoch, kAggregate);
      excl = look_back<A>(flags, aggs, incls, tile, epoch);
      if (lane == 0)
        publish(&flags[tile], &incls[tile], static_cast<A>(excl + agg), epoch,
                kPrefix);
    }
    if (lane < kWarps) s_warp[lane] = excl + inc - total;  // each warp's offset
  }
  __syncthreads();

  const A off = s_warp[warp];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    Chunk<I> v;
    v.u = mine[32 * r];
#pragma unroll
    for (int j = 0; j < V; ++j) v.e[j] = static_cast<T>(v.e[j] + off);
    vmap::store<I, kVec>(out, seg + (r * 32 + lane) * V, n, v);
  }
  if (tile == 0) copy_tail_bytes(in, out, n * I, tail);

  // The last block to finish readies the workspace for the next launch.  No
  // fence: every block took its ticket and read the epoch before counting
  // itself done, and the next launch on this stream sees all of this one's
  // writes once it has ended.
  if (threadIdx.x == 0 && atomicAdd(&ws[2], 1ull) == gridDim.x - 1) {
    st_volatile(&ws[1], 0);
    st_volatile(&ws[2], 0);
    st_volatile(&ws[0], epoch + 1);
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          kVecBytes) == 0;
}

template <int I, bool kVec>
void launch_undelta(unsigned blocks, cudaStream_t s, const void* in, void* out,
                    int64_t n, int tail, unsigned long long* ws,
                    int64_t capacity) {
  using T = typename UInt<I>::T;
  undelta_kernel<I, kVec><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, tail, ws, capacity);
}

}  // namespace

// in/out: n*itemsize + tail bytes, element-aligned, not overlapping.
extern "C" int rt_delta(const void* in, void* out, int64_t n, int itemsize,
                        int64_t tail, void* stream) {
  return vmap::launch<DeltaKernels>(in, out, n, itemsize, tail,
                                    static_cast<cudaStream_t>(stream));
}

// in/out: n*itemsize + tail bytes, element-aligned; workspace: the calling
// stream's, 4 + 3*capacity 64-bit words, zeroed when it was made, with
// capacity >= max(1, ceil(n*itemsize / 32768)) tiles (kernels/delta.py).
extern "C" int rt_undelta(const void* in, void* out, int64_t n, int itemsize,
                          int64_t tail, void* workspace, int64_t capacity,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || tail < 0 || tail >= itemsize)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && tail == 0) return 0;
  const bool vec = aligned16(in, out);
  auto* ws = static_cast<unsigned long long*>(workspace);
  RT_DISPATCH_ITEMSIZE(itemsize,
    constexpr int64_t per_tile = kTileBytes / I;
    const int64_t tiles = n > 0 ? (n + per_tile - 1) / per_tile : 1;
    if (ws == nullptr || tiles > capacity)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(tiles);
    const int t = static_cast<int>(tail);
    if (vec)
      launch_undelta<I, true>(blocks, s, in, out, n, t, ws, capacity);
    else
      launch_undelta<I, false>(blocks, s, in, out, n, t, ws, capacity));
  RT_CHECK_LAUNCH();
  return 0;
}
