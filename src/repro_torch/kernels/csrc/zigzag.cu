// Zigzag and its inverse over one basket of little-endian integers of I
// bytes, mod 2^(8*I), the len % I tail passed through: forward, on the
// signed view, (v << 1) ^ (v >> (8*I - 1)), so that small magnitudes of
// either sign become small unsigned values; inverse (u >> 1) ^ -(u & 1).
//
// Replaces no Pallas kernel: the reference preconditions zigzag{I} branches
// on the host only (src/repro/core/precond.py:zigzag_encode/zigzag_decode,
// which sign-extend through int64 and keep the low 8*I bits, as these do).
// Added so that a tuned zigzag{I} decision preconditions a CUDA tensor on
// its device, as every other stage does, instead of raising.
//
// Bound, design and hazards: those of the vector path, csrc/vector_map.cuh
// (the same bytes as the forward delta, without its neighbour): one launch
// a call, its tail included.
#include "vector_map.cuh"

namespace {

template <int I, int K, bool kVec>
__global__ void __launch_bounds__(vmap::kThreads)
zigzag_kernel(const typename UInt<I>::T* __restrict__ in,
              typename UInt<I>::T* __restrict__ out, int64_t n, int tail) {
  vmap::map_vectors<vmap::Op::kZigzag, I, K, kVec>(in, out, n, tail);
}

template <int I, int K, bool kVec>
__global__ void __launch_bounds__(vmap::kThreads)
unzigzag_kernel(const typename UInt<I>::T* __restrict__ in,
                typename UInt<I>::T* __restrict__ out, int64_t n, int tail) {
  vmap::map_vectors<vmap::Op::kUnzigzag, I, K, kVec>(in, out, n, tail);
}

struct ZigzagKernels {
  template <int I, int K, bool kVec>
  static vmap::Kernel<I> get() { return zigzag_kernel<I, K, kVec>; }
};

struct UnzigzagKernels {
  template <int I, int K, bool kVec>
  static vmap::Kernel<I> get() { return unzigzag_kernel<I, K, kVec>; }
};

}  // namespace

// in/out: n*itemsize + tail bytes, element-aligned, not overlapping.
extern "C" int rt_zigzag(const void* in, void* out, int64_t n, int itemsize,
                         int64_t tail, void* stream) {
  return vmap::launch<ZigzagKernels>(in, out, n, itemsize, tail,
                                     static_cast<cudaStream_t>(stream));
}

// in/out: n*itemsize + tail bytes, element-aligned, not overlapping.
extern "C" int rt_unzigzag(const void* in, void* out, int64_t n, int itemsize,
                           int64_t tail, void* stream) {
  return vmap::launch<UnzigzagKernels>(in, out, n, itemsize, tail,
                                       static_cast<cudaStream_t>(stream));
}
