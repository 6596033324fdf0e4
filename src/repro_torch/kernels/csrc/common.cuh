// Shared helpers for the port's kernels (plain C interface, loaded with
// ctypes).  Every preconditioner launcher takes one basket's bytes: `n`
// whole elements of `itemsize` bytes, then `tail` = len % itemsize bytes
// that the preconditioners pass through unchanged (core/precond.py
// semantics).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int I> struct UInt;
template <> struct UInt<1> { using T = uint8_t; };
template <> struct UInt<2> { using T = uint16_t; };
template <> struct UInt<4> { using T = uint32_t; };
template <> struct UInt<8> { using T = unsigned long long; };

constexpr unsigned kFullMask = 0xffffffffu;

// Instantiate BODY with a compile-time `I` for itemsize 1, 2, 4 or 8; any
// other itemsize returns cudaErrorInvalidValue from the enclosing launcher.
#define RT_DISPATCH_ITEMSIZE(itemsize, ...)                      \
  switch (itemsize) {                                           \
    case 1: { constexpr int I = 1; __VA_ARGS__; } break;        \
    case 2: { constexpr int I = 2; __VA_ARGS__; } break;        \
    case 4: { constexpr int I = 4; __VA_ARGS__; } break;        \
    case 8: { constexpr int I = 8; __VA_ARGS__; } break;        \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

#define RT_CHECK_LAUNCH()                                        \
  do {                                                          \
    cudaError_t err_ = cudaGetLastError();                      \
    if (err_ != cudaSuccess) return static_cast<int>(err_);     \
  } while (0)

inline unsigned blocks_for(int64_t work, int64_t per_block) {
  return static_cast<unsigned>((work + per_block - 1) / per_block);
}

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// one 16-byte chunk of 16/I elements, or of four 32-bit words
template <int I>
union Chunk {
  uint4 u;
  uint32_t w[4];
  typename UInt<I>::T e[16 / I];
};

// element bytes [0, bytes) of a 16-byte chunk from global to shared memory
// without passing through registers; the rest is zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// the len % I tail: `tail` bytes from in + from to out + to, by the last
// block of the launch (tail < 32 <= blockDim.x)
__device__ __forceinline__ void copy_tail_in_kernel(const uint8_t* in,
                                                    int64_t from, uint8_t* out,
                                                    int64_t to, int tail) {
  if (blockIdx.x == gridDim.x - 1 && static_cast<int>(threadIdx.x) < tail)
    out[to + threadIdx.x] = in[from + threadIdx.x];
}
