// Shared helpers for the preconditioner kernels (plain C interface, loaded
// with ctypes).  Every launcher takes one basket's bytes: `n` whole elements
// of `itemsize` bytes, then `tail` = len % itemsize bytes that the
// preconditioners pass through unchanged (core/precond.py semantics).
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

// Pass the tail bytes through: out[dst_off:dst_off+tail] = in[src_off:...].
inline cudaError_t copy_tail(const void* in, int64_t src_off, void* out,
                             int64_t dst_off, int64_t tail, cudaStream_t s) {
  if (tail <= 0) return cudaSuccess;
  return cudaMemcpyAsync(static_cast<uint8_t*>(out) + dst_off,
                         static_cast<const uint8_t*>(in) + src_off, tail,
                         cudaMemcpyDeviceToDevice, s);
}

inline unsigned blocks_for(int64_t work, int64_t per_block) {
  return static_cast<unsigned>((work + per_block - 1) / per_block);
}
