// Per-row int8 quantization of a (R, C) float matrix, and the dequant-sum
// that inverts it: the payload stage of the compressed tensor-parallel
// reduction (parallel/compressed.py).
//
// Replaces the Pallas kernels src/repro/kernels/qpack.py:qpack
// (_qpack_kernel) and :qunpack (_qunpack_kernel).
//
//   qpack:    amax = max_c |x[r, c]|, s = amax * float32(1/127),
//             q[r, c] = clip(rint(x[r, c] / s), -127, 127) as int8,
//             scale[r] = s; a row whose s is 0 divides by 1 (so q = 0) and
//             stores `zero_scale` (0 in the Pallas kernel, 1.0 in the
//             compressed reduction's own quantizer, compressed.py:44).
//   qunpack:  out[r, c] = sum_k q[k, r, c] * scale[k, r], summed in float32
//             in k order, cast to the output type; k = 1 is the Pallas
//             qunpack.
//
// Input float32 or bf16, output float32 or bf16, any R and C (the Pallas
// kernels assert R % block_rows == 0).  Every step rounds as the plain
// version (kernels/ref.py) does, so the two are bit-equal, and as the
// reference computes once XLA has compiled it: XLA turns `amax / 127.0`
// into a product with the float32 constant 1/127 (the scale is one ulp off
// the true quotient in about 5 % of rows), but keeps `x / scale` a true
// IEEE division.  So: __fmul_rn by that constant for the scale, __fdiv_rn
// for the quotient (no --use_fast_math), round-half-to-even (rintf), and
// products and sums rounded one at a time (__fmul_rn/__fadd_rn, which nvcc
// never contracts into an FMA).
//
// Bound: data movement.  qpack reads the row and writes a byte per element
// plus a scale: (itemsize + 1) * R * C + 4 * R bytes; qunpack reads k bytes
// per element and k scales per row and writes one element.  At 3.35 TB/s a
// (32768, 2048) float32 qpack takes at least 0.100 ms.
//
// Design (simple first).  qpack: one warp per row, eight rows per block;
// lanes stride the row with coalesced loads, a shuffle reduction gives the
// amax to every lane, and a second pass over the row (now in L1/L2) writes
// the int8s.  qunpack: a 2-D grid, rows on y and columns on x, one element
// per thread, so no thread divides to find its row.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int64_t kMaxGridY = 65535;
constexpr float kInv127 = 1.0f / 127.0f;  // XLA's constant for `/ 127.0`

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qpack_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scale, int64_t rows, int64_t cols,
             float zero_scale) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * cols;
  float amax = 0.0f;
#pragma unroll 4
  for (int64_t c = lane; c < cols; c += 32) {
    amax = fmaxf(amax, fabsf(to_f32(xr[c])));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, d));
  }
  const float s = __fmul_rn(amax, kInv127);
  const bool zero = s == 0.0f;
  const float div = zero ? 1.0f : s;
  int8_t* qr = q + row * cols;
#pragma unroll 4
  for (int64_t c = lane; c < cols; c += 32) {
    const float v = rintf(__fdiv_rn(to_f32(xr[c]), div));
    qr[c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (lane == 0) scale[row] = zero ? zero_scale : s;
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
qunpack_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               O* __restrict__ out, int64_t k, int64_t rows, int64_t cols) {
  const int64_t plane = rows * cols;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= cols) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t i = r * cols + c;
    float acc = __fmul_rn(static_cast<float>(q[i]), scale[r]);
    for (int64_t j = 1; j < k; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(q[j * plane + i]),
                                     scale[j * rows + r]));
    }
    store(out + i, acc);
  }
}

}  // namespace

extern "C" int rt_qpack(const void* x, void* q, void* scale, int64_t rows,
                        int64_t cols, int in_dtype, float zero_scale,
                        cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(rows, kRowsPerBlock));
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(scale);
  switch (in_dtype) {
    case kF32:
      qpack_kernel<float><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(x), qo, so, rows, cols, zero_scale);
      break;
    case kBF16:
      qpack_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), qo, so, rows, cols, zero_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  RT_CHECK_LAUNCH();
  return 0;
}

extern "C" int rt_qunpack(const void* q, const void* scale, void* out,
                          int64_t k, int64_t rows, int64_t cols, int out_dtype,
                          cudaStream_t stream) {
  if (k <= 0 || rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks_for(cols, kThreads),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* si = static_cast<const float*>(scale);
  switch (out_dtype) {
    case kF32:
      qunpack_kernel<float><<<grid, kThreads, 0, stream>>>(
          qi, si, static_cast<float*>(out), k, rows, cols);
      break;
    case kBF16:
      qunpack_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          qi, si, static_cast<__nv_bfloat16*>(out), k, rows, cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  RT_CHECK_LAUNCH();
  return 0;
}
