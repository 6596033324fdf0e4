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
// (32768, 2048) float32 qpack takes at least 0.100 ms, a k = 1 qunpack to
// bf16 at least 0.060 ms.  At the serve path's decode shape (4, 2048) the
// device work is a few kilobytes, and the time of a call is the host's.
//
// qpack (simple first): one warp per row, eight rows per block; lanes stride
// the row with coalesced loads, a shuffle reduction gives the amax to every
// lane, and a second pass over the row (now in L1/L2) writes the int8s.
//
// qunpack: each thread owns 16 consecutive elements of a row.  It reads them
// with one 16-byte load (ld.global.nc) per k-plane, reads that plane's scale
// for the row once, and writes two 16-byte vectors (bf16) or four (f32):
// one load and two stores for 16 elements, where one element a thread
// would issue a 1-byte load and a 2-byte store each and leave the card
// issue-bound rather than memory-bound.  The grid's x walks a row's vectors and
// its y the rows (threadIdx.y packs several short rows into one block), so
// no thread divides to find its row or column.  Rows whose length is not a
// multiple of 16, or pointers not 16-byte aligned, take the scalar variant
// of the same kernel, chosen at launch: a row r starts at byte r * C, so
// for C = 2047 every row after the first is unaligned.  The gathered
// payloads of the compressed reduction arrive as one (k * R, C) buffer
// viewed as (k, R, C): plane j starts at j * R * C, 16-byte aligned
// whenever C % 16 == 0.
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

constexpr int kVec = 16;  // qunpack: elements a thread owns

union Bytes16 {
  int4 v;
  int8_t b[kVec];
};

// acc[i] (+)= q[i] * s over the thread's elements [0, m); the vector variant
// reads all 16 with one 16-byte load
template <bool kVector, bool kFirst>
__device__ __forceinline__ void scaled(const int8_t* __restrict__ q, float s,
                                       int64_t m, float (&acc)[kVec]) {
  int8_t b[kVec];
  if constexpr (kVector) {
    Bytes16 u;
    u.v = __ldg(reinterpret_cast<const int4*>(q));
#pragma unroll
    for (int i = 0; i < kVec; ++i) b[i] = u.b[i];
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) b[i] = i < m ? q[i] : int8_t(0);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float p = __fmul_rn(static_cast<float>(b[i]), s);
    if constexpr (kFirst) {
      acc[i] = p;
    } else {
      acc[i] = __fadd_rn(acc[i], p);
    }
  }
}

template <bool kVector>
__device__ __forceinline__ void store16(float* __restrict__ out, int64_t m,
                                        const float (&acc)[kVec]) {
  if constexpr (kVector) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < m) out[i] = acc[i];
  }
}

template <bool kVector>
__device__ __forceinline__ void store16(__nv_bfloat16* __restrict__ out,
                                        int64_t m, const float (&acc)[kVec]) {
  if constexpr (kVector) {
    union {
      uint4 v[2];
      unsigned short h[kVec];
    } u;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      u.h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[i]));
    reinterpret_cast<uint4*>(out)[0] = u.v[0];
    reinterpret_cast<uint4*>(out)[1] = u.v[1];
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < m) out[i] = __float2bfloat16_rn(acc[i]);
  }
}

// out[r, c] = sum_j q[j, r, c] * scale[j, r]: thread (x, y) of block
// (bx, by) owns elements [16 * (bx * blockDim.x + x), +16) of the rows
// by * blockDim.y + y, stepping by gridDim.y * blockDim.y
template <typename O, bool kVector>
__global__ void __launch_bounds__(kThreads)
qunpack_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               O* __restrict__ out, int64_t k, int64_t rows, int64_t cols) {
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (c0 >= cols) return;
  const int64_t m = cols - c0;  // elements of the row from c0 on
  const int64_t plane = rows * cols;
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.y;
  for (int64_t r = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y;
       r < rows; r += step) {
    const int64_t at = r * cols + c0;
    float acc[kVec];
    scaled<kVector, true>(q + at, __ldg(scale + r), m, acc);
    for (int64_t j = 1; j < k; ++j)
      scaled<kVector, false>(q + j * plane + at, __ldg(scale + j * rows + r), m,
                             acc);
    store16<kVector>(out + at, m, acc);
  }
}

// the 16-byte variant when `vector`, else the scalar one
template <typename O>
void launch_qunpack(bool vector, dim3 grid, dim3 block, cudaStream_t s,
                    const int8_t* q, const float* scale, void* out, int64_t k,
                    int64_t rows, int64_t cols) {
  O* o = static_cast<O*>(out);
  if (vector)
    qunpack_kernel<O, true><<<grid, block, 0, s>>>(q, scale, o, k, rows, cols);
  else
    qunpack_kernel<O, false><<<grid, block, 0, s>>>(q, scale, o, k, rows, cols);
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
  // x: a row's vectors, up to a whole block; y: as many rows as fill it
  const int64_t vecs = (cols + kVec - 1) / kVec;
  unsigned bx = 1;
  while (bx < vecs && bx < static_cast<unsigned>(kThreads)) bx <<= 1;
  const unsigned by = kThreads / bx;
  const int64_t row_blocks = (rows + by - 1) / by;
  const dim3 grid(blocks_for(vecs, bx),
                  static_cast<unsigned>(row_blocks < kMaxGridY ? row_blocks : kMaxGridY));
  const bool vector = cols % kVec == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* si = static_cast<const float*>(scale);
  switch (out_dtype) {
    case kF32:
      launch_qunpack<float>(vector, grid, dim3(bx, by), stream, qi, si, out, k,
                            rows, cols);
      break;
    case kBF16:
      launch_qunpack<__nv_bfloat16>(vector, grid, dim3(bx, by), stream, qi, si,
                                    out, k, rows, cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  RT_CHECK_LAUNCH();
  return 0;
}
