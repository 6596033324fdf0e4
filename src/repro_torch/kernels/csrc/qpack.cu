// Per-row int8 quantization of a (R, C) float matrix, and the dequant-sum
// that inverts it: the payload stage of the compressed tensor-parallel
// reduction (parallel/compressed.py).
//
// Replaces the Pallas kernels src/repro/kernels/qpack.py:qpack
// (_qpack_kernel) and :qunpack (_qunpack_kernel).
//
//   qpack:    amax = max_c |x[r, c]|, s = amax * float32(1/127),
//             q[r, c] = clip(rint(x[r, c] / s), -127, 127) as int8,
//             scale[r] = s.  A subnormal x counts as 0 (q = 0) and a
//             subnormal s is 0, as in XLA, which flushes subnormals on
//             the CPU and the TPU alike; the compares against kTiny do
//             it, not -ftz=true, which would change every float op of
//             this file, qunpack's too.  A row left without a scale
//             follows the reference `zero_scale` stands for: with 0 (the
//             Pallas kernel) a row whose s is 0 divides by 1 (so q = 0)
//             and stores 0; with another value (the compressed
//             reduction's own quantizer, compressed.py:44, which tests
//             amax == 0) a row whose amax is 0 does that and stores
//             `zero_scale`, and a row whose s alone flushed divides by 0
//             and stores 0, so q = sign(x) * 127, and 0 where x is 0.
//             A NaN in the row makes amax and s NaN, an infinity makes
//             them inf; every quotient is then NaN or 0, and a NaN
//             quotient converts to 0, as XLA's convert and torch's
//             .to(int8) do.
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
// for the quotient (no --use_fast_math, no reciprocal), round-half-to-even
// (rintf), and products and sums rounded one at a time (__fmul_rn/__fadd_rn,
// which nvcc never contracts into an FMA).
//
// Bound: data movement.  qpack reads the row and writes a byte per element
// plus a scale: (itemsize + 1) * R * C + 4 * R bytes; qunpack reads k bytes
// per element and k scales per row and writes one element.  At 3.35 TB/s a
// (32768, 2048) float32 qpack takes at least 0.100 ms, a k = 1 qunpack to
// bf16 at least 0.060 ms.  At the serve path's decode shape (4, 2048) the
// device work is a few kilobytes, and a call costs one round trip to
// device memory and the host's launch.
//
// qpack: a block a row, up to kRowThreads threads, each holding one group
// of 16 consecutive elements (four 16-byte loads of f32 or two of bf16; one
// 16-byte store of q) in registers.  A thread issues its loads before it
// uses one, reduces the amax with one redux.sync a warp and shared memory
// across warps, and quantizes from its registers, so a row is read from
// device memory once and costs about one round trip and a short chain of
// arithmetic: at the decode step's (4, 2048), 4 blocks of 128 threads.
// Rows longer than a block's groups (4096 elements) go in chunks of 4096:
// all read for the amax, then read again (from L2) to quantize, but the
// last, still in registers.  tools/qpack_probe.py measured the other
// geometries on an H100 and they lost: a warp a row with 64 values a lane
// (fewer warps resident, a longer chain a lane) was no faster at any R up to
// 32768, and staging a long row's chunks in shared memory (up to 224 KB, one
// block an SM) slower than L2.
// The main path's rows (C % 16 == 0, tensors of their own) take the `wide`
// instantiation: 16-byte loads and stores and no bounds inside a group.
// Any other call takes the narrow one, which chooses at launch, as the wide
// does: loads of 16 bytes where C allows them at every row (C % 4 == 0 for
// f32, C % 8 == 0 for bf16) and x is 16-byte aligned, else one element
// each; stores of q of 16 bytes where C % 16 == 0 and q is 16-byte aligned,
// 4 where C % 4 == 0 and q is 4-byte aligned, else one.  A row r starts at
// r * C * itemsize in x and at r * C in q, so for C = 2047 every row after
// the first is unaligned.  One launch a call, whatever the path.
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

#include <algorithm>

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr float kInv127 = 1.0f / 127.0f;  // XLA's constant for `/ 127.0`
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN: below it XLA flushes to 0

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// qpack
// ---------------------------------------------------------------------------

constexpr int kGroup = 16;              // a thread's consecutive elements
constexpr int kRowThreads = 256;        // a block's threads, one group each
constexpr int64_t kMaxBlocks = 0x7fffffff;  // gridDim.x's limit

// a launch: `blocks` blocks of `threads`, a block a row (stepping by the
// grid past kMaxBlocks rows), a row in `chunks` of threads * kGroup elements
struct QpackGeometry {
  int64_t blocks;
  int threads;
  int64_t chunks;
};

QpackGeometry qpack_geometry(int64_t rows, int64_t cols) {
  const int64_t groups = (cols + kGroup - 1) / kGroup;
  const int threads =
      static_cast<int>(std::min<int64_t>((groups + 31) / 32 * 32, kRowThreads));
  return {std::min(rows, kMaxBlocks), threads, (groups + threads - 1) / threads};
}

// the bytes a store of q writes: 16, 4 or 1
int store_width(int64_t cols, const void* q) {
  if (cols % 16 == 0 && aligned(q, 16)) return 16;
  if (cols % 4 == 0 && aligned(q, 4)) return 4;
  return 1;
}

// what the launch tells every thread: the chunks of a row, and the narrow
// instantiation's access widths
struct QpackAccess {
  int64_t chunks;
  bool vector_loads;  // 16-byte loads of x
  int store_width;
};

// max that returns NaN when either operand is NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// 16 bytes of x as floats: four f32, or eight bf16 (the top halves of f32s)
__device__ __forceinline__ void widen(const uint4& u, float* v, const float*) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float* v,
                                      const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the elements of a group inside the row: 0 to kGroup, from the elements
// of the row at and after the group's first
__device__ __forceinline__ int in_row(int64_t left) {
  return left <= 0 ? 0 : left >= kGroup ? kGroup : static_cast<int>(left);
}

// the group at xg (n of its elements inside the row) into v, zero past the
// row.  Wide: 16-byte loads (C % 16 == 0, x 16-byte aligned: n is 0 or 16).
template <bool kWide, typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ xg, int n,
                                           bool vector_loads, float (&v)[kGroup]) {
  constexpr int kPerLoad = 16 / sizeof(T);
  if (kWide || vector_loads) {
    // C % kPerLoad == 0: a vector lies wholly inside the row or past it
#pragma unroll
    for (int k = 0; k < kGroup; k += kPerLoad) {
      if (k < n) {
        widen(__ldg(reinterpret_cast<const uint4*>(xg + k)), &v[k], xg);
      } else {
#pragma unroll
        for (int i = 0; i < kPerLoad; ++i) v[k + i] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) v[i] = i < n ? to_f32(xg[i]) : 0.0f;
  }
}

// q of one element: rint(x / div) clamped to +-127, and a NaN quotient (a
// NaN in the row, inf / inf, or 0 / 0 where the scale flushed) 0, where
// fmaxf alone would make it -127
__device__ __forceinline__ uint32_t quantize(float v, float div) {
  const float r = rintf(__fdiv_rn(v, div));
  if (r != r) return 0u;
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f))) &
         0xffu;
}

// the group's n elements, quantized, to qg
template <bool kWide>
__device__ __forceinline__ void store_group(int8_t* __restrict__ qg, int n,
                                            int width, float div,
                                            const float (&v)[kGroup]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = quantize(v[4 * k], div) | quantize(v[4 * k + 1], div) << 8 |
           quantize(v[4 * k + 2], div) << 16 | quantize(v[4 * k + 3], div) << 24;
  if (kWide || width == 16) {  // C % 16 == 0: the group lies wholly inside the row
    *reinterpret_cast<uint4*>(qg) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (width == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * k < n) *reinterpret_cast<uint32_t*>(qg + 4 * k) = w[k];
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < n) qg[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
  }
}

// XLA's flush of subnormal inputs: each |v| below FLT_MIN becomes 0.  A row
// needs it only where its divisor is below 2 * FLT_MIN (a subnormal over
// any larger divisor is under 0.5 and rounds to 0 either way), so the
// kernel calls this on those rare rows alone, not an element at a time
__device__ __forceinline__ void flush_subnormals(float (&v)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) v[i] = fabsf(v[i]) < kTiny ? 0.0f : v[i];
}

// max |v| over a group, NaN if any is: a tree
__device__ __forceinline__ float abs_max(const float (&v)[kGroup]) {
  float a[kGroup / 2];
#pragma unroll
  for (int i = 0; i < kGroup / 2; ++i)
    a[i] = max_nan(fabsf(v[i]), fabsf(v[i + kGroup / 2]));
#pragma unroll
  for (int w = kGroup / 4; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) a[i] = max_nan(a[i], a[i + w]);
  return a[0];
}

// the block's max of non-negative floats or NaNs, NaN if any is: as
// unsigned integers they order the same way and every NaN lies above inf,
// so a warp reduces with one redux.sync, the warps through shared memory
__device__ __forceinline__ float block_max(float m, unsigned* red) {
  unsigned u = __reduce_max_sync(kFullMask, __float_as_uint(m));
  if (blockDim.x > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = u;
    __syncthreads();
    u = red[0];
#pragma unroll
    for (int w = 1; w < kRowThreads / 32; ++w)
      if (w < static_cast<int>(blockDim.x >> 5)) u = max(u, red[w]);
  }
  return __uint_as_float(u);
}

// block b quantizes rows b, b + gridDim.x, ...; thread t holds group t of
// each chunk of the row
template <typename T, bool kWide>
__global__ void __launch_bounds__(kRowThreads)
qpack_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scale, int64_t rows, int64_t cols,
             float zero_scale, QpackAccess io) {
  __shared__ unsigned red[kRowThreads / 32];
  const int64_t chunk = int64_t{blockDim.x} * kGroup;  // elements
  const int64_t c0 = int64_t{threadIdx.x} * kGroup;    // in each chunk
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * cols + c0;
    float v[kGroup];
    float amax = 0.0f;
    for (int64_t c = 0; c < io.chunks; ++c) {
      load_group<kWide>(xr + c * chunk, in_row(cols - c0 - c * chunk),
                        io.vector_loads, v);
      amax = max_nan(amax, abs_max(v));
    }
    amax = block_max(amax, red);
    const float p = __fmul_rn(amax, kInv127);
    const float s = p < kTiny ? 0.0f : p;  // NaN stays
    // the row's zero rule: the scale's (Pallas) or the amax's (compressed)
    const bool zero = (zero_scale == 0.0f ? p : amax) < kTiny;
    const float div = zero ? 1.0f : s;
    const bool flush = div < 2.0f * kTiny;  // rare: see flush_subnormals
    int8_t* qr = q + row * cols + c0;
    // the last chunk is still in registers; the others are read again
    for (int64_t c = io.chunks - 1; c >= 0; --c) {
      const int n = in_row(cols - c0 - c * chunk);
      if (c != io.chunks - 1) load_group<kWide>(xr + c * chunk, n, io.vector_loads, v);
      if (flush) flush_subnormals(v);
      if (n > 0) store_group<kWide>(qr + c * chunk, n, io.store_width, div, v);
    }
    if (threadIdx.x == 0) scale[row] = zero ? zero_scale : s;
    if (blockDim.x > 32 && row + gridDim.x < rows)
      __syncthreads();  // red is free for the next row
  }
}

template <typename T>
int launch_qpack(const void* x, void* q, void* scale, int64_t rows,
                 int64_t cols, float zero_scale, cudaStream_t s) {
  const QpackGeometry g = qpack_geometry(rows, cols);
  const QpackAccess io{g.chunks, cols % (16 / sizeof(T)) == 0 && aligned(x, 16),
                       store_width(cols, q)};
  const bool wide = io.vector_loads && io.store_width == 16;
  const auto* xi = static_cast<const T*>(x);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(scale);
  const dim3 grid(static_cast<unsigned>(g.blocks));
  if (wide)
    qpack_kernel<T, true><<<grid, g.threads, 0, s>>>(xi, qo, so, rows, cols,
                                                    zero_scale, io);
  else
    qpack_kernel<T, false><<<grid, g.threads, 0, s>>>(xi, qo, so, rows, cols,
                                                     zero_scale, io);
  RT_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// qunpack
// ---------------------------------------------------------------------------

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
  switch (in_dtype) {
    case kF32:
      return launch_qpack<float>(x, q, scale, rows, cols, zero_scale, stream);
    case kBF16:
      return launch_qpack<__nv_bfloat16>(x, q, scale, rows, cols, zero_scale,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
