// The Mamba-1 selective scan over a whole sequence in one launch: for each
// batch row b and channel c, with the d_state float32 states h[0..N) in
// registers and t in order,
//
//   a    = expf(dt[b,t,c] * A[c,n])
//   bx   = (dt[b,t,c] * x[b,t,c]) * B[b,t,n]
//   h[n] = a * h[n] + bx
//   y[b,t,c] = sum_n C[b,t,n] * h[n]
//
// from h = h0[b,c,:]; the last h goes to h_last[b,c,:].  dt, A, h0, y and
// h_last are float32; x and the B and C rows are the compute type (float32
// or bf16).  B and C are one (B, S, 2N) operand, B then C in its last dim
// (the tail of the x projection, models/ssm.py:_ssm_inputs), with strides
// of its own for b and t and a unit stride within a row.
//
// Replaces no Pallas kernel: the reference runs the scan as
// lax.associative_scan (src/repro/models/ssm.py:_chunk_scan), which the
// port's eager path reproduces step for step (models/ssm.py:
// _associative_scan): about log2(S) levels of elementwise passes, cats and
// interleaves over (B, S, d_inner, d_state) float32 tensors of a and bx.
// Here a and bx never reach device memory.  The eager scan stays the plain
// version (the CPU, autograd and fake tensors take it); this order of the
// float32 operations is the sequential one, and the tests hold the two
// within the float32 tolerance the reference is held to.
//
// Rounding: dt * A and dt * x are rounded to float32 on their own
// (__fmul_rn), as the eager path's separate products are, before the
// accurate expf (no --use_fast_math) and the product with B; h and y
// update by fused multiply-adds.
//
// Bound at jamba's prefill (B 8, S 510, d_inner 8192, N 16, bf16 x): the
// bytes are dt (4), x (2) and y (4) per (b, t, c), 335 MB, 0.10 ms at
// 3.35 TB/s; the work is, per state and (b, t, c), two products, two FMAs
// and an expf (about seven float32 instructions and one ex2 on the SFU):
// about 5.9 G float32 instructions, 0.18 ms at the card's 33.5 T a second
// (its 67 TFLOP/s counted as FMAs).  The arithmetic bounds the kernel.
//
// Design: a block of kThreads threads covers kThreads consecutive channels
// of one batch row, a thread one channel, its N states and its row of A in
// registers, so each step's loads of dt and x and store of y are coalesced
// across the block.  Time goes in tiles of kT steps.  While a tile is
// computed, the next tile's dt and x are in flight to registers, and its B
// and C to registers, then to the other of two shared-memory buffers,
// which every thread of the block reads (broadcast reads); one
// __syncthreads a tile.  At the prefill's shape that is 64 x 8 blocks of
// 128 threads, all resident at once (four blocks an SM).
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kT = 8;          // time steps a tile
constexpr int64_t kMaxGridY = 65535;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                          const T* __restrict__ bc,
                          const float* __restrict__ a_mat,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ h_last, int64_t seq,
                          int64_t channels, int64_t bc_sb, int64_t bc_st) {
  constexpr int kRow = 2 * N;  // a step's B, then its C
  constexpr int kTile = kT * kRow;
  constexpr int kPer = (kTile + kThreads - 1) / kThreads;  // a thread's share
  __shared__ __align__(16) float sbc[2][kT][kRow];

  const int64_t b = blockIdx.y;
  const int64_t c = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const bool live = c < channels;
  const int64_t base = b * seq * channels + c;  // (b, 0, c)
  const T* __restrict__ bcb = bc + b * bc_sb;

  float A[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    A[i] = live ? a_mat[c * N + i] : 0.0f;
    h[i] = live ? h0[(b * channels + c) * N + i] : 0.0f;
  }

  // a tile's dt and x at t0.., zero past the sequence
  auto load_dx = [&](int64_t t0, float (&d)[kT], float (&v)[kT]) {
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const bool on = live && t0 + j < seq;
      const int64_t at = base + (t0 + j) * channels;
      d[j] = on ? dt[at] : 0.0f;
      v[j] = on ? to_f32(x[at]) : 0.0f;
    }
  };
  // this thread's share of a tile's B and C rows
  auto load_bc = [&](int64_t t0, float (&v)[kPer]) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int64_t t = t0 + e / kRow;
      v[k] = e < kTile && t < seq ? to_f32(bcb[t * bc_st + e % kRow]) : 0.0f;
    }
  };
  auto store_bc = [&](int buf, const float (&v)[kPer]) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kTile) sbc[buf][e / kRow][e % kRow] = v[k];
    }
  };

  float cd[kT], cx[kT], nd[kT], nx[kT], nbc[kPer];
  load_dx(0, cd, cx);
  load_bc(0, nbc);
  store_bc(0, nbc);
  __syncthreads();
  int buf = 0;
  for (int64_t t0 = 0; t0 < seq; t0 += kT) {
    load_dx(t0 + kT, nd, nx);  // the next tile, in flight while this one runs
    load_bc(t0 + kT, nbc);
    const int64_t steps = seq - t0;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < steps) {
        const float* s = sbc[buf][j];
        const float d = cd[j];
        const float dx = __fmul_rn(d, cx[j]);
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float a = expf(__fmul_rn(d, A[i]));
          h[i] = fmaf(a, h[i], __fmul_rn(dx, s[i]));
          acc = fmaf(s[N + i], h[i], acc);
        }
        if (live) y[base + (t0 + j) * channels] = acc;
      }
    }
    store_bc(buf ^ 1, nbc);
    __syncthreads();
    buf ^= 1;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      cd[j] = nd[j];
      cx[j] = nx[j];
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i) h_last[(b * channels + c) * N + i] = h[i];
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* bc, const void* a,
           const void* h0, void* y, void* h_last, int64_t batch, int64_t seq,
           int64_t channels, int64_t bc_sb, int64_t bc_st,
           cudaStream_t stream) {
  const dim3 grid(blocks_for(channels, kThreads), static_cast<unsigned>(batch));
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bc), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), seq, channels, bc_sb, bc_st);
  RT_CHECK_LAUNCH();
  return 0;
}

template <int N>
int launch_typed(int dtype, const void* dt, const void* x, const void* bc,
                 const void* a, const void* h0, void* y, void* h_last,
                 int64_t batch, int64_t seq, int64_t channels, int64_t bc_sb,
                 int64_t bc_st, cudaStream_t stream) {
  switch (dtype) {
    case kF32:
      return launch<float, N>(dt, x, bc, a, h0, y, h_last, batch, seq,
                              channels, bc_sb, bc_st, stream);
    case kBF16:
      return launch<__nv_bfloat16, N>(dt, x, bc, a, h0, y, h_last, batch, seq,
                                      channels, bc_sb, bc_st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// d_state n: 16 (jamba's) or 8 (its reduced config's); batch up to 65535
// rows (the grid's y); x and bc of `dtype` (0 float32, 1 bf16).
extern "C" int rt_selective_scan(const void* dt, const void* x, const void* bc,
                                 const void* a, const void* h0, void* y,
                                 void* h_last, int64_t batch, int64_t seq,
                                 int64_t channels, int n, int64_t bc_sb,
                                 int64_t bc_st, int dtype,
                                 cudaStream_t stream) {
  if (batch <= 0 || batch > kMaxGridY || seq <= 0 || channels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n) {
    case 8:
      return launch_typed<8>(dtype, dt, x, bc, a, h0, y, h_last, batch, seq,
                             channels, bc_sb, bc_st, stream);
    case 16:
      return launch_typed<16>(dtype, dt, x, bc, a, h0, y, h_last, batch, seq,
                              channels, bc_sb, bc_st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
