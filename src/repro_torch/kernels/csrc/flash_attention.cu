// Causal self-attention over a whole prefill in one launch, float32
// semantics on the bf16 tensor cores: for each batch row b, query head h
// (reading kv head h / G) and query i,
//
//   s[j]   = (q[b,i,h,:] . k[b,j,h/G,:]) * scale      masked where kpos[j] > qpos[i]
//   o[b,i,h,:] = sum_j exp(s[j] - max s) v[b,j,h/G,:] / sum_j exp(s[j] - max s)
//
// with no score, probability or mask in device memory.  q, k and v are
// bf16, (B, S, H, Dqk), (B, T, KV, Dqk), (B, T, KV, Dv), each with strides of
// its own for b, s and h and a unit stride within a head; the positions are
// int32 (B, S) and (B, T) with a batch stride of their own (0 for one
// broadcast row); o is float32 (B, S, H, Dv), contiguous.
//
// Replaces no Pallas kernel: the reference runs attention as float32
// einsums and an explicit softmax (src/repro/models/layers.py), which the
// port's eager core reproduces (models/layers.py:_scores_softmax_values)
// and which stays the plain version: the CPU, autograd, every mask but the
// causal one, softcap and the bf16-probability variant take it.
//
// Numbers.  The eager core computes float32 scores from exact bf16
// products, an explicit float32 softmax and a float32 product with the
// values.  Here each score is one wgmma with float32 accumulation over
// bf16 q and k (exact products, float32 sums), times scale in float32 (the
// eager core rounds q * scale before the product instead); the softmax is
// online over key tiles with the accurate expf (no --use_fast_math); each
// float32 probability p goes to the tensor cores as three bf16 terms,
// p = p0 + p1 + p2 exactly (each the bf16 rounding of what is left: 8 + 8
// + 8 significant bits hold p's 24 wherever p >= 2^-110), so every
// product with the bf16 values is exact and sums in float32, as the
// eager float32 einsum's; the division by the row's sum comes last.  A
// row with every key masked gives 0, as the eager core's clamps do.
//
// Bound at qwen3-8b's widest prefill (B 8, S 2016, 32 heads over 8, Dqk =
// Dv = 128), a layer: 8 x 32 x 2016 x 2017 / 2 = 5.2e8 causal scores,
// each (Dqk + 3 Dv) MACs on the tensor cores, 0.54 ms at 989.4 TFLOP/s
// (0.59 ms for the whole 128 x 64 tiles at or below the diagonal that the
// kernel runs).  The bytes (q, k, v read once, o written once: 0.46 GB)
// take 0.14 ms.  The tensor cores bound the kernel; beside them the CUDA
// cores spend about twenty float32 instructions a score (scale, mask,
// max, expf, sum, the three-way split), the same order of time, so the two
// have to overlap.  Measured on an H100 SXM at 700 W: 1.53 ms, 38.6 % of
// the tiles' bound (deepseek's expanded MLA at S 4032, Dqk 192: 3.27 ms,
// 39.4 %); the tensor cores run at about 60 % of their rate while busy and
// the softmax and split add about a third outside them.
//
// Design.  A CTA takes 128 queries of one head and batch row, two
// consumer warpgroups of 64 queries each and one producer warp (288
// threads, one CTA an SM).  The grid runs heads fastest, then batch rows,
// then query tiles from the last (longest) to the first: the heads of one
// kv group run side by side and share each K and V tile through L2, and
// the causal triangle's long tiles start first.  The producer warp loads
// the CTA's Q tile once and keeps K and V tiles of kBc keys in flight by
// TMA into a ring of kStages stages (128-byte swizzle, mbarriers full and
// empty), skipping a key tile whose smallest position exceeds the query
// tile's largest, and hands each stage's key positions and whether it
// needs the mask.  Each consumer warpgroup, per key tile: S = Q K^T by
// wgmma (A and B from shared memory), scale, mask, the online softmax in
// registers, the split of P into three bf16 A fragments in registers, and
// O += P V by three chains of wgmma (A from registers, V's tile as a
// transposed B); the two warpgroups' softmax and products interleave on
// the SM.  The output goes from registers to device memory once.
#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kBr = 128;          // queries a CTA
constexpr int kBc = 64;           // keys a tile
constexpr int kStages = 3;        // K and V tiles in flight
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 32;
constexpr int kChunk = 64;        // bf16 columns a 128-byte swizzle row
constexpr int64_t kMaxGrid = 65535;

template <int DQK, int DV>
struct Layout {
  static constexpr int kQ = kBr * DQK * 2;        // bytes
  static constexpr int kK = kBc * DQK * 2;        // a stage
  static constexpr int kV = kBc * DV * 2;
  static constexpr int kOffK = kQ;
  static constexpr int kOffV = kOffK + kStages * kK;
  static constexpr int kOffBar = kOffV + kStages * kV;  // full, empty, q
  static constexpr int kOffInfo = kOffBar + (2 * kStages + 1) * 8;
  static constexpr int kOffPos = kOffInfo + 2 * kStages * 4;
  static constexpr int kBytes = kOffPos + kStages * kBc * 4;
  static constexpr int kAlloc = kBytes + 1024;    // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (64 columns, 1 head, rows, 1 batch row) box of a bf16 (B, S, H, D)
// tensor into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled operand:
// `lbo` and `sbo` in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register uses across the asynchronous
// products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define RT_F8(d, i)                                                         \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A (queries) and B (keys) K-major
// in shared memory
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A (probabilities) in registers, B
// (values) MN-major in shared memory
__device__ __forceinline__ void wgmma_values(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24), RT_F8(d, 32),
        RT_F8(d, 40), RT_F8(d, 48), RT_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RT_F8

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p = t0 + t1 + t2 exactly, each term the bf16 rounding of what is left
__device__ __forceinline__ void split3(float p, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(p);
  const float r1 = p - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(r1 - __bfloat162float(t[1]));
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ k_pos, float* __restrict__ out,
                           int seq_q, int seq_k, int heads, int group,
                           int64_t qpos_sb, int64_t kpos_sb, float scale) {
  static_assert(DV == 128, "the value product is one m64n128 wgmma a k step");
  static_assert(DQK % kChunk == 0, "q and k come in 64-column boxes");
  using L = Layout<DQK, DV>;
  constexpr int kQChunk = kBr * kChunk * 2;   // bytes of a 64-column box
  constexpr int kKVChunk = kBc * kChunk * 2;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + L::kOffK;
  const uint32_t s_v = s_q + L::kOffV;
  const uint32_t bar_full = s_q + L::kOffBar;
  const uint32_t bar_empty = bar_full + kStages * 8;
  const uint32_t bar_q = bar_empty + kStages * 8;
  int* info_tile = reinterpret_cast<int*>(smem + L::kOffInfo);
  int* info_masked = info_tile + kStages;
  int* kpos_s = reinterpret_cast<int*>(smem + L::kOffPos);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBr;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_full + 8 * i, 32);                 // the producer's lanes
      mbar_init(bar_empty + 8 * i, kConsumers / 32);   // the consumers' warps
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: the Q tile, then each key tile that some query sees
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = lane; r < kBr; r += 32) {
      if (q0 + r < seq_q) {
        const int p = q_pos[b * qpos_sb + q0 + r];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int c = 0; c < DQK / kChunk; ++c)
        tma_load(s_q + c * kQChunk, &tm_q, bar_q, c * kChunk, h, q0, b);
    }
    const int tiles = (seq_k + kBc - 1) / kBc;
    int n = 0;
    for (int j = 0; j < tiles; ++j) {
      const int k0 = j * kBc + lane, k1 = k0 + 32;
      const int p0 = k0 < seq_k ? k_pos[b * kpos_sb + k0] : INT_MAX;
      const int p1 = k1 < seq_k ? k_pos[b * kpos_sb + k1] : INT_MAX;
      const int kmin = warp_min(min(p0, p1));
      if (kmin > qmax) continue;   // every key of the tile masked for every query
      const int kmax = warp_max(max(k0 < seq_k ? p0 : INT_MIN, k1 < seq_k ? p1 : INT_MIN));
      const int stage = n % kStages;
      mbar_wait(bar_empty + 8 * stage, ((n / kStages) & 1) ^ 1);
      kpos_s[stage * kBc + lane] = p0;
      kpos_s[stage * kBc + lane + 32] = p1;
      if (lane == 0) {
        info_tile[stage] = j;
        info_masked[stage] = kmax > qmin || (j + 1) * kBc > seq_k;
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, L::kK + L::kV);
#pragma unroll
        for (int c = 0; c < DQK / kChunk; ++c)
          tma_load(s_k + stage * L::kK + c * kKVChunk, &tm_k, full, c * kChunk, kvh,
                   j * kBc, b);
#pragma unroll
        for (int c = 0; c < DV / kChunk; ++c)
          tma_load(s_v + stage * L::kV + c * kKVChunk, &tm_v, full, c * kChunk, kvh,
                   j * kBc, b);
      } else {
        mbar_arrive(bar_full + 8 * stage);
      }
      ++n;
    }
    const int stage = n % kStages;   // the end: a stage with no tile
    mbar_wait(bar_empty + 8 * stage, ((n / kStages) & 1) ^ 1);
    if (lane == 0) info_tile[stage] = -1;
    mbar_arrive(bar_full + 8 * stage);
  } else {
    // consumers: warpgroup wg on queries q0 + 64 wg ..; this thread on rows
    // r0 and r0 + 8 of its warp's 16, columns 8 c + 2 t and + 1 of each
    // 8-column block of the accumulators
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    const int qp0 = r0 < seq_q ? q_pos[b * qpos_sb + r0] : INT_MIN;
    const int qp1 = r1 < seq_q ? q_pos[b * qpos_sb + r1] : INT_MIN;

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(bar_q, 0);
    for (int n = 0;; ++n) {
      const int stage = n % kStages;
      mbar_wait(bar_full + 8 * stage, (n / kStages) & 1);
      if (info_tile[stage] < 0) break;
      const bool masked = info_masked[stage];
      const int* kp = kpos_s + stage * kBc;

      float s[kBc / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns into the swizzled row
        const uint64_t da = smem_desc(
            s_q + (kk / 4) * kQChunk + wg * (64 * 128) + off, 16, 1024);
        const uint64_t db = smem_desc(
            s_k + stage * L::kK + (kk / 4) * kKVChunk + off, 16, 1024);
        wgmma_scores(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask, the rows' running max
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) {
        s[i] *= scale;
        if (masked) {
          const int col = (i / 4) * 8 + 2 * t + (i & 1);
          if (kp[col] > ((i & 2) ? qp1 : qp0)) s[i] = -INFINITY;
        }
        if (i & 2) {
          mx1 = fmaxf(mx1, s[i]);
        } else {
          mx0 = fmaxf(mx0, s[i]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
      // a row with no key seen yet keeps 0s: its base is 0, not -inf
      const float base0 = mx0 == -INFINITY ? 0.0f : mx0;
      const float base1 = mx1 == -INFINITY ? 0.0f : mx1;
      const float a0 = expf(m0 - base0), a1 = expf(m1 - base1);
      m0 = mx0;
      m1 = mx1;

      // p = exp(s - max), its row sums, and p's three bf16 terms as the A
      // fragments of the value products: k step kk takes accumulator
      // columns 16 kk .. 16 kk + 15, registers 8 kk .. 8 kk + 7
      uint32_t pa[3][kBc / 16][4];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float base = (r & 1) ? base1 : base0;
          const float x = expf(s[i] - base), y = expf(s[i + 1] - base);
          if (r & 1) {
            sum1 += x + y;
          } else {
            sum0 += x + y;
          }
          __nv_bfloat16 tx[3], ty[3];
          split3(x, tx);
          split3(y, ty);
#pragma unroll
          for (int u = 0; u < 3; ++u) pa[u][kk][r] = pack_bf16(tx[u], ty[u]);
        }
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int kk = 0; kk < kBc / 16; ++kk) {
          const uint64_t dv = smem_desc(s_v + stage * L::kV + kk * 16 * 128,
                                        kKVChunk, 1024);
          wgmma_values(o, pa[u][kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    }

    l0 += __shfl_xor_sync(kFullMask, l0, 1);
    l0 += __shfl_xor_sync(kFullMask, l0, 2);
    l1 += __shfl_xor_sync(kFullMask, l1, 1);
    l1 += __shfl_xor_sync(kFullMask, l1, 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      const float l = half ? l1 : l0;
      if (row >= seq_q) continue;
      float* dst = out + ((static_cast<int64_t>(b) * seq_q + row) * heads + h) * DV;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const int i = 4 * c + 2 * half;
        const float2 v = l > 0.0f ? make_float2(o[i] / l, o[i + 1] / l)
                                  : make_float2(0.0f, 0.0f);
        *reinterpret_cast<float2*>(dst + 8 * c + 2 * t) = v;
      }
    }
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 (B, S, H, D) tensor with element strides sb, ss, sh (unit within
// a head), read in (64 columns, 1 head, rows, 1 batch row) boxes, 128-byte
// swizzled; rows past S read as zeros
bool encode(CUtensorMap* map, const void* base, int d, int64_t heads, int64_t seq,
            int64_t batch, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(ss * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, int64_t batch, int64_t seq_q,
           int64_t seq_k, int64_t heads, int64_t kv_heads, const int64_t (&qs)[3],
           const int64_t (&ks)[3], const int64_t (&vs)[3], int64_t qpos_sb,
           int64_t kpos_sb, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, DQK, heads, seq_q, batch, qs[0], qs[1], qs[2], kBr) ||
      !encode(&tk, k, DQK, kv_heads, seq_k, batch, ks[0], ks[1], ks[2], kBc) ||
      !encode(&tv, v, DV, kv_heads, seq_k, batch, vs[0], vs[1], vs[2], kBc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_attention_kernel<DQK, DV>;
  constexpr int smem = Layout<DQK, DV>::kAlloc;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                  blocks_for(seq_q, kBr));
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<float*>(out), static_cast<int>(seq_q), static_cast<int>(seq_k),
      static_cast<int>(heads), static_cast<int>(heads / kv_heads), qpos_sb, kpos_sb,
      scale);
  RT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// (dqk, dv) (128, 128) or (192, 128); heads a multiple of kv_heads; batch
// and the query tiles up to 65535 each; strides in elements, b, s, h.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* q_pos, const void* k_pos, void* out,
                                  int64_t batch, int64_t seq_q, int64_t seq_k,
                                  int64_t heads, int64_t kv_heads, int dqk, int dv,
                                  int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                  int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                  int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                  int64_t qpos_sb, int64_t kpos_sb, float scale,
                                  cudaStream_t stream) {
  if (batch <= 0 || batch > kMaxGrid || seq_q <= 0 || seq_k <= 0 ||
      seq_q > kMaxGrid * kBr || seq_k > INT_MAX - kBc || heads <= 0 ||
      kv_heads <= 0 || heads % kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                vs[3] = {v_sb, v_ss, v_sh};
  if (dqk == 128 && dv == 128) {
    return launch<128, 128>(q, k, v, q_pos, k_pos, out, batch, seq_q, seq_k, heads,
                            kv_heads, qs, ks, vs, qpos_sb, kpos_sb, scale, stream);
  }
  if (dqk == 192 && dv == 128) {
    return launch<192, 128>(q, k, v, q_pos, k_pos, out, batch, seq_q, seq_k, heads,
                            kv_heads, qs, ks, vs, qpos_sb, kpos_sb, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
