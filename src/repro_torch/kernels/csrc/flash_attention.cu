// Causal (optionally sliding-window) GQA attention over one sequence, with
// an online softmax: the prefill attention of every layer, and the
// forward of every learner step (with the logsumexp).
//
// Replaces: src/repro/kernels/flash_attention_pallas.py, flash_attention
// (_flash_kernel), the Pallas TPU kernel whose grid is (batch, q head,
// q block, kv block) with the kv axis sequential, the running max, sum
// and accumulator in VMEM scratch, and kv blocks wholly outside the
// causal band or the window skipped.
//
// What it computes, per (b, head h, position p), with g = h / (H / KV):
//   s_j = (q[b,p,h] * D^-0.5) . k[b,j,g]  for keys j <= p, p - j < window
//   out[b,p,h] = sum_j softmax(s)_j v[b,j,g]
// q [B,S,H,D], k and v [B,S,KV,D], float32 or bfloat16; scores, softmax
// and accumulation float32 (float32 inputs to float32 accuracy); out in the
// inputs' dtype.  The running max starts at -1e30 and the denominator is
// clamped at 1e-30, as in the Pallas kernel; masked keys contribute
// exactly 0.  Optionally (lse != null, the forward of a step that will be
// differentiated) each row's float32 logsumexp of its scaled scores,
// lse[b, p, h] = m + log l, which the backward (flash_attention_bwd.cu)
// recomputes P from.
//
// What bounds it on an H100: operations at long S (4 D flops per attended
// (query, key) pair; 13.4 GFLOP for one hymba layer at S 2048, 42.9 GFLOP
// for one qwen2.5-14b layer at D 128), bytes at the serve prefill (B 8,
// S 32: 3.9 MB, 1.2 us at 3.35 TB/s).  Both products run on the tensor
// cores at D 64, 128 and 256.
//
// Five instantiations, chosen by the launcher from dtype and head dim
// alone (with or without the logsumexp):
//   float32 at D 64 and 128  -> flash_kernel_tf32 below: 3xTF32 mma.sync
//                               (mma_tf32.cuh), 495 / 3 TFLOP/s at best;
//   bfloat16 at D 64 and 128 -> flash_kernel_wgmma
//                               (flash_attention_wgmma.cuh: wgmma + TMA);
//   float32 at D 256         -> flash_kernel_d256 below (gemma3): the
//                               tf32 kernel's products with each 16-row
//                               tile split over two warps by output dims;
//   bfloat16 at D 256        -> flash_kernel_wgmma256
//                               (flash_attention_wgmma256.cuh: wgmma +
//                               TMA, Q read from shared memory);
//   D 8, 16 and 32           -> flash_kernel below: float32 FMA from
//                               shared memory (the JAX sweep's head dims;
//                               no model the port runs uses them).
// A call routes by these alone: nothing falls back to another
// instantiation when one fails to build or launch.
//
// Design, tf32: GQA packing.  The G = H / KV query heads of a kv head are
// adjacent in memory at each position, so the rows (position, head) of one
// kv head form an S*G x D matrix with row r at position r / G.  One block
// of 4 warps takes 64 such rows of one (b, kv head), 16 a warp (one mma
// row tile); row tiles are issued last first, so the heaviest causal
// blocks start first.  Its Q tile is loaded once, scaled by D^-0.5 in
// float32 as the plain version scales it, into shared memory (split into
// tf32 hi / lo at each fragment read: hi / lo kept in shared memory would
// take another block's worth of it, kept in registers 128 a thread at
// D 128).  K/V tiles of 32 keys arrive by cp.async in a 2-stage ring, the
// next in flight while this one is used, and serve every query head of
// the tile; tiles wholly outside the causal band or the window are never
// loaded, and a warp skips the tiles none of its rows sees.  Per tile and
// warp:
//   S = Q K^T: 3xTF32 mma.m16n8k8 over D, in 64-dim chunks each summed from
//     zero and added with a rounded float32 add (the tensor cores' own
//     accumulation, chained over many products, drifts past float32
//     rounding).  Within an 8-dim k-step, fragment slot t4 takes dim 2 t4
//     and slot t4 + 4 dim 2 t4 + 1 (any order of the summed index is the
//     same product), so each Q and K fragment is one float2 read;
//   the online softmax on the accumulator fragment (a row spans a quad,
//     two shuffles; ex2 on the SFU), masks only on tiles that cross the
//     causal edge or the window's start;
//   O += P V: the score accumulator is P's A fragment as it stands, no
//     re-layout through shared memory: with the 8 keys of a k-step ordered
//     so that slot t4 is key 2 t4 and slot t4 + 4 key 2 t4 + 1, the four
//     values a lane holds (rows g8, g8 + 8; keys 2 t4, 2 t4 + 1) are exactly
//     its A fragment, and the V fragment is read in the same key order.
//     Each 8-dim output tile's product over the tile's keys starts from
//     zero and is added into O with o = o * alpha + part (one rounded FMA).
// Row pitches of D + 8 (Q, K) and D + 4 (V) floats put a half-warp's
// float2 reads and a warp's V reads on 32 distinct banks.  A block takes
// 54,272 B of shared memory at D 64 (127 registers: four blocks an SM) and
// 103,424 B at D 128 (252 registers: two).  32-key tiles rather than 64
// keep four blocks on an SM at D 64 (the learner's and the serve
// prefill's short rows gain most); capping D 128 at 168 registers for a
// third block spills and runs slower.  Rows past S * G and keys past S
// are masked; nothing is padded in memory.
//
// Design, fma (D 8, 16, 32): the same packing, one block of 256 threads a
// 64-row tile; K/V tiles of 64 keys staged in shared memory; thread
// (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3, keys tx + 16 c of
// the score tile, and dims tx + 16 c of the output rows: scores in
// registers, row max and sum reduced over the 16 lanes of a half-warp,
// probabilities staged through shared memory for the value product.
//
// The windowed and global forms are separate instantiations (kWindow), so
// a profile tells them apart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_wgmma.cuh"
#include "flash_attention_wgmma256.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kRows = 64;       // (position, head) rows per block
constexpr int kKeys = 64;       // keys per K/V tile
constexpr float kNegInf = -1e30f;
static_assert(kKeys == kRows, "K/V tiles reuse the Q tile's load layout");

// Four consecutive elements (16 bytes of float32, 8 of bfloat16) as
// float32: one vector load.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static_assert(D <= 32, "D 64 and 128 take the tensor-core kernels");
  static constexpr int kQ = D + 4;       // row strides in floats, padded
  static constexpr int kK = D + 1;       // against bank conflicts
  static constexpr int kP = kKeys + 4;
  static constexpr int kDims = (D + 15) / 16;   // output dims per thread
  static constexpr int kQuads = kRows * D / 4;  // 4-element loads a tile
  static constexpr int kLoads = (kQuads + kThreads - 1) / kThreads;
  static constexpr size_t kBytes =
      sizeof(float) * (kRows * kQ + kKeys * kK + kKeys * D + kRows * kP);
};

template <typename T, int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int seq, int n_heads, int n_kv,
             int window, float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* s_q = smem;                       // [kRows][kQ]
  float* s_k = s_q + kRows * L::kQ;        // [kKeys][kK]
  float* s_v = s_k + kKeys * L::kK;        // [kKeys][D]
  float* s_p = s_v + kKeys * D;            // [kRows][kP]

  const int group = n_heads / n_kv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;          // rows of this (b, kv head)
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // Row r sits at position r / group, query head kvh * group + r % group.
  // Every load of a tile is unrolled, so a thread's loads are in flight
  // together.
#pragma unroll
  for (int it = 0; it < L::kLoads; ++it) {
    const int e = tid + it * kThreads;
    if (L::kQuads % kThreads != 0 && e >= L::kQuads) break;
    const int rr = e / (D / 4), d = (e % (D / 4)) * 4, r = r0 + rr;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_rows)
      load4(q + (((size_t)b * seq + r / group) * n_heads + kvh * group +
                 r % group) * D + d, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) s_q[rr * L::kQ + d + c] = x[c] * scale;
  }

  int pos[4];
  bool live[4];
  float m[4], l[4], acc[4][L::kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    live[i] = r < n_rows;
    pos[i] = live[i] ? r / group : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this block can reach: [first, last].
  const int last = (min(r0 + kRows, n_rows) - 1) / group;
  const int first = kWindow ? max(0, r0 / group - window + 1) : 0;
  const size_t kv_row = (size_t)n_kv * D;            // one position
  const size_t kv_base = (size_t)b * seq * kv_row + (size_t)kvh * D;

  for (int k0 = (first / kKeys) * kKeys; k0 <= last; k0 += kKeys) {
    float kx[L::kLoads][4], vx[L::kLoads][4];
#pragma unroll
    for (int it = 0; it < L::kLoads; ++it) {
      const int e = tid + it * kThreads;
      const int key = k0 + e / (D / 4), d = (e % (D / 4)) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) kx[it][c] = vx[it][c] = 0.f;
      if ((L::kQuads % kThreads == 0 || e < L::kQuads) && key < seq) {
        const size_t at = kv_base + (size_t)key * kv_row + d;
        load4(k + at, kx[it]);
        load4(v + at, vx[it]);
      }
    }
    __syncthreads();   // the previous tile is consumed; s_q is written
#pragma unroll
    for (int it = 0; it < L::kLoads; ++it) {
      const int e = tid + it * kThreads;
      if (L::kQuads % kThreads != 0 && e >= L::kQuads) break;
      const int kk = e / (D / 4), d = (e % (D / 4)) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_k[kk * L::kK + d + c] = kx[it][c];
        s_v[kk * D + d + c] = vx[it][c];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty * 4 + i) * L::kQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = s_k[(tx + 16 * c) * L::kK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        ok[c] = key <= pos[i] && (!kWindow || pos[i] - key < window);
        if (ok[c]) mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)    // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p;
        s_p[(ty * 4 + i) * L::kP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // s_p is complete

    const int n_keys = min(kKeys, seq - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty * 4 + i) * L::kP + kk];
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? s_v[kk * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = r0 + ty * 4 + i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const size_t head_row =
        ((size_t)b * seq + pos[i]) * n_heads + kvh * group + r % group;
    T* row = out + head_row * D;
    if (lse != nullptr && tx == 0)
      lse[head_row] = m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(row + d, acc[i][c] * inv);
    }
  }
}

template <typename T, int D, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int seq, int n_heads, int n_kv,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, kWindow>;
  const size_t bytes = Layout<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const int rows = seq * (n_heads / n_kv);
  dim3 grid((rows + kRows - 1) / kRows, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, n_heads,
      n_kv, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int seq, int n_heads, int n_kv,
                     int window, float scale, cudaStream_t stream) {
  if (window > 0)
    return launch<T, D, true>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                              window, scale, stream);
  return launch<T, D, false>(q, k, v, out, lse, batch, seq, n_heads, n_kv, 0,
                             scale, stream);
}

// ---------------------------------------------------------------------------
// float32 at D 64 and 128: 3xTF32 tensor-core products.
// ---------------------------------------------------------------------------

namespace tc {

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::split;
using wg::ex2;   // 2^x on the SFU

constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int kRows = 64;       // (position, head) rows per block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "the tf32 kernel takes D 64 or 128");
  static constexpr int kKeys = 32;   // keys a K/V tile
  static constexpr int kQK = D + 8;   // Q and K row pitch (floats)
  static constexpr int kV = D + 4;    // V row pitch
  static constexpr int kKT = kKeys / 8;   // 8-key steps (score n-tiles)
  static constexpr int kNT = D / 8;       // 8-dim output tiles
  static constexpr int kQFloats = kRows * kQK;
  static constexpr int kKFloats = kKeys * kQK;   // one stage
  static constexpr int kVFloats = kKeys * kV;
  static constexpr size_t kBytes =
      sizeof(float) * (kQFloats + 2 * (kKFloats + kVFloats));
};

// Fragment layout of mma.m16n8k8 (lane: g8 = lane / 4, t4 = lane % 4): the
// accumulator d[0], d[1] at row g8, columns 2 t4, 2 t4 + 1; d[2], d[3] at
// row g8 + 8.  Warp w holds the block's rows 16 w .. 16 w + 15.
template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int seq, int n_heads, int n_kv,
                  int window, float scale) {
  using L = Layout<D>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                        // [kRows][kQK]
  float* s_k = s_q + L::kQFloats;           // [2][kKeys][kQK]
  float* s_v = s_k + 2 * L::kKFloats;       // [2][kKeys][kV]

  const int group = n_heads / n_kv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;           // rows of this (b, kv head)
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const size_t kv_row = (size_t)n_kv * D;   // one position of k, v
  const size_t kv_base = (size_t)b * seq * kv_row + (size_t)kvh * D;

  // Keys any row of this block can reach: [first, last].
  const int last = (min(r0 + kRows, n_rows) - 1) / group;
  const int first = kWindow ? max(0, r0 / group - window + 1) : 0;
  const int t0 = first / kKeys, n_tiles = last / kKeys - t0 + 1;

  // Tile it of the walk into ring stage it % 2; keys past S zero-filled.
  auto stage = [&](int it) {
    const int k0 = (t0 + it) * kKeys;
    float* sk = s_k + (it & 1) * L::kKFloats;
    float* sv = s_v + (it & 1) * L::kVFloats;
#pragma unroll
    for (int i = 0; i < kKeys * D / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / (D / 4), c = (e % (D / 4)) * 4;
      const bool ok = k0 + j < seq;
      const size_t at = kv_base + (size_t)(ok ? k0 + j : 0) * kv_row + c;
      cp_async16(sk + j * L::kQK + c, k + at, ok ? 16 : 0);
      cp_async16(sv + j * L::kV + c, v + at, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  stage(0);

  // Q, scaled in float32 (as the plain version scales it); rows past
  // S * G zero.  Row r sits at position r / group, query head
  // kvh * group + r % group.
  {
    constexpr int kLoads = kRows * D / 4 / kThreads;
    float4 x[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int r = r0 + e / (D / 4), c = (e % (D / 4)) * 4;
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_rows)
        x[i] = *reinterpret_cast<const float4*>(
            q + (((size_t)b * seq + r / group) * n_heads + kvh * group +
                 r % group) * D + c);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      *reinterpret_cast<float4*>(s_q + (e / (D / 4)) * L::kQK +
                                 (e % (D / 4)) * 4) =
          make_float4(x[i].x * scale, x[i].y * scale, x[i].z * scale,
                      x[i].w * scale);
    }
  }

  // This warp's rows: positions [w_lo, w_hi]; a row past S * G has
  // position -1 and attends nothing.
  const int wr0 = r0 + 16 * warp;
  const bool warp_live = wr0 < n_rows;
  const int w_lo = wr0 / group;
  const int w_hi = (min(wr0 + 16, n_rows) - 1) / group;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g8 + 8 * h;
    pos[h] = r < n_rows ? r / group : -1;
  }
  float o[L::kNT][4], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < L::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const float* wq = s_q + 16 * warp * L::kQK;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, Q) is in
    const int k0 = (t0 + it) * kKeys;
    // Does any row of the warp see a key of the tile?
    if (warp_live && k0 <= w_hi &&
        (!kWindow || k0 + kKeys - 1 > w_lo - window)) {
      const float* sk = s_k + (it & 1) * L::kKFloats;
      const float* sv = s_v + (it & 1) * L::kVFloats;

      // S = Q K^T in 64-dim chunks, each from zero.
      float s[L::kKT][4];
#pragma unroll
      for (int j = 0; j < L::kKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 64) {
        float part[L::kKT][4];
#pragma unroll
        for (int j = 0; j < L::kKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int d0 = c0; d0 < c0 + 64; d0 += 8) {
          // Slot t4 is dim d0 + 2 t4, slot t4 + 4 dim d0 + 2 t4 + 1.
          const float2 x0 = *reinterpret_cast<const float2*>(
              wq + g8 * L::kQK + d0 + 2 * t4);
          const float2 x1 = *reinterpret_cast<const float2*>(
              wq + (g8 + 8) * L::kQK + d0 + 2 * t4);
          tf32::Frag a;
          split(x0.x, a.hi[0], a.lo[0]);
          split(x1.x, a.hi[1], a.lo[1]);
          split(x0.y, a.hi[2], a.lo[2]);
          split(x1.y, a.hi[3], a.lo[3]);
#pragma unroll
          for (int j = 0; j < L::kKT; ++j) {
            const float2 y = *reinterpret_cast<const float2*>(
                sk + (8 * j + g8) * L::kQK + d0 + 2 * t4);
            tf32::FragB bf;
            split(y.x, bf.hi[0], bf.lo[0]);
            split(y.y, bf.hi[1], bf.lo[1]);
            tf32::mma3(part[j], a, bf);
          }
        }
#pragma unroll
        for (int j = 0; j < L::kKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
      }

      // Online softmax.  Masks only where the tile crosses the causal edge
      // (a key past the warp's first position) or the window's start (a
      // key too old for its newest).
      const bool edge =
          k0 + kKeys - 1 > w_lo || (kWindow && k0 <= w_hi - window);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -1e30f;
#pragma unroll
        for (int j = 0; j < L::kKT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * h + c];
            if (edge) {
              const int key = k0 + 8 * j + 2 * t4 + c;
              const bool ok =
                  key <= pos[h] && (!kWindow || pos[h] - key < window);
              x = ok ? x : -INFINITY;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = ex2((m[h] - m_new) * kLog2e);
        const float ml = m_new * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < L::kKT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * h + c];
            x = ex2(fmaf(x, kLog2e, -ml));   // masked: ex2(-inf) = 0
            sum += x;
          }
        l[h] = l[h] * alpha[h] + sum;   // this lane's share; summed at the end
        m[h] = m_new;
      }

      // O = O alpha + P V.  Key step j (keys k0 + 8 j ..): slot t4 is key
      // 8 j + 2 t4, slot t4 + 4 key 8 j + 2 t4 + 1, so P's A fragment is the
      // lane's own accumulator values.
      tf32::Frag pa[L::kKT];
#pragma unroll
      for (int j = 0; j < L::kKT; ++j) {
        split(s[j][0], pa[j].hi[0], pa[j].lo[0]);
        split(s[j][2], pa[j].hi[1], pa[j].lo[1]);
        split(s[j][1], pa[j].hi[2], pa[j].lo[2]);
        split(s[j][3], pa[j].hi[3], pa[j].lo[3]);
      }
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < L::kKT; ++j) {
          const float* vp = sv + (8 * j + 2 * t4) * L::kV + 8 * nt + g8;
          tf32::FragB bf;
          split(vp[0], bf.hi[0], bf.lo[0]);
          split(vp[L::kV], bf.hi[1], bf.lo[1]);
          tf32::mma3(part, pa[j], bf);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nt][e] = fmaf(o[nt][e], alpha[e / 2], part[e]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (pos[h] < 0) continue;
    const int r = wr0 + g8 + 8 * h;
    const float l_safe = fmaxf(sum, 1e-30f);
    const float inv = 1.f / l_safe;
    const size_t head_row =
        ((size_t)b * seq + pos[h]) * n_heads + kvh * group + r % group;
    float* row = out + head_row * D;
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt)
      *reinterpret_cast<float2*>(row + 8 * nt + 2 * t4) =
          make_float2(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
    if (lse != nullptr && t4 == 0) lse[head_row] = m[h] + logf(l_safe);
  }
}

template <int D, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int seq, int n_heads, int n_kv,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_kernel_tf32<D, kWindow>;
  constexpr size_t bytes = Layout<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)seq * (n_heads / n_kv);
  const long long tiles = (rows + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, seq,
      n_heads, n_kv, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int seq, int n_heads, int n_kv,
                     int window, float scale, cudaStream_t stream) {
  if (window > 0)
    return launch<D, true>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                           window, scale, stream);
  return launch<D, false>(q, k, v, out, lse, batch, seq, n_heads, n_kv, 0,
                          scale, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// D 256, float32: two warps a 16-row tile, one a dims half (bfloat16 at
// D 256 takes flash_kernel_wgmma256).
// ---------------------------------------------------------------------------

namespace sp {

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::split;
using wg::ex2;   // 2^x on the SFU

constexpr int D = 256;
constexpr int kHalf = D / 2;     // the output dims a warp owns
constexpr int kThreads = 256;    // 8 warps: 4 row tiles x 2 dims halves
constexpr int kRows = 64;        // (position, head) rows per block
constexpr int kKeys = 32;        // keys a K/V tile
constexpr int kKT = kKeys / 8;   // 8-key steps (score n-tiles)
constexpr int kNT = kHalf / 8;   // 8-dim output tiles of a warp
constexpr float kLog2e = 1.4426950408889634f;

struct Layout {
  static constexpr int kQ = D + 8;    // Q row pitch
  static constexpr int kK = D + 8;    // K row pitch
  // V row pitch: 260 floats put a warp's V reads on 32 distinct banks.
  static constexpr int kV = D + 4;
  static constexpr int kQFloats = kRows * kQ;
  static constexpr int kKElems = kKeys * kK;   // one stage
  static constexpr int kVElems = kKeys * kV;
  static constexpr int kExFloats = 8 * kKT * 32 * 4;   // a warp's scores
  static constexpr size_t kBytes =
      sizeof(float) * (kQFloats + kExFloats) +
      sizeof(float) * 2 * (kKElems + kVElems);
};

// Two consecutive elements.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The two warps of one row tile (ids 1-4; 0 is __syncthreads').
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// The tf32 kernel's design with the work of each 16-row tile split over
// two warps (the output accumulator of one warp holding all 256 dims
// would take 128 registers a lane): warp w takes rows 16 (w / 2) ..
// 16 (w / 2) + 15 and dims half = w % 2, 128 half .. 128 half + 127.
// Per K/V tile each warp sums its half of the score product, in two
// 64-dim chunks each from zero; the pair swaps the 16 x 32 partial
// scores through shared memory and each adds the other's to its own
// (float addition commutes), so both hold the same scores, the same
// running max and sum and the same P.  Each then multiplies P by its own 128
// columns of V.  Everything else (GQA packing, 32-key tiles by cp.async
// in a ring of two, masks only on edge tiles, P's A fragment straight
// from the score accumulator, each tile's P V from zero) is the tf32
// kernel's.
template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_d256(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int seq, int n_heads, int n_kv,
                  int window, float scale) {
  using L = Layout;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                                      // [kRows][kQ]
  float* s_ex = s_q + L::kQFloats;                        // [8][kKT][32][4]
  float* s_k = s_ex + L::kExFloats;                       // [2][kKeys][kK]
  float* s_v = s_k + 2 * L::kKElems;                      // [2][kKeys][kV]

  const int group = n_heads / n_kv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;           // rows of this (b, kv head)
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = warp / 2, half = warp % 2;
  const int g8 = lane / 4, t4 = lane % 4;
  const size_t kv_row = (size_t)n_kv * D;   // one position of k, v
  const size_t kv_base = (size_t)b * seq * kv_row + (size_t)kvh * D;

  // Keys any row of this block can reach: [first, last].
  const int last = (min(r0 + kRows, n_rows) - 1) / group;
  const int first = kWindow ? max(0, r0 / group - window + 1) : 0;
  const int t0 = first / kKeys, n_tiles = last / kKeys - t0 + 1;

  // Tile it of the walk into ring stage it % 2; keys past S zero-filled.
  constexpr int kChunk = 4;                       // elements a cp.async
  constexpr int kRowChunks = D / kChunk;
  auto stage = [&](int it) {
    const int k0 = (t0 + it) * kKeys;
    float* sk = s_k + (it & 1) * L::kKElems;
    float* sv = s_v + (it & 1) * L::kVElems;
#pragma unroll
    for (int i = 0; i < kKeys * kRowChunks / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kRowChunks, c = (e % kRowChunks) * kChunk;
      const bool ok = k0 + j < seq;
      const size_t at = kv_base + (size_t)(ok ? k0 + j : 0) * kv_row + c;
      cp_async16(sk + j * L::kK + c, k + at, ok ? 16 : 0);
      cp_async16(sv + j * L::kV + c, v + at, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  stage(0);

  // Q, scaled in float32 (as the plain version scales it); rows past
  // S * G zero.  Row r sits at position r / group, query head
  // kvh * group + r % group.
  for (int e = tid; e < kRows * D / 2; e += kThreads) {
    const int rr = e / (D / 2), c = (e % (D / 2)) * 2, r = r0 + rr;
    float2 x = make_float2(0.f, 0.f);
    if (r < n_rows)
      x = ld2(q + (((size_t)b * seq + r / group) * n_heads + kvh * group +
                   r % group) * D + c);
    *reinterpret_cast<float2*>(s_q + rr * L::kQ + c) =
        make_float2(x.x * scale, x.y * scale);
  }

  // This pair's rows: positions [w_lo, w_hi]; a row past S * G has
  // position -1 and attends nothing.
  const int wr0 = r0 + 16 * pair;
  const bool warp_live = wr0 < n_rows;
  const int w_lo = wr0 / group;
  const int w_hi = (min(wr0 + 16, n_rows) - 1) / group;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g8 + 8 * h;
    pos[h] = r < n_rows ? r / group : -1;
  }
  float o[kNT][4], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const float* wq = s_q + 16 * pair * L::kQ;
  float4* ex_mine = reinterpret_cast<float4*>(s_ex) + warp * kKT * 32;
  const float4* ex_other =
      reinterpret_cast<const float4*>(s_ex) + (warp ^ 1) * kKT * 32;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, Q) is in
    const int k0 = (t0 + it) * kKeys;
    // Does any row of the pair see a key of the tile?  (The same answer
    // for both warps of a pair, so both reach pair_sync.)
    if (warp_live && k0 <= w_hi &&
        (!kWindow || k0 + kKeys - 1 > w_lo - window)) {
      const float* sk = s_k + (it & 1) * L::kKElems;
      const float* sv = s_v + (it & 1) * L::kVElems;

      // This warp's half of S = Q K^T, in two 64-dim chunks, each from
      // zero.
      float s[kKT][4];
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int c0 = half * kHalf; c0 < half * kHalf + kHalf; c0 += 64) {
        float part[kKT][4];
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int d0 = c0; d0 < c0 + 64; d0 += 8) {
          // Slot t4 is dim d0 + 2 t4, slot t4 + 4 dim d0 + 2 t4 + 1.
          const float2 x0 = ld2(wq + g8 * L::kQ + d0 + 2 * t4);
          const float2 x1 = ld2(wq + (g8 + 8) * L::kQ + d0 + 2 * t4);
          tf32::Frag a;
          split(x0.x, a.hi[0], a.lo[0]);
          split(x1.x, a.hi[1], a.lo[1]);
          split(x0.y, a.hi[2], a.lo[2]);
          split(x1.y, a.hi[3], a.lo[3]);
#pragma unroll
          for (int j = 0; j < kKT; ++j) {
            const float2 y = ld2(sk + (8 * j + g8) * L::kK + d0 + 2 * t4);
            tf32::FragB bf;
            split(y.x, bf.hi[0], bf.lo[0]);
            split(y.y, bf.hi[1], bf.lo[1]);
            tf32::mma3(part[j], a, bf);
          }
        }
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
      }
      // The pair's halves meet: S = half 0's + half 1's in both warps.
#pragma unroll
      for (int j = 0; j < kKT; ++j)
        ex_mine[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2],
                                             s[j][3]);
      pair_sync(pair);
#pragma unroll
      for (int j = 0; j < kKT; ++j) {   // a + b == b + a: both agree
        const float4 y = ex_other[j * 32 + lane];
        s[j][0] += y.x, s[j][1] += y.y, s[j][2] += y.z, s[j][3] += y.w;
      }

      // Online softmax, as in the tf32 kernel.
      const bool edge =
          k0 + kKeys - 1 > w_lo || (kWindow && k0 <= w_hi - window);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -1e30f;
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * h + c];
            if (edge) {
              const int key = k0 + 8 * j + 2 * t4 + c;
              const bool ok =
                  key <= pos[h] && (!kWindow || pos[h] - key < window);
              x = ok ? x : -INFINITY;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = ex2((m[h] - m_new) * kLog2e);
        const float ml = m_new * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * h + c];
            x = ex2(fmaf(x, kLog2e, -ml));   // masked: ex2(-inf) = 0
            sum += x;
          }
        l[h] = l[h] * alpha[h] + sum;   // this lane's share; summed at the end
        m[h] = m_new;
      }

      // O = O alpha + P V over this warp's 128 dims.
      tf32::Frag pa[kKT];
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        split(s[j][0], pa[j].hi[0], pa[j].lo[0]);
        split(s[j][2], pa[j].hi[1], pa[j].lo[1]);
        split(s[j][1], pa[j].hi[2], pa[j].lo[2]);
        split(s[j][3], pa[j].hi[3], pa[j].lo[3]);
      }
      const float* svh = sv + half * kHalf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          const float* vp = svh + (8 * j + 2 * t4) * L::kV + 8 * nt + g8;
          tf32::FragB bf;
          split(vp[0], bf.hi[0], bf.lo[0]);
          split(vp[L::kV], bf.hi[1], bf.lo[1]);
          tf32::mma3(part, pa[j], bf);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nt][e] = fmaf(o[nt][e], alpha[e / 2], part[e]);
      }
    }
    __syncthreads();   // every warp is done with this stage and its scores
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (pos[h] < 0) continue;
    const int r = wr0 + g8 + 8 * h;
    const float l_safe = fmaxf(sum, 1e-30f);
    const float inv = 1.f / l_safe;
    const size_t head_row =
        ((size_t)b * seq + pos[h]) * n_heads + kvh * group + r % group;
    float* row = out + head_row * D + half * kHalf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<float2*>(row + 8 * nt + 2 * t4) =
          make_float2(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
    if (lse != nullptr && half == 0 && t4 == 0)
      lse[head_row] = m[h] + logf(l_safe);
  }
}

template <bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int seq, int n_heads, int n_kv,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_kernel_d256<kWindow>;
  constexpr size_t bytes = Layout::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)seq * (n_heads / n_kv);
  const long long tiles = (rows + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, seq, n_heads,
      n_kv, window, scale);
  return cudaGetLastError();
}

inline cudaError_t launch_w(const void* q, const void* k, const void* v,
                            void* out, float* lse, int batch, int seq,
                            int n_heads, int n_kv, int window, float scale,
                            cudaStream_t stream) {
  if (window > 0)
    return launch<true>(q, k, v, out, lse, batch, seq, n_heads, n_kv, window,
                        scale, stream);
  return launch<false>(q, k, v, out, lse, batch, seq, n_heads, n_kv, 0, scale,
                       stream);
}

}  // namespace sp

// The instantiation by dtype and head dim alone: fma at D 8, 16 and 32;
// tf32 (float32) or wgmma (bfloat16) at D 64 and 128; d256 (float32) or
// wgmma256 (bfloat16) at D 256.
template <typename T>
cudaError_t launch_d(int dim, const void* q, const void* k, const void* v,
                     void* out, float* lse, int batch, int seq, int n_heads,
                     int n_kv, int window, float scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  switch (dim) {
    case 8:
      return launch_w<T, 8>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                            window, scale, stream);
    case 16:
      return launch_w<T, 16>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                             window, scale, stream);
    case 32:
      return launch_w<T, 32>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                             window, scale, stream);
    case 64:
      if constexpr (kBf16)
        return wg::launch_w<64>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                                window, scale, stream);
      else
        return tc::launch_w<64>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                                window, scale, stream);
    case 128:
      if constexpr (kBf16)
        return wg::launch_w<128>(q, k, v, out, lse, batch, seq, n_heads,
                                 n_kv, window, scale, stream);
      else
        return tc::launch_w<128>(q, k, v, out, lse, batch, seq, n_heads,
                                 n_kv, window, scale, stream);
    case 256:
      if constexpr (kBf16)
        return wg256::launch_w(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                               window, scale, stream);
      else
        return sp::launch_w(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, D], k and v [B, S, KV, D]: contiguous, one dtype (0 =
// float32, 1 = bfloat16), H a multiple of KV, D in {8, 16, 32, 64, 128,
// 256}; at D 64 and above q, k, v 16-byte aligned, and bfloat16 there
// (flash_kernel_wgmma, flash_kernel_wgmma256) H / KV <= 64.  window > 0
// limits each query to the keys p - window < j <= p; 0 is global causal
// attention.  out [B, S, H, D] in the inputs' dtype is written, and lse
// [B, S, H] float32 unless it is null.  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int seq, int n_heads,
                                      int n_kv, int dim, int window,
                                      int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || n_kv <= 0 || n_heads < n_kv ||
      n_heads % n_kv != 0 || window < 0 || batch > 65535 || n_kv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(dim, q, k, v, out, lf, batch, seq,
                                  n_heads, n_kv, window, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(dim, q, k, v, out, lf, batch, seq,
                                          n_heads, n_kv, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
