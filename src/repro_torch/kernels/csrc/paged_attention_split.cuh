// Paged decode above head dim 128 (gemma3-12b's 256), split over the
// context: the decode routine of paged_attention.cu at 128 < D <= 256, in
// both dtypes.  D <= 128 keeps the row-tile routine
// (paged_attention_common.cuh, attend_tile).
//
// What bounds it on an H100: the K/V rows, 2 * KV * span_b * D *
// sizeof(T) bytes for slot b's span_b visible keys (67.1 MB for gemma3's
// 8 kv heads of 256 at B 4 past its window of 1024 in float32: 20 us at
// 3.35 TB/s).  The scores and values are 4 D flops per (head, key), far
// below that.  So the design's aim is bytes in flight on every SM: the
// row-tile routine runs one block per (slot, kv head), 32 blocks at B 4
// and 8 at B 1, each walking its up to 1,024 keys alone.
//
// Design:
// - Grid (context splits x row tiles, KV, B).  A block takes kRows of the
//   G query heads of one (slot, kv head) (kRows the least power of two
//   >= G, at most 8: gemma3's G 2 runs 2 rows, no dead ones) over one
//   contiguous span of the slot's visible keys [first, last] (the newest
//   row's, as attend_tile computes them).  Splits are chunk keys each,
//   chunk = ceil(span / n_splits) raised to min_keys and rounded up to a
//   stage (split_chunk): a short context takes one split and leaves the
//   others empty.  n_splits comes from the host, from the geometry alone
//   (kernels/paged_attention.py, plan_splits: B x KV x row tiles, the
//   longest visible span, the SM count).
// - Keys are staged kKeys = 16 at a time by 16-byte cp.async, each row
//   through its own table entry (8 threads a row, coalesced), in a ring
//   of kStages stages (3 float32 / 4 bfloat16: 104 / 72 KB at kRows 8,
//   two / three blocks an SM).  A key past the split, past the table or
//   with an entry outside the pool is never read: its rows are zero and
//   its flag is 0.
// - The warps divide a stage's keys, 4 each: 8 lanes a key, each lane a
//   16-byte chunk in 8 (so a quarter warp reads one 128-byte run of the
//   row and the rows need no padding), the key's score summed over the 8
//   lanes by three shuffles, for all kRows rows at once.  Each warp keeps
//   its own running max, sum and accumulator (expf, the Pallas body's
//   update order); for the value product a lane owns 8 dims of every row
//   (float32: 4 lanes x 4 + 128; bfloat16: 8 consecutive), reading each
//   key's V row as one contiguous 16-byte load a lane.
// - At the end of the span the warps' (m, l, acc) merge in shared memory
//   in warp order.  One split writes the output.  Otherwise each split
//   writes its partial (m, l, acc[D], float32) to scratch the wrapper
//   allocates ([B, H, n_splits] rows), and the last block of a (slot,
//   kv head, row tile) to finish (a per-tile atomic ticket, which that
//   block resets to 0 for the next call) merges the non-empty splits in
//   split order: the same bits whichever block finishes last, and no
//   float atomics.  A split that sees no key contributes nothing; ctx 0
//   gives exact zeros; the denominator is clamped at 1e-30.
// - Registers (ptxas, sm_90a): 56-64 at 1-2 rows, 80-84 at 4, 136-139 at
//   8, no spills; shared memory as above plus 48-272 B of merge state.
#pragma once

#include "paged_attention_common.cuh"

namespace paged {
namespace split {

constexpr int kThreads = 128;                     // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = 8;                   // a key's score
constexpr int kKeysPerWarp = 32 / kLanesPerKey;   // 4 keys a warp a stage
constexpr int kKeys = kWarps * kKeysPerWarp;      // 16 keys a stage
constexpr int kMaxRows = 8;                       // query rows a block
constexpr int kMaxSplits = 32;                    // splits a (slot, kv head)
constexpr int kMaxD = kMaxHeadDim;                // 256
constexpr int kDimsPerLane = 8;                   // output dims a lane

template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 ? 3 : 4;
}

// q[kRows][kMaxD] f32 | k, v[kStages][kKeys][kMaxD] T | ok[kStages][kKeys]
template <typename T, int kRows>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * kRows * kMaxD +
         (size_t)2 * stages<T>() * kKeys * kMaxD * sizeof(T) +
         sizeof(int) * stages<T>() * kKeys;
}

// Keys a non-empty split takes: the span over n_splits, at least min_keys,
// rounded up to a whole stage.  kernels/paged_attention.py's split_chunk
// and the plain version (kernels/ref.py) compute the same.
__host__ __device__ inline int split_chunk(int span, int n_splits,
                                           int min_keys) {
  int c = (span + n_splits - 1) / n_splits;
  if (c < min_keys) c = min_keys;
  return (c + kKeys - 1) / kKeys * kKeys;
}

// Output dim e (< kDimsPerLane) of a lane: float32 lanes hold two 4-dim
// runs 128 apart, bfloat16 lanes one 8-dim run, so that each V load of a
// quarter warp is one contiguous 128-byte run.
template <typename T>
__device__ __forceinline__ int dim_of(int lane, int e) {
  if constexpr (sizeof(T) == 4)
    return 4 * lane + 128 * (e / 4) + e % 4;
  else
    return 8 * lane + e;
}

// Eight bfloat16 elements (16 bytes, one load) as float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// The kDimsPerLane elements dim_of(lane, 0 ..) of a staged row, as float32.
__device__ __forceinline__ void load_dims(const float* row, int lane,
                                          float (&x)[kDimsPerLane]) {
  float a[4], b[4];
  load4(row + 4 * lane, a);
  load4(row + 4 * lane + 128, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = a[e], x[4 + e] = b[e];
}
__device__ __forceinline__ void load_dims(const __nv_bfloat16* row, int lane,
                                          float (&x)[kDimsPerLane]) {
  load8(row + 8 * lane, x);
}

// A 16-byte chunk of a staged K row dotted with the same dims of a staged
// float32 query row.
__device__ __forceinline__ float chunk_dot(const float* k, const float* q) {
  float x[4];
  load4(k, x);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  return qv.x * x[0] + qv.y * x[1] + qv.z * x[2] + qv.w * x[3];
}
__device__ __forceinline__ float chunk_dot(const __nv_bfloat16* k,
                                           const float* q) {
  float x[8];
  load8(k, x);
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  return qa.x * x[0] + qa.y * x[1] + qa.z * x[2] + qa.w * x[3] +
         qb.x * x[4] + qb.y * x[5] + qb.z * x[6] + qb.w * x[7];
}

// part_acc [B, H, n_splits, D] and part_ml [B, H, n_splits, 2] float32
// (read and written only when n_splits > 1); tickets [>= B * KV * tiles]
// int32, all 0 between calls.
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int* __restrict__ tables,
                             const int* __restrict__ context_lens,
                             T* __restrict__ out, float* __restrict__ part_acc,
                             float* __restrict__ part_ml,
                             int* __restrict__ tickets, Geometry g,
                             int n_splits, int min_keys) {
  constexpr int kStages = stages<T>();
  constexpr int kChunk = 16 / (int)sizeof(T);         // elements a cp.async
  constexpr int kLaneChunks = kMaxD / kChunk / kLanesPerKey;
  static_assert(sizeof(float) * kWarps * kRows * kMaxD <=
                        2 * sizeof(T) * kStages * kKeys * kMaxD &&
                    sizeof(float) * (3 * kMaxSplits + 1) * kRows <=
                        2 * sizeof(T) * kStages * kKeys * kMaxD,
                "the warps' merge and the splits' merge reuse the K/V ring");
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  T* k_s = reinterpret_cast<T*>(q_s + kRows * kMaxD);
  T* v_s = k_s + kStages * kKeys * kMaxD;
  int* ok_s = reinterpret_cast<int*>(v_s + kStages * kKeys * kMaxD);
  __shared__ float s_m[kWarps][kRows], s_l[kWarps][kRows];
  __shared__ int s_last;

  const int split = blockIdx.x % n_splits, tile = blockIdx.x / n_splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = g.H / g.KV, D = g.D, chunks = D / kChunk;
  const int r0 = tile * kRows, nr = min(kRows, G - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head0 = (size_t)b * g.H + kvh * G + r0;   // row 0 in q / out

  // The newest row's visible keys [first, last]; this split's [lo, hi].
  const int ctx = context_lens[b];
  const int last = ctx - 1;
  const int first = g.window >= 0 ? max(0, last - g.window + 1) : 0;
  const int span = ctx > 0 ? last - first + 1 : 0;
  const int chunk = split_chunk(span, n_splits, min_keys);
  const int used = (span + chunk - 1) / chunk;   // splits that see a key
  const int lo = first + split * chunk;
  const int hi = min(last, lo + chunk - 1);
  const int n_tiles = split < used ? (hi - lo + kKeys) / kKeys : 0;

  // Stage tile `it` of the split: 8 threads a key, 16 bytes each a step.
  auto stage = [&](int it) {
    const int buf = it % kStages, kk = tid / kLanesPerKey;
    const int part = tid % kLanesPerKey, j = lo + it * kKeys + kk;
    const int jp = j / g.BS;
    int page = -1;
    if (j <= hi && jp < g.M) page = tables[(size_t)b * g.M + jp];
    const bool valid = page >= 0 && page < g.NB;
    const size_t row =
        valid ? (((size_t)kvh * g.NB + page) * g.BS + j % g.BS) * D : 0;
    T* kd = k_s + (buf * kKeys + kk) * kMaxD;
    T* vd = v_s + (buf * kKeys + kk) * kMaxD;
    for (int c = part; c < chunks; c += kLanesPerKey) {
      cp_async16(kd + c * kChunk, k_pages + row + c * kChunk, valid ? 16 : 0);
      cp_async16(vd + c * kChunk, v_pages + row + c * kChunk, valid ? 16 : 0);
    }
    if (part == 0) ok_s[buf * kKeys + kk] = valid;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s);
    cp_async_commit();
  }
  for (int e = tid; e < kRows * kMaxD; e += kThreads) {
    const int i = e / kMaxD, d = e % kMaxD;
    q_s[e] = i < nr && d < D ? to_float(q[(head0 + i) * D + d]) * g.scale
                             : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) acc[i][e] = 0.f;
  }
  const int kw = lane / kLanesPerKey, part = lane % kLanesPerKey;
  const int kk = warp * kKeysPerWarp + kw;   // the key this lane scores

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();   // tile `it` (and q_s) visible to every warp
    const int buf = it % kStages;
    const T* kr = k_s + (buf * kKeys + kk) * kMaxD;

    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
#pragma unroll
    for (int jc = 0; jc < kLaneChunks; ++jc) {
      const int c = part + kLanesPerKey * jc;
      if (c < chunks) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          s[i] += chunk_dot(kr + c * kChunk, q_s + i * kMaxD + c * kChunk);
      }
    }
    const bool valid = ok_s[buf * kKeys + kk] != 0;
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int off = 1; off < kLanesPerKey; off <<= 1)
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      float mx = valid ? s[i] : kNegInf;
#pragma unroll
      for (int off = kLanesPerKey; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      p[i] = valid ? expf(s[i] - m_new) : 0.f;
      l[i] = l[i] * alpha + (part == 0 ? p[i] : 0.f);   // summed at the end
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) acc[i][e] *= alpha;
    }
    const bool has_dims = dim_of<T>(lane, 0) < D;
#pragma unroll
    for (int kq = 0; kq < kKeysPerWarp; ++kq) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = __shfl_sync(0xffffffffu, p[i], kq * kLanesPerKey);
      if (has_dims) {
        float vx[kDimsPerLane];
        load_dims(v_s + (buf * kKeys + warp * kKeysPerWarp + kq) * kMaxD,
                  lane, vx);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e)
            acc[i][e] = fmaf(pv[i], vx[e], acc[i][e]);
      }
    }
    __syncthreads();   // buffer `buf` is free for the next stage
  }
  cp_async_wait<0>();

  // The warps' states merge in warp order: each warp's share rescaled to
  // the block's max into red[warp][row][dim] (over the ring, now free).
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    if (lane == 0) s_m[warp][i] = m[i], s_l[warp][i] = l[i];
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(k_s);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float mb = s_m[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, s_m[w][i]);
    const float sc = expf(m[i] - mb);
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = dim_of<T>(lane, e);
      if (d < D) red[(warp * kRows + i) * kMaxD + d] = acc[i][e] * sc;
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += kThreads) {
    const int i = e / D, d = e % D;
    float mb = s_m[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, s_m[w][i]);
    float lb = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lb += s_l[w][i] * expf(s_m[w][i] - mb);
      a += red[(w * kRows + i) * kMaxD + d];
    }
    if (n_splits == 1) {
      out[(head0 + i) * D + d] =
          from_float<T>(span > 0 ? a / fmaxf(lb, kMinDenom) : 0.f);
    } else if (split < used) {
      const size_t at = (head0 + i) * n_splits + split;
      part_acc[at * D + d] = a;
      if (d == 0) part_ml[2 * at] = mb, part_ml[2 * at + 1] = lb;
    }
  }
  if (n_splits == 1) return;

  // The last block of this (slot, kv head, row tile) merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + ((size_t)b * g.KV + kvh) * (gridDim.x / n_splits) +
                  tile;
    s_last = atomicAdd(ticket, 1) == n_splits - 1;
    if (s_last) *ticket = 0;   // every split has taken its ticket
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Every split's (m, l) read at once into shared memory, then each row's
  // max, scales and sum in split order, then the values: each thread's
  // loads of the splits' partials are independent (unrolled, so they are
  // in flight together) and summed in split order.
  float* s_ml = red;                          // [kMaxSplits][kRows][2]
  float* s_sc = red + 2 * kMaxSplits * kRows;  // [kMaxSplits][kRows]
  float* s_lt = s_sc + kMaxSplits * kRows;     // [kRows]
  for (int e = tid; e < used * nr; e += kThreads) {
    const int s = e / nr, i = e % nr;
    const size_t at = (head0 + i) * n_splits + s;
    s_ml[2 * (s * kRows + i)] = __ldcg(part_ml + 2 * at);
    s_ml[2 * (s * kRows + i) + 1] = __ldcg(part_ml + 2 * at + 1);
  }
  __syncthreads();
  if (tid < nr) {
    const int i = tid;
    float mb = kNegInf;
    for (int s = 0; s < used; ++s) mb = fmaxf(mb, s_ml[2 * (s * kRows + i)]);
    float lb = 0.f;
    for (int s = 0; s < used; ++s) {
      const float sc = expf(s_ml[2 * (s * kRows + i)] - mb);
      s_sc[s * kRows + i] = sc;
      lb += s_ml[2 * (s * kRows + i) + 1] * sc;
    }
    s_lt[i] = lb;
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += kThreads) {
    const int i = e / D, d = e % D;
    const float* pa = part_acc + (head0 + i) * n_splits * D + d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < used; ++s)
      a += __ldcg(pa + (size_t)s * D) * s_sc[s * kRows + i];
    out[(head0 + i) * D + d] =
        from_float<T>(used > 0 ? a / fmaxf(s_lt[i], kMinDenom) : 0.f);
  }
}

template <typename T, int kRows>
cudaError_t launch_rows(const void* q, const void* k_pages,
                        const void* v_pages, const int* tables,
                        const int* context_lens, void* out, float* part,
                        int* tickets, int batch, const Geometry& g,
                        int n_splits, int min_keys, cudaStream_t stream) {
  auto kernel = paged_attention_split_kernel<T, kRows>;
  constexpr size_t bytes = smem_bytes<T, kRows>();
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (g.H / g.KV + kRows - 1) / kRows;
  const long long blocks = (long long)tiles * n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* ml = part == nullptr
                  ? nullptr
                  : part + (size_t)batch * g.H * n_splits * g.D;
  kernel<<<dim3((unsigned)blocks, g.KV, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, context_lens,
      static_cast<T*>(out), part, ml, tickets, g, n_splits, min_keys);
  return cudaGetLastError();
}

// The row-tile height by group size: the least power of two >= G, at
// most kMaxRows (larger groups take several row tiles).  part holds
// B * H * n_splits * (D + 2) floats and tickets B * H ints (all 0) when
// n_splits > 1; both may be null at one split.
template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* context_lens, void* out,
                   float* part, int* tickets, int batch, const Geometry& g,
                   int n_splits, int min_keys, cudaStream_t stream) {
  if (n_splits < 1 || n_splits > kMaxSplits || min_keys < 1 || g.D > kMaxD ||
      (n_splits > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const int G = g.H / g.KV;
#define PAGED_SPLIT_ROWS(R)                                                  \
  return launch_rows<T, R>(q, k_pages, v_pages, tables, context_lens, out,  \
                           part, tickets, batch, g, n_splits, min_keys,      \
                           stream)
  if (G <= 1) PAGED_SPLIT_ROWS(1);
  if (G <= 2) PAGED_SPLIT_ROWS(2);
  if (G <= 4) PAGED_SPLIT_ROWS(4);
  PAGED_SPLIT_ROWS(kMaxRows);
#undef PAGED_SPLIT_ROWS
}

}  // namespace split
}  // namespace paged
