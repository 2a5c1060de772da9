// Shared block routine of the two paged-attention kernels
// (paged_attention.cu: one query per slot; paged_attention_varlen.cu:
// ragged rows per slot).  Both launch a grid of (row tiles, KV, B) and
// call attend_tile; they differ only in how a slot's rows are described.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

// Same masking constant, denominator floor and scale placement as the
// Pallas kernels and the plain versions (kernels/ref.py).
constexpr float kNegInf = -1e30f;
constexpr float kMinDenom = 1e-30f;

constexpr int kThreads = 128;                   // 4 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;                    // query rows per block
constexpr int kRowsPerWarp = kRowTile / kWarps; // a warp owns 4 rows
constexpr int kKeys = 64;                       // keys staged per sync
constexpr int kKeysPerLane = kKeys / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kDimsPerLane = kMaxHeadDim / 32;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

// Four consecutive elements of a staged K row as float32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}

// 16 bytes global -> shared without a register round trip; src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged K or V row: D elements padded by 16 bytes, so that the
// 16-byte loads of 8 consecutive lanes (8 rows) hit distinct banks.
template <typename T>
__host__ __device__ constexpr int row_bytes(int d) {
  return d * (int)sizeof(T) + 16;
}

// Dynamic shared memory of one block, in bytes:
// q[kRowTile][D] f32 | k, v[2 stages][kKeys][row] T | p[kRowTile][kKeys]
// f32 | ok[2 stages][kKeys] int.
template <typename T>
inline size_t smem_bytes(int head_dim) {
  return sizeof(float) * kRowTile * head_dim +
         (size_t)4 * kKeys * row_bytes<T>(head_dim) +
         sizeof(float) * kRowTile * kKeys + sizeof(int) * 2 * kKeys;
}

struct Geometry {
  int T;        // query rows per slot in q/out ([B, T, H, D]; 1 for decode)
  int H, KV;    // query heads, kv heads (H % KV == 0)
  int NB, BS;   // pool pages, rows per page
  int D;        // head dim (a multiple of 8, <= kMaxHeadDim)
  int M;        // block-table width
  int window;   // sliding window, < 0 = global
  float scale;  // D ** -0.5, applied to q
};

// Stage keys k0 .. k0 + kKeys - 1 of slot b, kv head kvh into one buffer
// (cp.async, 16 bytes a thread per step).  Each key's row comes through
// its own table entry; a key past `last`, past the table, or whose entry
// is < 0 or >= NB is never read: its rows are zero and ok[key] is 0.
template <typename T>
__device__ __forceinline__ void stage_keys(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ tables, uint8_t* k_s, uint8_t* v_s, int* ok_s,
    int b, int kvh, int k0, int last, const Geometry& g) {
  const int chunks = g.D * (int)sizeof(T) / 16;   // per row
  const int rb = row_bytes<T>(g.D);
  for (int e = threadIdx.x; e < 2 * kKeys * chunks; e += kThreads) {
    const bool is_v = e >= kKeys * chunks;
    const int rem = is_v ? e - kKeys * chunks : e;
    const int kk = rem / chunks, c = rem % chunks, j = k0 + kk;
    const int jp = j / g.BS;
    int page = -1;
    if (j <= last && jp < g.M) page = tables[(size_t)b * g.M + jp];
    const bool valid = page >= 0 && page < g.NB;
    const T* pages = is_v ? v_pages : k_pages;
    const T* src = valid ? pages + (((size_t)kvh * g.NB + page) * g.BS +
                                    j % g.BS) * g.D + c * (16 / sizeof(T))
                         : pages;
    cp_async16((is_v ? v_s : k_s) + kk * rb + c * 16, src, valid ? 16 : 0);
    if (!is_v && c == 0) ok_s[kk] = valid;
  }
}

// One block = rows r0 .. r0 + kRowTile - 1 of (slot b, kv head kvh).  The
// slot's live query rows are tokens t < n at absolute positions base + t;
// each token has G = H / KV group heads, so the slot has n * G live rows,
// row r -> token r / G, head kvh * G + r % G (of T * G rows in q/out).
// Rows of the tile at tokens >= n are written as exact zeros.  Keys run
// from the oldest row's first visible key to the newest row's position,
// kKeys at a time, double-buffered: the next tile's cp.async is in flight
// while this one is used.  Warp w owns rows 4w .. 4w + 3: lane l scores
// keys l and l + 32 of each, row max and sum by warp shuffles, then
// accumulates dims l + 32c of each row's output.  Online softmax in
// float32, with the update order of the Pallas body.
template <typename T>
__device__ void attend_tile(const T* __restrict__ q,
                            const T* __restrict__ k_pages,
                            const T* __restrict__ v_pages,
                            const int* __restrict__ tables,
                            T* __restrict__ out, int b, int kvh, int base,
                            int n, int r0, const Geometry& g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int D = g.D, G = g.H / g.KV, rb = row_bytes<T>(D);
  float* q_s = reinterpret_cast<float*>(smem);
  uint8_t* kv_s = smem + sizeof(float) * kRowTile * D;
  auto k_buf = [&](int st) { return kv_s + st * kKeys * rb; };
  auto v_buf = [&](int st) { return kv_s + (2 + st) * kKeys * rb; };
  float* p_s = reinterpret_cast<float*>(kv_s + 4 * kKeys * rb);
  int* ok_s = reinterpret_cast<int*>(p_s + kRowTile * kKeys);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool has_window = g.window >= 0;
  if (n < 0) n = 0;
  if (n > g.T) n = g.T;
  const int live_rows = n * G;

  float acc[kRowsPerWarp][kDimsPerLane], l[kRowsPerWarp], m[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    l[i] = 0.f;
    m[i] = kNegInf;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[i][c] = 0.f;
  }
  // The output rows this warp writes: live rows from acc, the rest zeros.
  auto write_rows = [&]() {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + warp * kRowsPerWarp + i;
      if (r >= g.T * G) break;
      const int t = r / G, h = kvh * G + r % G;
      T* row = out + (((size_t)b * g.T + t) * g.H + h) * D;
      const float inv = r < live_rows ? 1.f / fmaxf(l[i], kMinDenom) : 0.f;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < D) row[d] = from_float<T>(r < live_rows ? acc[i][c] * inv
                                                        : 0.f);
      }
    }
  };
  if (r0 >= live_rows) {   // only padding rows: zeros, nothing read
    write_rows();
    return;
  }

  // Keys any live row of the tile can see: [first, last].
  const int t_lo = r0 / G, t_hi = (min(r0 + kRowTile, live_rows) - 1) / G;
  const int last = base + t_hi;
  const int first = has_window ? max(0, base + t_lo - g.window + 1) : 0;
  const int n_tiles = (last - first) / kKeys + 1;

  stage_keys<T>(k_pages, v_pages, tables, k_buf(0), v_buf(0), ok_s, b, kvh,
                first, last, g);
  cp_async_commit();
  for (int e = tid; e < kRowTile * D; e += kThreads) {
    const int rr = r0 + e / D, d = e % D;
    float x = 0.f;
    if (rr < live_rows)
      x = to_float(q[(((size_t)b * g.T + rr / G) * g.H + kvh * G + rr % G) *
                         D + d]) * g.scale;
    q_s[e] = x;
  }
  int pos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp * kRowsPerWarp + i;
    pos[i] = r < live_rows ? base + r / G : -1;   // -1: attends nothing
  }
  float* p_w = p_s + warp * kRowsPerWarp * kKeys;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = first + it * kKeys;
    if (it + 1 < n_tiles) {
      stage_keys<T>(k_pages, v_pages, tables, k_buf(st ^ 1), v_buf(st ^ 1),
                    ok_s + (st ^ 1) * kKeys, b, kvh, k0 + kKeys, last, g);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile `it` (and q_s) visible to every warp
    const T* ks = reinterpret_cast<const T*>(k_buf(st));
    const T* vs = reinterpret_cast<const T*>(v_buf(st));
    const int* ok = ok_s + st * kKeys;

    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float kx[kKeysPerLane][4];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c)
        load4(ks + (lane + 32 * c) * (rb / (int)sizeof(T)) + d, kx[c]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + (warp * kRowsPerWarp + i) * D + d);
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c)
          s[i][c] += qv.x * kx[c][0] + qv.y * kx[c][1] + qv.z * kx[c][2] +
                     qv.w * kx[c][3];
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool valid[kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int kk = lane + 32 * c, key = k0 + kk;
        valid[c] = ok[kk] && key <= pos[i] &&
                   (!has_window || pos[i] - key < g.window);
        if (valid[c]) mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const float p = valid[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p;
        p_w[i * kKeys + lane + 32 * c] = p;
      }
      l[i] = l[i] * alpha + sum;   // this lane's share; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // p_w complete

    const int n_keys = min(kKeys, last + 1 - k0);
    const int v_row = rb / (int)sizeof(T);
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pv[i] = p_w[i * kKeys + kk];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) {
        const int d = lane + 32 * c;
        const float vv = d < D ? to_float(vs[kk * v_row + d]) : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();   // buffer `st` and p_s are free for the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  write_rows();
}

// Host-side shape check shared by both launchers.
inline cudaError_t check_geometry(const Geometry& g, int batch) {
  if (batch <= 0 || batch > 65535 || g.KV <= 0 || g.KV > 65535 ||
      g.H % g.KV != 0 || g.D <= 0 || g.D > kMaxHeadDim || g.D % 8 != 0 ||
      g.BS <= 0 || g.T <= 0 || g.M <= 0 || g.NB <= 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace paged
