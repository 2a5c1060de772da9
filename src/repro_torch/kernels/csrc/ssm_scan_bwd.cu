// Backward of the selective (Mamba / S6) scan: the gradients of hymba's SSM
// recurrence with respect to every input, for training.
//
// Replaces: the gradient that jax.grad takes through
// src/repro/models/ssm.py, _ssm_scan (the lax.scan the JAX package trains
// through; the Pallas kernel ssm_scan_pallas is forward-only).  The plain
// version is kernels/ref.py: ref_ssm_scan_backward, which spells out the
// same algebra.
//
// What it computes.  Forward, per (b, i, n): h_t = e_t h_{t-1} +
// dt_t u_t b_t[n] with e_t = exp(dt_t a[i, n]), y_t[i] = sum_n h_t c_t[n].
// Given dy [B, S, I] and the final state's gradient dhf [B, I, N] (null =
// zeros), with g_t = dL/dh_t:
//   g_t    = c_t[n] dy_t[i] + e_{t+1} g_{t+1}      (g_{S-1} adds dhf)
//   du_t   = dt_t sum_n g_t b_t[n]
//   ddt_t  = sum_n g_t (a e_t h_{t-1} + b_t[n] u_t)
//   db_t[n] = sum_i g_t dt_t u_t,   dc_t[n] = sum_i dy_t h_t
//   da[i, n] = sum_{b, t} g_t dt_t e_t h_{t-1},   dh0 = e_0 g_0
// Inputs as the forward takes them (u, dt, b, c one dtype, float32 or
// bfloat16; b and c rows ld_b / ld_c apart; a and h0 float32); dy in the
// inputs' dtype.  du, ddt [B, S, I] and db, dc [B, S, N] (contiguous) in
// that dtype; da [I, N] and dh0 [B, I, N] float32.  All math float32.
//
// What bounds it on an H100: bytes.  u, dt and dy are read, du and ddt
// written (u and dt twice: the state walk and the reverse walk; L2 serves
// much of the second): 5 x B S I elements, 164 MB float32 at the
// learner's B 64 x S 40 x I 3200, 49 us at 3.35 TB/s.  Each element of
// the state costs one exponential on the state walk, one on the chunk's
// recompute and one on the reverse walk (131 M each at that shape, ~35 us
// each on the SFU pipes).
//
// Design: one thread per (b, channel i), Mamba's selective-scan backward
// layout.  The thread's N <= 16 states, their gradients and da live in
// registers, so the sums over n (du, ddt) are in-thread, and a warp covers
// 32 consecutive channels: every u, dt, dy, du and ddt access is one
// 128-byte line.  A block of 64 threads covers 64 channels of one batch
// row (two warps: the chunk's states below take 28 KB of shared memory a
// block, and 64 channels keep three blocks, six warps, on an SM at the
// learner's shape; 128 would leave one).  The sequence is walked in chunks
// of kChunk = 8 steps:
//   1. a state walk from h0 keeps the state at the start of every chunk:
//      in shared memory while the sequence has at most 14 chunks (S 112,
//      still two blocks an SM; the learner's S 40 has 5), else in device
//      scratch hc [B, C, N, I];
//   2. chunks are taken last to first: the thread recomputes its chunk's
//      states from the chunk's start into shared memory (recomputing is
//      what a whole sequence of states in shared memory would cost: 2.5 KB
//      a thread at S 40), then walks the chunk in reverse, carrying
//      e_t g_t.  ddt takes a e_t h_{t-1} as ln2 * (a log2e) e_t h_{t-1}.
//   3. db and dc over the block's channels: each step's 32 per-thread
//      values (db[n], dc[n]) are reduce-scattered across the warp (31
//      shuffles: lane q ends with value q summed over the warp's
//      channels), then summed over the two warps through shared memory
//      once a chunk, in order, into per-block partials [tiles, B, S, N]
//      (50 tiles at I 3200); da lands in a [B, I, N] partial.
// Every chunk's u, dt (and, walking back, dy) rows and its b_t / c_t rows
// come by cp.async into a ring of three buffers, the next two chunks in
// flight while this one is used (16-byte copies where the rows allow;
// element copies otherwise, e.g. bfloat16 b_t / c_t read in place from
// x_proj's output).  With two chunks in flight rather than one the
// block keeps ~2x the bytes in flight that a latency-bound copy needs.
// A second small kernel (ssm_scan_bwd_reduce) sums the partials over the
// channel tiles (db, dc, in the inputs' dtype) and over b (da), in a fixed
// order, so the result is deterministic.  No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait;

constexpr int kThreads = 64;                   // channels per block
constexpr int kWarps = kThreads / 32;
constexpr int kN = 16;                         // state slots (N <= 16)
constexpr int kChunk = 8;                      // steps per chunk
constexpr int kStages = 3;                     // chunks staged at a time
constexpr int kMaxChunksOnChip = 14;           // chunk starts in shared memory
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the SFU, as the forward kernel computes its decays.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// The 16 floats of a 16-byte aligned b_t / c_t row in shared memory, by
// 16-byte loads (one broadcast each to the warp).
__device__ __forceinline__ void load_row(const float* p, float (&x)[kN]) {
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[kN]) {
#pragma unroll
  for (int q = 0; q < kN / 8; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      x[8 * q + 2 * h] = f.x;
      x[8 * q + 2 * h + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 32 values on each lane of a warp (lane q its own x): afterwards x[0] on
// lane q is the sum over the lanes of their x[q].  Each round halves the
// values a lane keeps and swaps the other half with its partner: 16 + 8 +
// 4 + 2 + 1 shuffles, none of a round waiting on another.
template <int kHalf = 16>
__device__ __forceinline__ void warp_reduce_scatter(float (&x)[32],
                                                    int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float give = upper ? x[j] : x[j + kHalf];
    const float keep = upper ? x[j + kHalf] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, give, kHalf);
  }
  if constexpr (kHalf > 1) warp_reduce_scatter<kHalf / 2>(x, lane);
}

// Dynamic shared memory of a block: the staging ring, the chunk's states,
// the per-warp db / dc sums and, on chip, the chunk starts.
template <typename T>
struct Layout {
  static constexpr size_t kIn = kStages * 3 * kChunk * kThreads;  // u, dt, dy
  static constexpr size_t kBC = kStages * 2 * kChunk * kN;        // b_t, c_t
  static constexpr size_t kH = (kChunk - 1) * kN * kThreads;  // floats
  static constexpr size_t kRed = kWarps * kChunk * 32;        // floats
  static constexpr size_t kStart = kN * kThreads;             // floats a chunk
  static size_t bytes(int starts_on_chip) {
    return sizeof(T) * (kIn + kBC) +
           sizeof(float) * (kH + kRed + kStart * starts_on_chip);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const T* __restrict__ bt, const T* __restrict__ ct,
                    const float* __restrict__ a, const float* __restrict__ h0,
                    const T* __restrict__ dy, const float* __restrict__ dhf,
                    T* __restrict__ du, T* __restrict__ ddt,
                    float* __restrict__ dh0, float* __restrict__ part_b,
                    float* __restrict__ part_c, float* __restrict__ part_a,
                    float* __restrict__ hc, int n_steps, int inner, int n,
                    int ld_b, int ld_c, int vec_in, int vec_bc) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);   // [kStages][3][kChunk][kThreads]
  T* s_bc = s_in + L::kIn;                // [kStages][2][kChunk][kN]
  // [kChunk - 1][kN][kThreads]
  float* s_h = reinterpret_cast<float*>(s_bc + L::kBC);
  float* s_red = s_h + L::kH;                      // [kWarps][kChunk][32]
  float* s_start = s_red + L::kRed;                // [C][kN][kThreads]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, b = blockIdx.y, batch = gridDim.y;
  const int i0 = tile * kThreads, i = i0 + tid;
  const int n_ch = min(kThreads, inner - i0);      // real channels here
  const bool ch = tid < n_ch;
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;
  const int n_visits = 2 * n_chunks - 1;           // state walk, then back
  const size_t row0 = (size_t)b * n_steps;
  const size_t cell = ((size_t)b * inner + i) * n;  // [B, I, N] row of i

  // The start of chunk c, slot m: on chip, or hc [B, C, N, I] (slots of
  // real (channel, n) only).
  auto put_start = [&](int c, const float (&x)[kN]) {
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      if (hc == nullptr)
        s_start[(c * kN + m) * kThreads + tid] = x[m];
      else if (ch && m < n)
        hc[(((size_t)b * n_chunks + c) * n + m) * inner + i] = x[m];
    }
  };
  auto get_start = [&](int c, float (&x)[kN]) {
#pragma unroll
    for (int m = 0; m < kN; ++m)
      x[m] = hc == nullptr ? s_start[(c * kN + m) * kThreads + tid]
             : (ch && m < n)
                 ? hc[(((size_t)b * n_chunks + c) * n + m) * inner + i]
                 : 0.f;
  };

  // Visit v < C - 1 walks chunk v forward (u, dt, b_t); visit v >= C - 1
  // takes chunk 2C - 2 - v back (u, dt, dy, b_t, c_t).
  auto visit_chunk = [&](int v) {
    return v < n_chunks - 1 ? v : 2 * n_chunks - 2 - v;
  };
  auto stage = [&](int v) {
    const int buf = v % kStages, c = visit_chunk(v);
    const bool fwd = v < n_chunks - 1;
    const int t0 = c * kChunk, len = min(kChunk, n_steps - t0);
    T* d_in = s_in + buf * 3 * kChunk * kThreads;
    T* d_bc = s_bc + buf * 2 * kChunk * kN;
    // (Selected, not indexed: an indexed array of pointers would live in
    // local memory.)
    auto src = [&](int arr) { return arr == 0 ? u : arr == 1 ? dt : dy; };
    const int arrays = fwd ? 2 : 3;
    // Row r of the chunk's arrays x steps is array r / len, step r % len
    // (by compares: no integer division in the copy loops).
    auto row_of = [&](int r, int& arr, int& j) {
      arr = r >= 2 * len ? 2 : r >= len ? 1 : 0;
      j = r - arr * len;
    };
    if (vec_in) {   // inner and the pointers 16-byte aligned
      constexpr int kVec = 16 / sizeof(T), kPer = kThreads / kVec;
      const int c0 = (tid % kPer) * kVec;   // this thread's 16 bytes
      const bool live = c0 < n_ch;
      for (int r = tid / kPer; r < arrays * len; r += kThreads / kPer) {
        int arr, j;
        row_of(r, arr, j);
        cp_async16(d_in + (arr * kChunk + j) * kThreads + c0,
                   live ? src(arr) + (row0 + t0 + j) * inner + i0 + c0
                        : src(arr),
                   live ? 16 : 0);
      }
    } else {
      for (int r = 0; r < arrays * len; ++r) {
        int arr, j;
        row_of(r, arr, j);
        d_in[(arr * kChunk + j) * kThreads + tid] =
            ch ? src(arr)[(row0 + t0 + j) * inner + i] : from_float<T>(0.f);
      }
    }
    auto bc = [&](int arr, int t) {
      return arr == 0 ? bt + (row0 + t) * ld_b : ct + (row0 + t) * ld_c;
    };
    const int bc_arrays = fwd ? 1 : 2;
    if (vec_bc) {   // N rows of 16-byte multiples, 16-byte aligned
      constexpr int kVec = 16 / sizeof(T);
      const int per = n / kVec;
      for (int e = tid; e < bc_arrays * len * per; e += kThreads) {
        const int arr = e / (len * per), j = (e / per) % len,
                  c0 = (e % per) * kVec;
        cp_async16(d_bc + (arr * kChunk + j) * kN + c0,
                   bc(arr, t0 + j) + c0);
      }
    } else {
      for (int e = tid; e < bc_arrays * len * n; e += kThreads) {
        const int arr = e / (len * n), j = (e / n) % len, m = e % n;
        d_bc[(arr * kChunk + j) * kN + m] = bc(arr, t0 + j)[m];
      }
    }
    cp_async_commit();
  };

  // Slots n >= N stay zero in every buffer (so do their states).
  for (int e = tid; e < (int)L::kBC; e += kThreads)
    if (e % kN >= n) s_bc[e] = from_float<T>(0.f);

  float al[kN], h[kN], carry[kN], da[kN];
#pragma unroll
  for (int m = 0; m < kN; ++m) {
    const bool owns = ch && m < n;
    al[m] = owns ? a[(size_t)i * n + m] * kLog2e : 0.f;
    h[m] = (owns && h0 != nullptr) ? h0[cell + m] : 0.f;
    carry[m] = (owns && dhf != nullptr) ? dhf[cell + m] : 0.f;  // e g
    da[m] = 0.f;
  }
  put_start(0, h);

  // The ring: visits v + 1 and v + 2 in flight while v is walked.
  stage(0);
  if (n_visits > 1) stage(1);
  for (int v = 0; v < n_visits; ++v) {
    __syncthreads();   // visit v - 1 is done with its buffer and sums
    if (v + 2 < n_visits) {
      stage(v + 2);
      cp_async_wait<2>();
    } else if (v + 1 < n_visits) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // visit v's rows are in
    const int buf = v % kStages, c = visit_chunk(v);
    const int t0 = c * kChunk, len = min(kChunk, n_steps - t0);
    const T* x_u = s_in + (buf * 3 + 0) * kChunk * kThreads + tid;
    const T* x_dt = s_in + (buf * 3 + 1) * kChunk * kThreads + tid;
    const T* x_dy = s_in + (buf * 3 + 2) * kChunk * kThreads + tid;
    const T* x_b = s_bc + (buf * 2 + 0) * kChunk * kN;
    const T* x_c = s_bc + (buf * 2 + 1) * kChunk * kN;

    // The forward walks are unrolled over the chunk's kChunk steps (len is
    // the block's, so every thread takes the same branches): the steps'
    // loads issue early.
    if (v < n_chunks - 1) {   // 1. the state walk over chunk c
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j >= len) continue;
        const float d = to_float(x_dt[j * kThreads]);
        const float dtu = d * to_float(x_u[j * kThreads]);
        float bb[kN];
        load_row(x_b + j * kN, bb);
#pragma unroll
        for (int m = 0; m < kN; ++m)
          h[m] = exp2_sfu(d * al[m]) * h[m] + dtu * bb[m];
      }
      put_start(c + 1, h);
      continue;
    }

    // 2. Chunk c back: its states from its start, then the reverse walk.
    float cur[kN];
    get_start(c, cur);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j >= len) continue;
      const float d = to_float(x_dt[j * kThreads]);
      const float dtu = d * to_float(x_u[j * kThreads]);
      float bb[kN];
      load_row(x_b + j * kN, bb);
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        cur[m] = exp2_sfu(d * al[m]) * cur[m] + dtu * bb[m];
        if (j < len - 1) s_h[(j * kN + m) * kThreads + tid] = cur[m];
      }
    }
    // (Not unrolled: faster than the unrolled walk, which holds more
    // registers; tools/ssm_scan_bwd_variants.py times both.)
#pragma unroll 1
    for (int j = len - 1; j >= 0; --j) {   // cur = h_t, prev = h_{t-1}
      float prev[kN];
      if (j > 0) {
#pragma unroll
        for (int m = 0; m < kN; ++m)
          prev[m] = s_h[((j - 1) * kN + m) * kThreads + tid];
      } else {
        get_start(c, prev);
      }
      const float d = to_float(x_dt[j * kThreads]);
      const float uu = to_float(x_u[j * kThreads]);
      const float dyv = to_float(x_dy[j * kThreads]);
      const float dtu = d * uu;
      float pu = 0.f, pta = 0.f, x[2 * kN], bb[kN], cc[kN];
      load_row(x_b + j * kN, bb);
      load_row(x_c + j * kN, cc);
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        const float e = exp2_sfu(d * al[m]);
        const float g = fmaf(cc[m], dyv, carry[m]);
        const float w = g * e * prev[m];            // g e_t h_{t-1}
        pu = fmaf(g, bb[m], pu);
        pta = fmaf(al[m], w, pta);
        da[m] = fmaf(d, w, da[m]);
        carry[m] = e * g;
        x[m] = g * dtu;                             // db_t[n] term
        x[kN + m] = dyv * cur[m];                   // dc_t[n] term
        cur[m] = prev[m];
      }
      if (ch) {
        const size_t r = (row0 + t0 + j) * inner + i;
        store(du + r, d * pu);
        store(ddt + r, fmaf(kLn2, pta, uu * pu));
      }
      warp_reduce_scatter(x, lane);
      s_red[(warp * kChunk + j) * 32 + lane] = x[0];
    }
    __syncthreads();
    // 3. The chunk's db, dc over the block's channels: one partial per
    // (tile, b, t, n), warps summed in order.
    for (int e = tid; e < len * 32; e += kThreads) {
      const int j = e / 32, q = e % 32, m = q % kN;
      if (m >= n) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_red[(w * kChunk + j) * 32 + q];
      float* part = q < kN ? part_b : part_c;
      part[(((size_t)tile * batch + b) * n_steps + t0 + j) * n + m] = sum;
    }
  }
  if (ch) {
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      if (m >= n) continue;
      if (dh0 != nullptr) dh0[cell + m] = carry[m];   // e_0 g_0
      part_a[cell + m] = da[m];
    }
  }
}

// acc[q] += p[(t + q) * stride] for t = 0, 4, 8, .. < count: four loads
// in flight at a time, and the same order on every run.
__device__ __forceinline__ void sum4(const float* __restrict__ p,
                                     size_t stride, int count,
                                     float (&acc)[4]) {
  int t = 0;
  for (; t + 4 <= count; t += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += p[(size_t)(t + q) * stride];
  }
  for (; t < count; ++t) acc[t % 4] += p[(size_t)t * stride];
}

// db, dc [B, S, N] = the partials summed over the channel tiles; da [I, N] =
// the [B, I, N] partial summed over b.  One thread per output element.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ssm_scan_bwd_reduce(const float* __restrict__ part_b,
                    const float* __restrict__ part_c,
                    const float* __restrict__ part_a, T* __restrict__ db,
                    T* __restrict__ dc, float* __restrict__ da, int tiles,
                    int batch, int n_steps, int inner, int n) {
  const size_t e = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  const size_t bsn = (size_t)batch * n_steps * n, in = (size_t)inner * n;
  if (e < bsn) {
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, sc[4] = {0.f, 0.f, 0.f, 0.f};
    sum4(part_b + e, bsn, tiles, sb);
    sum4(part_c + e, bsn, tiles, sc);
    store(db + e, (sb[0] + sb[1]) + (sb[2] + sb[3]));
    store(dc + e, (sc[0] + sc[1]) + (sc[2] + sc[3]));
  } else if (e < bsn + in) {
    const size_t f = e - bsn;
    float sa[4] = {0.f, 0.f, 0.f, 0.f};
    sum4(part_a + f, in, batch, sa);
    da[f] = (sa[0] + sa[1]) + (sa[2] + sa[3]);
  }
}

int chunks_of(int n_steps) { return (n_steps + kChunk - 1) / kChunk; }
int starts_on_chip(int n_steps) {
  return chunks_of(n_steps) <= kMaxChunksOnChip ? chunks_of(n_steps) : 0;
}

// The float32 scratch at these sizes: the db / dc partials of every
// channel tile, the per-row da partials, and the chunk starts hc [B, C,
// N, I] when they do not stay on chip.
size_t scratch_floats(int batch, int n_steps, int inner, int n) {
  const size_t tiles = (inner + kThreads - 1) / kThreads;
  const size_t starts =
      starts_on_chip(n_steps) ? 0 : (size_t)chunks_of(n_steps);
  return 2 * tiles * batch * n_steps * n + (size_t)batch * inner * n +
         (size_t)batch * starts * n * inner;
}

// Lets the kernel take its largest dynamic shared memory (once).
template <typename T>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<T>::bytes(kMaxChunksOnChip));
  return err;
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* bt,
                   const void* ct, const float* a, const float* h0,
                   const void* dy, const float* dhf, void* du, void* ddt,
                   void* db, void* dc, float* da, float* dh0, float* scratch,
                   int batch, int n_steps, int inner, int n, int ld_b,
                   int ld_c, cudaStream_t stream) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return err;
  const int tiles = (inner + kThreads - 1) / kThreads;
  const int on_chip = starts_on_chip(n_steps);
  const size_t bsn = (size_t)batch * n_steps * n;
  float* part_b = scratch;
  float* part_c = part_b + (size_t)tiles * bsn;
  float* part_a = part_c + (size_t)tiles * bsn;
  float* hc = part_a + (size_t)batch * inner * n;
  constexpr int esize = sizeof(T);
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_in = al16(u) && al16(dt) && al16(dy) &&
                     ((size_t)inner * esize) % 16 == 0;
  const int vec_bc = al16(bt) && al16(ct) && (ld_b * esize) % 16 == 0 &&
                     (ld_c * esize) % 16 == 0 && (n * esize) % 16 == 0;
  ssm_scan_bwd_kernel<T><<<dim3(tiles, batch), kThreads,
                           Layout<T>::bytes(on_chip), stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const T*>(bt), static_cast<const T*>(ct), a, h0,
      static_cast<const T*>(dy), dhf, static_cast<T*>(du),
      static_cast<T*>(ddt), dh0, part_b, part_c, part_a,
      on_chip ? nullptr : hc, n_steps, inner, n, ld_b, ld_c, vec_in, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t cells = bsn + (size_t)inner * n;
  ssm_scan_bwd_reduce<T><<<(unsigned)((cells + kReduceThreads - 1) /
                                      kReduceThreads),
                           kReduceThreads, 0, stream>>>(
      part_b, part_c, part_a, static_cast<T*>(db), static_cast<T*>(dc), da,
      tiles, batch, n_steps, inner, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t info(int n_steps, int* out) {
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ssm_scan_bwd_kernel<T>);
  if (err != cudaSuccess) return err;
  const int bytes = (int)Layout<T>::bytes(starts_on_chip(n_steps));
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ssm_scan_bwd_kernel<T>, kThreads, bytes);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = bytes;
  out[4] = starts_on_chip(n_steps) > 0;
  return err;
}

}  // namespace

// Inputs as ssm_scan_launch takes them, plus dy [B, S, I] (the inputs'
// dtype, contiguous) and dhf [B, I, N] float32 or null (zeros).  Writes du,
// ddt [B, S, I] and db, dc [B, S, N] (contiguous, the inputs' dtype), da
// [I, N] float32, and dh0 [B, I, N] float32 unless it is null.  `scratch`
// holds the floats ssm_scan_bwd_scratch_floats reports.  Returns the
// cudaError_t of the launches.
extern "C" int ssm_scan_bwd_launch(const void* u, const void* dt,
                                   const void* bt, const void* ct,
                                   const void* a, const void* h0,
                                   const void* dy, const void* dhf, void* du,
                                   void* ddt, void* db, void* dc, void* da,
                                   void* dh0, void* scratch, int batch,
                                   int n_steps, int inner, int n, int ld_b,
                                   int ld_c, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || n_steps <= 0 || inner <= 0 || n <= 0 ||
      n > kN || ld_b < n || ld_c < n || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhff = static_cast<const float*>(dhf);
  float* daf = static_cast<float*>(da);
  float* dh0f = static_cast<float*>(dh0);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return (int)launch<float>(u, dt, bt, ct, af, h0f, dy, dhff, du, ddt,
                                db, dc, daf, dh0f, sc, batch, n_steps, inner,
                                n, ld_b, ld_c, s);
    case 1:
      return (int)launch<__nv_bfloat16>(u, dt, bt, ct, af, h0f, dy, dhff, du,
                                        ddt, db, dc, daf, dh0f, sc, batch,
                                        n_steps, inner, n, ld_b, ld_c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What the main kernel takes at S steps (dtype 0 = float32, 1 =
// bfloat16): out[0] registers a thread, out[1] local (spilled) bytes a
// thread, out[2] blocks resident on an SM, out[3] dynamic shared bytes a
// block, out[4] 1 if the chunk starts stay on chip.  Returns the
// cudaError_t of the queries.
extern "C" int ssm_scan_bwd_info(int dtype, int n_steps, int* out) {
  if (n_steps <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)info<float>(n_steps, out);
    case 1:
      return (int)info<__nv_bfloat16>(n_steps, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The float32 scratch ssm_scan_bwd_launch takes at these sizes; -1 for
// sizes it refuses.
extern "C" long long ssm_scan_bwd_scratch_floats(int batch, int n_steps,
                                                 int inner, int n) {
  if (batch <= 0 || n_steps <= 0 || inner <= 0 || n <= 0 || n > kN)
    return -1;
  return (long long)scratch_floats(batch, n_steps, inner, n);
}
