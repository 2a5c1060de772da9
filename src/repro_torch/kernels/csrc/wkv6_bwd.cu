// Backward of the RWKV-6 (Finch) WKV recurrence: the gradients of rwkv6's
// time-mix recurrence with respect to every input, for training.
//
// Replaces: the gradient that jax.grad takes through
// src/repro/models/rwkv6.py, wkv6_scan (the lax.scan the JAX package
// trains through; the Pallas kernel wkv6_pallas is forward-only).  The
// plain version is kernels/ref.py: ref_wkv6_backward, which spells out
// the same algebra.
//
// What it computes.  Forward, per (b, h), from state S_{-1} (zeros if
// absent): y_t = S_{t-1}^T r_t + (r_t . u k_t) v_t and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T.  Given dy [B, S, H, V] and the
// final state's gradient G_{S-1} [B, H, K, V] (null = zeros), with
// g_t = dy_t . v_t, walking t = S-1 .. 0:
//   dr_t[k] = sum_v S_{t-1}[k, v] dy_t[v] + u[k] k_t[k] g_t
//   dk_t[k] = u[k] r_t[k] g_t + sum_v G_t[k, v] v_t[v]
//   dv_t[v] = (r_t . u k_t) dy_t[v] + sum_k G_t[k, v] k_t[k]
//   dw_t[k] = sum_v G_t[k, v] S_{t-1}[k, v]
//   du[k]  += r_t[k] k_t[k] g_t            (summed over b and t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
// and the initial state's gradient is G_{-1}.  r, k, w, u, dy and the
// outputs dr, dk, dv, dw, du in the inputs' dtype (float32 or bfloat16);
// the states and their gradients float32; all arithmetic float32.
//
// Why nothing divides by w: S_{t-1} is recomputed forward from a saved
// chunk start, never as (S_t - k_t v_t^T) / w_t, so w = 0 gives exact,
// finite gradients; nothing takes a logarithm.
//
// What bounds it on an H100: operations.  r, k, v, w and dy are read and
// dr, dk, dv and dw written once: 189 MB float32 at the learner's B 64 x
// S 40 x H 32 x K = V = 64, 56 us at 3.35 TB/s.  About 12 float32
// operations per state element and step (the recomputed state, the four
// gradient products, the reverse recurrence): 4.0 GFLOP there, 60 us at
// 67 TFLOP/s.  The measured time (PERF.md) is ~10x that: one 512-thread
// block an SM at 124 registers, and each step a dependent chain of
// shared loads and shuffles.
//
// Design: one block per (b, h), a thread per (key row k, slice of 8 value
// columns): 8 K threads, four key rows to a warp with the eight slices of
// a row on consecutive lanes.  Value columns are independent (S[:, v] and
// G[:, v] evolve alone), so a thread owns S[k, slice] and G[k, slice] in
// registers.  The sequence is walked in chunks of kChunk = 8 steps:
//   1. a forward walk from the initial state keeps the state at the start
//      of every chunk: in shared memory while the sequence has at most
//      kMaxChunksOnChip chunks (S 64; the learner's S 40 has 5), else in
//      device scratch;
//   2. chunks are taken last to first: the thread recomputes its chunk's
//      states from the chunk's start into registers (8 steps x 8 columns,
//      indices fixed at compile time), then walks the chunk in reverse
//      with G in registers.  dr, dk and dw sum over v: in the thread over
//      its 8 columns, then over the row's 8 slice lanes by shuffles (xor
//      1, 2, 4).  dv sums over k (the bonus term (r_t . u k_t) dy_t as
//      k (r u dy) of each row, beside k G): over the warp's four rows by
//      a reduce-scatter across lanes xor 8 and 16 (six shuffles), then
//      over the warps in shared memory, in order, once a chunk, when the
//      chunk's dr, dk, dw and dv rows are written coalesced.
// Both walks fetch the next chunk's rows (in walk order) into registers
// before walking the current one and stage them, as float32, into the
// other of two shared buffers after it, so those loads are in flight
// during the walk.  K is a template parameter (8 K threads a block).
// A second small kernel (wkv6_bwd_reduce) sums du's per-(b, h) partials
// over b in a fixed order.  No atomics: two launches on the same inputs
// give bit-identical gradients.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;             // steps per chunk
constexpr int kCols = 8;              // value columns per thread
constexpr int kSlices = 8;            // threads per key row
constexpr int kDim = 64;              // K and V, padded on chip
constexpr int kMaxWarps = kDim * kSlices / 32;
constexpr int kMaxChunksOnChip = 8;
constexpr int kReduceThreads = 256;
// Shared floats besides the chunk starts: two chunks' r, k, w, v and dy
// rows, the chunk's dr, dk and dw rows, u, and the per-warp dv partials.
constexpr int kRow = kChunk * kDim;
constexpr int kInFloats = 5 * kRow;
constexpr int kFixedFloats = 2 * kInFloats + 3 * kRow + kDim +
                             kMaxWarps * kRow;
constexpr int kStartFloats = kDim * kDim;   // one chunk start, padded

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Eight consecutive shared floats (32-byte aligned) as two 16-byte loads.
__device__ __forceinline__ void load8(const float* p, float (&x)[kCols]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float slice_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// One thread's share of a chunk's rows, as loaded (the inputs' dtype):
// the chunk's 8 x K r, k and w values one each (row tid / K, key tid %
// K), and its 8 x 64 v and dy values (zero-padded past V) kV each.
template <typename T, int K>
struct Staged {
  static constexpr int kThreads = K * kSlices;
  static constexpr int kV = kChunk * kDim / kThreads;
  T r, k, w;
  T v[kV], dy[kV];
};

template <typename T, int K>
__device__ __forceinline__ void fetch(
    Staged<T, K>& st, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ dy, size_t base_k, size_t step_k, size_t base_v,
    size_t step_v, int t0, int len, int vd, bool with_r_dy) {
  const int tid = threadIdx.x;
  const int j = tid / K, i = tid % K;
  const size_t g = base_k + (size_t)(t0 + j) * step_k + i;
  const bool ok = j < len;
  st.k = ok ? k[g] : zero<T>();
  st.w = ok ? w[g] : zero<T>();
  st.r = (ok && with_r_dy) ? r[g] : zero<T>();
#pragma unroll
  for (int m = 0; m < Staged<T, K>::kV; ++m) {
    const int e = tid + m * Staged<T, K>::kThreads;
    const int jv = e / kDim, iv = e % kDim;
    const size_t gv = base_v + (size_t)(t0 + jv) * step_v + iv;
    const bool okv = jv < len && iv < vd;
    st.v[m] = okv ? v[gv] : zero<T>();
    st.dy[m] = (okv && with_r_dy) ? dy[gv] : zero<T>();
  }
}

// The staged values into a shared buffer [r | k | w | v | dy] of kRow
// floats each.
template <typename T, int K>
__device__ __forceinline__ void stage(const Staged<T, K>& st, float* buf) {
  const int tid = threadIdx.x;
  const int j = tid / K, i = tid % K;
  buf[j * kDim + i] = to_float(st.r);
  buf[kRow + j * kDim + i] = to_float(st.k);
  buf[2 * kRow + j * kDim + i] = to_float(st.w);
#pragma unroll
  for (int m = 0; m < Staged<T, K>::kV; ++m) {
    const int e = tid + m * Staged<T, K>::kThreads;
    buf[3 * kRow + e] = to_float(st.v[m]);
    buf[4 * kRow + e] = to_float(st.dy[m]);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(K * kSlices, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, const float* __restrict__ s0,
                const T* __restrict__ dy, const float* __restrict__ dsf,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ ds0,
                float* __restrict__ part_u, float* __restrict__ hc,
                int n_steps, int n_heads, int vd) {
  constexpr int kThreads = K * kSlices, kWarps = kThreads / 32;
  extern __shared__ float smem[];
  // Two chunks' inputs, [r | k | w | v | dy] each: chunk c's at
  // smem + (c & 1) * kInFloats.
  float* s_dr = smem + 2 * kInFloats;
  float* s_dk = s_dr + kRow;
  float* s_dw = s_dk + kRow;
  float* s_u = s_dw + kRow;
  float* s_dv = s_u + kDim;                   // [warp][j][v]
  float* s_starts = s_dv + kMaxWarps * kRow;  // [chunk][k][v], on chip

  const int bh = blockIdx.x;                  // b * H + h
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid / kSlices;              // key row
  const int c0 = (tid % kSlices) * kCols;     // first value column
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;
  const bool on_chip = hc == nullptr;

  const size_t step_k = (size_t)n_heads * K, step_v = (size_t)n_heads * vd;
  const size_t base_k = (size_t)b * n_steps * step_k + (size_t)h * K;
  const size_t base_v = (size_t)b * n_steps * step_v + (size_t)h * vd;
  const size_t st_base = ((size_t)bh * K + row) * vd;   // S[row, 0]
  if (tid < K) s_u[tid] = to_float(u[h * K + tid]);
  auto start_of = [&](int c) {
    return (on_chip ? s_starts + (size_t)c * kStartFloats
                    : hc + ((size_t)bh * n_chunks + c) * kStartFloats) +
           row * kDim + c0;
  };
  Staged<T, K> st;

  // 1. The forward walk, keeping every chunk's start (the last chunk's
  // end is not needed).
  float x[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    x[q] = (s0 != nullptr && c0 + q < vd) ? s0[st_base + c0 + q] : 0.f;
  if (n_chunks > 1) {
    fetch(st, r, k, v, w, dy, base_k, step_k, base_v, step_v, 0, kChunk, vd,
          false);
    stage(st, smem);
  }
  __syncthreads();
  for (int c = 0;; ++c) {
    float4* dst = reinterpret_cast<float4*>(start_of(c));
    dst[0] = make_float4(x[0], x[1], x[2], x[3]);
    dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    if (c == n_chunks - 1) break;
    const bool next = c + 1 < n_chunks - 1;
    if (next)
      fetch(st, r, k, v, w, dy, base_k, step_k, base_v, step_v,
            (c + 1) * kChunk, kChunk, vd, false);
    const float* in = smem + (c & 1) * kInFloats;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float kk = in[kRow + j * kDim + row];
      const float ww = in[2 * kRow + j * kDim + row];
      float vv[kCols];
      load8(in + 3 * kRow + j * kDim + c0, vv);
#pragma unroll
      for (int q = 0; q < kCols; ++q) x[q] = fmaf(ww, x[q], kk * vv[q]);
    }
    if (next) stage(st, smem + ((c + 1) & 1) * kInFloats);
    __syncthreads();
  }

  // 2. Chunks last to first.
  float g[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    g[q] = (dsf != nullptr && c0 + q < vd) ? dsf[st_base + c0 + q] : 0.f;
  float du_acc = 0.f;
  // This lane's two dv columns after the reduce-scatter (see below).
  const int q_dv = ((lane & 16) ? 4 : 0) + ((lane & 8) ? 2 : 0);
  {
    const int t0 = (n_chunks - 1) * kChunk;
    fetch(st, r, k, v, w, dy, base_k, step_k, base_v, step_v, t0,
          n_steps - t0, vd, true);
    stage(st, smem + ((n_chunks - 1) & 1) * kInFloats);
  }
  __syncthreads();
  const float uu = s_u[row];
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, n_steps - t0);
    if (c > 0)
      fetch(st, r, k, v, w, dy, base_k, step_k, base_v, step_v,
            t0 - kChunk, kChunk, vd, true);
    const float* in = smem + (c & 1) * kInFloats;
    const float* s_r = in;
    const float* s_k = in + kRow;
    const float* s_w = in + 2 * kRow;
    const float* s_v = in + 3 * kRow;
    const float* s_dy = in + 4 * kRow;
    // The chunk's states S_{t-1}, t = t0 .. t0 + len - 1.
    const float4* src = reinterpret_cast<const float4*>(start_of(c));
    const float4 lo = src[0], hi = src[1];
    float sb[kChunk][kCols];
    sb[0][0] = lo.x; sb[0][1] = lo.y; sb[0][2] = lo.z; sb[0][3] = lo.w;
    sb[0][4] = hi.x; sb[0][5] = hi.y; sb[0][6] = hi.z; sb[0][7] = hi.w;
#pragma unroll
    for (int j = 1; j < kChunk; ++j) {
      const float kk = s_k[(j - 1) * kDim + row];
      const float ww = s_w[(j - 1) * kDim + row];
      float vv[kCols];
      load8(s_v + (j - 1) * kDim + c0, vv);
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        sb[j][q] = fmaf(ww, sb[j - 1][q], kk * vv[q]);
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j >= len) continue;      // uniform across the block
      float vv[kCols], yy[kCols];
      load8(s_v + j * kDim + c0, vv);
      load8(s_dy + j * kDim + c0, yy);
      const float rr = s_r[j * kDim + row], kk = s_k[j * kDim + row];
      const float ww = s_w[j * kDim + row];
      float gp = 0.f, d_r = 0.f, d_k = 0.f, d_w = 0.f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        gp = fmaf(yy[q], vv[q], gp);
        d_r = fmaf(sb[j][q], yy[q], d_r);
        d_k = fmaf(g[q], vv[q], d_k);
        d_w = fmaf(g[q], sb[j][q], d_w);
      }
      d_r = fmaf(uu * kk, gp, d_r);
      d_k = fmaf(uu * rr, gp, d_k);
      du_acc = fmaf(rr * kk, gp, du_acc);
      d_r = slice_sum(d_r);
      d_k = slice_sum(d_k);
      d_w = slice_sum(d_w);
      if (c0 == 0) {
        s_dr[j * kDim + row] = d_r;
        s_dk[j * kDim + row] = d_k;
        s_dw[j * kDim + row] = d_w;
      }
      // dv_t over the warp's four rows, k (G + (r u) dy): lanes xor 16
      // swap half of their eight columns, lanes xor 8 half of the rest;
      // each lane ends with columns q_dv, q_dv + 1 summed over the rows.
      float p[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) p[q] = kk * fmaf(rr * uu, yy[q], g[q]);
      {
        const bool upper = lane & 16;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float give = upper ? p[q] : p[q + 4];
          const float keep = upper ? p[q + 4] : p[q];
          p[q] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
        }
      }
      {
        const bool upper = lane & 8;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float give = upper ? p[q] : p[q + 2];
          const float keep = upper ? p[q + 2] : p[q];
          p[q] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
        }
      }
      *reinterpret_cast<float2*>(s_dv + (warp * kChunk + j) * kDim + c0 +
                                 q_dv) = make_float2(p[0], p[1]);
#pragma unroll
      for (int q = 0; q < kCols; ++q) g[q] = fmaf(ww, g[q], rr * yy[q]);
    }
    if (c > 0) stage(st, smem + ((c - 1) & 1) * kInFloats);
    __syncthreads();
    for (int e = tid; e < len * K; e += kThreads) {
      const int j = e / K, i = e % K;
      const size_t o = base_k + (size_t)(t0 + j) * step_k + i;
      store(dr + o, s_dr[j * kDim + i]);
      store(dk + o, s_dk[j * kDim + i]);
      store(dw + o, s_dw[j * kDim + i]);
    }
    for (int e = tid; e < len * vd; e += kThreads) {
      const int j = e / vd, i = e % vd;
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp)
        acc[wp & 1] += s_dv[(wp * kChunk + j) * kDim + i];
      store(dv + base_v + (size_t)(t0 + j) * step_v + i, acc[0] + acc[1]);
    }
    if (c > 0) __syncthreads();    // the rows are read before the next walk
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (c0 + q < vd) ds0[st_base + c0 + q] = g[q];
  }
  du_acc = slice_sum(du_acc);
  if (c0 == 0) part_u[(size_t)bh * K + row] = du_acc;
}

// du [H, K] = the [B, H, K] partials summed over b, in order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
wkv6_bwd_reduce(const float* __restrict__ part_u, T* __restrict__ du,
                int batch, int hk) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= hk) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc += part_u[(size_t)b * hk + e];
  store(du + e, acc);
}

int chunks_of(int n_steps) { return (n_steps + kChunk - 1) / kChunk; }
bool starts_on_chip(int n_steps) {
  return chunks_of(n_steps) <= kMaxChunksOnChip;
}
size_t smem_bytes(int n_steps) {
  return sizeof(float) *
         (kFixedFloats +
          (starts_on_chip(n_steps) ? (size_t)chunks_of(n_steps) : 0) *
              kStartFloats);
}

// The float32 scratch at these sizes: du's per-(b, h) partials, and the
// chunk starts [B * H, C, 64, 64] when they do not stay on chip.
size_t scratch_floats(int batch, int n_steps, int n_heads, int kd) {
  const size_t bh = (size_t)batch * n_heads;
  return bh * kd + (starts_on_chip(n_steps)
                        ? 0
                        : bh * chunks_of(n_steps) * kStartFloats);
}

// Lets the kernel take its largest dynamic shared memory (once).
template <typename T, int K>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) *
            (kFixedFloats + (size_t)kMaxChunksOnChip * kStartFloats)));
  return err;
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const float* s0,
                   const void* dy, const float* dsf, void* dr, void* dk,
                   void* dv, void* dw, void* du, float* ds0, float* scratch,
                   int batch, int n_steps, int n_heads, int vd,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem<T, K>();
  if (err != cudaSuccess) return err;
  const int n_bh = batch * n_heads;
  float* part_u = scratch;
  float* hc = starts_on_chip(n_steps) ? nullptr : scratch + (size_t)n_bh * K;
  wkv6_bwd_kernel<T, K><<<n_bh, K * kSlices, smem_bytes(n_steps), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<const T*>(dy), dsf,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), ds0, part_u, hc, n_steps, n_heads, vd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hk = n_heads * K;
  wkv6_bwd_reduce<T><<<(hk + kReduceThreads - 1) / kReduceThreads,
                       kReduceThreads, 0, stream>>>(
      part_u, static_cast<T*>(du), batch, hk);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t info(int n_steps, int* out) {
  cudaError_t err = allow_smem<T, K>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wkv6_bwd_kernel<T, K>);
  if (err != cudaSuccess) return err;
  const int bytes = (int)smem_bytes(n_steps);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wkv6_bwd_kernel<T, K>, K * kSlices, bytes);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = bytes;
  out[4] = starts_on_chip(n_steps);
  out[5] = kChunk;
  return err;
}

// launch<T, K> or info<T, K> at the key width kd (8, 16, 32 or 64).
#define WKV6_BWD_BY_K(kd, CALL)                        \
  switch (kd) {                                        \
    case 8: { constexpr int K = 8; return CALL; }      \
    case 16: { constexpr int K = 16; return CALL; }    \
    case 32: { constexpr int K = 32; return CALL; }    \
    case 64: { constexpr int K = 64; return CALL; }    \
    default: return cudaErrorInvalidValue;             \
  }

template <typename T>
cudaError_t launch_k(int kd, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const float* s0,
                     const void* dy, const float* dsf, void* dr, void* dk,
                     void* dv, void* dw, void* du, float* ds0,
                     float* scratch, int batch, int n_steps, int n_heads,
                     int vd, cudaStream_t stream) {
  WKV6_BWD_BY_K(kd, (launch<T, K>(r, k, v, w, u, s0, dy, dsf, dr, dk, dv,
                                  dw, du, ds0, scratch, batch, n_steps,
                                  n_heads, vd, stream)))
}

template <typename T>
cudaError_t info_k(int kd, int n_steps, int* out) {
  WKV6_BWD_BY_K(kd, (info<T, K>(n_steps, out)))
}

bool bad_sizes(int batch, int n_steps, int n_heads, int kd, int vd) {
  return batch <= 0 || n_steps <= 0 || n_heads <= 0 || vd <= 0 ||
         vd > kDim || (kd != 8 && kd != 16 && kd != 32 && kd != 64) ||
         (long long)batch * n_heads > 0x7fffffff;
}

}  // namespace

// r, k, w [B, S, H, K], v [B, S, H, V], u [H, K] as wkv6_launch takes
// them (one dtype: 0 = float32, 1 = bfloat16; contiguous), state_in [B,
// H, K, V] float32 or null (zeros), dy [B, S, H, V] in the inputs' dtype
// and dstate_final [B, H, K, V] float32 or null (zeros).  Writes dr, dk,
// dw [B, S, H, K], dv [B, S, H, V] and du [H, K] in the inputs' dtype,
// and dstate [B, H, K, V] float32 unless it is null.  K is 8, 16, 32 or
// 64 and V at most 64.  `scratch` holds the floats
// wkv6_bwd_scratch_floats reports.  Returns the cudaError_t of the
// launches.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* state_in, const void* dy,
                               const void* dstate_final, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* dstate,
                               void* scratch, int batch, int n_steps,
                               int n_heads, int kd, int vd, int dtype,
                               void* stream) {
  if (bad_sizes(batch, n_steps, n_heads, kd, vd) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(state_in);
  const float* dsf = static_cast<const float*>(dstate_final);
  float* ds0 = static_cast<float*>(dstate);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return (int)launch_k<float>(kd, r, k, v, w, u, s0, dy, dsf, dr, dk, dv,
                                  dw, du, ds0, sc, batch, n_steps, n_heads,
                                  vd, s);
    case 1:
      return (int)launch_k<__nv_bfloat16>(kd, r, k, v, w, u, s0, dy, dsf, dr,
                                          dk, dv, dw, du, ds0, sc, batch,
                                          n_steps, n_heads, vd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What the main kernel takes at K keys and S steps (dtype 0 = float32,
// 1 = bfloat16): out[0] registers a thread, out[1] local (spilled) bytes
// a thread, out[2] blocks resident on an SM, out[3] dynamic shared bytes
// a block, out[4] 1 if the chunk starts stay on chip, out[5] steps a
// chunk.  Returns the cudaError_t of the queries.
extern "C" int wkv6_bwd_info(int dtype, int kd, int n_steps, int* out) {
  if (bad_sizes(1, n_steps, 1, kd, 1) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)info_k<float>(kd, n_steps, out);
    case 1:
      return (int)info_k<__nv_bfloat16>(kd, n_steps, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The float32 scratch wkv6_bwd_launch takes at these sizes; -1 for sizes
// it refuses.
extern "C" long long wkv6_bwd_scratch_floats(int batch, int n_steps,
                                             int n_heads, int kd, int vd) {
  if (bad_sizes(batch, n_steps, n_heads, kd, vd)) return -1;
  return (long long)scratch_floats(batch, n_steps, n_heads, kd);
}
