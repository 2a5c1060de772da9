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
// What bounds it on an H100: bytes.  u, dt and dy are read (u and dt twice,
// for the state walk and the reverse walk; L2 serves much of the second),
// du and ddt written: 5 x B S I elements, 164 MB float32 at the learner's
// B 64 x S 40 x I 3200, 49 us at 3.35 TB/s.  Each step costs one
// exponential per state element on the reverse walk's recompute and one on
// the state walk (131 M each at that shape), ~20 us each on the SFU pipes.
//
// Design: one thread per (b, channel i, state slot n), so a thread's state
// is one register and the recurrence over a chunk of kChunk = 16 steps fits
// in registers.  A block covers 32 channels x 16 slots of one batch row
// (slots n >= N idle and add zero).  Three steps inside the main kernel:
//   1. a forward walk from h0 writes the state at the start of every chunk
//      but the first to scratch (hc [B, C-1, I, N]);
//   2. chunks are taken last to first: the thread recomputes its chunk's
//      16 states and decays into registers from the chunk's start state,
//      then walks the chunk in reverse, carrying e_t g_t;
//   3. sums: over n (du, ddt) by shuffles across the 16 lanes of a channel;
//      over i (db, dc) by a shuffle across the warp's two channels, then
//      across the block's 16 warps through shared memory once a chunk, into
//      per-block partials [tiles, B, S, N]; da accumulates over t in a
//      register and lands in a [B, I, N] partial.
// A second small kernel (ssm_scan_bwd_reduce) sums the partials over the
// channel tiles (db, dc, in the inputs' dtype) and over b (da), in a fixed
// order, so the result is deterministic.  No atomics.  A simple design: the
// time axis is walked twice and never split across threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;                     // state slots (N <= 16)
constexpr int kChannels = 32;                  // channels per block
constexpr int kThreads = kLanes * kChannels;   // 512
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                     // steps kept in registers
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
                    int ld_b, int ld_c) {
  __shared__ float s_red[2][kChunk][kWarps][kLanes];   // db, dc per warp

  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / 32;
  const int b = blockIdx.y, tile = blockIdx.x, batch = gridDim.y;
  const int i = tile * kChannels + tid / kLanes;
  const bool ch = i < inner;               // a real channel
  const bool owns = ch && lane < n;        // a real (channel, slot)
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;
  const float a_n = owns ? a[(size_t)i * n + lane] : 0.f;
  const float al = a_n * kLog2e;
  const size_t cell = ((size_t)b * inner + i) * n + lane;   // [B, I, N]
  const float start0 = (owns && h0 != nullptr) ? h0[cell] : 0.f;
  const size_t row0 = (size_t)b * n_steps;
  // hc [B, C-1, I, N]: the state at the start of chunk c >= 1.
  auto hc_at = [&](int c) {
    return hc + (((size_t)b * (n_chunks - 1) + c - 1) * inner + i) * n + lane;
  };

  // 1. The state walk: chunk-start states.
  float h = start0;
  for (int c = 1; c < n_chunks; ++c) {
    for (int t = (c - 1) * kChunk; t < c * kChunk; ++t) {
      const size_t r = row0 + t;
      const float d = ch ? to_float(dt[r * inner + i]) : 0.f;
      const float uu = ch ? to_float(u[r * inner + i]) : 0.f;
      const float bb = owns ? to_float(bt[r * ld_b + lane]) : 0.f;
      h = exp2_sfu(d * al) * h + d * uu * bb;
    }
    if (owns) *hc_at(c) = h;
  }

  // 2. Chunks last to first.
  float carry = (owns && dhf != nullptr) ? dhf[cell] : 0.f;   // e_{t+1} g_{t+1}
  float da_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, n_steps - t0);
    const float start = c == 0 ? start0 : (owns ? *hc_at(c) : 0.f);
    float hs[kChunk], es[kChunk];
    float hh = start;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < len) {
        const size_t r = row0 + t0 + j;
        const float d = ch ? to_float(dt[r * inner + i]) : 0.f;
        const float uu = ch ? to_float(u[r * inner + i]) : 0.f;
        const float bb = owns ? to_float(bt[r * ld_b + lane]) : 0.f;
        es[j] = exp2_sfu(d * al);
        hh = es[j] * hh + d * uu * bb;
        hs[j] = hh;
      }
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < len) {   // len is the block's: every thread takes this branch
        const size_t r = row0 + t0 + j;
        const float d = ch ? to_float(dt[r * inner + i]) : 0.f;
        const float uu = ch ? to_float(u[r * inner + i]) : 0.f;
        const float dyv = ch ? to_float(dy[r * inner + i]) : 0.f;
        const float bb = owns ? to_float(bt[r * ld_b + lane]) : 0.f;
        const float cc = owns ? to_float(ct[r * ld_c + lane]) : 0.f;
        const float e = es[j];
        const float hp = j > 0 ? hs[j - 1] : start;
        const float g = cc * dyv + carry;
        float pu = g * bb;
        float pt = g * (a_n * e * hp + bb * uu);
        float pb = g * d * uu;
        float pc = dyv * hs[j];
        da_acc += g * d * e * hp;
        carry = e * g;
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {   // over n
          pu += __shfl_xor_sync(0xffffffffu, pu, off);
          pt += __shfl_xor_sync(0xffffffffu, pt, off);
        }
        if (lane == 0 && ch) {
          store(du + r * inner + i, d * pu);
          store(ddt + r * inner + i, pt);
        }
        pb += __shfl_xor_sync(0xffffffffu, pb, 16);   // the warp's 2 channels
        pc += __shfl_xor_sync(0xffffffffu, pc, 16);
        if ((tid & 31) < kLanes) {
          s_red[0][j][warp][lane] = pb;
          s_red[1][j][warp][lane] = pc;
        }
      }
    }
    __syncthreads();
    // The chunk's db, dc over the block's channels: one partial per
    // (tile, b, t, n), warps summed in order.
    for (int e = tid; e < 2 * len * kLanes; e += kThreads) {
      const int which = e / (len * kLanes), j = (e / kLanes) % len,
                m = e % kLanes;
      if (m >= n) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_red[which][j][w][m];
      float* part = which == 0 ? part_b : part_c;
      part[(((size_t)tile * batch + b) * n_steps + t0 + j) * n + m] = sum;
    }
    __syncthreads();   // s_red is free for the next chunk
  }
  if (owns) {
    if (dh0 != nullptr) dh0[cell] = carry;   // e_0 g_0
    part_a[cell] = da_acc;
  }
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
    float sb = 0.f, sc = 0.f;
    for (int t = 0; t < tiles; ++t) {
      sb += part_b[(size_t)t * bsn + e];
      sc += part_c[(size_t)t * bsn + e];
    }
    store(db + e, sb);
    store(dc + e, sc);
  } else if (e < bsn + in) {
    const size_t f = e - bsn;
    float s = 0.f;
    for (int bb = 0; bb < batch; ++bb) s += part_a[(size_t)bb * in + f];
    da[f] = s;
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* bt,
                   const void* ct, const float* a, const float* h0,
                   const void* dy, const float* dhf, void* du, void* ddt,
                   void* db, void* dc, float* da, float* dh0, float* scratch,
                   int batch, int n_steps, int inner, int n, int ld_b,
                   int ld_c, cudaStream_t stream) {
  const int tiles = (inner + kChannels - 1) / kChannels;
  const int n_chunks = (n_steps + kChunk - 1) / kChunk;
  const size_t bsn = (size_t)batch * n_steps * n;
  float* part_b = scratch;
  float* part_c = part_b + (size_t)tiles * bsn;
  float* part_a = part_c + (size_t)tiles * bsn;
  float* hc = part_a + (size_t)batch * inner * n;
  ssm_scan_bwd_kernel<T><<<dim3(tiles, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const T*>(bt), static_cast<const T*>(ct), a, h0,
      static_cast<const T*>(dy), dhf, static_cast<T*>(du),
      static_cast<T*>(ddt), dh0, part_b, part_c, part_a,
      n_chunks > 1 ? hc : nullptr, n_steps, inner, n, ld_b, ld_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t cells = bsn + (size_t)inner * n;
  ssm_scan_bwd_reduce<T><<<(unsigned)((cells + kReduceThreads - 1) /
                                      kReduceThreads),
                           kReduceThreads, 0, stream>>>(
      part_b, part_c, part_a, static_cast<T*>(db), static_cast<T*>(dc), da,
      tiles, batch, n_steps, inner, n);
  return cudaGetLastError();
}

}  // namespace

// Inputs as ssm_scan_launch takes them, plus dy [B, S, I] (the inputs'
// dtype, contiguous) and dhf [B, I, N] float32 or null (zeros).  Writes du,
// ddt [B, S, I] and db, dc [B, S, N] (contiguous, the inputs' dtype), da
// [I, N] float32, and dh0 [B, I, N] float32 unless it is null.  `scratch`
// holds at least 2 x ceil(I / 32) x B x S x N + B x I x N +
// B x (ceil(S / 16) - 1) x I x N floats (kernels/ssm_scan.py:
// bwd_scratch_floats).  Returns the cudaError_t of the launches.
extern "C" int ssm_scan_bwd_launch(const void* u, const void* dt,
                                   const void* bt, const void* ct,
                                   const void* a, const void* h0,
                                   const void* dy, const void* dhf, void* du,
                                   void* ddt, void* db, void* dc, void* da,
                                   void* dh0, void* scratch, int batch,
                                   int n_steps, int inner, int n, int ld_b,
                                   int ld_c, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || n_steps <= 0 || inner <= 0 || n <= 0 ||
      n > kLanes || ld_b < n || ld_c < n || scratch == nullptr)
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
