// Selective (Mamba / S6) scan: hymba's SSM recurrence, its output at every
// step and the final state, per (batch row, channel).
//
// Replaces: src/repro/kernels/ssm_scan_pallas.py, ssm_scan_pallas
// (_ssm_kernel), the Pallas TPU kernel that runs the recurrence over a
// (batch, channel block) grid with the [channels, N] state in VMEM
// scratch for the whole sequence.
//
// What it computes, per (b, i), from h0[b, i, :] (zeros if absent):
//   h[n] <- exp(dt_t[i] * a[i, n]) * h[n] + dt_t[i] * u_t[i] * b_t[n]
//   y_t[i] = sum_n h[n] * c_t[n]
// for t = 0 .. S-1.  u and dt are [B, S, I], b and c [B, S, N], a [I, N]
// float32 (negative), h0 and the final state [B, I, N] float32; u, dt,
// b, c float32 or bfloat16 (all one dtype), y in that dtype; every input
// is cast to float32 and all arithmetic is float32, as in the reference.
// u, dt, a and h0 are contiguous; b and c may be column slices of one
// wider tensor (the model's x_proj output): their rows (b, t) sit ld_b /
// ld_c elements apart, their last dim contiguous.  The D skip and the
// silu(z) gate stay in the caller.
//
// What bounds it on an H100: bytes, then the exponentials.  Each input is
// read once, y written once, the state read (where carried) and written
// once: 11.7 MB for hymba's serve prefill (B 8, S 32, I 3200, N 16, zero
// state), 3.5 us at 3.35 TB/s; 3.8 MB (1.1 us) for one decode step,
// mostly the state in and out; 79 MB (24 us) for the long forward's
// B 1 x S 2048.  One exponential per state element and step: 105 M at
// B 1 x S 2048, ~28 us on the SFU pipes (16 a clock an SM), about the
// bytes' time.  In practice each step is a chain of ~8 instructions per
// state (the exponential, the update, the y term, the staged b and c)
// that the grid's warps must hide.  Every exponential is one SFU ex2 of
// dt * a * log2(e), a scaled once per thread; the library's expf and
// exp2f add range handling on the FMA pipe around that same instruction.
//
// Two instantiations; the wrapper (kernels/ssm_scan.py: ssm_impl,
// chunk_steps) picks one from S and B x I and passes its chunk length
// (0 = serial).  The chunked scan runs every exponential twice and three
// kernels, so it pays only where the serial grid leaves SMs idle: from S
// 128 while B x ceil(I / 128) <= 132 / 4, from S 512 while it is below
// 1.5 x 132.  At hymba's I 3200, measured on an NVIDIA H100 80GB HBM3 at
// 700.00 W by chip_smoke.py's ssm_crossover records (device ms, serial /
// chunked): B 1 S 96 0.0232 / 0.0237, S 128 0.0299 / 0.0230, S 2048
// 0.610 / 0.128; B 2 S 128 0.0301 / 0.0309, S 512 0.156 / 0.071; B 6
// S 512 0.195 / 0.166; B 8 S 512 0.202 / 0.212, S 2048 0.775 / 0.771.
//
// serial (ssm_scan_kernel), for short S (a decode step, S 1; hymba's
// prefill, S 32) and for batches whose grid covers the card: one thread
// per (b, channel i) keeps its N <= 16 states and its row of a in
// registers for the whole sequence; a block covers 128 channels of one
// batch row (grid: I / 128 x B).  The state slab of a block (128 x N
// contiguous floats) and its rows of a move through shared memory so
// that device memory sees coalesced reads and writes.  Steps are staged
// 32 at a time: b_t and c_t (shared by every channel of the block) and u,
// dt (read coalesced across i) into shared memory, so a chunk's loads are
// all in flight before its dependent chain starts; y is written coalesced
// as soon as it is known.  h0 == null reads nothing.  Time is the one
// axis its grid never splits: at B 1 x I 3200 that is 25 blocks on 132
// SMs, each walking all S steps.
//
// chunked (three kernels, one call), for long S: the recurrence over a
// chunk of steps composes into
//   h_end = exp(a * sum_chunk dt) * h_start + h_end_local,
// where h_end_local is the chunk's end state from a zero start.  So:
//   1. ssm_scan_chunk_state: every chunk but the last, in parallel, runs
//      from zero and writes its local end state [N] and its sum of dt per
//      channel to scratch;
//   2. ssm_scan_chunk_carry: one thread per (b, i, n) walks the chunks in
//      order from h0 (or zero) and turns each local end state into the
//      true start state of the next chunk, in place;
//   3. ssm_scan_chunk_emit: every chunk, in parallel, re-runs from its
//      true start state and writes y; the last chunk writes h_final.
// Passes 1 and 3 run a grid of I / 128 x chunks x B blocks of 128
// threads, a thread per (b, channel, chunk) with its N states in
// registers; a warp reads u and dt along I, coalesced, straight from
// device memory (a variant that prefetched them into registers ahead of
// the chain used more registers and was no faster), and a chunk's b_t and
// c_t rows are staged
// in shared memory.  Chunks are 64 steps, or 32 where 64 would give fewer
// than about three blocks an SM: at B 1 x S 2048 x I 3200 that is 800
// blocks, against the serial kernel's 25.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kMaxN = 16;       // state size (hymba: 16)
constexpr int kStage = 32;      // steps staged per pass (serial)
constexpr int kMaxChunkSteps = 64;   // most steps per chunk (chunked)
constexpr int kCarryThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: about 2 ulp; results below 2^-126
// flush to 0).  The library's exp2f / expf add range handling around the
// same instruction that costs the chunked scan ~40 % of its time.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One staged row of b_t or c_t (kMaxN floats, 16-byte aligned) into
// registers by 16-byte shared loads.
__device__ __forceinline__ void load_row(float (&v)[kMaxN],
                                         const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < kMaxN / 4; ++q) {
    const float4 t = r[q];
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
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
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const T* __restrict__ bt, const T* __restrict__ ct,
                const float* __restrict__ a, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hf, int n_steps,
                int inner, int n, int ld_b, int ld_c) {
  __shared__ __align__(16) float s_b[kStage][kMaxN];
  __shared__ __align__(16) float s_c[kStage][kMaxN];
  __shared__ float s_u[kStage][kThreads];
  __shared__ float s_dt[kStage][kThreads];
  __shared__ float s_slab[kThreads][kMaxN + 1];   // a rows, then states

  const int b = blockIdx.y, i0 = blockIdx.x * kThreads, tid = threadIdx.x;
  const int i = i0 + tid;
  const bool owns = i < inner;
  const int n_ch = min(kThreads, inner - i0);
  const size_t slab = ((size_t)b * inner + i0) * n;   // h0 / hf block

  float av[kMaxN], h[kMaxN];
  for (int e = tid; e < n_ch * n; e += kThreads)
    s_slab[e / n][e % n] = a[(size_t)i0 * n + e];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    av[j] = (owns && j < n) ? s_slab[tid][j] * kLog2e : 0.f;
  __syncthreads();
  if (h0 != nullptr) {
    for (int e = tid; e < n_ch * n; e += kThreads)
      s_slab[e / n][e % n] = h0[slab + e];
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    h[j] = (h0 != nullptr && owns && j < n) ? s_slab[tid][j] : 0.f;

  const size_t row0 = (size_t)b * n_steps;   // time row of (b, t = 0)
  for (int t0 = 0; t0 < n_steps; t0 += kStage) {
    const int len = min(kStage, n_steps - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int e = tid; e < len * n; e += kThreads) {
      const size_t r = row0 + t0 + e / n;
      s_b[e / n][e % n] = to_float(bt[r * ld_b + e % n]);
      s_c[e / n][e % n] = to_float(ct[r * ld_c + e % n]);
    }
    if (owns) {
      for (int j = 0; j < len; ++j) {
        const size_t g = (row0 + t0 + j) * inner + i;
        s_u[j][tid] = to_float(u[g]);
        s_dt[j][tid] = to_float(dt[g]);
      }
    }
    __syncthreads();
    if (!owns) continue;
    for (int j = 0; j < len; ++j) {
      const float d = s_dt[j][tid];
      const float du = d * s_u[j][tid];
      float bv[kMaxN], cv[kMaxN];
      load_row(bv, s_b[j]);
      load_row(cv, s_c[j]);
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxN; ++m) {
        if (m < n) {
          h[m] = exp2_sfu(d * av[m]) * h[m] + du * bv[m];
          acc = fmaf(h[m], cv[m], acc);
        }
      }
      store(y + (row0 + t0 + j) * inner + i, acc);
    }
  }

  __syncthreads();
  if (owns) {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < n) s_slab[tid][j] = h[j];
  }
  __syncthreads();
  for (int e = tid; e < n_ch * n; e += kThreads)
    hf[slab + e] = s_slab[e / n][e % n];
}

// Stage `len` rows of one [B, S, N] operand (row stride ld) from time row
// `row` on, as float32, into s[len][kMaxN].
template <typename T>
__device__ __forceinline__ void stage_rows(float (*s)[kMaxN],
                                           const T* __restrict__ src,
                                           size_t row, int len, int n,
                                           int ld) {
  for (int e = threadIdx.x; e < len * n; e += blockDim.x)
    s[e / n][e % n] = to_float(src[(row + e / n) * ld + e % n]);
}

// Scratch layout (float32): the local end states hl [B, C-1, I, N], then
// the chunks' sums of dt sd [B, C-1, I], for chunks c = 0 .. C-2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_chunk_state(const T* __restrict__ u, const T* __restrict__ dt,
                     const T* __restrict__ bt, const float* __restrict__ a,
                     float* __restrict__ hl, float* __restrict__ sd,
                     int n_steps, int inner, int n, int ld_b, int chunk,
                     int n_carry) {
  __shared__ __align__(16) float s_b[kMaxChunkSteps][kMaxN];
  const int c = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = (size_t)b * n_steps + (size_t)c * chunk;
  stage_rows(s_b, bt, row, chunk, n, ld_b);   // chunks but the last: full
  __syncthreads();
  if (i >= inner) return;
  float al[kMaxN], h[kMaxN];
#pragma unroll
  for (int m = 0; m < kMaxN; ++m) {
    al[m] = m < n ? a[(size_t)i * n + m] * kLog2e : 0.f;
    h[m] = 0.f;
  }
  const T* up = u + row * inner + i;
  const T* dp = dt + row * inner + i;
  float sum = 0.f;
#pragma unroll 4
  for (int j = 0; j < chunk; ++j) {
    const float d = to_float(dp[(size_t)j * inner]);
    const float du = d * to_float(up[(size_t)j * inner]);
    sum += d;
    float bv[kMaxN];
    load_row(bv, s_b[j]);
#pragma unroll
    for (int m = 0; m < kMaxN; ++m)
      if (m < n) h[m] = exp2_sfu(d * al[m]) * h[m] + du * bv[m];
  }
  const size_t g = ((size_t)b * n_carry + c) * inner + i;
#pragma unroll
  for (int m = 0; m < kMaxN; ++m)
    if (m < n) hl[g * n + m] = h[m];
  sd[g] = sum;
}

// One thread per (b, i, n): hl[b, c] becomes the true start state of
// chunk c + 1, from h0 (or zero) through the chunks in order.
__global__ void __launch_bounds__(kCarryThreads)
ssm_scan_chunk_carry(const float* __restrict__ a,
                     const float* __restrict__ h0, float* __restrict__ hl,
                     const float* __restrict__ sd, int batch, int inner,
                     int n, int n_carry) {
  const size_t e = (size_t)blockIdx.x * kCarryThreads + threadIdx.x;
  if (e >= (size_t)batch * inner * n) return;
  const int m = (int)(e % n);
  const size_t bi = e / n;
  const int i = (int)(bi % inner), b = (int)(bi / inner);
  const float al = a[(size_t)i * n + m] * kLog2e;
  float carry = h0 != nullptr ? h0[e] : 0.f;
  for (int c = 0; c < n_carry; ++c) {
    const size_t g = ((size_t)b * n_carry + c) * inner + i;
    carry = exp2_sfu(al * sd[g]) * carry + hl[g * n + m];
    hl[g * n + m] = carry;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_chunk_emit(const T* __restrict__ u, const T* __restrict__ dt,
                    const T* __restrict__ bt, const T* __restrict__ ct,
                    const float* __restrict__ a,
                    const float* __restrict__ h0,
                    const float* __restrict__ hl, T* __restrict__ y,
                    float* __restrict__ hf, int n_steps, int inner, int n,
                    int ld_b, int ld_c, int chunk, int n_carry) {
  __shared__ __align__(16) float s_b[kMaxChunkSteps][kMaxN];
  __shared__ __align__(16) float s_c[kMaxChunkSteps][kMaxN];
  const int c = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int len = min(chunk, n_steps - c * chunk);
  const size_t row = (size_t)b * n_steps + (size_t)c * chunk;
  stage_rows(s_b, bt, row, len, n, ld_b);
  stage_rows(s_c, ct, row, len, n, ld_c);
  __syncthreads();
  if (i >= inner) return;
  // Start state: h0 (or zero) for chunk 0, else the carry pass's.
  const float* start =
      c == 0 ? (h0 != nullptr ? h0 + ((size_t)b * inner + i) * n : nullptr)
             : hl + (((size_t)b * n_carry + c - 1) * inner + i) * n;
  float al[kMaxN], h[kMaxN];
#pragma unroll
  for (int m = 0; m < kMaxN; ++m) {
    al[m] = m < n ? a[(size_t)i * n + m] * kLog2e : 0.f;
    h[m] = (start != nullptr && m < n) ? start[m] : 0.f;
  }
  const T* up = u + row * inner + i;
  const T* dp = dt + row * inner + i;
  T* yp = y + row * inner + i;
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    const float d = to_float(dp[(size_t)j * inner]);
    const float du = d * to_float(up[(size_t)j * inner]);
    float bv[kMaxN], cv[kMaxN];
    load_row(bv, s_b[j]);
    load_row(cv, s_c[j]);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < n) {
        h[m] = exp2_sfu(d * al[m]) * h[m] + du * bv[m];
        acc = fmaf(h[m], cv[m], acc);
      }
    }
    store(yp + (size_t)j * inner, acc);
  }
  if (c == n_carry) {   // the last chunk
    float* out = hf + ((size_t)b * inner + i) * n;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m)
      if (m < n) out[m] = h[m];
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* bt,
                   const void* ct, const float* a, const float* h0, void* y,
                   float* hf, float* scratch, int batch, int n_steps,
                   int inner, int n, int ld_b, int ld_c, int chunk,
                   cudaStream_t stream) {
  const T* ut = static_cast<const T*>(u);
  const T* dtt = static_cast<const T*>(dt);
  const T* btt = static_cast<const T*>(bt);
  const T* ctt = static_cast<const T*>(ct);
  T* yt = static_cast<T*>(y);
  const int tiles = (inner + kThreads - 1) / kThreads;
  if (chunk == 0) {
    ssm_scan_kernel<T><<<dim3(tiles, batch), kThreads, 0, stream>>>(
        ut, dtt, btt, ctt, a, h0, yt, hf, n_steps, inner, n, ld_b, ld_c);
    return cudaGetLastError();
  }
  const int n_chunks = (n_steps + chunk - 1) / chunk, n_carry = n_chunks - 1;
  float* hl = scratch;
  float* sd = scratch + (size_t)batch * n_carry * inner * n;
  if (n_carry > 0) {
    ssm_scan_chunk_state<T><<<dim3(tiles, n_carry, batch), kThreads, 0,
                              stream>>>(ut, dtt, btt, a, hl, sd, n_steps,
                                        inner, n, ld_b, chunk, n_carry);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t cells = (size_t)batch * inner * n;
    ssm_scan_chunk_carry<<<(unsigned)((cells + kCarryThreads - 1) /
                                      kCarryThreads),
                           kCarryThreads, 0, stream>>>(a, h0, hl, sd, batch,
                                                       inner, n, n_carry);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssm_scan_chunk_emit<T><<<dim3(tiles, n_chunks, batch), kThreads, 0,
                           stream>>>(ut, dtt, btt, ctt, a, h0, hl, yt, hf,
                                     n_steps, inner, n, ld_b, ld_c, chunk,
                                     n_carry);
  return cudaGetLastError();
}

}  // namespace

// u, dt [B, S, I] contiguous, b_t, c_t [B, S, N] with rows ld_b / ld_c
// apart (>= N) and a contiguous last dim; one dtype (0 = float32, 1 =
// bfloat16); a [I, N] float32; h0 [B, I, N] float32 or null (zeros).  y
// [B, S, I] in the inputs' dtype and h_final [B, I, N] float32 are
// written.  N is at most 16.  chunk 0 runs the serial kernel; chunk in
// 1 .. 64 the chunked one, with `scratch` holding at least
// B * (ceil(S / chunk) - 1) * I * (N + 1) floats (null when that is 0).
// Returns the cudaError_t of the launches.
extern "C" int ssm_scan_launch(const void* u, const void* dt, const void* bt,
                               const void* ct, const void* a, const void* h0,
                               void* y, void* h_final, void* scratch,
                               int batch, int n_steps, int inner, int n,
                               int ld_b, int ld_c, int chunk, int dtype,
                               void* stream) {
  if (batch <= 0 || batch > 65535 || n_steps <= 0 || inner <= 0 || n <= 0 ||
      n > kMaxN || ld_b < n || ld_c < n || chunk < 0 ||
      chunk > kMaxChunkSteps ||
      (chunk > 0 && (n_steps + chunk - 1) / chunk > 65535) ||
      (chunk > 0 && n_steps > chunk && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return (int)launch<float>(u, dt, bt, ct, af, h0f, y, hf, sc, batch,
                                n_steps, inner, n, ld_b, ld_c, chunk, s);
    case 1:
      return (int)launch<__nv_bfloat16>(u, dt, bt, ct, af, h0f, y, hf, sc,
                                        batch, n_steps, inner, n, ld_b, ld_c,
                                        chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
