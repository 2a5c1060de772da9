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
// The D skip and the silu(z) gate stay in the caller.
//
// What bounds it on an H100: bytes.  Each input is read once, y written
// once, the state read (where carried) and written once: 11.7 MB for
// hymba's serve prefill (B 8, S 32, I 3200, N 16, zero state), 3.5 us at
// 3.35 TB/s, and 3.8 MB (1.1 us) for one decode step, mostly the state
// in and out.  About 7 operations per state element and step, far below
// the float32 peak.  The practical limit is latency: a step is some 200
// instructions per thread (N exponentials, the updates, an N-term sum)
// and one thread per channel gives hymba's widths 200 blocks of 4 warps,
// about 6 warps an SM, too few to hide them.  Splitting a channel's
// states over several threads is the redesign.
//
// Design: one thread per (b, channel i) keeps its N <= 16 states and its
// row of a in registers for the whole sequence; a block covers 128
// channels of one batch row (grid: I / 128 x B).  The state slab of a
// block (128 x N contiguous floats) and its rows of a are moved through
// shared memory so that device memory sees coalesced reads and writes.
// Steps are staged 32 at a time: b_t and c_t (shared by every channel of
// the block) and u, dt (read coalesced across i) into shared memory, so
// a chunk's loads are all in flight before its dependent chain starts;
// y is written coalesced as soon as it is known.  h0 == null reads
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kMaxN = 16;       // state size (hymba: 16)
constexpr int kChunk = 32;      // steps staged per pass

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
                int inner, int n) {
  __shared__ float s_b[kChunk][kMaxN];
  __shared__ float s_c[kChunk][kMaxN];
  __shared__ float s_u[kChunk][kThreads];
  __shared__ float s_dt[kChunk][kThreads];
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
    av[j] = (owns && j < n) ? s_slab[tid][j] : 0.f;
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
  for (int t0 = 0; t0 < n_steps; t0 += kChunk) {
    const int len = min(kChunk, n_steps - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int e = tid; e < len * n; e += kThreads) {
      const size_t g = (row0 + t0) * n + e;
      s_b[e / n][e % n] = to_float(bt[g]);
      s_c[e / n][e % n] = to_float(ct[g]);
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
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxN; ++m) {
        if (m < n) {
          h[m] = expf(d * av[m]) * h[m] + du * s_b[j][m];
          acc = fmaf(h[m], s_c[j][m], acc);
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

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* bt,
                   const void* ct, const float* a, const float* h0, void* y,
                   float* hf, int batch, int n_steps, int inner, int n,
                   cudaStream_t stream) {
  dim3 grid((inner + kThreads - 1) / kThreads, batch);
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const T*>(bt), static_cast<const T*>(ct), a, h0,
      static_cast<T*>(y), hf, n_steps, inner, n);
  return cudaGetLastError();
}

}  // namespace

// u, dt [B, S, I], b_t, c_t [B, S, N]: contiguous, one dtype (0 =
// float32, 1 = bfloat16); a [I, N] float32; h0 [B, I, N] float32 or null
// (zeros).  y [B, S, I] in the inputs' dtype and h_final [B, I, N]
// float32 are written.  N is at most 16.  Returns the cudaError_t of the
// launch.
extern "C" int ssm_scan_launch(const void* u, const void* dt, const void* bt,
                               const void* ct, const void* a, const void* h0,
                               void* y, void* h_final, int batch,
                               int n_steps, int inner, int n, int dtype,
                               void* stream) {
  if (batch <= 0 || batch > 65535 || n_steps <= 0 || inner <= 0 || n <= 0 ||
      n > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  switch (dtype) {
    case 0:
      return (int)launch<float>(u, dt, bt, ct, af, h0f, y, hf, batch,
                                n_steps, inner, n, s);
    case 1:
      return (int)launch<__nv_bfloat16>(u, dt, bt, ct, af, h0f, y, hf, batch,
                                        n_steps, inner, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
