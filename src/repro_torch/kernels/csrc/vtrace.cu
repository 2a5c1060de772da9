// V-trace targets and realigned advantages (paper Eqs. 14-15) in one
// backward sweep over time.
//
// Replaces: src/repro/kernels/vtrace_pallas.py, vtrace_pallas
// (_vtrace_kernel), the Pallas TPU kernel that keeps a [8, T] tile of
// each input in VMEM and runs the backward recurrence with its carry in
// vector registers, one grid step per 8 trajectories.
//
// What it computes, per trajectory b and step t (V_T and vs_T are the
// bootstrap value):
//   ratio = exp(log_ratio), rho = min(rho_bar, ratio),
//   c = lam * min(c_bar, ratio),
//   delta_t = rho_t * (r_t + d_t * V_{t+1} - V_t),
//   acc_t = delta_t + d_t * c_t * acc_{t+1},   vs_t = V_t + acc_t,
//   adv_t = r_t + d_t * vs_{t+1} - V_t,
// float32 arithmetic from float32 or bfloat16 inputs, float32 outputs.
//
// What bounds it on an H100: its bytes are few, four [B, T] inputs and
// the bootstrap read once and two [B, T] float32 outputs written once,
// 12.0 MB at the paper's B = 500, T = 1000 in float32, 3.6 us at 3.35
// TB/s.  The real limit is latency: acc is a chain of T dependent
// multiply-adds per trajectory, and B = 500 trajectories fill only 16
// warps of a 132-SM card.
//
// Design: one block per 32 trajectories; time is swept backwards in
// chunks of 32 steps.  Every input element is read once, along t by
// consecutive threads (a thread per row would read [B, T] row-major
// memory with a stride of T), and staged in shared memory with the
// parts that need no carry already computed there: rho_t * (...) and
// d_t * c_t.  One thread per trajectory then runs the chunk's 32
// dependent steps out of shared memory (rows padded to 33 words, so the
// 32 threads hit 32 banks), and all 128 threads compute the advantages
// and write both outputs back along t.  The carries from one chunk to
// the next (acc, V and vs of the chunk's first step) stay in registers
// and shared memory.  Any B >= 1 and T >= 1; ragged edges are masked.
// A parallel scan over t ((a, b) pairs of acc -> a + b * acc compose
// associatively) would shorten the chain; that is for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;            // trajectories per block
constexpr int kChunk = 32;           // time steps staged per pass
constexpr int kThreads = 128;
constexpr int kPitch = kChunk + 1;   // row padding against bank conflicts

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const T* __restrict__ log_ratios, const T* __restrict__ values,
              const T* __restrict__ bootstrap, const T* __restrict__ rewards,
              const T* __restrict__ discounts, float* __restrict__ vs_out,
              float* __restrict__ adv_out, int n_rows, int n_steps,
              float rho_bar, float c_bar, float lam) {
  __shared__ float s_val[kRows][kPitch];
  __shared__ float s_rew[kRows][kPitch];
  __shared__ float s_disc[kRows][kPitch];
  __shared__ float s_delta[kRows][kPitch];  // rho, then delta
  __shared__ float s_dc[kRows][kPitch];     // d * c
  __shared__ float s_vs[kRows][kPitch];
  __shared__ float s_v_next[kRows];   // V one step right of the chunk
  __shared__ float s_vs_next[kRows];  // vs one step right of the chunk

  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const bool sweeps = tid < kRows && row0 + tid < n_rows;
  if (tid < kRows) {
    const float boot = sweeps ? to_float(bootstrap[row0 + tid]) : 0.f;
    s_v_next[tid] = boot;
    s_vs_next[tid] = boot;
  }
  float acc = 0.f;   // the sweeping thread's acc_{t+1}
  for (int t0 = ((n_steps - 1) / kChunk) * kChunk; t0 >= 0; t0 -= kChunk) {
    const int len = min(kChunk, n_steps - t0);
    __syncthreads();   // the previous chunk's tiles are read, carries set
    // 1. Stage the chunk along t, with rho and d * c.
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk, j = e % kChunk, row = row0 + r;
      if (row < n_rows && j < len) {
        const size_t g = (size_t)row * n_steps + t0 + j;
        const float ratio = expf(to_float(log_ratios[g]));
        const float d = to_float(discounts[g]);
        s_val[r][j] = to_float(values[g]);
        s_rew[r][j] = to_float(rewards[g]);
        s_disc[r][j] = d;
        s_delta[r][j] = fminf(rho_bar, ratio);
        s_dc[r][j] = d * (lam * fminf(c_bar, ratio));
      }
    }
    __syncthreads();
    // 2. delta_t = rho_t * (r_t + d_t * V_{t+1} - V_t).
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk, j = e % kChunk;
      if (row0 + r < n_rows && j < len) {
        const float v_tp1 = j + 1 < len ? s_val[r][j + 1] : s_v_next[r];
        s_delta[r][j] *= s_rew[r][j] + s_disc[r][j] * v_tp1 - s_val[r][j];
      }
    }
    __syncthreads();
    // 3. The dependent chain, one thread per trajectory.
    if (sweeps) {
#pragma unroll 8
      for (int j = len - 1; j >= 0; --j) {
        acc = s_delta[tid][j] + s_dc[tid][j] * acc;
        s_vs[tid][j] = s_val[tid][j] + acc;
      }
    }
    __syncthreads();
    // 4. adv_t = r_t + d_t * vs_{t+1} - V_t; both outputs along t.
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk, j = e % kChunk, row = row0 + r;
      if (row < n_rows && j < len) {
        const float vs = s_vs[r][j];
        const float vs_tp1 = j + 1 < len ? s_vs[r][j + 1] : s_vs_next[r];
        const size_t g = (size_t)row * n_steps + t0 + j;
        vs_out[g] = vs;
        adv_out[g] = s_rew[r][j] + s_disc[r][j] * vs_tp1 - s_val[r][j];
      }
    }
    __syncthreads();
    if (sweeps) {
      s_v_next[tid] = s_val[tid][0];
      s_vs_next[tid] = s_vs[tid][0];
    }
  }
}

template <typename T>
cudaError_t launch(const void* log_ratios, const void* values,
                   const void* bootstrap, const void* rewards,
                   const void* discounts, float* vs, float* adv, int n_rows,
                   int n_steps, float rho_bar, float c_bar, float lam,
                   cudaStream_t stream) {
  const int blocks = (n_rows + kRows - 1) / kRows;
  vtrace_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(log_ratios), static_cast<const T*>(values),
      static_cast<const T*>(bootstrap), static_cast<const T*>(rewards),
      static_cast<const T*>(discounts), vs, adv, n_rows, n_steps, rho_bar,
      c_bar, lam);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all five inputs alike).  Outputs are
// float32 [B, T].  Returns the cudaError_t of the launch.
extern "C" int vtrace_launch(const void* log_ratios, const void* values,
                             const void* bootstrap, const void* rewards,
                             const void* discounts, void* vs, void* adv,
                             int n_rows, int n_steps, int dtype,
                             float rho_bar, float c_bar, float lam,
                             void* stream) {
  if (n_rows <= 0 || n_steps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* vs_f = static_cast<float*>(vs);
  float* adv_f = static_cast<float*>(adv);
  switch (dtype) {
    case 0:
      return (int)launch<float>(log_ratios, values, bootstrap, rewards,
                                discounts, vs_f, adv_f, n_rows, n_steps,
                                rho_bar, c_bar, lam, s);
    case 1:
      return (int)launch<__nv_bfloat16>(log_ratios, values, bootstrap,
                                        rewards, discounts, vs_f, adv_f,
                                        n_rows, n_steps, rho_bar, c_bar, lam,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
