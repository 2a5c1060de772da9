// RWKV-6 (Finch) WKV recurrence: the output of every step and the final
// state, per (batch, head).
//
// Replaces: src/repro/kernels/wkv6_pallas.py, wkv6_pallas (_wkv6_kernel),
// the Pallas TPU kernel that runs the recurrence in its chunked parallel
// form (intra-chunk decayed score matrix on the MXU, a [K, V] state in
// VMEM scratch carried across the sequential chunk axis of its grid).
//
// What it computes, per (b, h), from state S [K, V] (zeros if absent):
//   y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//   S[k, v] <- w_t[k] * S[k, v] + k_t[k] * v_t[v]
// for t = 0 .. S-1; the bonus term uses k_t, v_t before the update.
// r, k, w, u are [.., K], v and y [.., V]; inputs float32 or bfloat16,
// y in the inputs' dtype, the state and all arithmetic float32.
//
// What bounds it on an H100: bytes.  Each input is read once, y written
// once, the state read and written once: 18.9 MB for the serve prefill
// (B 8, S 32, H 32, K = V = 64, float32), 5.6 us at 3.35 TB/s, and
// 8.7 MB (2.6 us) for one decode step, which is mostly the state.  The
// operations (about 6 per state element per step) are far below the
// float32 peak.  The practical limit of this design is latency: each
// step is a chain of dependent multiply-adds per thread, and one block
// per (b, h) gives the serve shapes 256 blocks of 2 warps.
//
// Design: one block per (b, h); thread v owns column S[:, v] in K float
// registers for the whole sequence, so the state touches device memory
// twice (one coalesced read, one coalesced write: consecutive threads,
// consecutive v).  Steps are staged 32 at a time in shared memory, r, k,
// w and v each read along their contiguous 64-element rows by all
// threads together; in the step loop every thread reads the same r, k,
// w entries (a broadcast) and its own v entry.  y_t[v] is written as
// soon as it is known.  The dot product over k keeps four partial sums
// to shorten the dependent chain.  Decays as small as 1e-6 stay finite:
// the sequential form multiplies by w and never divides or takes logs.
// Any S >= 1 runs without padding; K must be 8, 16, 32 or 64 (the model
// uses 64) and V at most 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // one per value column (V <= 64)
constexpr int kMaxV = 64;
constexpr int kChunk = 32;     // steps staged per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ sf, int n_steps,
            int n_heads, int vd) {
  __shared__ float s_r[kChunk][K];
  __shared__ float s_k[kChunk][K];
  __shared__ float s_w[kChunk][K];
  __shared__ float s_v[kChunk][kMaxV];
  __shared__ float s_u[K];

  const int bh = blockIdx.x;              // b * H + h
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x;
  const bool owns = tid < vd;             // this thread's column exists

  float st[K];                            // S[:, tid]
  const size_t st_base = (size_t)bh * K * vd + tid;
#pragma unroll
  for (int i = 0; i < K; ++i)
    st[i] = (owns && s0 != nullptr) ? s0[st_base + (size_t)i * vd] : 0.f;
  for (int i = tid; i < K; i += kThreads) s_u[i] = to_float(u[h * K + i]);

  // Row t of (b, h) starts at ((b * S + t) * H + h) * K in r, k, w and
  // at ((b * S + t) * H + h) * V in v and y.
  const size_t step_k = (size_t)n_heads * K, step_v = (size_t)n_heads * vd;
  const size_t base_k = (size_t)b * n_steps * step_k + (size_t)h * K;
  const size_t base_v = (size_t)b * n_steps * step_v + (size_t)h * vd;

  for (int t0 = 0; t0 < n_steps; t0 += kChunk) {
    const int len = min(kChunk, n_steps - t0);
    __syncthreads();   // the previous chunk is consumed; s_u is set
    for (int e = tid; e < len * K; e += kThreads) {
      const int j = e / K, i = e % K;
      const size_t g = base_k + (size_t)(t0 + j) * step_k + i;
      s_r[j][i] = to_float(r[g]);
      s_k[j][i] = to_float(k[g]);
      s_w[j][i] = to_float(w[g]);
    }
    for (int e = tid; e < len * vd; e += kThreads) {
      const int j = e / vd, i = e % vd;
      s_v[j][i] = to_float(v[base_v + (size_t)(t0 + j) * step_v + i]);
    }
    __syncthreads();
    if (!owns) continue;
    for (int j = 0; j < len; ++j) {
      const float vv = s_v[j][tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = s_k[j][i] * vv;
        acc[i & 3] = fmaf(s_r[j][i], fmaf(s_u[i], kv, st[i]), acc[i & 3]);
        st[i] = fmaf(s_w[j][i], st[i], kv);
      }
      store(y + base_v + (size_t)(t0 + j) * step_v + tid,
            (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (owns) {
#pragma unroll
    for (int i = 0; i < K; ++i) sf[st_base + (size_t)i * vd] = st[i];
  }
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const float* s0, void* y,
                   float* sf, int batch, int n_steps, int n_heads, int vd,
                   cudaStream_t stream) {
  wkv6_kernel<T, K><<<batch * n_heads, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(y), sf, n_steps, n_heads,
      vd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int kd, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const float* s0, void* y,
                     float* sf, int batch, int n_steps, int n_heads, int vd,
                     cudaStream_t stream) {
  switch (kd) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                          vd, stream);
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                           vd, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                           vd, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                           vd, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, w [B, S, H, K], v [B, S, H, V], u [H, K]: contiguous, one dtype
// (0 = float32, 1 = bfloat16).  state_in [B, H, K, V] float32 or null
// (zeros); y [B, S, H, V] in the inputs' dtype and state_out [B, H, K, V]
// float32 are written.  Returns the cudaError_t of the launch.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u,
                           const void* state_in, void* y, void* state_out,
                           int batch, int n_steps, int n_heads, int kd,
                           int vd, int dtype, void* stream) {
  if (batch <= 0 || n_steps <= 0 || n_heads <= 0 || vd <= 0 || vd > kMaxV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(state_in);
  float* sf = static_cast<float*>(state_out);
  switch (dtype) {
    case 0:
      return (int)launch_k<float>(kd, r, k, v, w, u, s0, y, sf, batch,
                                  n_steps, n_heads, vd, s);
    case 1:
      return (int)launch_k<__nv_bfloat16>(kd, r, k, v, w, u, s0, y, sf, batch,
                                          n_steps, n_heads, vd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
