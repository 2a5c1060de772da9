// Shared block routine of the two paged-attention kernels
// (paged_attention.cu: one query per slot; paged_attention_varlen.cu:
// ragged rows per slot).  Both launch one block per (slot, kv head) and
// call attend_rows; they differ only in how a slot's rows are described.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

// Same masking constant, denominator floor and scale placement as the
// Pallas kernels and the plain versions (kernels/ref.py).
constexpr float kNegInf = -1e30f;
constexpr float kMinDenom = 1e-30f;

constexpr int kThreads = 128;      // threads per block
constexpr int kRowTile = 16;       // query rows (token x group head) per pass
constexpr int kMaxHeadDim = 128;
constexpr int kAccPerThread = kRowTile * kMaxHeadDim / kThreads;

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

// Dynamic shared memory of one block, in floats:
// q[kRowTile*D] | k[BS*(D+1)] | v[BS*D] | p[kRowTile*BS] | m, l, alpha[kRowTile]
// (k rows are padded by one float so the score loop reads distinct banks).
inline size_t smem_bytes(int block_size, int head_dim) {
  size_t floats = (size_t)kRowTile * head_dim +
                  (size_t)block_size * (head_dim + 1) +
                  (size_t)block_size * head_dim +
                  (size_t)kRowTile * block_size + 3 * kRowTile;
  return floats * sizeof(float);
}

struct Geometry {
  int T;        // query rows per slot in q/out ([B, T, H, D]; 1 for decode)
  int H, KV;    // query heads, kv heads (H % KV == 0)
  int NB, BS;   // pool pages, rows per page
  int D;        // head dim (<= kMaxHeadDim)
  int M;        // block-table width
  int window;   // sliding window, < 0 = global
  float scale;  // D ** -0.5, applied to q
};

// One block = one (slot b, kv head kvh).  The slot's live query rows are
// tokens t < n at absolute positions base + t; each token has G = H / KV
// group heads, so the block owns n * G score rows, row r -> token r / G,
// head kvh * G + r % G.  A K/V page is loaded into shared memory once per
// pass of up to kRowTile rows and used by all of them (the Pallas grid
// re-streams every page once per query head).  Pages are visited as the
// Pallas kernels visit them: j < ceil((base + n) / BS), skipping pages
// entirely left of the OLDEST row's window.  Online softmax per row,
// in float32, with the same update order as the Pallas body.
template <typename T>
__device__ void attend_rows(const T* __restrict__ q,
                            const T* __restrict__ k_pages,
                            const T* __restrict__ v_pages,
                            const int* __restrict__ tables,
                            T* __restrict__ out, int b, int kvh, int base,
                            int n, const Geometry& g) {
  extern __shared__ float smem[];
  const int D = g.D, BS = g.BS, G = g.H / g.KV;
  float* q_s = smem;
  float* k_s = q_s + kRowTile * D;
  float* v_s = k_s + BS * (D + 1);
  float* p_s = v_s + BS * D;
  float* m_s = p_s + kRowTile * BS;
  float* l_s = m_s + kRowTile;
  float* a_s = l_s + kRowTile;
  const int tid = threadIdx.x;
  const bool has_window = g.window >= 0;
  if (n < 0) n = 0;
  if (n > g.T) n = g.T;

  // Padding rows (t >= n) and idle slots (n == 0) are exact zeros.
  for (int e = tid; e < (g.T - n) * G * D; e += kThreads) {
    const int t = n + e / (G * D), rem = e % (G * D);
    out[(((size_t)b * g.T + t) * g.H + kvh * G + rem / D) * D + rem % D] =
        from_float<T>(0.f);
  }
  if (n == 0) return;

  // Live pages: from the page holding the oldest row's first visible key
  // (base - window + 1) to the page holding the newest row (ctx - 1).
  const int ctx = base + n;
  const int first_key = has_window ? base - g.window + 1 : 0;
  const int j_begin = first_key > 0 ? first_key / BS : 0;
  int j_end = (ctx + BS - 1) / BS;
  if (j_end > g.M) j_end = g.M;
  const int rows = n * G;
  for (int r0 = 0; r0 < rows; r0 += kRowTile) {
    const int R = min(kRowTile, rows - r0);
    __syncthreads();   // the previous pass is done with q_s, m_s, l_s
    for (int e = tid; e < R * D; e += kThreads) {
      const int r = e / D, d = e % D, rr = r0 + r;
      const int t = rr / G, h = kvh * G + rr % G;
      q_s[e] = to_float(q[(((size_t)b * g.T + t) * g.H + h) * D + d]) *
               g.scale;
    }
    if (tid < R) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[kAccPerThread];
#pragma unroll
    for (int k = 0; k < kAccPerThread; ++k) acc[k] = 0.f;

    for (int j = j_begin; j < j_end; ++j) {
      const int page = tables[(size_t)b * g.M + j];
      if (page < 0 || page >= g.NB) continue;   // never read out of the pool
      __syncthreads();   // q_s written; the previous page fully consumed
      const size_t page_off = ((size_t)kvh * g.NB + page) * BS * D;
      for (int e = tid; e < BS * D; e += kThreads) {
        k_s[(e / D) * (D + 1) + e % D] = to_float(k_pages[page_off + e]);
        v_s[e] = to_float(v_pages[page_off + e]);
      }
      __syncthreads();
      for (int e = tid; e < R * BS; e += kThreads) {
        const int r = e / BS, s = e % BS;
        const int qpos = base + (r0 + r) / G, kpos = j * BS + s;
        const bool valid =
            kpos <= qpos && (!has_window || qpos - kpos < g.window);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[r * D + d] * k_s[s * (D + 1) + d];
        p_s[e] = valid ? dot : kNegInf;
      }
      __syncthreads();
      if (tid < R) {
        float* p = p_s + tid * BS;
        float mx = kNegInf;
        for (int s = 0; s < BS; ++s) mx = fmaxf(mx, p[s]);
        const float m_prev = m_s[tid];
        const float m_new = fmaxf(m_prev, mx);
        const float alpha = expf(m_prev - m_new);
        float sum = 0.f;
        for (int s = 0; s < BS; ++s) {
          p[s] = expf(p[s] - m_new);
          sum += p[s];
        }
        l_s[tid] = alpha * l_s[tid] + sum;
        m_s[tid] = m_new;
        a_s[tid] = alpha;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAccPerThread; ++k) {
        const int idx = tid + k * kThreads;
        if (idx < R * D) {
          const int r = idx / D, d = idx % D;
          float pv = 0.f;
          for (int s = 0; s < BS; ++s) pv += p_s[r * BS + s] * v_s[s * D + d];
          acc[k] = acc[k] * a_s[r] + pv;
        }
      }
    }
    __syncthreads();   // l_s is final for this pass
#pragma unroll
    for (int k = 0; k < kAccPerThread; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < R * D) {
        const int r = idx / D, d = idx % D, rr = r0 + r;
        const int t = rr / G, h = kvh * G + rr % G;
        out[(((size_t)b * g.T + t) * g.H + h) * D + d] =
            from_float<T>(acc[k] / fmaxf(l_s[r], kMinDenom));
      }
    }
  }
}

// Host-side shape check shared by both launchers.
inline cudaError_t check_geometry(const Geometry& g, int batch) {
  if (batch <= 0 || g.KV <= 0 || g.H % g.KV != 0 || g.D <= 0 ||
      g.D > kMaxHeadDim || g.BS <= 0 || g.T <= 0 || g.M <= 0 || g.NB <= 0)
    return cudaErrorInvalidValue;
  if (smem_bytes(g.BS, g.D) > 48 * 1024) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace paged
