// Backward of causal (optionally sliding-window) GQA attention: dQ, dK and
// dV of every layer's attention in a learner step.
//
// Replaces: the gradient that jax.grad takes through
// src/repro/models/attention.py, _sdpa (the einsum attention the JAX
// package trains through; the Pallas flash kernel is forward-only).  The
// plain version is kernels/ref.py: ref_attention_backward, the same
// FlashAttention-2 algebra.
//
// What it computes, per (b, kv head g), with s = (q * D^-0.5) . k over the
// causal band (and the window), lse the forward's per-row logsumexp of s
// (flash_attention.cu writes it), O the forward's output and dO its
// gradient:
//   Dr  = rowsum(dO * O)                      (per query row)
//   P   = exp(s - lse),  dP = dO . V^T,  dS = P * (dP - Dr)
//   dV  = P^T dO,  dK = D^-0.5 dS^T Q,  dQ = D^-0.5 dS K
// dK and dV sum over the G = H / KV query heads of the kv head.  q, k, v,
// O and dO float32 or bfloat16 (one dtype), lse float32; every product and
// sum in float32 on the FMA pipes (no TF32, no tensor cores); dq, dk, dv
// in the inputs' dtype.
//
// What bounds it on an H100: bytes at the learner's short sequences (q, k,
// v, O, dO, lse read once, dq, dk, dv written once: 79 MB at hymba's B 64 x
// S 40 x 25 / 5 heads of 64, 24 us at 3.35 TB/s), operations at long ones
// (10 D flops per attended (query, key) pair for the five products: S
// recomputed, dP, dV, dK, dQ).  This design reaches neither: it recomputes
// S and dP in both passes and runs every product from shared memory on
// the FMA pipes.
//
// Design: three kernels, no atomics.
//   1. flash_bwd_rowdot: Dr for every (b, position, head), one thread a row.
//   2. flash_bwd_dkdv: one block per (key tile of 64 keys, kv head, b) keeps
//      the tile's K and V in shared memory and its dK, dV in registers, and
//      walks the tiles of 64 query rows that can see any of its keys (the
//      rows of the kv head's G query heads packed as the forward packs them:
//      row r at position r / G; from the tile's first key on, up to the
//      window's reach), skipping what the forward skips.  Per row tile: S^T
//      and dP^T (keys x rows), P^T and dS^T through shared memory, then
//      dV += P^T dO and dK += dS^T Q.
//   3. flash_bwd_dq: one block per (tile of 64 query rows, kv head, b), as
//      the forward: the key tiles of the band in order; S and dP, dS through
//      shared memory, dQ += dS K in registers.
// Thread (ty, tx) of a 16 x 16 grid owns 4 rows (or keys) 4 ty .. 4 ty + 3
// of a tile and columns tx + 16 c; tiles read along rows by tx are padded
// to an odd stride (D + 1) against bank conflicts.  Ragged S and rows past
// S * G are bounds-checked; nothing is padded.  D is 8, 16, 32 or 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kRows = 64;       // query rows (position, head) per tile
constexpr int kKeys = 64;       // keys per tile
constexpr int kRowThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static constexpr int kS = D + 1;              // padded row stride
  static constexpr int kT = kRows + 1;          // P / dS tile stride
  static constexpr int kDims = (D + 15) / 16;   // columns per thread
  // K, V, Q, dO tiles, two 64 x 64 score tiles, lse and Dr of 64 rows.
  static constexpr size_t kBytes =
      sizeof(float) * (4 * 64 * kS + 2 * 64 * kT + 2 * 64);
};

// dst[rr][d] (row stride kS) = scale * src row (r0 + rr) of the packed
// rows, as float32; rows past n_rows are zeros.  src_row(r) gives the
// element offset of packed row r.
template <typename T, int D, typename RowOf>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int n_rows, float scale,
                                      RowOf src_row) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int rr = e / D, d = e % D, r = r0 + rr;
    dst[rr * Layout<D>::kS + d] =
        r < n_rows ? to_float(src[src_row(r) + d]) * scale : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_rowdot(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ dr, size_t rows, int dim) {
  const size_t r = (size_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.f;
  for (int d = 0; d < dim; ++d)
    acc = fmaf(to_float(out[r * dim + d]), to_float(dout[r * dim + d]), acc);
  dr[r] = acc;
}

template <typename T, int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv, int seq, int n_heads,
               int n_kv, int window, float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* s_k = smem;                   // [kKeys][kS]
  float* s_v = s_k + kKeys * L::kS;    // [kKeys][kS]
  float* s_q = s_v + kKeys * L::kS;    // [kRows][kS], scaled
  float* s_do = s_q + kRows * L::kS;   // [kRows][kS]
  float* s_p = s_do + kRows * L::kS;   // [kKeys][kT]  P^T
  float* s_ds = s_p + kKeys * L::kT;   // [kKeys][kT]  dS^T
  float* s_l = s_ds + kKeys * L::kT;   // [kRows]
  float* s_d = s_l + kRows;            // [kRows]

  const int group = n_heads / n_kv;
  const int k0 = blockIdx.x * kKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // Row r of this (b, kv head): position r / group, head kvh * group +
  // r % group; its [B, S, H] index, and the [B, S, KV] index of key j.
  auto head_row = [&](int r) {
    return ((size_t)b * seq + r / group) * n_heads + kvh * group + r % group;
  };
  auto key_row = [&](int j) { return ((size_t)b * seq + j) * n_kv + kvh; };

  stage<T, D>(s_k, k, k0, seq, 1.f,
              [&](int j) { return key_row(j) * D; });
  stage<T, D>(s_v, v, k0, seq, 1.f,
              [&](int j) { return key_row(j) * D; });

  float acc_k[4][L::kDims], acc_v[4][L::kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // Rows that see a key of [k0, k0 + 63]: positions from k0 to the last
  // key plus the window's reach.
  const int key_last = min(k0 + kKeys, seq) - 1;
  const int pos_last =
      kWindow ? min(seq - 1, key_last + window - 1) : seq - 1;
  const int r_first = k0 * group, r_last = (pos_last + 1) * group - 1;

  for (int r0 = (r_first / kRows) * kRows; r0 <= r_last; r0 += kRows) {
    __syncthreads();   // the previous row tile is consumed
    stage<T, D>(s_q, q, r0, n_rows, scale,
                [&](int r) { return head_row(r) * D; });
    stage<T, D>(s_do, dout, r0, n_rows, 1.f,
                [&](int r) { return head_row(r) * D; });
    for (int rr = tid; rr < kRows; rr += kThreads) {
      const int r = r0 + rr;
      s_l[rr] = r < n_rows ? lse[head_row(r)] : 0.f;
      s_d[rr] = r < n_rows ? dr[head_row(r)] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: keys 4 ty + i, rows tx + 16 c.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kx[4], vx[4], qx[4], ox[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kx[i] = s_k[(ty * 4 + i) * L::kS + d];
        vx[i] = s_v[(ty * 4 + i) * L::kS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qx[c] = s_q[(tx + 16 * c) * L::kS + d];
        ox[c] = s_do[(tx + 16 * c) * L::kS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[i][c] = fmaf(kx[i], qx[c], st[i][c]);
          dpt[i][c] = fmaf(vx[i], ox[c], dpt[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = tx + 16 * c, r = r0 + rr, pos = r / group;
        const bool ok = r < n_rows && key < seq && key <= pos &&
                        (!kWindow || pos - key < window);
        const float p = ok ? expf(st[i][c] - s_l[rr]) : 0.f;
        s_p[(ty * 4 + i) * L::kT + rr] = p;
        s_ds[(ty * 4 + i) * L::kT + rr] = p * (dpt[i][c] - s_d[rr]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: keys 4 ty + i, dims tx + 16 c.
    const int live = min(kRows, n_rows - r0);
    for (int rr = 0; rr < live; ++rr) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = s_p[(ty * 4 + i) * L::kT + rr];
        dsv[i] = s_ds[(ty * 4 + i) * L::kT + rr];
      }
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) {
        const int d = tx + 16 * c;
        const float ov = d < D ? s_do[rr * L::kS + d] : 0.f;
        const float qv = d < D ? s_q[rr * L::kS + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
        }
      }
    }
  }

  // Q was staged scaled, so acc_k is dK already.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= seq) continue;
    const size_t at = key_row(key) * D;
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(dk + at + d, acc_k[i][c]);
        store(dv + at + d, acc_v[i][c]);
      }
    }
  }
}

template <typename T, int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dr,
             T* __restrict__ dq, int seq, int n_heads, int n_kv, int window,
             float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* s_q = smem;                   // [kRows][kS], scaled
  float* s_do = s_q + kRows * L::kS;   // [kRows][kS]
  float* s_k = s_do + kRows * L::kS;   // [kKeys][kS]
  float* s_v = s_k + kKeys * L::kS;    // [kKeys][kS]
  float* s_ds = s_v + kKeys * L::kS;   // [kRows][kT]

  const int group = n_heads / n_kv;
  const int r0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  auto head_row = [&](int r) {
    return ((size_t)b * seq + r / group) * n_heads + kvh * group + r % group;
  };
  auto key_row = [&](int j) { return ((size_t)b * seq + j) * n_kv + kvh; };

  stage<T, D>(s_q, q, r0, n_rows, scale,
              [&](int r) { return head_row(r) * D; });
  stage<T, D>(s_do, dout, r0, n_rows, 1.f,
              [&](int r) { return head_row(r) * D; });

  int pos[4];
  float lrow[4], drow[4], acc[4][L::kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    const bool live = r < n_rows;
    pos[i] = live ? r / group : -1;
    lrow[i] = live ? lse[head_row(r)] : 0.f;
    drow[i] = live ? dr[head_row(r)] : 0.f;
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this tile can reach, as in the forward.
  const int last = (min(r0 + kRows, n_rows) - 1) / group;
  const int first = kWindow ? max(0, r0 / group - window + 1) : 0;

  for (int k0 = (first / kKeys) * kKeys; k0 <= last; k0 += kKeys) {
    __syncthreads();   // the previous key tile is consumed
    stage<T, D>(s_k, k, k0, seq, 1.f,
                [&](int j) { return key_row(j) * D; });
    stage<T, D>(s_v, v, k0, seq, 1.f,
                [&](int j) { return key_row(j) * D; });
    __syncthreads();

    // S and dP: rows 4 ty + i, keys tx + 16 c.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qx[4], ox[4], kx[4], vx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qx[i] = s_q[(ty * 4 + i) * L::kS + d];
        ox[i] = s_do[(ty * 4 + i) * L::kS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kx[c] = s_k[(tx + 16 * c) * L::kS + d];
        vx[c] = s_v[(tx + 16 * c) * L::kS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qx[i], kx[c], s[i][c]);
          dp[i][c] = fmaf(ox[i], vx[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        const bool ok = pos[i] >= 0 && key < seq && key <= pos[i] &&
                        (!kWindow || pos[i] - key < window);
        const float p = ok ? expf(s[i][c] - lrow[i]) : 0.f;
        s_ds[(ty * 4 + i) * L::kT + tx + 16 * c] = p * (dp[i][c] - drow[i]);
      }
    }
    __syncthreads();

    // dQ += dS K: rows 4 ty + i, dims tx + 16 c.
    const int n_keys = min(kKeys, seq - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = s_ds[(ty * 4 + i) * L::kT + kk];
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? s_k[kk * L::kS + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pos[i] < 0) continue;
    T* row = dq + head_row(r0 + ty * 4 + i) * D;
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(row + d, acc[i][c] * scale);
    }
  }
}

template <typename T, int D, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dr,
                   void* dq, void* dk, void* dv, int batch, int seq,
                   int n_heads, int n_kv, int window, float scale,
                   cudaStream_t stream) {
  const size_t bytes = Layout<D>::kBytes;
  auto kdkdv = flash_bwd_dkdv<T, D, kWindow>;
  auto kdq = flash_bwd_dq<T, D, kWindow>;
  static const cudaError_t attr_kv = cudaFuncSetAttribute(   // once
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kdkdv<<<dim3((seq + kKeys - 1) / kKeys, n_kv, batch), kThreads, bytes,
          stream>>>(qt, kt, vt, dot, lse, dr, static_cast<T*>(dk),
                    static_cast<T*>(dv), seq, n_heads, n_kv, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = seq * (n_heads / n_kv);
  kdq<<<dim3((rows + kRows - 1) / kRows, n_kv, batch), kThreads, bytes,
        stream>>>(qt, kt, vt, dot, lse, dr, static_cast<T*>(dq), seq,
                  n_heads, n_kv, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_w(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dr,
                     void* dq, void* dk, void* dv, int batch, int seq,
                     int n_heads, int n_kv, int window, float scale,
                     cudaStream_t stream) {
  if (window > 0)
    return launch<T, D, true>(q, k, v, dout, lse, dr, dq, dk, dv, batch, seq,
                              n_heads, n_kv, window, scale, stream);
  return launch<T, D, false>(q, k, v, dout, lse, dr, dq, dk, dv, batch, seq,
                             n_heads, n_kv, 0, scale, stream);
}

template <typename T>
cudaError_t launch_d(int dim, const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* dr, void* dq, void* dk, void* dv, int batch,
                     int seq, int n_heads, int n_kv, int window, float scale,
                     cudaStream_t stream) {
  const size_t rows = (size_t)batch * seq * n_heads;
  flash_bwd_rowdot<T><<<(unsigned)((rows + kRowThreads - 1) / kRowThreads),
                        kRowThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), dr, rows, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (dim) {
    case 8:
      return launch_w<T, 8>(q, k, v, dout, lse, dr, dq, dk, dv, batch, seq,
                            n_heads, n_kv, window, scale, stream);
    case 16:
      return launch_w<T, 16>(q, k, v, dout, lse, dr, dq, dk, dv, batch, seq,
                             n_heads, n_kv, window, scale, stream);
    case 32:
      return launch_w<T, 32>(q, k, v, dout, lse, dr, dq, dk, dv, batch, seq,
                             n_heads, n_kv, window, scale, stream);
    case 64:
      return launch_w<T, 64>(q, k, v, dout, lse, dr, dq, dk, dv, batch, seq,
                             n_heads, n_kv, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout [B, S, H, D] and k, v [B, S, KV, D]: contiguous, one dtype
// (0 = float32, 1 = bfloat16), H a multiple of KV, D in {8, 16, 32, 64};
// lse [B, S, H] float32 from the forward; `rowdot` scratch of B * S * H
// floats.  window > 0 as in flash_attention_launch.  Writes dq [B, S, H,
// D], dk and dv [B, S, KV, D] in the inputs' dtype.  Returns the
// cudaError_t of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* rowdot, void* dq, void* dk,
    void* dv, int batch, int seq, int n_heads, int n_kv, int dim, int window,
    int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || n_kv <= 0 || n_heads < n_kv ||
      n_heads % n_kv != 0 || window < 0 || batch > 65535 || n_kv > 65535 ||
      rowdot == nullptr || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* dr = static_cast<float*>(rowdot);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(dim, q, k, v, out, dout, lf, dr, dq, dk,
                                  dv, batch, seq, n_heads, n_kv, window,
                                  scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(dim, q, k, v, out, dout, lf, dr,
                                          dq, dk, dv, batch, seq, n_heads,
                                          n_kv, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
