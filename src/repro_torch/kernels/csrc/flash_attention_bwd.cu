// Backward of causal (optionally sliding-window) GQA attention: dQ, dK and
// dV of every layer's attention in a learner step.
//
// Replaces: the gradient that jax.grad takes through
// src/repro/models/attention.py, _sdpa (the einsum attention the JAX
// package trains through; the Pallas flash kernel is forward-only).  The
// plain version is kernels/ref.py: ref_attention_backward, the same
// FlashAttention-2 algebra.
//
// What it computes, per (b, kv head g), with s = D^-0.5 q . k over the
// causal band (and the window), lse the forward's per-row logsumexp of s
// (flash_attention.cu writes it), O the forward's output and dO its
// gradient:
//   Dr  = rowsum(dO * O)                      (per query row)
//   P   = exp(s - lse),  dP = dO . V^T,  dS = P * (dP - Dr)
//   dV  = P^T dO,  dK = D^-0.5 dS^T Q,  dQ = D^-0.5 dS K
// dK and dV sum over the G = H / KV query heads of the kv head.  q, k, v,
// O and dO float32 or bfloat16 (one dtype), lse float32; dq, dk, dv in the
// inputs' dtype.  The rows of a kv head are its G query heads packed as
// the forward packs them: row r at position r / G, head g G + r % G.
//
// What bounds it on an H100: bytes at the learner's short sequences (q, k,
// v, O, dO, lse read once, dq, dk, dv written once: 79 MB at hymba's B 64 x
// S 40 x 25 / 5 heads of 64, 24 us at 3.35 TB/s), operations at long ones
// (10 D flops per attended (query, key) pair for the five products: S,
// dP, dV, dK, dQ, each computed once).
//
// Products on the tensor cores (Mma below): float32 inputs by 3xTF32
// (mma.m16n8k8, each operand split into hi + lo, three products:
// mma_tf32.cuh), which holds float32 accuracy; bfloat16 inputs by
// mma.m16n8k16 in bfloat16, with P and dS rounded to bfloat16 for their
// products (as they are stored); every sum in float32.  Tiles in shared
// memory are XOR-swizzled in 16-byte chunks (swz) so that the fragment
// reads of a warp, down rows or across them, hit 32 banks without padding.
//
// Two paths, picked by the shared memory the short one needs, here only
// (flash_attention_bwd_scratch_floats: 0 for the short path; the wrapper
// allocates what it reports, and the launcher takes the short path when
// it gets no scratch):
//
// short (flash_bwd_short), every learner shape the port runs (hymba's 200
// and qwen's 280 rows at S 40): one block of 16 warps per (kv head, b)
// holds all of its G S query rows (Q, dO, lse, Dr) and the kv head's K and
// V in shared memory (cp.async, Q and K in flight first; rows zero-padded
// to a multiple of 16, so fragment reads need no bounds checks), plus one
// [G S, S] buffer for P, then dS in its place.  While the tiles load, the
// warps form Dr = rowsum(dO * O) for the block's rows from device memory
// (O is read once).  Then four phases, a block barrier between each,
// every warp taking 16 x 16 (row, key) or (key, dim) tiles in turn, tiles
// wholly outside the causal band or the window skipped:
//   1. S = Q K^T, P = exp(D^-0.5 S - lse) into the buffer;
//   2. dV = P^T dO (the G heads summed inside the block);
//   3. dP = dO V^T, dS = P * (dP - Dr) over P in place;
//   4. dQ = D^-0.5 dS K and dK = D^-0.5 dS^T Q.
// A sum over row tiles adds each tile's product in with a rounded float32
// add: the tensor cores' own accumulation, chained over thousands of
// products, drifts past float32 rounding (past the 2e-5 gate at B 1 x
// S 2048).
// One launch, S and dP computed once, no atomics, the result deterministic.
// Float32 at qwen's 280 rows takes 214 KB of the 227 KB a block may have.
//
// long (flash_bwd_long), sequences whose rows do not fit (B 1 x S 2048,
// S 2100): FlashAttention-2's structure.  One block of 8 warps per (tile
// of 32 keys, kv head, b) keeps the tile's K, V in shared memory and its
// dK, dV in registers, and walks the tiles of 64 query rows that see any
// of its keys (from the tile's first key on, up to the window's reach),
// their Q, dO, lse and Dr double-buffered by cp.async.  Per row tile: S
// and dP once, P and dS into shared memory, dV += P^T dO and dK += dS^T Q,
// and dQ's share of this key tile, dS K, added into a float32 scratch by
// float2 atomicAdd.  32 keys rather than 64 halve the longest block's
// walk (causal: the first key tile sees every row).  bfloat16 keeps two
// blocks on an SM (128 registers); float32 one, its 3xTF32 fragments
// taking ~200 registers (at 128 they spill).  Three launches:
// flash_bwd_rowdot (Dr), flash_bwd_long, flash_bwd_dq_cast (dQ in the
// inputs' dtype).  The atomics' order varies, so this path's dQ is
// run-to-run nondeterministic (to float32 rounding); dK and dV are not.
//
// Ragged S and the rows past G S are masked; nothing outside the inputs
// is read.  D is 8, 16, 32 or 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait;

constexpr int kShortThreads = 512;   // 16 warps
constexpr int kThreads = 256;        // long path: 8 warps
constexpr int kKeys = 32;       // long path: keys per block
constexpr int kRows = 64;       // long path: query rows per tile
constexpr int kPitchX = kKeys + 8;   // long path's P / dS row pitch
constexpr int kRowThreads = 256;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block

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
// Two consecutive outputs (an even column).
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0,
                                       float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// d (16 x 8, float) += A (16 x 16) B (16 x 8) on the tensor cores, the
// operands read through accessors: at(m, k) for A, at(k, n) for B, each
// returning the element as float.  The accumulator fragment: d[0], d[1]
// at row g8, columns 2 t4, 2 t4 + 1; d[2], d[3] at row g8 + 8.
template <typename T>
struct Mma;

template <>
struct Mma<float> {   // 3xTF32: two m16n8k8 steps
  struct A {
    tf32::Frag f[2];
  };
  struct B {
    tf32::FragB f[2];
  };
  template <typename At>
  __device__ __forceinline__ static A load_a(At at, int g8, int t4) {
    A a;
    a.f[0] = tf32::load_a_of(at, g8, t4);
    a.f[1] = tf32::load_a_of([&](int m, int k) { return at(m, k + 8); }, g8,
                             t4);
    return a;
  }
  template <typename At>
  __device__ __forceinline__ static B load_b(At at, int g8, int t4) {
    B b;
    b.f[0] = tf32::load_b_of(at, g8, t4);
    b.f[1] = tf32::load_b_of([&](int k, int n) { return at(k + 8, n); }, g8,
                             t4);
    return b;
  }
  __device__ __forceinline__ static void mma(float (&d)[4], const A& a,
                                             const B& b) {
    tf32::mma3(d, a.f[0], b.f[0]);
    tf32::mma3(d, a.f[1], b.f[1]);
  }
};

template <>
struct Mma<__nv_bfloat16> {   // one m16n8k16 in bfloat16
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  // Lower k in the lower half; rounds to bfloat16 (exact for bf16 data).
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  template <typename At>
  __device__ __forceinline__ static A load_a(At at, int g8, int t4) {
    const int k = 2 * t4;
    A a;
    a.r[0] = pack(at(g8, k), at(g8, k + 1));
    a.r[1] = pack(at(g8 + 8, k), at(g8 + 8, k + 1));
    a.r[2] = pack(at(g8, k + 8), at(g8, k + 9));
    a.r[3] = pack(at(g8 + 8, k + 8), at(g8 + 8, k + 9));
    return a;
  }
  template <typename At>
  __device__ __forceinline__ static B load_b(At at, int g8, int t4) {
    const int k = 2 * t4;
    B b;
    b.r[0] = pack(at(k, g8), at(k + 1, g8));
    b.r[1] = pack(at(k + 8, g8), at(k + 9, g8));
    return b;
  }
  __device__ __forceinline__ static void mma(float (&d)[4], const A& a,
                                             const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// Element (row, col) of a [rows][D] tile in shared memory.  The column is
// XORed, per row, with a multiple of the 16-byte chunk, so a 16-byte chunk
// stays whole (cp.async fills it) while a warp's fragment reads spread
// over the banks: float32 rows g8 (8) x columns t4 (4) and rows t4 (4) x
// columns g8 (8) hit 32 banks at D 32 and 64; bfloat16 pairs likewise.
template <typename T, int D>
__device__ __forceinline__ int swz(int row, int col) {
  if constexpr (sizeof(T) == 4)
    return row * D +
           (col ^ ((((row & 3) << 3) | (((row >> 2) & 1) << 2)) & (D - 4)));
  else
    return row * D + (col ^ ((row * 8) & (D - 8)));
}

// Stage rows [0, n_rows) of a tile (source row r at element row_of(r) *
// D), zero rows [n_valid, n_rows): 16-byte cp.async where the rows are
// aligned (vec), element copies otherwise.
template <typename T, int D, int NT, typename RowOf>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int n_rows, int n_valid,
                                           RowOf row_of, bool vec) {
  constexpr int kVec = 16 / sizeof(T), kPer = D / kVec;
  for (int e = threadIdx.x; e < n_rows * kPer; e += NT) {
    const int r = e / kPer, c0 = (e % kPer) * kVec;
    T* d = dst + swz<T, D>(r, c0);
    if (r >= n_valid) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* s = src + (size_t)row_of(r) * D + c0;
    if (vec) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = s[x];
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Element (row, col) of a swizzled [rows][D] tile whose rows are padded
// with zeros to a multiple of 16 (columns past D read 0 at D 8).
template <typename T, int D>
struct Tile {
  const T* p;
  __device__ __forceinline__ float get(int row, int col) const {
    if (D < 16 && col >= D) return 0.f;
    return to_float(p[swz<T, D>(row, col)]);
  }
};

// ---------------------------------------------------------------------------
// Short path: one block per (kv head, b) holding all of its rows.
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}
__host__ __device__ inline size_t pad16(size_t x) {
  return (x + 15) / 16 * 16;
}
// lse and Dr of the G S rows; Q, dO and K, V with their rows padded to
// 16; the [G S, S] P / dS buffer.
template <typename T>
inline size_t short_bytes(int seq, int group, int dim) {
  const size_t rows = (size_t)seq * group;
  return align16(2 * sizeof(float) * rows) +
         sizeof(T) * (2 * (pad16(rows) + pad16(seq)) * dim + rows * seq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kShortThreads, 1)
flash_bwd_short(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ out,
                const T* __restrict__ dout, const float* __restrict__ lse,
                T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                int seq, int n_heads, int n_kv, int window, float scale,
                int vec) {
  using M = Mma<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = n_heads / n_kv, kvh = blockIdx.x, b = blockIdx.y;
  const int n_rows = seq * group;
  float* s_l = reinterpret_cast<float*>(smem);   // [R] lse
  float* s_d = s_l + n_rows;                     // [R] Dr
  const int n_rt = (n_rows + 15) / 16, n_kt = (seq + 15) / 16;
  T* s_q = reinterpret_cast<T*>(smem + align16(2 * sizeof(float) * n_rows));
  T* s_o = s_q + (size_t)16 * n_rt * D;          // dO [R][D]
  T* s_k = s_o + (size_t)16 * n_rt * D;          // [S][D]
  T* s_v = s_k + (size_t)16 * n_kt * D;          // [S][D]
  T* s_x = s_v + (size_t)16 * n_kt * D;          // P, then dS [R][S]
  constexpr int kWarpsS = kShortThreads / 32;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  auto head_row = [&](int r) {
    return ((size_t)b * seq + r / group) * n_heads + kvh * group + r % group;
  };
  auto key_row = [&](int j) { return ((size_t)b * seq + j) * n_kv + kvh; };

  stage_rows<T, D, kShortThreads>(s_q, q, 16 * n_rt, n_rows, head_row, vec);
  stage_rows<T, D, kShortThreads>(s_k, k, 16 * n_kt, seq, key_row, vec);
  cp_async_commit();
  stage_rows<T, D, kShortThreads>(s_o, dout, 16 * n_rt, n_rows, head_row, vec);
  stage_rows<T, D, kShortThreads>(s_v, v, 16 * n_kt, seq, key_row, vec);
  cp_async_commit();
  for (int r = tid; r < n_rows; r += kShortThreads) s_l[r] = lse[head_row(r)];
  // Dr = rowsum(dO * O) from device memory while the tiles are in flight:
  // 8 rows a warp at a time, each lane a quarter of a row (D / 4 loads
  // of each in flight at once).
  for (int r0 = 8 * warp; r0 < n_rows; r0 += 8 * kWarpsS) {
    const int r = r0 + lane / 4;
    float acc = 0.f;
    if (r < n_rows) {
      const T* o_row = out + head_row(r) * D;
      const T* do_row = dout + head_row(r) * D;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const int d = lane % 4 + 4 * i;
        acc = fmaf(to_float(o_row[d]), to_float(do_row[d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (lane % 4 == 0 && r < n_rows) s_d[r] = acc;
  }

  const Tile<T, D> tq{s_q}, to{s_o}, tk{s_k}, tv{s_v};
  // P / dS at (row, key), and whether a (row tile, key tile) of 16 x 16
  // holds any attended pair.
  auto x_at = [&](int row, int key) {
    return row < n_rows && key < seq ? to_float(s_x[row * seq + key]) : 0.f;
  };
  auto live = [&](int rt, int kt) {
    const int p_lo = 16 * rt / group,
              p_hi = min(16 * rt + 15, n_rows - 1) / group;
    const int k_lo = 16 * kt, k_hi = min(16 * kt + 15, seq - 1);
    return k_lo <= p_hi && (window <= 0 || p_lo - k_hi < window);
  };
  auto attended = [&](int row, int key) {
    const int pos = row / group;
    return row < n_rows && key < seq && key <= pos &&
           (window <= 0 || pos - key < window);
  };
  // c[nt] (16 rows x 8 keys each) = A rows . B rows^T over D.
  auto scores = [&](float (&c)[2][4], const Tile<T, D>& ta,
                    const Tile<T, D>& tb, int r0, int k0) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      const auto a = M::load_a(
          [&](int m, int kk) { return ta.get(r0 + m, d0 + kk); }, g8, t4);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        M::mma(c[nt], a,
               M::load_b([&](int kk, int n) {
                 return tb.get(k0 + 8 * nt + n, d0 + kk);
               }, g8, t4));
    }
  };

  cp_async_wait<1>();
  __syncthreads();   // Q, K, lse in
  // 1. S and P.
  for (int item = warp; item < n_rt * n_kt; item += kWarpsS) {
    const int rt = item / n_kt, kt = item % n_kt;
    if (!live(rt, kt)) continue;
    float c[2][4];
    scores(c, tq, tk, 16 * rt, 16 * kt);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * rt + g8 + 8 * (e / 2),
                  key = 16 * kt + 8 * nt + 2 * t4 + (e % 2);
        if (row < n_rows && key < seq)
          s_x[row * seq + key] = from_float<T>(
              attended(row, key) ? expf(c[nt][e] * scale - s_l[row])
                                 : 0.f);
      }
  }
  cp_async_wait<0>();
  __syncthreads();   // P, dO, V in
  // 2. dV = P^T dO: (key tile, 16 dims) items.
  constexpr int kDG = (D + 15) / 16;   // 16-column groups of D
  // acc[nt] (16 keys x 8 dims) = A^T B over the rows that see the keys:
  // A the [R][S] buffer, B a [R][D] tile.  Each row tile's product starts
  // from zero and is added in with a rounded float32 add: a tensor-core
  // accumulator chained over many tiles drifts (its adds do not round to
  // nearest).
  auto key_product = [&](float (&acc)[2][4], const Tile<T, D>& tb, int kt,
                         int dg) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int rt = 0; rt < n_rt; ++rt) {
      if (!live(rt, kt)) continue;
      const auto a = M::load_a(
          [&](int m, int kk) { return x_at(16 * rt + kk, 16 * kt + m); }, g8,
          t4);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (16 * dg + 8 * nt >= D) continue;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        M::mma(part, a, M::load_b([&](int kk, int n) {
                 return tb.get(16 * rt + kk, 16 * dg + 8 * nt + n);
               }, g8, t4));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
      }
    }
  };
  auto store_keys = [&](T* dst, const float (&acc)[2][4], int kt, int dg,
                        float mul) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 16 * dg + 8 * nt + 2 * t4;
      if (col >= D) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 16 * kt + g8 + 8 * h;
        if (key < seq)
          store2(dst + key_row(key) * D + col, acc[nt][2 * h] * mul,
                 acc[nt][2 * h + 1] * mul);
      }
    }
  };
  for (int item = warp; item < n_kt * kDG; item += kWarpsS) {
    const int kt = item / kDG, dg = item % kDG;
    float acc[2][4];
    key_product(acc, to, kt, dg);
    store_keys(dv, acc, kt, dg, 1.f);
  }
  __syncthreads();   // Dr in; P read for the last time
  // 3. dP and dS over P in place.
  for (int item = warp; item < n_rt * n_kt; item += kWarpsS) {
    const int rt = item / n_kt, kt = item % n_kt;
    if (!live(rt, kt)) continue;
    float c[2][4];
    scores(c, to, tv, 16 * rt, 16 * kt);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * rt + g8 + 8 * (e / 2),
                  key = 16 * kt + 8 * nt + 2 * t4 + (e % 2);
        if (row < n_rows && key < seq) {
          T* x = s_x + row * seq + key;
          *x = from_float<T>(to_float(*x) * (c[nt][e] - s_d[row]));
        }
      }
  }
  __syncthreads();   // dS in
  // 4. dK = dS^T Q ((key tile, 16 dims) items, the longer ones, first)
  // and dQ = dS K ((row tile, 16 dims) items).
  for (int item = warp; item < (n_kt + n_rt) * kDG; item += kWarpsS) {
    float acc[2][4];
    if (item < n_kt * kDG) {
      const int kt = item / kDG, dg = item % kDG;
      key_product(acc, tq, kt, dg);
      store_keys(dk, acc, kt, dg, scale);
      continue;
    }
    const int rt = item / kDG - n_kt, dg = item % kDG;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (!live(rt, kt)) continue;
      const auto a = M::load_a(
          [&](int m, int kk) { return x_at(16 * rt + m, 16 * kt + kk); }, g8,
          t4);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        if (16 * dg + 8 * nt < D)
          M::mma(acc[nt], a, M::load_b([&](int kk, int n) {
                   return tk.get(16 * kt + kk, 16 * dg + 8 * nt + n);
                 }, g8, t4));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 16 * dg + 8 * nt + 2 * t4;
      if (col >= D) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * rt + g8 + 8 * h;
        if (row < n_rows)
          store2(dq + head_row(row) * D + col, acc[nt][2 * h] * scale,
                 acc[nt][2 * h + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Long path: one block per (key tile, kv head, b), walking the row tiles.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct LongLayout {
  static constexpr size_t kKV = 2 * kKeys * D;        // T: K, V
  static constexpr size_t kQO = 2 * 2 * kRows * D;    // T: Q, dO x 2 buffers
  static constexpr size_t kX = 2 * kRows * kPitchX;   // T: P, dS
  static constexpr size_t kLD = 2 * 2 * kRows;        // float: lse, Dr x 2
  static constexpr size_t kBytes = sizeof(T) * (kKV + kQO + kX) +
                                   sizeof(float) * kLD;
};

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

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_dq_cast(const float* __restrict__ acc, T* __restrict__ dq,
                  size_t n, float scale) {
  const size_t e = (size_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (e < n) dq[e] = from_float<T>(acc[e] * scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
flash_bwd_long(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dr,
               float* __restrict__ dq_acc, T* __restrict__ dk,
               T* __restrict__ dv, int seq, int n_heads, int n_kv,
               int window, float scale, int vec) {
  using M = Mma<T>;
  using L = LongLayout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);           // [32][D]
  T* s_v = s_k + kKeys * D;                      // [32][D]
  T* s_qo = s_v + kKeys * D;                     // [2 buf][Q, dO][64][D]
  T* s_p = s_qo + L::kQO;                        // [64][kPitchX]
  T* s_s = s_p + kRows * kPitchX;                // [64][kPitchX]
  float* s_ld = reinterpret_cast<float*>(s_s + kRows * kPitchX);  // [2][2][64]

  const int group = n_heads / n_kv;
  const int k0 = blockIdx.x * kKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  auto head_row = [&](int r) {
    return ((size_t)b * seq + r / group) * n_heads + kvh * group + r % group;
  };
  auto key_row = [&](int j) { return ((size_t)b * seq + j) * n_kv + kvh; };

  // Rows that see a key of [k0, k0 + 31]: positions from k0 to the last
  // key plus the window's reach.
  const int key_last = min(k0 + kKeys, seq) - 1;
  const int pos_last =
      window > 0 ? min(seq - 1, key_last + window - 1) : seq - 1;
  const int r_first = (k0 * group / kRows) * kRows;
  const int n_it = ((pos_last + 1) * group - 1 - r_first) / kRows + 1;

  auto stage = [&](int it) {
    const int buf = it & 1, r0 = r_first + it * kRows;
    const int valid = min(kRows, n_rows - r0);
    const auto rows = [&](int r) { return head_row(r0 + r); };
    T* sq = s_qo + (size_t)(2 * buf) * kRows * D;
    stage_rows<T, D, kThreads>(sq, q, kRows, valid, rows, vec);
    stage_rows<T, D, kThreads>(sq + kRows * D, dout, kRows, valid, rows,
                               vec);
    float* sl = s_ld + buf * 2 * kRows;
    for (int r = tid; r < kRows; r += kThreads) {
      if (r < valid) {
        cp_async4(sl + r, lse + head_row(r0 + r));
        cp_async4(sl + kRows + r, dr + head_row(r0 + r));
      } else {
        sl[r] = 0.f;
        sl[kRows + r] = 0.f;
      }
    }
    cp_async_commit();
  };

  stage_rows<T, D, kThreads>(s_k, k, kKeys, min(kKeys, seq - k0),
                             [&](int j) { return key_row(k0 + j); }, vec);
  stage_rows<T, D, kThreads>(s_v, v, kKeys, min(kKeys, seq - k0),
                             [&](int j) { return key_row(k0 + j); }, vec);
  stage(0);   // K, V and the first row tile in one group

  // dK, dV: warp w holds keys 16 (w / 4) .. + 15 of the tile and the
  // 8-column tiles n with n % 4 == w % 4.  dQ: warp w takes rows
  // 16 (w / 2) .. + 15 of the row tile and the 8-column tiles n with
  // n % 2 == w % 2.
  constexpr int kNT = D / 32 > 0 ? D / 32 : 1;    // dK / dV tiles a warp
  constexpr int kNQ = D / 16 > 0 ? D / 16 : 1;    // dQ tiles a warp
  const int wk = warp / 4, wn = warp % 4, wr = warp / 2, wq = warp % 2;
  float acc_v[kNT][4], acc_k[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[j][e] = acc_k[j][e] = 0.f;
  const Tile<T, D> tk{s_k}, tv{s_v};
  auto x_of = [&](const T* x, int row, int key) {
    return to_float(x[row * kPitchX + key]);
  };

  for (int it = 0; it < n_it; ++it) {
    __syncthreads();   // the last row tile's buffers are consumed
    if (it + 1 < n_it) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1, r0 = r_first + it * kRows;
    const Tile<T, D> tq{s_qo + (size_t)(2 * buf) * kRows * D},
        to{s_qo + (size_t)(2 * buf + 1) * kRows * D};
    const float* sl = s_ld + buf * 2 * kRows;
    // S, dP, then P and dS of (16 rows, 16 keys) items, one a warp.
    {
      const int rt = warp / 2, kt = warp % 2;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      // S, then dP: one A fragment live at a time (registers).
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        const auto aq = M::load_a(
            [&](int m, int kk) { return tq.get(16 * rt + m, d0 + kk); }, g8,
            t4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          M::mma(s[nt], aq, M::load_b([&](int kk, int n) {
                   return tk.get(16 * kt + 8 * nt + n, d0 + kk);
                 }, g8, t4));
      }
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        const auto ao = M::load_a(
            [&](int m, int kk) { return to.get(16 * rt + m, d0 + kk); }, g8,
            t4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          M::mma(dp[nt], ao, M::load_b([&](int kk, int n) {
                   return tv.get(16 * kt + 8 * nt + n, d0 + kk);
                 }, g8, t4));
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 16 * rt + g8 + 8 * (e / 2),
                    kk = 16 * kt + 8 * nt + 2 * t4 + (e % 2);
          const int row = r0 + rr, key = k0 + kk, pos = row / group;
          const bool ok = row < n_rows && key < seq && key <= pos &&
                          (window <= 0 || pos - key < window);
          const float p = ok ? expf(s[nt][e] * scale - sl[rr]) : 0.f;
          s_p[rr * kPitchX + kk] = from_float<T>(p);
          s_s[rr * kPitchX + kk] =
              from_float<T>(p * (dp[nt][e] - sl[kRows + rr]));
        }
    }
    __syncthreads();   // P, dS in
    // dV += P^T dO, dK += dS^T Q over the tile's rows: the tile's
    // products from zero, then added in with rounded float32 adds (a
    // tensor-core accumulator chained over a long sequence drifts).
    float part_v[kNT][4], part_k[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part_v[j][e] = part_k[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kRows; ks += 16) {
      const auto ap = M::load_a(
          [&](int m, int kk) { return x_of(s_p, ks + kk, 16 * wk + m); }, g8,
          t4);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n0 = 8 * (4 * j + wn);
        if (n0 < D)
          M::mma(part_v[j], ap, M::load_b([&](int kk, int n) {
                   return to.get(ks + kk, n0 + n);
                 }, g8, t4));
      }
    }
#pragma unroll
    for (int ks = 0; ks < kRows; ks += 16) {
      const auto as = M::load_a(
          [&](int m, int kk) { return x_of(s_s, ks + kk, 16 * wk + m); }, g8,
          t4);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n0 = 8 * (4 * j + wn);
        if (n0 < D)
          M::mma(part_k[j], as, M::load_b([&](int kk, int n) {
                   return tq.get(ks + kk, n0 + n);
                 }, g8, t4));
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_v[j][e] += part_v[j][e];
        acc_k[j][e] += part_k[j][e];
      }
    // dQ's share of this key tile: dS K, added into the scratch.
    float acc_q[kNQ][4];
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_q[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKeys; ks += 16) {
      const auto a = M::load_a(
          [&](int m, int kk) { return x_of(s_s, 16 * wr + m, ks + kk); }, g8,
          t4);
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        const int n0 = 8 * (2 * j + wq);
        if (n0 >= D) continue;
        M::mma(acc_q[j], a, M::load_b([&](int kk, int n) {
                 return tk.get(ks + kk, n0 + n);
               }, g8, t4));
      }
    }
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const int col = 8 * (2 * j + wq) + 2 * t4;
      if (col >= D) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * wr + g8 + 8 * h;
        if (row >= n_rows) continue;
        atomicAdd(reinterpret_cast<float2*>(dq_acc + head_row(row) * D +
                                            col),
                  make_float2(acc_q[j][2 * h], acc_q[j][2 * h + 1]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = 8 * (4 * j + wn) + 2 * t4;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + 16 * wk + g8 + 8 * h;
      if (key >= seq) continue;
      const size_t at = key_row(key) * D + col;
      store2(dk + at, acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale);
      store2(dv + at, acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* scratch, void* dq, void* dk, void* dv, int batch,
                   int seq, int n_heads, int n_kv, int window, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(out);
  const T* dot = static_cast<const T*>(dout);
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout);
  const int group = n_heads / n_kv;
  if (scratch == nullptr) {   // the short path
    const size_t bytes = short_bytes<T>(seq, group, D);
    if (bytes > kMaxSmem) return cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(   // once
        flash_bwd_short<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_short<T, D><<<dim3(n_kv, batch), kShortThreads, bytes,
                            stream>>>(
        qt, kt, vt, ot, dot, lse, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), seq, n_heads, n_kv, window, scale, vec);
    return cudaGetLastError();
  }
  const size_t rows = (size_t)batch * seq * n_heads;
  float* dq_acc = scratch;   // the scratch's aligned start: float2 atomics
  float* dr = scratch + rows * D;
  cudaError_t err =
      cudaMemsetAsync(dq_acc, 0, rows * D * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  flash_bwd_rowdot<T><<<(unsigned)((rows + kRowThreads - 1) / kRowThreads),
                        kRowThreads, 0, stream>>>(ot, dot, dr, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t lbytes = LongLayout<T, D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_long<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lbytes);
  if (attr != cudaSuccess) return attr;
  flash_bwd_long<T, D><<<dim3((seq + kKeys - 1) / kKeys, n_kv, batch),
                         kThreads, lbytes, stream>>>(
      qt, kt, vt, dot, lse, dr, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), seq, n_heads, n_kv, window, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = rows * D;
  flash_bwd_dq_cast<T><<<(unsigned)((n + kRowThreads - 1) / kRowThreads),
                         kRowThreads, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

// The float32 scratch the backward takes at these sizes: 0 while a
// short-path block's rows fit in shared memory, else the long path's dQ
// sums and each row's Dr, B * S * H * (D + 1).
template <typename T>
size_t scratch_floats(int batch, int seq, int n_heads, int n_kv, int dim) {
  if (short_bytes<T>(seq, n_heads / n_kv, dim) <= kMaxSmem) return 0;
  return (size_t)batch * seq * n_heads * (dim + 1);
}

template <typename T>
cudaError_t launch_d(int dim, const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* scratch, void* dq, void* dk, void* dv, int batch,
                     int seq, int n_heads, int n_kv, int window, float scale,
                     cudaStream_t stream) {
  switch (dim) {
    case 8:
      return launch<T, 8>(q, k, v, out, dout, lse, scratch, dq, dk, dv,
                          batch, seq, n_heads, n_kv, window, scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, dout, lse, scratch, dq, dk, dv,
                           batch, seq, n_heads, n_kv, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, lse, scratch, dq, dk, dv,
                           batch, seq, n_heads, n_kv, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, scratch, dq, dk, dv,
                           batch, seq, n_heads, n_kv, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout [B, S, H, D] and k, v [B, S, KV, D]: contiguous, one dtype
// (0 = float32, 1 = bfloat16), H a multiple of KV, D in {8, 16, 32, 64};
// lse [B, S, H] float32 from the forward.  window > 0 as in
// flash_attention_launch.  `scratch` null takes the short path (an error
// if its block's shared memory does not fit), else it holds the floats
// flash_attention_bwd_scratch_floats reports, for the long one.  Writes
// dq [B, S, H, D], dk and dv [B, S, KV, D] in the inputs' dtype.  Returns
// the cudaError_t of the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int batch, int seq, int n_heads, int n_kv, int dim, int window,
    int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || n_kv <= 0 || n_heads < n_kv ||
      n_heads % n_kv != 0 || window < 0 || batch > 65535 || n_kv > 65535 ||
      lse == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(dim, q, k, v, out, dout, lf, sc, dq, dk,
                                  dv, batch, seq, n_heads, n_kv, window,
                                  scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(dim, q, k, v, out, dout, lf, sc,
                                          dq, dk, dv, batch, seq, n_heads,
                                          n_kv, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The float32 scratch flash_attention_bwd_launch takes at these sizes and
// dtype (0 = float32, 1 = bfloat16): 0 for the short path (pass scratch
// null), else the long path's.  -1 for arguments the launcher refuses.
extern "C" long long flash_attention_bwd_scratch_floats(int batch, int seq,
                                                        int n_heads,
                                                        int n_kv, int dim,
                                                        int dtype) {
  if (batch <= 0 || seq <= 0 || n_kv <= 0 || n_heads < n_kv ||
      n_heads % n_kv != 0 ||
      (dim != 8 && dim != 16 && dim != 32 && dim != 64))
    return -1;
  switch (dtype) {
    case 0:
      return (long long)scratch_floats<float>(batch, seq, n_heads, n_kv, dim);
    case 1:
      return (long long)scratch_floats<__nv_bfloat16>(batch, seq, n_heads,
                                                      n_kv, dim);
    default:
      return -1;
  }
}
