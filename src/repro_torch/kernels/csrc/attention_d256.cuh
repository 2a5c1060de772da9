// The head-dim-256 attention tile on the tensor cores, shared by the
// float32 flash forward at D 256 (flash_attention.cu, flash_kernel_d256)
// and the ragged paged attention above head dim 128
// (paged_attention_varlen.cu, varlen_d256_kernel).
//
// Why a routine of its own: an mma row tile is 16 rows, and 16 rows x 256
// float32 output dims are 128 accumulator registers a lane, too many to
// keep beside the scores and operands.  So four warps share each group of
// rows, one for each 64 output dims, and a warp carries kM (1 or 2) m-tiles
// of 16 rows (32 accumulator registers a lane each): at kM 2 every K and V
// fragment it reads and splits serves two mma products.  Both kernels
// reach ~40 TFLOP/s of float32 products on an H100, and mma.sync's rate
// is not what holds them there: 3xTF32 products with operands split in
// registers run at ~108 on that card, this routine's score loop alone
// (operands split at each use, K read from shared memory) at ~67
// (probe_mma_rate.cu; PERF.md).  The splits and loads, then the
// exchange, softmax and P V around the products, take the rest.
// Per K/V tile of kKeys = 32 keys each warp:
//   - takes the score product over its own 64 dims of Q and K, from zero
//     (one 64-dim chunk: float32 through 3xTF32 mma.m16n8k8, mma_tf32.cuh;
//     bfloat16 through mma.m16n8k16 with float32 sums), Q's fragments held
//     for the whole walk (loaded once, scaled in float32 as the plain
//     versions scale it; in registers, or in shared memory at kM 2);
//   - puts its partial scores in shared memory (a float4 a lane an m-tile
//     and score n-tile), meets the group's other three warps at a named
//     barrier, and adds the four partials in warp order (0 + 1 + 2 + 3,
//     rounded float32 adds: each warp does the same adds, so all four hold
//     the same scores, running max, sum and P);
//   - masks (only on tiles the caller marks as edges), runs the online
//     softmax on the accumulator fragment (ex2 on the SFU, the flash
//     kernels' update order) and multiplies P, taken in place from the
//     score accumulator, by its own 64 columns of V: 3xTF32 with the key
//     order of the tf32 flash kernel (slot t4 is key 2 t4, slot t4 + 4 key
//     2 t4 + 1), or bfloat16 pairs with V's fragments by ldmatrix.trans.
//     Each 8-dim output tile's product over the tile's keys starts from
//     zero and goes into O as o = o * alpha + part.
// The caller stages K and V rows (any source: contiguous or paged) into a
// ring of stages of stage_bytes (K rows, then V rows, at Pitch), decides
// which tiles a row group walks and which are edges, and writes the result
// (normalised, or the float32 partial m, l, acc of a context split).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace d256 {

constexpr int kMaxD = 256;
constexpr int kWarpDims = 64;                      // output dims a warp owns
constexpr int kWarpsPerTile = kMaxD / kWarpDims;   // 4 warps a row group
constexpr int kTileThreads = 32 * kWarpsPerTile;   // 128
constexpr int kKeys = 32;                          // keys a K/V stage
constexpr int kKT = kKeys / 8;                     // score n-tiles
constexpr int kNT = kWarpDims / 8;                 // a warp's output n-tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr float kMinDenom = 1e-30f;

// Staged row pitches in elements.  float32: K at D + 8 and V at D + 4
// floats put a half warp's float2 K reads and a warp's V reads on distinct
// banks (the tf32 flash kernel's pitches); bfloat16: 528-byte rows for both
// (each 32-bit K read of a warp and each 16-byte ldmatrix row of a phase
// on its own banks).
template <typename T>
struct Pitch {
  static constexpr int kK = kMaxD + 8;
  static constexpr int kV = sizeof(T) == 4 ? kMaxD + 4 : kMaxD + 8;
};

// One stage: K rows then V rows, kKeys each.
template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kKeys * (Pitch<T>::kK + Pitch<T>::kV) * sizeof(T);
}
// The score exchange of `warps` warps of m m-tiles: a float4 a lane an
// m-tile and score n-tile.
__host__ __device__ constexpr size_t exchange_bytes(int warps, int m) {
  return (size_t)warps * m * kKT * 32 * sizeof(float4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The four warps of row group `group` of the block (barrier ids 1 ..; 0
// is __syncthreads').
__device__ __forceinline__ void tile_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kTileThreads)
               : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// Two float32 values rounded to a bfloat16 pair (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8 x 8 bfloat16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// Q's fragments of a warp's 64 dims for its kM m-tiles, for the whole
// walk: a 16-byte entry a lane per (m-tile, k-step).  float32: the scaled
// values of 8 k-steps of 8 dims (as float bits; split into tf32 hi / lo
// at each use: held split they would take twice the room); bfloat16: 4
// k-steps of 16 dims as bfloat16 pairs.  QRegs keeps them in registers,
// QShared in shared memory (where registers are short: two m-tiles).
template <typename T>
__host__ __device__ constexpr int q_steps() {
  return sizeof(T) == 4 ? 8 : 4;
}
template <typename T, int kM>
struct QRegs {
  uint4 x[kM][q_steps<T>()];
  __device__ __forceinline__ uint4 frag(int m, int ks) const {
    return x[m][ks];
  }
  __device__ __forceinline__ void put(int m, int ks, uint4 v) { x[m][ks] = v; }
};
template <typename T, int kM>
struct QShared {
  uint4* p;   // this warp's [kM][q_steps][32]
  __device__ __forceinline__ uint4 frag(int m, int ks) const {
    return p[(m * q_steps<T>() + ks) * 32 + threadIdx.x % 32];
  }
  __device__ __forceinline__ void put(int m, int ks, uint4 v) {
    p[(m * q_steps<T>() + ks) * 32 + threadIdx.x % 32] = v;
  }
};
// Bytes of QShared for `warps` warps of kM m-tiles.
template <typename T>
__host__ __device__ constexpr size_t q_shared_bytes(int warps, int m) {
  return (size_t)warps * m * q_steps<T>() * 32 * sizeof(uint4);
}

// The running state of one lane: O over the warp's 64 dims (rows g8 and
// g8 + 8 of each m-tile), each row's max and this lane's share of its sum.
template <int kM>
struct State {
  float o[kM][kNT][4];
  float m[kM][2], l[kM][2];
};

template <int kM>
__device__ __forceinline__ void init(State<kM>& st) {
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[i][nt][e] = 0.f;
    st.m[i][0] = st.m[i][1] = kNegInf;
    st.l[i][0] = st.l[i][1] = 0.f;
  }
}

// The fragment of k-step ks: rows g8 (row0) and g8 + 8 (row1) of an
// m-tile, each D elements or null (a row that attends nothing: zeros),
// this warp's dims from dw, times scale in float32; dims past D are
// zeros.
__device__ __forceinline__ uint4 q_fragment(const float* row0,
                                            const float* row1, int dw,
                                            int ks, int D, float scale,
                                            int t4) {
  const int d = dw + 8 * ks + 2 * t4;
  float2 x0 = make_float2(0.f, 0.f), x1 = x0;
  if (d < D) {
    if (row0 != nullptr) x0 = ld2(row0 + d);
    if (row1 != nullptr) x1 = ld2(row1 + d);
  }
  // Slot t4 is dim 2 t4 of the k-step, slot t4 + 4 dim 2 t4 + 1.
  return make_uint4(
      __float_as_uint(x0.x * scale), __float_as_uint(x1.x * scale),
      __float_as_uint(x0.y * scale), __float_as_uint(x1.y * scale));
}
__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* row,
                                                int d, int D, float scale) {
  if (row == nullptr || d >= D) return 0u;
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + d));
  return pack_bf16(x.x * scale, x.y * scale);
}
__device__ __forceinline__ uint4 q_fragment(const __nv_bfloat16* row0,
                                            const __nv_bfloat16* row1,
                                            int dw, int ks, int D,
                                            float scale, int t4) {
  const int d = dw + 16 * ks + 2 * t4;
  return make_uint4(scaled_pair(row0, d, D, scale),
                    scaled_pair(row1, d, D, scale),
                    scaled_pair(row0, d + 8, D, scale),
                    scaled_pair(row1, d + 8, D, scale));
}
// rows[i][h]: row g8 + 8 h of m-tile i.
template <typename T, int kM, typename Q>
__device__ __forceinline__ void load_q(Q& q, const T* (&rows)[kM][2],
                                       int dw, int D, float scale, int t4) {
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int ks = 0; ks < q_steps<T>(); ++ks)
      q.put(i, ks, q_fragment(rows[i][0], rows[i][1], dw, ks, D, scale, t4));
}

// This warp's partial scores over its 64 dims: s[i][j] is m-tile i's keys
// 8 j .. 8 j + 7 of the stage (accumulator layout: s[i][j][0..1] row g8,
// keys 8 j + 2 t4, + 1; s[i][j][2..3] row g8 + 8).  Each K fragment is
// read and split once for all kM m-tiles.
template <int kM, typename Q>
__device__ __forceinline__ void partial_scores(float (&s)[kM][kKT][4],
                                               const Q& q, const float* sk,
                                               int dw, int g8, int t4) {
  constexpr int kK = Pitch<float>::kK;
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int d0 = dw + 8 * ks;
    tf32::Frag a[kM];
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const uint4 x = q.frag(i, ks);
      tf32::split(__uint_as_float(x.x), a[i].hi[0], a[i].lo[0]);
      tf32::split(__uint_as_float(x.y), a[i].hi[1], a[i].lo[1]);
      tf32::split(__uint_as_float(x.z), a[i].hi[2], a[i].lo[2]);
      tf32::split(__uint_as_float(x.w), a[i].hi[3], a[i].lo[3]);
    }
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const float2 y = ld2(sk + (8 * j + g8) * kK + d0 + 2 * t4);
      tf32::FragB b;
      tf32::split(y.x, b.hi[0], b.lo[0]);
      tf32::split(y.y, b.hi[1], b.lo[1]);
#pragma unroll
      for (int i = 0; i < kM; ++i) tf32::mma3(s[i][j], a[i], b);
    }
  }
}
template <int kM, typename Q>
__device__ __forceinline__ void partial_scores(float (&s)[kM][kKT][4],
                                               const Q& q,
                                               const __nv_bfloat16* sk,
                                               int dw, int g8, int t4) {
  constexpr int kK = Pitch<__nv_bfloat16>::kK;
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int d0 = dw + 16 * ks + 2 * t4;
    uint32_t a[kM][4];
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const uint4 x = q.frag(i, ks);
      a[i][0] = x.x, a[i][1] = x.y, a[i][2] = x.z, a[i][3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const __nv_bfloat16* kr = sk + (8 * j + g8) * kK + d0;
      const uint32_t b0 = ld_u32(kr), b1 = ld_u32(kr + 8);
#pragma unroll
      for (int i = 0; i < kM; ++i) mma_bf16(s[i][j], a[i], b0, b1);
    }
  }
}

// O = O alpha + P V over this warp's 64 dims; p is the probabilities in
// the score accumulator's layout.  Each V fragment is read and split once
// for all kM m-tiles.
template <int kM>
__device__ __forceinline__ void add_pv(State<kM>& st,
                                       const float (&p)[kM][kKT][4],
                                       const float (&alpha)[kM][2],
                                       const float* sv, int dw, int g8,
                                       int t4, int lane) {
  constexpr int kV = Pitch<float>::kV;
  // Key step j: slot t4 is key 8 j + 2 t4, slot t4 + 4 key 8 j + 2 t4 + 1,
  // so P's A fragment is the lane's own accumulator values.
  tf32::Frag pa[kM][kKT];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      tf32::split(p[i][j][0], pa[i][j].hi[0], pa[i][j].lo[0]);
      tf32::split(p[i][j][2], pa[i][j].hi[1], pa[i][j].lo[1]);
      tf32::split(p[i][j][1], pa[i][j].hi[2], pa[i][j].lo[2]);
      tf32::split(p[i][j][3], pa[i][j].hi[3], pa[i][j].lo[3]);
    }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float part[kM][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const float* vp = sv + (8 * j + 2 * t4) * kV + dw + 8 * nt + g8;
      tf32::FragB b;
      tf32::split(vp[0], b.hi[0], b.lo[0]);
      tf32::split(vp[kV], b.hi[1], b.lo[1]);
#pragma unroll
      for (int i = 0; i < kM; ++i) tf32::mma3(part[i], pa[i][j], b);
    }
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st.o[i][nt][e] = fmaf(st.o[i][nt][e], alpha[i][e / 2], part[i][e]);
  }
}
template <int kM>
__device__ __forceinline__ void add_pv(State<kM>& st,
                                       const float (&p)[kM][kKT][4],
                                       const float (&alpha)[kM][2],
                                       const __nv_bfloat16* sv, int dw,
                                       int g8, int t4, int lane) {
  constexpr int kV = Pitch<__nv_bfloat16>::kV;
  // Keys 16 kk .. 16 kk + 15 as the A fragment of m16n8k16: the score
  // accumulators of n-tiles 2 kk and 2 kk + 1, rounded to bfloat16 pairs.
  uint32_t pa[kM][2][4];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[i][kk][0] = pack_bf16(p[i][2 * kk][0], p[i][2 * kk][1]);
      pa[i][kk][1] = pack_bf16(p[i][2 * kk][2], p[i][2 * kk][3]);
      pa[i][kk][2] = pack_bf16(p[i][2 * kk + 1][0], p[i][2 * kk + 1][1]);
      pa[i][kk][3] = pack_bf16(p[i][2 * kk + 1][2], p[i][2 * kk + 1][3]);
    }
  // ldmatrix.trans: matrix mi = lane / 8 is keys 16 kk + 8 (mi % 2) .. + 7
  // by dims 16 np + 8 (mi / 2) .. + 7: registers 0, 1 are n-tile 2 np's
  // B fragment, 2, 3 n-tile 2 np + 1's.
  const int mi = lane / 8, rr = lane % 8;
  const __nv_bfloat16* vb = sv + ((mi & 1) * 8 + rr) * kV + dw + (mi >> 1) * 8;
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np) {
    float part[kM][2][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t b[4];
      ldsm_x4_t(vb + 16 * kk * kV + 16 * np, b);
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        mma_bf16(part[i][0], pa[i][kk], b[0], b[1]);
        mma_bf16(part[i][1], pa[i][kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st.o[i][2 * np + c][e] =
              fmaf(st.o[i][2 * np + c][e], alpha[i][e / 2], part[i][c][e]);
  }
}

// One staged K/V tile for one row group (kM m-tiles of 16 rows, four
// warps; all four call it together: it meets them at tile_sync).  ex is
// the block's exchange area, warp the warp's index in the block (group
// warp / 4), dw = 64 * (warp % 4).  visible(key_in_stage, i, h) says
// whether row g8 + 8 h of the lane's m-tile i sees that key; it is asked
// only when `edge`.
template <typename T, int kM, typename Q, typename Visible>
__device__ __forceinline__ void attend(State<kM>& st, const Q& q,
                                       const T* sk, const T* sv, float4* ex,
                                       int warp, bool edge, Visible visible) {
  const int lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
  const int group = warp / kWarpsPerTile, wd = warp % kWarpsPerTile;
  const int dw = wd * kWarpDims;
  float s[kM][kKT][4];
  partial_scores<kM>(s, q, sk, dw, g8, t4);

  // The group's four partials meet: S = p0 + p1 + p2 + p3 in every warp.
  float4* mine = ex + (size_t)warp * kM * kKT * 32;
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kKT; ++j)
      mine[(i * kKT + j) * 32 + lane] =
          make_float4(s[i][j][0], s[i][j][1], s[i][j][2], s[i][j][3]);
  tile_sync(group);
  const float4* first = ex + (size_t)group * kWarpsPerTile * kM * kKT * 32;
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      float4 acc = first[(i * kKT + j) * 32 + lane];
#pragma unroll
      for (int w = 1; w < kWarpsPerTile; ++w) {
        const float4 y = first[((w * kM + i) * kKT + j) * 32 + lane];
        acc.x += y.x, acc.y += y.y, acc.z += y.z, acc.w += y.w;
      }
      s[i][j][0] = acc.x, s[i][j][1] = acc.y, s[i][j][2] = acc.z,
      s[i][j][3] = acc.w;
    }

  // Online softmax on the fragment (a row spans a quad).
  float alpha[kM][2];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[i][j][2 * h + c];
          if (edge && !visible(8 * j + 2 * t4 + c, i, h)) x = -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(st.m[i][h], mx);
      alpha[i][h] = ex2((st.m[i][h] - m_new) * kLog2e);
      const float ml = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[i][j][2 * h + c];
          x = ex2(fmaf(x, kLog2e, -ml));   // masked: ex2(-inf) = 0
          sum += x;
        }
      st.l[i][h] = st.l[i][h] * alpha[i][h] + sum;   // this lane's share
      st.m[i][h] = m_new;
    }
  add_pv<kM>(st, s, alpha, sv, dw, g8, t4, lane);
}

// Each row's whole sum (the quad's shares added).
template <int kM>
__device__ __forceinline__ void reduce_l(State<kM>& st) {
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.l[i][h] += __shfl_xor_sync(0xffffffffu, st.l[i][h], 1);
      st.l[i][h] += __shfl_xor_sync(0xffffffffu, st.l[i][h], 2);
    }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Row g8 + 8 h of the lane's m-tile i, dims dw .. dw + 63 (below D) of
// out_row: O / max(l, 1e-30) (after reduce_l), or zeros when live is
// false.
template <typename T, int kM>
__device__ __forceinline__ void write_row(T* out_row, const State<kM>& st,
                                          int i, int h, bool live, int dw,
                                          int D, int t4) {
  const float inv = live ? 1.f / fmaxf(st.l[i][h], kMinDenom) : 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int d = dw + 8 * nt + 2 * t4;
    if (d < D)
      store2(out_row + d, live ? st.o[i][nt][2 * h] * inv : 0.f,
             live ? st.o[i][nt][2 * h + 1] * inv : 0.f);
  }
}

}  // namespace d256
