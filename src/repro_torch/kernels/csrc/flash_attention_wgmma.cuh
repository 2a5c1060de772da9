// The bfloat16, D = 64 instantiation of flash_attention.cu: Hopper's
// tensor cores (wgmma) fed by TMA.  flash_attention.cu's launcher takes
// it for bfloat16 inputs with head dim 64 (the head dim of every model the
// port serves); float32 and the other head dims keep the FMA kernel.
//
// What bounds it on an H100: operations at long S (4 D flops per
// attended (query, key) pair; 13.4 GFLOP for one hymba layer at S 2048,
// 0.0136 ms at the bf16 tensor-core peak of 989 TFLOP/s), bytes at short
// S.  The FMA kernel runs bf16 on float32 pipes, ~39x its bf16 bound.
//
// Design (one warpgroup of 128 threads per block, grid (row tiles, KV, B)
// flattened with the row tiles slowest and the last ones, the heaviest
// causal rows, first):
// - Q tile, GQA-packed: for one kv head the G query heads at a position
//   are adjacent in [B, S, H, D], so a 4-D tensor map (D, H, S, B) with
//   box (64, G, P, 1) lands P positions x G heads as P * G rows of 128
//   bytes.  wgmma's M is 64, so P = 64 / G (12 positions, 60 rows at
//   hymba's G 5; 9 and 63 at qwen's G 7); the pad rows are zeroed.  One
//   warpgroup at M 64 rather than two over 128 rows: it keeps the block at
//   41 KB of shared memory and ~100 registers a thread, so several blocks
//   share an SM and one block's softmax overlaps another's products
//   without a producer warp or a second barrier set.  G must be <= 64,
//   as in every model the port serves; the launcher refuses more.
// - K/V tiles of 64 keys come by TMA (cp.async.bulk.tensor, one mbarrier
//   per stage) into a 2-stage ring, the next tile in flight while this one
//   is used.  Maps (D, KV, S, B) box (64, 1, 64, 1): keys past S are
//   zero-filled and masked.  Maps are encoded on the host with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
//   library links no libcuda).  128-byte swizzle in every box and in the
//   wgmma descriptors alike.
// - Scores: wgmma m64n64k16 x 4 (D 64), Q and K both K-major from shared
//   memory, float32 in registers.  The causal and window masks are applied
//   only on the tiles that cross the causal edge or the window's start;
//   tiles wholly outside either are never loaded.
// - Online softmax on the accumulator fragment: a thread holds 2 rows x 16
//   keys, a row spans the 4 lanes of a quad, so two shuffles reduce it.
//   The scale (1/8 at D 64, exact in bf16) and log2(e) are folded into one
//   multiply of the scores, then exp2.  Running max from -1e30, masked
//   keys exactly 0, denominator clamped at 1e-30.
// - Values: P is cast to bf16 in registers (as the plain version casts its
//   probabilities to q's dtype before the value product) and is the
//   register A operand of wgmma m64n64k16 x 4; the V tile is the B operand
//   in its transposed (MN-major) form, straight from the TMA box.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the entry point is fetched
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wg {

constexpr int kThreads = 128;                 // one warpgroup
constexpr int kRows = 64;                     // wgmma M: packed query rows
constexpr int kKeys = 64;                     // keys per K/V tile
constexpr int kDim = 64;                      // head dim: one 128-byte row
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kTileBytes = kRows * kDim * 2;  // one 64 x 64 bf16 tile
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024;  // +align
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  K-major tiles of 128-byte
// rows: the stride between 8-row groups is 1024 bytes, the leading offset
// is unused.  The MN-major V tile: 1024 bytes between 8-key groups, one
// 64-wide swizzle atom across N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads across a wait.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, A and B from shared memory, both K-major; accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A B, A from registers (the m64k16 fragment), B from shared memory
// transposed (MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WG_D32
#undef WG_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of m64nNk16 (float32): warp w of the warpgroup
// holds rows 16w .. 16w + 15; lane l holds rows 16w + l/4 (h = 0) and
// 16w + l/4 + 8 (h = 1), and of each n-block j of 8 columns the two
// columns 8j + 2(l%4) + {0, 1}: d[4j + 2h + c].
template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int batch, int seq,
                   int n_heads, int n_kv, int pos_per_tile, int n_pos_tiles,
                   int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + kStages];   // Q, then one per ring stage
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = base;
  auto s_k = [&](int st) { return base + (1 + st) * kTileBytes; };
  auto s_v = [&](int st) { return base + (1 + kStages + st) * kTileBytes; };

  int x = blockIdx.x;
  const int kvh = x % n_kv;
  x /= n_kv;
  const int b = x % batch;
  const int pt = n_pos_tiles - 1 - x / batch;   // heaviest first

  const int group = n_heads / n_kv;
  const int p0 = pt * pos_per_tile;
  const int n_q = pos_per_tile * group;         // rows the Q box fills
  const int last = min(p0 + pos_per_tile, seq) - 1;
  const int first = kWindow ? max(0, p0 - window + 1) : 0;
  const int t0 = first / kKeys, n_tiles = last / kKeys - t0 + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Rows n_q .. 63 are never written by TMA: zero them so they stay finite.
  for (int e = n_q * 8 + tid; e < kRows * 8; e += kThreads)
    reinterpret_cast<uint4*>(s_q)[e] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int st, int tile) {
    mbar_expect_tx(&bars[1 + st], 2 * kTileBytes);
    tma_load(s_k(st), map_k, &bars[1 + st], 0, kvh, tile * kKeys, b);
    tma_load(s_v(st), map_v, &bars[1 + st], 0, kvh, tile * kKeys, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], n_q * kDim * 2);
    tma_load(s_q, &tm_q, &bars[0], 0, kvh * group, p0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st) load_kv(st, t0 + st);
  }

  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    pos[h] = r < n_q ? p0 + r / group : -1;   // -1: pad row, attends nothing
  }
  float o[32], sc[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.f;
  const uint32_t q_addr = smem_u32(s_q);

  mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, k0 = (t0 + it) * kKeys;
    mbar_wait(&bars[1 + st], (it / kStages) & 1);

    // Scores: sc = Q K^T over D = 4 x 16.
    const uint32_t k_addr = smem_u32(s_k(st));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk)
      wgmma_ss(sc, desc(q_addr + 32 * kk, 16, 1024),
               desc(k_addr + 32 * kk, 16, 1024), kk);
    wgmma_commit();
    wgmma_wait();
    reg_fence(sc);

    // Masks only where a tile crosses the causal edge (a key past the
    // tile's first position) or the window's start (a key too old for its
    // newest position).
    const bool edge = k0 + kKeys - 1 > p0 ||
                      (kWindow && k0 < last - window + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          float s = sc[i] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            const bool ok =
                key <= pos[h] && (!kWindow || pos[h] - key < window);
            s = ok ? s : -INFINITY;
          }
          sc[i] = s;
          mx = fmaxf(mx, s);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          sc[i] = exp2f(sc[i] - m_new);   // masked: exp2(-inf) = 0
          sum += sc[i];
          o[i] *= alpha;
        }
      l[h] = l[h] * alpha + sum;   // this lane's share; summed at the end
      m[h] = m_new;
    }

    // Values: o += P V, P in bf16 registers.  The score fragment of keys
    // 16kk .. 16kk + 15 is the A fragment of k-step kk.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    const uint32_t v_addr = smem_u32(s_v(st));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs(o, pa[kk], desc(v_addr + kk * 16 * kDim * 2, kTileBytes, 1024));
    wgmma_commit();
    wgmma_wait();
    reg_fence(o);

    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && it + kStages < n_tiles) load_kv(st, t0 + it + kStages);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (pos[h] < 0 || pos[h] >= seq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* row = out + (((size_t)b * seq + pos[h]) * n_heads +
                                kvh * group + r % group) * kDim;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, S, n, 64] bf16 as the 4-D map (64, n, S, B), box (64, box_n, box_s,
// 1), 128-byte swizzle, zero fill out of bounds.
inline bool encode(CUtensorMap* map, const void* ptr, int batch, int seq,
                   int n, int box_n, int box_s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = kDim * 2;
  cuuint64_t dims[4] = {kDim, (cuuint64_t)n, (cuuint64_t)seq,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {row, row * n, row * n * seq};
  cuuint32_t box[4] = {kDim, (cuuint32_t)box_n, (cuuint32_t)box_s, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int seq, int n_heads, int n_kv, int window,
                   float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv;
  if (group > kRows) return cudaErrorInvalidValue;
  const int pp = kRows / group;                 // positions per row tile
  const int n_pos_tiles = (seq + pp - 1) / pp;
  const long long blocks = (long long)n_pos_tiles * n_kv * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, batch, seq, n_heads, group, pp) ||
      !encode(&mk, k, batch, seq, n_kv, 1, kKeys) ||
      !encode(&mv, v, batch, seq, n_kv, 1, kKeys))
    return cudaErrorInvalidValue;
  flash_kernel_wgmma<kWindow><<<(unsigned)blocks, kThreads, kSmemBytes,
                                stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), batch, seq, n_heads, n_kv,
      pp, n_pos_tiles, window, scale * kLog2e);
  return cudaGetLastError();
}

// window > 0: the sliding-window instantiation; 0: global.
inline cudaError_t launch_w(const void* q, const void* k, const void* v,
                            void* out, int batch, int seq, int n_heads,
                            int n_kv, int window, float scale,
                            cudaStream_t stream) {
  if (window > 0)
    return launch<true>(q, k, v, out, batch, seq, n_heads, n_kv, window,
                        scale, stream);
  return launch<false>(q, k, v, out, batch, seq, n_heads, n_kv, 0, scale,
                       stream);
}

}  // namespace wg
