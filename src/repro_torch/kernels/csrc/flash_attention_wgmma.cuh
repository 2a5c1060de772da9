// The bfloat16 instantiation of flash_attention.cu at D 64 and 128:
// Hopper's tensor cores (wgmma) fed by TMA.  flash_attention.cu's launcher
// takes it for every bfloat16 input at those head dims, with or without
// the logsumexp; float32 takes the 3xTF32 kernel there, and D 8, 16 and
// 32 the FMA kernel.
//
// What bounds it on an H100: operations at long S (4 D flops per
// attended (query, key) pair; 13.4 GFLOP for one hymba layer at S 2048,
// 0.0136 ms at the bf16 tensor-core peak of 989 TFLOP/s; 42.9 GFLOP for
// a qwen2.5-14b layer at D 128, 0.0434 ms), bytes at short S.
//
// Design (one warpgroup of 128 threads per block, grid (row tiles, KV, B)
// flattened with the row tiles slowest and the last ones, the heaviest
// causal rows, first):
// - Tiles in shared memory are rows of 128-byte swizzle atoms: a row of
//   D 64 is one atom, a row of D 128 two, kept as two 64-column sub-tiles
//   of 8 KB (kAtomBytes), each its own TMA box and swizzle pattern.
// - Q tile, GQA-packed: for one kv head the G query heads at a position
//   are adjacent in [B, S, H, D], so a 4-D tensor map (D, H, S, B) with
//   box (64, G, P, 1) lands P positions x G heads as P * G rows of 128
//   bytes (one box per atom).  wgmma's M is 64, so P = 64 / G (12
//   positions, 60 rows at hymba's G 5; 9 and 63 at qwen's G 7; 64 at
//   codeqwen's G 1); the pad rows are zeroed.  G must be <= 64, as in
//   every model the port serves; the launcher refuses more.  Each warp
//   then reads its 16 rows once into registers as the A fragments of the
//   D / 16 k-steps (16-byte chunk c of row r sits at chunk c ^ (r % 8)),
//   so the scores read only K from shared memory: with Q from shared
//   memory too, m64n64k16 wants more shared-memory bandwidth than the SM
//   has beside the TMA writes.
// - K/V tiles of 64 keys come by TMA (cp.async.bulk.tensor) into a
//   2-stage ring, K and V of a stage with an mbarrier each: a K slot is
//   refilled once its tile's scores are done, a V slot once its values
//   are.  Maps (D, KV, S, B) box (64, 1, 64, 1): keys past S are
//   zero-filled and masked.  Maps are encoded on the host with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
//   library links no libcuda).  128-byte swizzle in every box and in the
//   wgmma descriptors alike.
// - Per tile it: the scores of it (wgmma m64n64k16 x D / 16, Q from
//   registers, K K-major) and the values of tile it - 1 (m64nDk16 x 4)
//   are issued together; the scores are waited for and its softmax runs
//   while the values are still on the tensor cores; then the accumulator
//   is rescaled.  P of consecutive tiles alternates between two register
//   sets, so no register an in-flight product reads is written (ptxas
//   would serialize the products).  The causal and window masks apply only
//   on tiles that cross the causal edge or the window's start; tiles
//   wholly outside either are never loaded.
// - Online softmax on the accumulator fragment: a thread holds 2 rows x 16
//   keys, a row spans the 4 lanes of a quad, so two shuffles reduce it.
//   The scale and log2(e) are folded into one multiply of the scores, then
//   ex2 on the SFU (the running max is in log2 units).  Running max from
//   -1e30, masked keys exactly 0, denominator clamped at 1e-30.
// - Values: P is cast to bf16 in registers (as the plain version casts its
//   probabilities to q's dtype before the value product) and is the
//   register A operand; the V tile is the B operand in its transposed
//   (MN-major) form, straight from the TMA boxes (the descriptor's
//   leading offset steps from one 64-column atom to the next).
// - The logsumexp, when asked for: lse = m ln 2 + log l (m in log2 units),
//   float32, one float per row by the quad's first lane.
// - Registers: 125-128 a thread at D 64, 178-180 at D 128, no spills;
//   shared memory 41 / 81 KB: two blocks an SM at D 128 (three would need
//   168 registers, where ptxas serializes the products and spills).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the entry point is fetched
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: two builds of this file loaded into one process keep
// their own kernels and launch state.
namespace {
namespace wg {

constexpr int kThreads = 128;                 // one warpgroup
constexpr int kRows = 64;                     // wgmma M: packed query rows
constexpr int kKeys = 64;                     // keys per K/V tile
constexpr int kAtom = 64;                     // columns of a 128-byte atom
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kAtomBytes = kRows * kAtom * 2;  // one 64 x 64 bf16 sub-tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Head dim D (64 or 128): D / 64 atoms a row.
template <int D>
struct Shape {
  static_assert(D == 64 || D == 128, "wgmma flash takes D 64 or 128");
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;   // 64 rows
  static constexpr int kSmemBytes =
      (1 + 2 * kStages) * kTileBytes + 1024;   // Q, the ring, alignment
};

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
// is unused.  The MN-major V tile: 1024 bytes between 8-key groups, and
// the leading offset from one 64-wide swizzle atom across N to the next
// (kAtomBytes; only D 128 has a second).
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
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across a wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d (+)= A B at N 64, A from registers (the m64k16 fragment), B from
// shared memory: K-major (kTransB 0: the scores' K tile) or MN-major
// (kTransB 1: D 64's V tile); accumulate = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d)                                                         \
  WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The same at N 128, B MN-major (D 128's value product).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  static_assert(kTransB == 1, "N 128 is the value product only");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
#undef WG_D32
#undef WG_OUT32
#undef WG_D64
#undef WG_OUT64

// 2^x on the SFU (x <= 0 here; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of m64nNk16 (float32): warp w of the warpgroup
// holds rows 16w .. 16w + 15; lane l holds rows 16w + l/4 (h = 0) and
// 16w + l/4 + 8 (h = 1), and of each n-block j of 8 columns the two
// columns 8j + 2(l%4) + {0, 1}: d[4j + 2h + c].
template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int batch, int seq, int n_heads, int n_kv,
                   int pos_per_tile, int n_pos_tiles, int window,
                   float scale_log2) {
  using Sh = Shape<D>;
  constexpr int kTileBytes = Sh::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * kStages];   // Q, K stages, V stages
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

  // Rows n_q .. 63 of each sub-tile are never written by TMA: zero them so
  // they stay finite.
  for (int e = n_q * 8 + tid; e < kRows * 8; e += kThreads) {
#pragma unroll
    for (int a = 0; a < Sh::kAtoms; ++a)
      reinterpret_cast<uint4*>(s_q + a * kAtomBytes)[e] =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // K and V of a ring stage have barriers of their own: a K slot is free
  // once its tile's scores are done, a V slot once its values are.
  uint64_t* k_bar = &bars[1];
  uint64_t* v_bar = &bars[1 + kStages];
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load = [&](const CUtensorMap* map, uint8_t* dst, uint64_t* bar,
                  int tile) {
    mbar_expect_tx(bar, kTileBytes);
#pragma unroll
    for (int a = 0; a < Sh::kAtoms; ++a)
      tma_load(dst + a * kAtomBytes, map, bar, a * kAtom, kvh, tile * kKeys,
               b);
  };
  auto wait_tile = [&](uint64_t* bars_of, int it) {
    mbar_wait(&bars_of[it % kStages], (it / kStages) & 1);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], n_q * D * 2);
#pragma unroll
    for (int a = 0; a < Sh::kAtoms; ++a)
      tma_load(s_q + a * kAtomBytes, &tm_q, &bars[0], a * kAtom, kvh * group,
               p0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st) {
      load(map_k, s_k(st), &k_bar[st], t0 + st);
      load(map_v, s_v(st), &v_bar[st], t0 + st);
    }
  }

  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    pos[h] = r < n_q ? p0 + r / group : -1;   // -1: pad row, attends nothing
  }
  float o[D / 2], sc[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  // Q as the A fragments of the D / 16 k-steps, read once from its
  // swizzled tile (16-byte chunk c of row r sits at chunk c ^ (r % 8)):
  // the scores then read only K from shared memory.
  uint32_t qa[D / 16][4];
  auto load_q = [&]() {
    const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * warp + g8 + 8 * (i & 1);
        const int chunk = 2 * (kk % 4) + (i >> 1);
        qa[kk][i] = *reinterpret_cast<const uint32_t*>(
            s_q + (kk / 4) * kAtomBytes + r * 128 + ((chunk ^ g8) << 4) +
            4 * t4);
      }
  };

  // Scores sc = Q K^T of tile `it`, D / 16 k-steps of 16 (k-step kk at
  // byte 32 (kk % 4) of K's atom kk / 4); committed.
  auto issue_scores = [&](int it) {
    const uint32_t k_addr = smem_u32(s_k(it % kStages));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs<0>(sc, qa[kk],
                  desc(k_addr + (kk / 4) * kAtomBytes + 32 * (kk % 4), 16,
                       1024),
                  kk);
    wgmma_commit();
  };
  // o += P V of tile `it`, P in bf16 registers (the score fragment of keys
  // 16kk .. 16kk + 15 is the A fragment of k-step kk); committed.
  auto issue_values = [&](const uint32_t (&p)[4][4], int it) {
    const uint32_t v_addr = smem_u32(s_v(it % kStages));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<1>(o, p[kk],
                  desc(v_addr + kk * 16 * kAtom * 2, kAtomBytes, 1024), 1);
    wgmma_commit();
  };
  // The online softmax of tile `it`'s scores: m and l updated, each row's
  // rescale of o in alpha (applied once o is not in flight), P packed to
  // bf16 into p (as the plain version casts its probabilities to q's
  // dtype before the value product).  Masks only where the tile crosses
  // the causal edge (a key past the tile's first position) or the
  // window's start (a key too old for its newest position).
  auto softmax = [&](int it, float (&alpha)[2], uint32_t (&p)[4][4]) {
    const int k0 = (t0 + it) * kKeys;
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
      alpha[h] = ex2(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          sc[i] = ex2(sc[i] - m_new);   // masked: ex2(-inf) = 0
          sum += sc[i];
        }
      l[h] = l[h] * alpha[h] + sum;   // this lane's share; summed at the end
      m[h] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // Tile 0's scores and softmax, then per tile `it` >= 1: its scores and
  // tile it - 1's values issued together; the scores waited for, then
  // this tile's softmax runs while the values are in flight; then o is
  // rescaled.  A K slot is refilled once its scores are done, a V slot
  // once its values are.
  uint32_t pa[4][4], pb[4][4];
  float alpha[2];
  // Tile `it` >= 1: p_prev holds tile it - 1's P, p_next receives this
  // tile's (the two alternate, so no register an in-flight product reads
  // is written).
  auto step = [&](const uint32_t (&p_prev)[4][4], uint32_t (&p_next)[4][4],
                  int it) {
    wait_tile(k_bar, it);
    wait_tile(v_bar, it - 1);
    wgmma_fence();
    issue_scores(it);
    issue_values(p_prev, it - 1);
    wgmma_wait<1>();   // the scores; the values stay in flight
    reg_fence(sc);
    __syncthreads();   // every warp is done with this K slot
    if (tid == 0 && it + kStages < n_tiles)
      load(map_k, s_k(it % kStages), &k_bar[it % kStages], t0 + it + kStages);
    softmax(it, alpha, p_next);
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
    __syncthreads();   // every warp is done with V slot (it - 1) % 2
    if (tid == 0 && it + 1 < n_tiles)
      load(map_v, s_v((it - 1) % kStages), &v_bar[(it - 1) % kStages],
           t0 + it + 1);
  };
  mbar_wait(&bars[0], 0);
  load_q();
  wait_tile(k_bar, 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  reg_fence(sc);
  __syncthreads();   // every warp is done with K slot 0
  if (tid == 0 && kStages < n_tiles)
    load(map_k, s_k(0), &k_bar[0], t0 + kStages);
  softmax(0, alpha, pa);   // o is still 0: nothing to rescale
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {
    step(pa, pb, it);
    step(pb, pa, it + 1);
  }
  if (it < n_tiles) {   // one tile left: its P lands in pb
    step(pa, pb, it);
    wait_tile(v_bar, n_tiles - 1);
    wgmma_fence();
    issue_values(pb, n_tiles - 1);
  } else {
    wait_tile(v_bar, n_tiles - 1);
    wgmma_fence();
    issue_values(pa, n_tiles - 1);
  }
  wgmma_wait<0>();
  reg_fence(o);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (pos[h] < 0 || pos[h] >= seq) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / l_safe;
    const size_t head_row =
        ((size_t)b * seq + pos[h]) * n_heads + kvh * group + r % group;
    __nv_bfloat16* row = out + head_row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[head_row] = m[h] * kLn2 + logf(l_safe);
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

// [B, S, n, D] bf16 as the 4-D map (D, n, S, B), box (64, box_n, box_s,
// 1): one 128-byte atom of a row a box, 128-byte swizzle, zero fill out of
// bounds.
inline bool encode(CUtensorMap* map, const void* ptr, int dim, int batch,
                   int seq, int n, int box_n, int box_s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)dim * 2;
  cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)n, (cuuint64_t)seq,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {row, row * n, row * n * seq};
  cuuint32_t box[4] = {kAtom, (cuuint32_t)box_n, (cuuint32_t)box_s, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int seq, int n_heads, int n_kv,
                   int window, float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv;
  if (group > kRows) return cudaErrorInvalidValue;
  const int pp = kRows / group;                 // positions per row tile
  const int n_pos_tiles = (seq + pp - 1) / pp;
  const long long blocks = (long long)n_pos_tiles * n_kv * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, D, batch, seq, n_heads, group, pp) ||
      !encode(&mk, k, D, batch, seq, n_kv, 1, kKeys) ||
      !encode(&mv, v, D, batch, seq, n_kv, 1, kKeys))
    return cudaErrorInvalidValue;
  auto kernel = flash_kernel_wgmma<D, kWindow>;
  constexpr int bytes = Shape<D>::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, batch, seq, n_heads,
      n_kv, pp, n_pos_tiles, window, scale * kLog2e);
  return cudaGetLastError();
}

// window > 0: the sliding-window instantiation; 0: global.  lse null
// writes none.
template <int D>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int seq, int n_heads, int n_kv,
                     int window, float scale, cudaStream_t stream) {
  if (window > 0)
    return launch<D, true>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                           window, scale, stream);
  return launch<D, false>(q, k, v, out, lse, batch, seq, n_heads, n_kv, 0,
                          scale, stream);
}

}  // namespace wg
}  // namespace
