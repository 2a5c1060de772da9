// Paged decode attention: one query token per slot over its block table.
//
// Replaces: src/repro/kernels/paged_attention_pallas.py, paged_attention
// (_paged_kernel), the Pallas TPU kernel of the serve engine's steady
// decode step (models/transformer.decode_step_paged).
//
// What bounds it on an H100: the K/V rows it must read.  Slot b reads
// ctx_b rows of K and of V per kv head, 2 * KV * ctx_b * D * sizeof(T)
// bytes; the query and output add 2 * H * D * sizeof(T) per slot.  At the
// serve path's shapes (B = 4 slots, KV = 2, D = 64, float32, contexts
// of tens of rows) that is a few hundred KB per layer, well under a
// microsecond at 3.35 TB/s, so a launch (a few microseconds) is what a
// call costs: the kernel is launch-bound there, not bandwidth-bound.
//
// Design, D <= 128: the ragged kernel's block routine
// (paged_attention_common.cuh, attend_tile) with one live
// row per slot at position ctx - 1: grid (row tiles, KV, B), one block per
// 16 of the G = H / KV group heads of a (slot, kv head), so each staged
// key tile serves every group head (the Pallas grid (B, H, M) streams
// every page once per query head).  Keys are staged 64 at a time by
// cp.async, double-buffered; pages wholly left of a sliding window and
// table entries past the context are never read.  ctx == 0 gives exact
// zeros.  Known limit: at B = 4, KV = 2 the grid has 8 blocks for 132 SMs.
// Above head dim 128 (gemma3's 256) the decode is split over the context
// instead (paged_attention_split.cuh): grid (splits x row tiles, KV, B),
// the splits merged in one launch by the last block to finish.
#include "paged_attention_common.cuh"
#include "paged_attention_split.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, paged::Geometry g) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int ctx = context_lens[b];
  // The decode query is the newest row: position ctx - 1, one live row.
  paged::attend_tile<T>(q, k_pages, v_pages, tables, out, b, kvh, ctx - 1,
                        ctx > 0 ? 1 : 0, blockIdx.x * paged::kRowTile, g);
}

template <typename T>
cudaError_t launch_narrow(const void* q, const void* k_pages,
                          const void* v_pages, const int* tables,
                          const int* context_lens, void* out, int batch,
                          const paged::Geometry& g, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T>;
  // Raised once to what the widest head dim of the routine needs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)paged::smem_bytes<T>(paged::kNarrowMaxDim));
  if (attr != cudaSuccess) return attr;
  const int tiles = (g.H / g.KV + paged::kRowTile - 1) / paged::kRowTile;
  kernel<<<dim3(tiles, g.KV, batch), paged::kThreads,
           paged::smem_bytes<T>(g.D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, context_lens,
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

// The routine by head dim: attend_tile up to 128, the context split above.
template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* context_lens, void* out,
                   float* part, int* tickets, int batch,
                   const paged::Geometry& g, int n_splits, int min_keys,
                   cudaStream_t stream) {
  if (g.D <= paged::kNarrowMaxDim)
    return launch_narrow<T>(q, k_pages, v_pages, tables, context_lens, out,
                            batch, g, stream);
  return paged::split::launch<T>(q, k_pages, v_pages, tables, context_lens,
                                 out, part, tickets, batch, g, n_splits,
                                 min_keys, stream);
}

}  // namespace

// q [B, H, D], pages [KV, NB, BS, D], tables [B, M] int32, context_lens [B]
// int32, out [B, H, D]; all contiguous, q/pages/out of one dtype.
// window < 0 means global attention.  Above head dim 128 the decode takes
// n_splits context splits of at least min_keys keys; at n_splits > 1,
// part is float32 scratch of B * H * n_splits * (D + 2) and tickets int32
// of B * H, all 0 (the kernel leaves them 0).  D <= 128 reads none of the
// four.  Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* context_lens, void* out, void* part,
    void* tickets, int batch, int heads, int kv_heads, int num_blocks,
    int block_size, int head_dim, int max_blocks, int window, int n_splits,
    int min_keys, float scale, int dtype, void* stream) {
  paged::Geometry g{1, heads, kv_heads, num_blocks, block_size, head_dim,
                    max_blocks, window, scale};
  cudaError_t err = paged::check_geometry(g, batch);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(context_lens);
  float* pf = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  switch (dtype) {
    case paged::kFloat32:
      return (int)launch<float>(q, k_pages, v_pages, tbl, lens, out, pf, tk,
                                batch, g, n_splits, min_keys, s);
    case paged::kBFloat16:
      return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, tbl, lens, out,
                                        pf, tk, batch, g, n_splits, min_keys,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
