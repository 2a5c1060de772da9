// In-place K/V row scatter into the paged pool.
//
// Replaces: src/repro/kernels/paged_kv_write_pallas.py, paged_kv_write
// (_kv_write_kernel), the Pallas TPU kernel that DMAs one decode step's
// K/V rows into the aliased pool, once per layer per step.
//
// What bounds it on an H100: the bytes it moves, 2 * N * KV * D *
// sizeof(T) read and the same written, for N rows (N = B for a decode
// step, B * T for a varlen round).  At the serve path's shapes (N <= 64,
// KV = 2, D = 64, float32) that is at most 128 KB, tens of nanoseconds at
// 3.35 TB/s.  The device work of a decode step's 4 rows takes ~1.4 us
// (NVIDIA H100 80GB HBM3, 700.00 W): the call is bound by its host cost,
// paid once per layer per model pass.
//
// Design: one block per row, N rows per launch, so a varlen round writes
// all of a layer's B * T rows in one launch (the Pallas path issues T
// launches per layer, one per row position).  The pool is written in
// place: only the destination rows move.  An inactive row writes nothing;
// a row whose page or offset lies outside the pool is dropped the same
// way, so a bad table can never write outside the pool.  The mask is read
// in the dtype it arrives in, bool (one byte) or int32, so the model's
// step mask needs no cast launch.
//
// Launch path: what a model pass's layers share (the pools, the rows'
// destinations, the mask and the geometry) sits in a KvWritePlan that the
// wrapper fills and checks once per step; a layer's call passes only the
// plan's address, its two row tensors, the layer and the stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by kernels/paged_kv_write.py (_Plan).
struct KvWritePlan {
  void* k_pages;           // [L, KV, NB, BS, D], written in place
  void* v_pages;
  const void* page_idx;    // [N] int32
  const void* offset;      // [N] int32
  const void* active;      // [N] bool or int32 (0 = drop the row)
  int n_rows, num_layers, kv_heads, num_blocks, block_size, head_dim;
  int dtype;               // 0 = float32, 1 = bfloat16 (pools and rows)
  int mask_dtype;          // 0 = int32, 1 = bool
};

namespace {

constexpr int kThreads = 128;

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(T* __restrict__ k_pages, T* __restrict__ v_pages,
                const T* __restrict__ k_rows, const T* __restrict__ v_rows,
                const int* __restrict__ page_idx,
                const int* __restrict__ offset,
                const M* __restrict__ active, int kv_heads, int num_blocks,
                int block_size, int head_dim, int layer) {
  const int n = blockIdx.x;
  if (!active[n]) return;
  const int page = page_idx[n], off = offset[n];
  if (page < 0 || page >= num_blocks || off < 0 || off >= block_size) return;
  for (int e = threadIdx.x; e < kv_heads * head_dim; e += kThreads) {
    const int h = e / head_dim, d = e % head_dim;
    const size_t dst =
        ((((size_t)layer * kv_heads + h) * num_blocks + page) * block_size +
         off) * head_dim + d;
    const size_t src = (size_t)n * kv_heads * head_dim + e;
    k_pages[dst] = k_rows[src];
    v_pages[dst] = v_rows[src];
  }
}

template <typename T, typename M>
cudaError_t launch(const KvWritePlan& p, const void* k_rows,
                   const void* v_rows, int layer, cudaStream_t stream) {
  kv_write_kernel<T, M><<<p.n_rows, kThreads, 0, stream>>>(
      static_cast<T*>(p.k_pages), static_cast<T*>(p.v_pages),
      static_cast<const T*>(k_rows), static_cast<const T*>(v_rows),
      static_cast<const int*>(p.page_idx), static_cast<const int*>(p.offset),
      static_cast<const M*>(p.active), p.kv_heads, p.num_blocks,
      p.block_size, p.head_dim, layer);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mask(const KvWritePlan& p, const void* k_rows,
                        const void* v_rows, int layer, cudaStream_t stream) {
  switch (p.mask_dtype) {
    case 0: return launch<T, int>(p, k_rows, v_rows, layer, stream);
    case 1: return launch<T, bool>(p, k_rows, v_rows, layer, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows [N, KV, D] of the pools' dtype, contiguous; the plan's tensors as
// its comments say, all contiguous.  Writes layer `layer` of the pools.
// Returns cudaGetLastError().
extern "C" int paged_kv_write_launch(const KvWritePlan* plan,
                                     const void* k_rows, const void* v_rows,
                                     int layer, void* stream) {
  if (plan == nullptr || plan->n_rows <= 0 || layer < 0 ||
      layer >= plan->num_layers || plan->kv_heads <= 0 ||
      plan->head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan->dtype) {
    case 0:
      return (int)launch_mask<float>(*plan, k_rows, v_rows, layer, s);
    case 1:
      return (int)launch_mask<__nv_bfloat16>(*plan, k_rows, v_rows, layer, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
