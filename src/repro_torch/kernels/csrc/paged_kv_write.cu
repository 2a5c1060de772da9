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
// 3.35 TB/s: the call is launch-bound.
//
// Design: one block per row, N rows per launch, so a varlen round writes
// all of a layer's B * T rows in one launch (the Pallas path issues T
// launches per layer, one per row position).  The pool is written in
// place: only the destination rows move.  An inactive row writes nothing;
// a row whose page or offset lies outside the pool is dropped the same
// way, so a bad table can never write outside the pool.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(T* __restrict__ k_pages, T* __restrict__ v_pages,
                const T* __restrict__ k_rows, const T* __restrict__ v_rows,
                const int* __restrict__ page_idx,
                const int* __restrict__ offset,
                const int* __restrict__ active, int kv_heads, int num_blocks,
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

template <typename T>
cudaError_t launch(void* k_pages, void* v_pages, const void* k_rows,
                   const void* v_rows, const int* page_idx, const int* offset,
                   const int* active, int n_rows, int kv_heads,
                   int num_blocks, int block_size, int head_dim, int layer,
                   cudaStream_t stream) {
  kv_write_kernel<T><<<n_rows, kThreads, 0, stream>>>(
      static_cast<T*>(k_pages), static_cast<T*>(v_pages),
      static_cast<const T*>(k_rows), static_cast<const T*>(v_rows), page_idx,
      offset, active, kv_heads, num_blocks, block_size, head_dim, layer);
  return cudaGetLastError();
}

}  // namespace

// pages [L, KV, NB, BS, D] (written in place), rows [N, KV, D] of the pool's
// dtype, page_idx / offset / active [N] int32; all contiguous.
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int paged_kv_write_launch(
    void* k_pages, void* v_pages, const void* k_rows, const void* v_rows,
    const void* page_idx, const void* offset, const void* active, int n_rows,
    int num_layers, int kv_heads, int num_blocks, int block_size,
    int head_dim, int layer, int dtype, void* stream) {
  if (n_rows <= 0 || layer < 0 || layer >= num_layers || kv_heads <= 0 ||
      head_dim <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pidx = static_cast<const int*>(page_idx);
  const int* off = static_cast<const int*>(offset);
  const int* act = static_cast<const int*>(active);
  switch (dtype) {
    case 0:
      return (int)launch<float>(k_pages, v_pages, k_rows, v_rows, pidx, off,
                                act, n_rows, kv_heads, num_blocks, block_size,
                                head_dim, layer, s);
    case 1:
      return (int)launch<__nv_bfloat16>(k_pages, v_pages, k_rows, v_rows, pidx,
                                        off, act, n_rows, kv_heads, num_blocks,
                                        block_size, head_dim, layer, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
