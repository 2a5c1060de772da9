// Tensor-core products in float32 precision (3xTF32) and asynchronous
// copies into shared memory, shared by wkv6.cu (the chunked state
// products), flash_attention_bwd.cu (the float32 products) and
// ssm_scan_bwd.cu (the copies).
//
// 3xTF32: each operand x is split into two tf32 values, hi and lo =
// x - hi, and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, every sum
// in float32 (the a_lo b_lo term is below float32 rounding).  That holds
// float32 inputs to float32 accuracy, which plain TF32 (three decimal
// digits) would not.  One fragment of mma.m16n8k8: lane (g8 = lane / 4,
// t4 = lane % 4).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

struct Frag {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi is x rounded to its top 19 bits (sign, exponent, 10 mantissa bits:
// a tf32 value; half a unit rounds away from zero); lo = x - hi is exact
// in float32 and at most 2^-11 of x, and the tensor core reads its top
// 19 bits, so the dropped tail is ~2^-21 of x.  Three integer / float
// instructions, where cvt.rna.tf32 is five.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A (16 x 8) from an accessor: at(m, k) is element (m, k) of the tile:
// (g8, t4), (g8 + 8, t4), (g8, t4 + 4), (g8 + 8, t4 + 4).
template <typename At>
__device__ __forceinline__ Frag load_a_of(At at, int g8, int t4) {
  const float x[4] = {at(g8, t4), at(g8 + 8, t4), at(g8, t4 + 4),
                      at(g8 + 8, t4 + 4)};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
  return f;
}

// B (8 x 8) from an accessor: at(k, n) is element (k, n): (t4, g8),
// (t4 + 4, g8).
template <typename At>
__device__ __forceinline__ FragB load_b_of(At at, int g8, int t4) {
  FragB f;
  split(at(t4, g8), f.hi[0], f.lo[0]);
  split(at(t4 + 4, g8), f.hi[1], f.lo[1]);
  return f;
}

// A from a row-major array of pitch P at a.
template <int P>
__device__ __forceinline__ Frag load_a(const float* a, int g8, int t4) {
  return load_a_of([&](int m, int k) { return a[m * P + k]; }, g8, t4);
}

// A as the transpose of a row-major array of pitch P at a: element (m, j)
// is a[j][m].
template <int P>
__device__ __forceinline__ Frag load_at(const float* a, int g8, int t4) {
  return load_a_of([&](int m, int k) { return a[k * P + m]; }, g8, t4);
}

// B from a row-major array of pitch P at b.
template <int P>
__device__ __forceinline__ FragB load_b(const float* b, int g8, int t4) {
  return load_b_of([&](int k, int n) { return b[k * P + n]; }, g8, t4);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8: d[0], d[1] at row g8, columns 2 t4, 2 t4 + 1; d[2], d[3]
// at row g8 + 8) += a b.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// 16 bytes from global to shared memory without passing through
// registers; src_bytes < 16 zero-fills the rest (0: the whole chunk).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32
