// Tile helpers of the bf16 tensor-core bodies (sm_90a): asynchronous
// global -> shared copies, ldmatrix, mma.sync m16n8k16 and the bf16
// packing of an accumulator fragment. Included by flash_attention.cu
// (K7, K8a, K8b) and paged_attention.cu (K1 and K2 at W > 1), so both
// read fragments by one set of rules; cuda_build.py hashes this header
// into each source's library name.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously. With ok false the 16 bytes
// are zero-filled (src-size 0) and the source is never read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8, and register j receives matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Fragments (g = lane / 4, t = lane % 4): c[0..1] row g, columns 2 t and
// 2 t + 1, c[2..3] row g + 8; a[0] row g, k 2 t .. 2 t + 1, a[1] row
// g + 8, a[2] and a[3] the same at k + 8; b[0] k 2 t .. 2 t + 1 of column
// g, b[1] at k + 8.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half, as a fragment
// holds its lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory row of a bf16 tile: HD + 8 elements, so that the 8 rows
// an ldmatrix phase reads fall on distinct banks.
template <int HD>
__host__ __device__ constexpr int mma_ld() {
  return HD + 8;
}

}  // namespace mma_sm90
