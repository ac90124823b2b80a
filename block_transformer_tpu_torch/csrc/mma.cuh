// PTX helpers shared by the tensor-core kernels (K1/K4 in dequant_matmul.cu,
// K3 in flash_attention.cu; W8A8-mm in w8a8.cu takes the shared-memory
// address and bf16 packing): cp.async copies into shared memory, ldmatrix
// fragment loads, the bf16 mma.sync product, and exact int8 / int4 -> float
// widening (also used by K2 and K6).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; copies nothing and zero-fills when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4-byte global -> shared copy; zero-fills when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a[16 x 16] @ b[16 x 8], bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Widening without the quarter-rate integer-to-float conversions: byte i
// of u (an unsigned value v + bias, v the signed weight) goes into the low
// mantissa bits of 2^23, and one float subtraction of 2^23 + bias leaves v
// exactly. u = b ^ 0x80 for an int8 b (bias 128); for a nibble n,
// u = n ^ 8 = ((n ^ 8) - 8) + 8, so v = ((n ^ 8) - 8) is n sign-extended.
template <int BIAS>
__device__ __forceinline__ float biased_byte(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
         (8388608.f + BIAS);
}

// Two floats that are small integers (their low 16 bits are zero) as a
// bf16 pair: their top halves, exact.
__device__ __forceinline__ uint32_t pack_exact_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

}  // namespace bt
