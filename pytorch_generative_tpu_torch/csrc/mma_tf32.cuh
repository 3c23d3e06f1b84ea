// The few instructions that the tensor-core flash kernels (flash_mma.cuh,
// flash_bwd_mma_small.cuh) are built from: TF32 rounding, the m16n8k8 and
// m16n8k4 TF32 products with f32 accumulators, ldmatrix, and 16-byte and
// 4-byte asynchronous copies into shared memory. Nothing else of the
// kernels is written in PTX.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: an f32 whose low 13 bits are 0. The value of cvt.rna.tf32.f32, by
// two integer operations (add half a TF32 ulp to the magnitude, cut the
// low bits; a carry moves into the exponent as it should): on an H100 the
// flash kernels ran 1.3-1.6x faster so than with the cvt instruction.
__device__ __forceinline__ float round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// d += a b on the tensor cores: a 16 x 8 (row major), b 8 x 8 (column
// major), d 16 x 8, each spread over the warp in mma.sync's fragment layout
// (lane = 4 * g + t: a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]}). a and b hold TF32 values.
__device__ __forceinline__ void mma(float (&d)[4], const float (&a)[4],
                                    const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// d += a b, m16n8k4: a 16 x 4 (row major), b 4 x 8 (column major), d as in
// mma (lane = 4 * g + t: a = {A[g][t], A[g+8][t]}, b = {B[t][g]}). Its depth
// is PixelSNAIL's d_k = 4.
__device__ __forceinline__ void mma_k4(float (&d)[4], const float (&a)[2], float b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(b)));
}

// Four 8 x 4 blocks of 32-bit values from shared memory by one ldmatrix
// (.x4, read as 8 x 8 blocks of 16-bit values): lane l gives the address of
// row l % 8 of block l / 8 (16-byte aligned); r[i] = block i's row g,
// column t.
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], const float* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  uint32_t x0, x1, x2, x3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
               : "r"(a)
               : "memory");
  r[0] = __uint_as_float(x0);
  r[1] = __uint_as_float(x1);
  r[2] = __uint_as_float(x2);
  r[3] = __uint_as_float(x3);
}

// Starts a copy of 16 bytes from global to shared memory; writes 16 zero
// bytes instead (and reads nothing) when !valid. Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// As cp_async16 for 4 bytes (one f32), both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Closes the group of copies started since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32
