// The few instructions that the bf16 GEMM of gemm_bf16.cuh is built from,
// and the bf16 conversions of the wgmma flash kernels
// (flash_wgmma_bf16.cuh): packed round-to-nearest
// conversion of f32 to bf16, the m16n8k16 bf16 product with f32
// accumulators, ldmatrix (plain and transposed) and 16-byte asynchronous
// copies into shared memory. Nothing else of those kernels is written in
// PTX.
//
// Every conversion to bf16 rounds to nearest even (cvt.rn), as JAX's
// astype(bfloat16) does; none truncates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16 {

using T = __nv_bfloat16;

// lo and hi rounded to bf16 (nearest even) and packed, lo in the low half:
// the layout of two neighbouring bf16 values in memory and in an mma
// fragment register.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The two bf16 values of a packed register as f32 (exact).
__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// x rounded to bf16 and back: the f32 value a bf16 store of x holds.
__device__ __forceinline__ float round(float x) { return lo(pack(x, 0.f)); }

// d += a b on the tensor cores: a 16 x 16 (row major), b 16 x 8 (column
// major), d 16 x 8, each spread over the warp in mma.sync's fragment layout
// (lane = 4 g + t; a = {A[g][2t, 2t+1], A[g+8][2t, 2t+1], A[g][2t+8, 2t+9],
// A[g+8][2t+8, 2t+9]}, b = {B[2t, 2t+1][g], B[2t+8, 2t+9][g]}, each
// register two bf16 values, the lower index in the low half; d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 blocks of bf16 from shared memory by one ldmatrix: lane l gives
// the address of row l % 8 of block l / 8 (16 bytes, 16-byte aligned);
// r[i] = block i's row g, columns 2t and 2t + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// As ldmatrix_x4, each block transposed: r[i] = block i's rows 2t and
// 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Starts a copy of 16 bytes from global to shared memory; writes 16 zero
// bytes instead (and reads nothing) when !valid. Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// Eight bf16 values as f32, from the four registers of a 16-byte load.
__device__ __forceinline__ void unpack8(float (&x)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = lo(w[i]);
    x[2 * i + 1] = hi(w[i]);
  }
}

}  // namespace bf16
