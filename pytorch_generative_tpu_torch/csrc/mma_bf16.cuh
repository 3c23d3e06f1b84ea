// The bf16 conversions of the wgmma kernels (flash_wgmma_bf16.cuh,
// gemm_wgmma_bf16.cuh) and of the bf16 rows (rows.cuh, mlp.cuh): packed
// round-to-nearest conversion of f32 to bf16 and back.
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
