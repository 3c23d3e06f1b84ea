// Channel LayerNorm backward over (R, C) float32 rows, from x and dy:
//   dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd,
//   dxhat = dy * gamma, dgamma = sum over rows of dy * xhat, dbeta = sum dy.
//
// Replaces pytorch_generative_tpu/ops/ln_pallas.py::_bwd_kernel (launched by
// _ln_bwd, the custom_vjp backward of channel_layernorm). Same contract:
// the statistics are recomputed from x, dx is row-local, and dgamma, dbeta
// are summed over all R rows in f32.
//
// Why the design differs from the TPU's: the TPU kernel adds dgamma and
// dbeta into one VMEM tile that its sequential grid revisits. CUDA blocks
// run in no order, so each CTA of 64 rows writes its own partial (2, C)
// sums and a second launch adds the partials in a fixed order (rows.cuh).
// No atomics: the gradients are the same run to run.
//
// What bounds it on an H100: bytes. It reads x and dy and writes dx, 3 R C
// floats: 308 MB at R = 50,176, C = 512, ~92 us at 3.35 TB/s. One warp per
// row with the row in registers, as in ln_fwd.cu; the partials add
// R / 64 * 2 C floats, under 2% of the traffic.
// Rows wider than 512 channels take one CTA a row-chunk instead
// (rows.cuh, ln_bwd_rows_wide_kernel): the CTA walks its 64 rows one at a
// time and each thread keeps the column sums of its own columns.
//
// ln_bwd_bf16 runs the same kernels on bf16 x, dy, gamma and dx: the
// statistics, dx's arithmetic and the dgamma/dbeta partials and sums in
// f32 (ln_pallas.py:48-66, :140-141 with bf16 rows), dx rounded to bf16 at
// its store; dgamma and dbeta stay f32 (the caller casts them to gamma's
// type, as the JAX package's custom_vjp does). Bytes bound it: 154 MB at
// R = 50,176, C = 512, ~46 us at 3.35 TB/s.

#include "rows.cuh"

// x, dy, dx (R, C), gamma (C,), sums (2, C) = (dgamma, dbeta): contiguous
// float32; part is (ceil(R / rows_per_cta), 2, C) scratch. C a multiple of
// 4, at most rows::kMaxChannels (4096; rows.cuh).
extern "C" int ln_bwd_f32(const float* x, const float* dy, const float* gamma,
                          float* dx, float* sums, float* part, int R, int C,
                          int rows_per_cta, float eps, void* stream) {
  return static_cast<int>(rows::ln_backward(x, dy, gamma, static_cast<const float*>(nullptr),
                                            dx, part, sums, R, C, rows_per_cta, eps,
                                            static_cast<cudaStream_t>(stream)));
}

// As ln_bwd_f32 for bf16 x, dy, gamma and dx (sums and part f32); C a
// multiple of 8.
extern "C" int ln_bwd_bf16(const void* x, const void* dy, const void* gamma, void* dx,
                           float* sums, float* part, int R, int C, int rows_per_cta,
                           float eps, void* stream) {
  if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rows::ln_backward(
      static_cast<const bf16::T*>(x), static_cast<const bf16::T*>(dy),
      static_cast<const bf16::T*>(gamma), static_cast<const bf16::T*>(nullptr),
      static_cast<bf16::T*>(dx), part, sums, R, C, rows_per_cta, eps,
      static_cast<cudaStream_t>(stream)));
}
