// Fused LayerNorm -> W1 -> exact GELU -> W2 -> residual forward over (R, C)
// float32 rows:  out = x + gelu(LN(x) W1 + b1) W2 + b2,  y = LN(x) W1 + b1.
//
// Replaces pytorch_generative_tpu/ops/mlp_pallas.py::_fwd_kernel (launched
// by _fused_fwd, with save_y for the backward). Same contract: LayerNorm
// statistics in f32 with the biased variance, exact GELU (erff here; the
// TPU kernel's A&S polynomial is a Mosaic workaround for the same target),
// the residual added in f32, and the (R, F) pre-activation y written out for
// the backward.
//
// Why the design differs from the TPU's: the TPU kernel keeps a whole
// (rows, 4C) f32 intermediate of a row block in 64-100 MB of VMEM between
// its two products. A CTA has at most 227 KB of shared memory, so this
// kernel runs three launches instead: per-row (mean, rstd) of x (one warp
// per row, rows.cuh); y = LN(x) W1 + b1, with the LayerNorm applied to each
// float4 of x as the product loads it and y written to device memory, which
// the backward needs anyway; then out = gelu(y) W2 + b2 + x, with GELU
// applied to each float4 of y as the second product loads it.
//
// What bounds it on an H100: the two (R x C x F) products, 4 R C F FLOPs
// (210 GFLOP at R = 50,176, C = 512, F = 2048), against ~0.6 GB of x, y,
// out and weights: f32 FMA work on the CUDA cores (67 TFLOP/s), ~3.1 ms at
// best. The products are sgemm.cuh's SIMT tiles; each element of y is
// passed through erff once for each of the C / 128 column tiles that read
// it.

#include "mlp.cuh"

// x (R, C), w1 (C, F), w2 (F, C), gamma/beta/b2 (C,), b1 (F,): contiguous
// float32. Writes out (R, C) and y (R, F); stats is (R, 2) float32
// scratch. C and F multiples of 4, C at most rows::kMaxChannels (4096).
extern "C" int mlp_fwd_f32(const float* x, const float* gamma, const float* beta,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* out, float* y, float* stats,
                           int R, int C, int F, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mlp::preact(x, gamma, beta, w1, b1, y,
                                reinterpret_cast<float2*>(stats), R, C, F, eps, s);
  if (err != cudaSuccess) return err;
  return sgemm::gemm<false, false>(y, F, w2, C, R, C, F, 1, mlp::Gelu{},
                                   sgemm::BiasStore<true>{b2, x, out, C}, s);
}
