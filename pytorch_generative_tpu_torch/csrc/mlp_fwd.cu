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
// kernel runs three launches instead: xn = LN(x) (rows.cuh's LayerNorm
// kernels); y = xn W1 + b1, whose epilogue writes y, which the backward
// needs anyway, and g = gelu(y) to device memory; then out = g W2 + b2 +
// x. Each element of LN(x) and gelu(y) is computed once (mlp.cuh says
// why).
//
// What bounds it on an H100: the two (R x C x F) products, 4 R C F FLOPs
// (210 GFLOP at R = 50,176, C = 512, F = 2048), against ~0.6 GB of x, y,
// out and weights: operations. Both products run on the tensor cores by
// 3xTF32 (gemm_tf32x3.cuh, 495 / 3 = 165 TFLOP/s: ~1.3 ms at best; f32 on
// the CUDA cores would stop at 67 TFLOP/s, ~3.1 ms).
//
// mlp_fwd_bf16 runs the same three launches on bf16 rows, weights and
// scratch: the products on gemm_wgmma_bf16.cuh (wgmma fed by TMA, 989
// TFLOP/s: ~0.21 ms at best), bf16 stores where the TPU kernel casts
// (mlp.cuh says where).

#include "mlp.cuh"

// x (R, C), w1 (C, F), w2 (F, C), gamma/beta/b2 (C,), b1 (F,): contiguous
// float32. Writes out (R, C) and y (R, F); xn (R, C) and g (R, F) are
// float32 scratch. C and F multiples of 4, C at most rows::kMaxChannels
// (4096).
extern "C" int mlp_fwd_f32(const float* x, const float* gamma, const float* beta,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, float* out, float* y, float* xn, float* g,
                           int R, int C, int F, float eps, void* stream) {
  return static_cast<int>(mlp::forward(x, gamma, beta, w1, b1, w2, b2, out, y, xn, g, R, C,
                                       F, eps, static_cast<cudaStream_t>(stream)));
}

// As mlp_fwd_f32 with every operand, output and scratch bf16; C and F
// multiples of 8.
extern "C" int mlp_fwd_bf16(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* y, void* xn, void* g, int R, int C, int F,
                            float eps, void* stream) {
  using P = const bf16::T*;
  using W = bf16::T*;
  return static_cast<int>(mlp::forward(
      static_cast<P>(x), static_cast<P>(gamma), static_cast<P>(beta), static_cast<P>(w1),
      static_cast<P>(b1), static_cast<P>(w2), static_cast<P>(b2), static_cast<W>(out),
      static_cast<W>(y), static_cast<W>(xn), static_cast<W>(g), R, C, F, eps,
      static_cast<cudaStream_t>(stream)));
}
