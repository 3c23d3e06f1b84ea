// Channel LayerNorm forward over (R, C) float32 rows:
//   y = (x - mean) / sqrt(biased var + eps) * gamma + beta.
//
// Replaces pytorch_generative_tpu/ops/ln_pallas.py::_fwd_kernel (launched by
// _ln_fwd, the forward of channel_layernorm). Same contract: statistics in
// f32, biased variance, nothing but y written. The TPU wrapper pads the
// rows to a multiple of 8 for its row blocks; here a row is a warp and the
// ragged last CTA masks itself, so nothing is padded.
//
// What bounds it on an H100: bytes. It reads R*C and writes R*C floats, a
// few FLOPs each: 205.5 MB at R = 50,176, C = 512, ~61 us at 3.35 TB/s.
// Design: one warp per row (rows.cuh), the row in registers as float4s
// (C / 128 per lane), mean and variance by warp shuffles, no shared
// memory; eight rows per CTA of 256 threads keep enough loads in flight.
// Rows wider than 512 channels (up to rows::kMaxChannels) take one CTA of
// 256 threads a row instead (ln_fwd_wide_kernel), the statistics summed
// through shared memory in a fixed order. The kernels live in rows.cuh,
// where the fused MLP runs them for its LN(x).
//
// ln_fwd_bf16 runs the same kernels on bf16 x, gamma, beta and out: the
// statistics and the arithmetic in f32, out rounded to bf16 at its store
// (ln_pallas.py's _fwd_kernel with bf16 rows). Bytes bound it: 103 MB at
// R = 50,176, C = 512, ~31 us at 3.35 TB/s.

#include "rows.cuh"

// x, out (R, C), gamma, beta (C,): contiguous float32; C a multiple of 4,
// at most rows::kMaxChannels (4096).
extern "C" int ln_fwd_f32(const float* x, const float* gamma, const float* beta,
                          float* out, int R, int C, float eps, void* stream) {
  return static_cast<int>(
      rows::layer_norm(x, gamma, beta, out, R, C, eps, static_cast<cudaStream_t>(stream)));
}

// As ln_fwd_f32 for bf16 x, gamma, beta and out; C a multiple of 8.
extern "C" int ln_fwd_bf16(const void* x, const void* gamma, const void* beta, void* out,
                           int R, int C, float eps, void* stream) {
  if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rows::layer_norm(
      static_cast<const bf16::T*>(x), static_cast<const bf16::T*>(gamma),
      static_cast<const bf16::T*>(beta), static_cast<bf16::T*>(out), R, C, eps,
      static_cast<cudaStream_t>(stream)));
}
