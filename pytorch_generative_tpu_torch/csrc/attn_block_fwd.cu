// The fused attention block's forward over (B, L, C) float32 rows x:
//   q = x Wq + bq (E = H * d), [k | v] = x Wkv + bkv (E + O, O = H * d),
//   attn = causal flash attention of (q, k, v) over H heads (B, L, O),
//   y = attn Wo + bo (B, L, C'), with lse (B, H, L) for the backward.
//
// Replaces pytorch_generative_tpu/ops/attn_block_pallas.py::_fwd_block_kernel
// (launched by _fwd_block, the forward of attention_block_packed under
// PGT_FUSED_ATTN=1). Same contract: the attention is flash_fwd.cu's (base-2
// online softmax with f32 statistics, `mask_center` shifts the diagonal by
// one, a fully-masked row gives exactly 0 with lse = -inf), y's width is
// Wo's (the TPU kernel sizes it by x, a defect not copied here), and the
// pre-Wo attention and lse are written for the backward.
//
// Why the design differs from the TPU's: the TPU kernel projects a whole
// batch row into VMEM at its first query step, relies on its sequential
// grid to reuse it at the later steps, and keeps the attention tile in VMEM
// for the output projection. CUDA blocks run in no order, and attn is
// written to device memory anyway as the backward's residual, so this file
// runs four launches from one call, every product on the tensor cores by
// 3xTF32 (about f32's accuracy):
//   (a) the projection stage: q and [k | v] for all rows, each one
//       gemm_tf32x3.cuh product with the bias in its epilogue, into scratch
//       that the caller frees after the call. The backward recomputes q, k
//       and v by attn_block_project_f32, which runs this same stage, so it
//       differentiates through the forward's bits;
//   (b) the attention: flash_fwd_mma.cuh's kernel, the one flash_fwd.cu runs
//       for d_k == d_v, over the q scratch and the packed [k | v] scratch
//       (row strides E and 2E, v at offset E), one CTA a (query tile, head,
//       batch);
//   (c) the output projection y = attn Wo + bo, a third gemm_tf32x3.cuh
//       product. Fusing it into (b) would save only attn's read-back (~100 MB
//       at C = 512, ~0.03 ms at 3.35 TB/s) and would cost (b) its per-head
//       grid.
//
// What bounds it on an H100: 2 B L C (2E + O) FLOPs of projection, 2 B L O C'
// of output projection and the attention's 2 (d_k + d_v) per causal pair and
// head: ~145 GFLOP at B = 64, L = 784, C = 512, 8 heads, ~0.88 ms at the
// 3xTF32 rate (495 / 3 = 165 TFLOP/s), ~2.2 ms at f32's 67 on the CUDA cores.
// Head widths d = 32, 64 and 128.
//
// attn_block_fwd_bf16 (and attn_block_project_bf16) take bf16 x, weights
// and biases and write bf16 q, kv, attn and y (lse f32), in three launches
// (the recompute in one), at the TPU kernel's rounding points for a bf16
// compute dtype (attn_block_pallas.py:66-78, :95-113, :183-185): each
// product on the wgmma GEMM of gemm_wgmma_bf16.cuh with f32 sums and its
// tile-store epilogue, which adds the bias (bf16, widened) to the f32 sum,
// rounds once (mlp.cuh's PreactStore without its GELU, the same bits) and
// stores the tile by TMA while the consumers go on to the next tile's
// products; q and [k | v] are one launch that walks the n-tiles of both
// (bias_products); the attention the bf16 flash forward of
// flash_wgmma_bf16.cuh with kQ2 = false: q stays bf16(q), S = q K^T is
// scaled in f32 (the flash kernel rounds q * scale * log2 e to bf16
// instead), P rounded to bf16 for P V, attn = bf16(O / l), lse natural in
// f32. Bound at the bf16 tensor-core rate: ~145 GFLOP at C = 512, ~0.147
// ms at 989 TFLOP/s. Widths (C, E, C') multiples of 8 (the GEMM's 16-byte
// TMA rows).

#include "flash_fwd_mma.cuh"
#include "flash_wgmma_bf16.cuh"
#include "gemm_tf32x3.cuh"
#include "gemm_wgmma_bf16.cuh"

// The projection stage alone: q = x wq + bq (R, E), kv = x wkv + bkv
// (R, E + O), from x (R, C), wq (C, E), wkv (C, E + O); contiguous float32,
// C, E and O multiples of 4.
extern "C" int attn_block_project_f32(const float* x, const float* wq, const float* bq,
                                      const float* wkv, const float* bkv, float* q,
                                      float* kv, int R, int C, int E, int O,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gemm3::gemm(x, wq, bq, q, R, E, C, s);
  if (err != cudaSuccess) return err;
  return gemm3::gemm(x, wkv, bkv, kv, R, E + O, C, s);
}

// x (B, L, C), wq (C, E), bq (E,), wkv (C, 2E), bkv (2E,), wo (E, Cout),
// bo (Cout,): contiguous float32, E = H * d with d one of 32, 64 and 128
// (d_k == d_v), C and Cout multiples of 4. Writes attn (B, L, E), lse
// (B, H, L) and y (B, L, Cout); q (B, L, E) and kv (B, L, 2E) are scratch.
extern "C" int attn_block_fwd_f32(const float* x, const float* wq, const float* bq,
                                  const float* wkv, const float* bkv, const float* wo,
                                  const float* bo, float* q, float* kv, float* attn,
                                  float* lse, float* y, int B, int L, int C, int H,
                                  int d, int Cout, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * d;
  cudaError_t err = static_cast<cudaError_t>(
      attn_block_project_f32(x, wq, bq, wkv, bkv, q, kv, B * L, C, E, E, stream));
  if (err != cudaSuccess) return err;
  const int64_t q_bs = static_cast<int64_t>(L) * E, kv_bs = 2 * q_bs;
#define ATTN_BLOCK_CASE(D)                                                             \
  case D:                                                                              \
    err = fmma::launch_fwd<D>(q, kv, kv + E, attn, lse, B, L, H, q_bs, E, kv_bs, 2 * E, \
                              kv_bs, 2 * E, mask_center, s);                           \
    break;
  switch (d) {
    ATTN_BLOCK_CASE(32)
    ATTN_BLOCK_CASE(64)
    ATTN_BLOCK_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ATTN_BLOCK_CASE
  if (err != cudaSuccess) return err;
  return gemm3::gemm(attn, wo, bo, y, B * L, Cout, E, s);
}

// As attn_block_project_f32 for bf16 x, wq, bq, wkv, bkv, q and kv, in one
// launch over the n-tiles of q and then of kv: each sum in f32, the bias
// added to it, then rounded to bf16 once; C, E and O multiples of 8, every
// operand 16-byte aligned.
extern "C" int attn_block_project_bf16(const void* x, const void* wq, const void* bq,
                                       const void* wkv, const void* bkv, void* q, void* kv,
                                       int R, int C, int E, int O, void* stream) {
  using T = bf16::T;
  const T* w[2] = {static_cast<const T*>(wq), static_cast<const T*>(wkv)};
  const T* bias[2] = {static_cast<const T*>(bq), static_cast<const T*>(bkv)};
  T* out[2] = {static_cast<T*>(q), static_cast<T*>(kv)};
  const int n[2] = {E, E + O};
  return wgemm::bias_products(static_cast<const T*>(x), R, C, 2, w, bias, out, n, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// As attn_block_fwd_f32 for bf16 x, weights, biases, q, kv, attn and y
// (lse f32): d one of 32, 64 and 128, C and Cout multiples of 8.
extern "C" int attn_block_fwd_bf16(const void* x, const void* wq, const void* bq,
                                   const void* wkv, const void* bkv, const void* wo,
                                   const void* bo, void* q, void* kv, void* attn, float* lse,
                                   void* y, int B, int L, int C, int H, int d, int Cout,
                                   int mask_center, void* stream) {
  using T = bf16::T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * d;
  cudaError_t err = static_cast<cudaError_t>(
      attn_block_project_bf16(x, wq, bq, wkv, bkv, q, kv, B * L, C, E, E, stream));
  if (err != cudaSuccess) return err;
  const T* qb = static_cast<const T*>(q);
  const T* kvb = static_cast<const T*>(kv);
  T* ab = static_cast<T*>(attn);
  const int64_t q_bs = static_cast<int64_t>(L) * E, kv_bs = 2 * q_bs;
#define ATTN_BLOCK_BF16_CASE(D)                                                          \
  case D:                                                                                \
    err = fwg::launch_fwd<D, false>(qb, kvb, kvb + E, ab, lse, B, L, H, q_bs, E, kv_bs,  \
                                    2 * E, kv_bs, 2 * E, mask_center, s);                \
    break;
  switch (d) {
    ATTN_BLOCK_BF16_CASE(32)
    ATTN_BLOCK_BF16_CASE(64)
    ATTN_BLOCK_BF16_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ATTN_BLOCK_BF16_CASE
  if (err != cudaSuccess) return err;
  const T* w[1] = {static_cast<const T*>(wo)};
  const T* bias[1] = {static_cast<const T*>(bo)};
  T* out[1] = {static_cast<T*>(y)};
  const int n[1] = {Cout};
  return wgemm::bias_products(ab, B * L, E, 1, w, bias, out, n, nullptr, s);
}
