// Causal flash-attention forward over packed float32 tensors: q and k
// (B, L, H*d_k), v and out (B, L, H*d_v).
//
// Replaces pytorch_generative_tpu/ops/attention_pallas.py::_fwd_kernel (the
// packed forward that _flash_forward launches). Same contract: heads are cut
// out of the packed feature axis by offsets (no transposes), the online
// softmax runs in base 2 with scale*log2(e) folded into q and f32 statistics,
// `mask_center` shifts the diagonal by one, fully-masked rows give exactly 0
// with lse = -inf, and lse is stored as a natural log, (B, H, L).
//
// What bounds it on an H100: ~2 (d_k + d_v) FLOPs per causal (query, key)
// pair and head, 40 GFLOP at ImageGPT's C = 512 (B 64, L 784, 8 heads of
// 64), against 0.1 GB of q/k/v/out: operations, not device memory. On the
// CUDA cores (67 TFLOP/s f32) the old kernels of this file ran at 6-8
// TFLOP/s, paced by one shared-memory load per FMA.
//
// d_k == d_v (16, 32, 64, 128: ImageGPT's heads) runs on the tensor cores by
// 3xTF32 mma.sync: fmma::flash_fwd_mma_kernel of flash_fwd_mma.cuh, which the
// fused attention block (attn_block_fwd.cu) runs as well.
//
// flash_fwd_bf16 takes bf16 q, k, v and writes bf16 out and f32 lse, at
// the TPU kernel's rounding points for bf16 operands: for d_k == d_v = 16,
// 32, 64, 128 by warpgroup wgmma products fed by TMA (fwg::launch_fwd,
// flash_wgmma_bf16.cuh), for (4, 32) and (4, 8) by bf16 mma.sync with d_k
// zero-padded to the m16n8k8 product's depth (smma::launch_fwd,
// flash_fwd_small_bf16.cuh), which takes any view with unit feature stride.
//
// (d_k, d_v) = (4, 32) and (4, 8) (PixelSNAIL) keep the SIMT tile pass of
// flash_fwd.cuh in f32, which reads each operand one value at a time and so
// takes the same views.

#include "flash_fwd.cuh"
#include "flash_fwd_mma.cuh"
#include "flash_fwd_small_bf16.cuh"
#include "flash_wgmma_bf16.cuh"

namespace {

template <int DK, int DV>
__global__ void __launch_bounds__(flash::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int L, int H,
                 int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                 int64_t v_bs, int64_t v_rs, float scale_log2, int offset) {
  extern __shared__ float smem[];
  flash::tile<DK, DV>(q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                      scale_log2, offset, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int DK, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int B, int L, int H, int64_t q_bs, int64_t q_rs,
                   int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                   int mask_center, cudaStream_t stream) {
  const size_t smem = sizeof(float) * flash::tile_smem_floats<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + flash::kBlockQ - 1) / flash::kBlockQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(DK));
  flash_fwd_kernel<DK, DV><<<grid, flash::kThreads, smem, stream>>>(
      q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale_log2,
      mask_center ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// q, k: f32 (B, L, H*d_k); v: f32 (B, L, H*d_v); each with unit stride over
// features and (batch, row) strides given in elements. (d_k, d_v) is one of
// (16, 16), (32, 32), (64, 64), (128, 128), (4, 32), (4, 8); for d_k == d_v
// each operand's start is 16-byte aligned and its strides multiples of 4.
// out: contiguous (B, L, H*d_v); lse: (B, H, L).
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* out, float* lse, int B, int L, int H,
                             int d_k, int d_v, int64_t q_bs, int64_t q_rs,
                             int64_t k_bs, int64_t k_rs, int64_t v_bs,
                             int64_t v_rs, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(DK, DV)                                              \
  if (d_k == DK && d_v == DV)                                               \
    return launch<DK, DV>(q, k, v, out, lse, B, L, H, q_bs, q_rs, k_bs,     \
                          k_rs, v_bs, v_rs, mask_center, s);
  FLASH_FWD_CASE(4, 32)
  FLASH_FWD_CASE(4, 8)
#undef FLASH_FWD_CASE
#define FLASH_FWD_MMA_CASE(D)                                                   \
  if (d_k == D && d_v == D)                                                     \
    return fmma::launch_fwd<D>(q, k, v, out, lse, B, L, H, q_bs, q_rs, k_bs,    \
                               k_rs, v_bs, v_rs, mask_center, s);
  FLASH_FWD_MMA_CASE(16)
  FLASH_FWD_MMA_CASE(32)
  FLASH_FWD_MMA_CASE(64)
  FLASH_FWD_MMA_CASE(128)
#undef FLASH_FWD_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_fwd_f32 for bf16 q, k, v and out (lse f32): (d_k, d_v) = (4,
// 32) or (4, 8), any such view (bf16 mma.sync); or d_k == d_v, one of 16, 32, 64, 128, each
// operand's start 16-byte aligned and its (batch, row) strides multiples of
// 8 values.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                              float* lse, int B, int L, int H, int d_k, int d_v,
                              int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                              int64_t v_bs, int64_t v_rs, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16::T*>(q);
  const auto* kb = static_cast<const bf16::T*>(k);
  const auto* vb = static_cast<const bf16::T*>(v);
  auto* ob = static_cast<bf16::T*>(out);
#define FLASH_FWD_SMALL_CASE(DV)                                                        \
  if (d_k == smma::kDK && d_v == DV)                                                    \
    return smma::launch_fwd<DV>(qb, kb, vb, ob, lse, B, L, H, q_bs, q_rs, k_bs, k_rs,    \
                                v_bs, v_rs, mask_center, fwg::scale_log2_of(smma::kDK), s);
  FLASH_FWD_SMALL_CASE(32)
  FLASH_FWD_SMALL_CASE(8)
#undef FLASH_FWD_SMALL_CASE
#define FLASH_FWD_BF16_CASE(D)                                                      \
  if (d_k == D && d_v == D)                                                         \
    return fwg::launch_fwd<D>(qb, kb, vb, ob, lse, B, L, H, q_bs, q_rs, k_bs, k_rs, \
                              v_bs, v_rs, mask_center, s);
  FLASH_FWD_BF16_CASE(16)
  FLASH_FWD_BF16_CASE(32)
  FLASH_FWD_BF16_CASE(64)
  FLASH_FWD_BF16_CASE(128)
#undef FLASH_FWD_BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared-memory bytes of flash_fwd_bf16's CTA at d_k == d_v == d (0 for
// another d): tests/test_torch_flash_plan.py restates it.
extern "C" int flash_fwd_bf16_smem(int d) {
  switch (d) {
    case 16: return fwg::Fwd<16, fwg::groups<16>()>::kSmem;
    case 32: return fwg::Fwd<32, fwg::groups<32>()>::kSmem;
    case 64: return fwg::Fwd<64, fwg::groups<64>()>::kSmem;
    case 128: return fwg::Fwd<128, fwg::groups<128>()>::kSmem;
  }
  return 0;
}
