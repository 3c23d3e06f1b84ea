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
// What bounds it on an H100: at the ImageGPT shapes (L = 784, d = 32) the
// work is ~2*L^2*d FLOPs per head, a few GFLOP per forward, against a few MB
// of q/k/v. It is bound by the f32 FMA rate of the CUDA cores and by shared
// memory bandwidth, not by device memory. This first version keeps the
// design simple: one CTA per (64-row query tile, head, batch), 2 threads per
// query row, K/V tiles staged through shared memory with loads coalesced over
// the packed row, and a k-loop that stops at the causal diagonal (the tile
// pass of flash_fwd.cuh). Where d_k == d_v, one loop stages k and v, so that
// both loads of an element are in flight at once: staging them in two loops
// made the (32, 32) and (64, 64) instances 1.4x slower on an H100 at the
// same bits.
// Tensor cores (wgmma) and TMA pipelining are left to later work.
//
// Wide heads (d = 128, bench.py's C = 512 model with 4 heads) take their own
// kernel, flash_fwd_wide_kernel, on flash_fwd.cuh's four-threads-a-row tile
// pass.

#include "flash_fwd.cuh"

namespace {

using namespace flash;

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int L, int H,
                 int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                 int64_t v_bs, int64_t v_rs, float scale_log2, int offset) {
  extern __shared__ float smem[];
  tile<DK, DV>(q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
               scale_log2, offset, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int DK, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int B, int L, int H, int64_t q_bs, int64_t q_rs,
                   int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                   int mask_center, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_smem_floats<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(DK));
  flash_fwd_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale_log2,
      mask_center ? 1 : 0);
  return cudaGetLastError();
}

template <int DK, int DV>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int L, int H,
                      int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                      int64_t v_bs, int64_t v_rs, float scale_log2, int offset) {
  extern __shared__ float smem[];
  wide_tile<DK, DV>(q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                    scale_log2, offset, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int DK, int DV>
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* out,
                        float* lse, int B, int L, int H, int64_t q_bs, int64_t q_rs,
                        int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                        int mask_center, cudaStream_t stream) {
  const size_t smem = sizeof(float) * wide_tile_smem_floats<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(DK));
  flash_fwd_wide_kernel<DK, DV><<<grid, kWideThreads, smem, stream>>>(
      q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale_log2,
      mask_center ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// q, k: f32 (B, L, H*d_k); v: f32 (B, L, H*d_v); each with unit stride over
// features and (batch, row) strides given in elements. (d_k, d_v) is one of
// (16, 16), (32, 32), (64, 64), (128, 128), (4, 32), (4, 8). out: contiguous
// (B, L, H*d_v); lse: (B, H, L).
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
  FLASH_FWD_CASE(16, 16)
  FLASH_FWD_CASE(32, 32)
  FLASH_FWD_CASE(64, 64)
  FLASH_FWD_CASE(4, 32)
  FLASH_FWD_CASE(4, 8)
#undef FLASH_FWD_CASE
  if (d_k == 128 && d_v == 128)
    return launch_wide<128, 128>(q, k, v, out, lse, B, L, H, q_bs, q_rs, k_bs,
                                 k_rs, v_bs, v_rs, mask_center, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
