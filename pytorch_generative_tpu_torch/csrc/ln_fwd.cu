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
// through shared memory in a fixed order.

#include "rows.cuh"

namespace {

template <int NV>
__global__ void __launch_bounds__(rows::kThreads)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ out, int R, int C,
              float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * rows::kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int64_t base = static_cast<int64_t>(r) * C;
  float4 v[NV];
  rows::load_row<NV>(v, x + base, C, lane);
  const float2 st = rows::row_stats<NV>(v, C, lane, eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = rows::col(lane, i);
    if (c >= C) continue;
    const float4 g = rows::ld4(gamma + c), b = rows::ld4(beta + c);
    rows::st4(out + base + c,
              make_float4((v[i].x - st.x) * st.y * g.x + b.x,
                          (v[i].y - st.x) * st.y * g.y + b.y,
                          (v[i].z - st.x) * st.y * g.z + b.z,
                          (v[i].w - st.x) * st.y * g.w + b.w));
  }
}

template <int NVC>
__global__ void __launch_bounds__(rows::kThreads)
ln_fwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out, int C,
                   float eps) {
  __shared__ float red[rows::kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * C;
  float4 v[NVC];
  rows::load_row_wide<NVC>(v, x + base, C);
  const float2 st = rows::row_stats_wide<NVC>(v, C, eps, red);
#pragma unroll
  for (int i = 0; i < NVC; ++i) {
    const int c = rows::wcol(threadIdx.x, i);
    if (c >= C) continue;
    const float4 g = rows::ld4(gamma + c), b = rows::ld4(beta + c);
    rows::st4(out + base + c,
              make_float4((v[i].x - st.x) * st.y * g.x + b.x,
                          (v[i].y - st.x) * st.y * g.y + b.y,
                          (v[i].z - st.x) * st.y * g.z + b.z,
                          (v[i].w - st.x) * st.y * g.w + b.w));
  }
}

}  // namespace

// x, out (R, C), gamma, beta (C,): contiguous float32; C a multiple of 4,
// at most rows::kMaxChannels (4096).
extern "C" int ln_fwd_f32(const float* x, const float* gamma, const float* beta,
                          float* out, int R, int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + rows::kWarps - 1) / rows::kWarps);
  switch (rows::vecs_per_lane(C)) {
    case 1: ln_fwd_kernel<1><<<grid, rows::kThreads, 0, s>>>(x, gamma, beta, out, R, C, eps); break;
    case 2: ln_fwd_kernel<2><<<grid, rows::kThreads, 0, s>>>(x, gamma, beta, out, R, C, eps); break;
    case 4: ln_fwd_kernel<4><<<grid, rows::kThreads, 0, s>>>(x, gamma, beta, out, R, C, eps); break;
    default:
      if (R <= 0) return static_cast<int>(cudaErrorInvalidValue);
      switch (rows::vecs_per_thread(C)) {
        case 1: ln_fwd_wide_kernel<1><<<R, rows::kThreads, 0, s>>>(x, gamma, beta, out, C, eps); break;
        case 2: ln_fwd_wide_kernel<2><<<R, rows::kThreads, 0, s>>>(x, gamma, beta, out, C, eps); break;
        case 4: ln_fwd_wide_kernel<4><<<R, rows::kThreads, 0, s>>>(x, gamma, beta, out, C, eps); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
  }
  return static_cast<int>(cudaGetLastError());
}
