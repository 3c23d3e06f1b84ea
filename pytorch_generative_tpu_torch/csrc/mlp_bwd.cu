// Backward of the fused LayerNorm -> W1 -> exact GELU -> W2 -> residual
// block over (R, C) float32 rows, from x, dO and the forward's saved
// pre-activation y (R, F):
//   g = gelu(y), dW2 = g^T dO, db2 = sum dO,
//   dy = (dO W2^T) * gelu'(y), dW1 = LN(x)^T dy, db1 = sum dy,
//   dln = dy W1^T, then the LayerNorm backward of dln: dgamma, dbeta and
//   dx = LN-backward(dln) + dO (the residual path).
//
// Replaces pytorch_generative_tpu/ops/mlp_pallas.py::_bwd_kernel_savey /
// _bwd_kernel with a saved y (launched by _fused_bwd, the custom_vjp
// backward of ln_mlp_residual with _SAVE_PREACT). Same outputs, the weight,
// bias and LayerNorm-parameter gradients summed over all R rows in f32.
//
// Why the design differs from the TPU's: the TPU kernel walks row blocks in
// order and adds every weight gradient into VMEM tiles that its sequential
// grid revisits. CUDA blocks run in no order, and this kernel uses no
// atomics, so that the gradients are the same run to run. It runs as
// launches on one stream:
//   1. per-row (mean, rstd) of x (rows.cuh);
//   2. dy = (dO W2^T) * gelu'(y): a product over C per row, with gelu'(y)
//      in the epilogue; dy (R, F) goes to device memory;
//   3. dW2 = gelu(y)^T dO and 4. dW1 = LN(x)^T dy: products over the R rows,
//      cut into `splits` parts of R whose partial products are written
//      apart and then added in order (sum_slices); GELU and the LayerNorm
//      (from the stats of 1) are applied to y and x as they are loaded;
//   5. dln = dy W1^T (R, C);
//   6. the LayerNorm backward over whole rows of dln (warp per row, it
//      needs each row's two means), + dO, with per-CTA partial sums of
//      dln * xhat, dln and dO added in order for dgamma, dbeta and db2;
//   7. db1 = sum dy: per-chunk column sums added in order.
//
// What bounds it on an H100: four (R x C x F) products, 8 R C F FLOPs
// (421 GFLOP at R = 50,176, C = 512, F = 2048), against 0.74 GB of operands:
// f32 FMA work on the CUDA cores (67 TFLOP/s), ~6.3 ms at best. The
// products are sgemm.cuh's SIMT tiles.

#include "rows.cuh"
#include "sgemm.cuh"

namespace {

constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.f + erff(y * kSqrtHalf));
}

__device__ __forceinline__ float gelu_grad(float y) {
  const float cdf = 0.5f * (1.f + erff(y * kSqrtHalf));
  return cdf + y * (expf(-0.5f * y * y) * kInvSqrt2Pi);
}

struct Gelu {
  __device__ float operator()(int, int, float v) const { return gelu(v); }
};

// A(m = channel, k = row) = (x[row][channel] - mean[row]) * rstd[row]
// * gamma[channel] + beta[channel]: LN(x)^T.
struct LnCols {
  const float2* stats;
  const float* gamma;
  const float* beta;
  __device__ float operator()(int m, int k, float v) const {
    const float2 s = stats[k];
    return (v - s.x) * s.y * gamma[m] + beta[m];
  }
};

// dy[m][n..n+3] = acc * gelu'(y[m][n..n+3]).
struct GeluGradStore {
  const float* y;
  float* dy;
  int64_t ld;
  __device__ void operator()(int m, int n, float4 acc, int) const {
    const float4 v = sgemm::ldg4(y + m * ld + n);
    *reinterpret_cast<float4*>(dy + m * ld + n) =
        make_float4(acc.x * gelu_grad(v.x), acc.y * gelu_grad(v.y),
                    acc.z * gelu_grad(v.z), acc.w * gelu_grad(v.w));
  }
};

// out[split][m][n..n+3] = acc.
struct Store {
  float* out;
  int64_t ld;
  int64_t split_stride;
  __device__ void operator()(int m, int n, float4 acc, int split) const {
    *reinterpret_cast<float4*>(out + split * split_stride + m * ld + n) = acc;
  }
};

}  // namespace

// Inputs, contiguous float32: x, dout (R, C), y (R, F), gamma, beta (C,),
// w1 (C, F), w2 (F, C). Outputs: dx (R, C), dw1 (C, F), db1 (F,),
// dw2 (F, C), and sums (3, C) = (dgamma, dbeta, db2). Scratch: stats (R, 2),
// dy (R, F), dln (R, C), wpart (splits, C * F), rpart (ceil(R /
// rows_per_cta), 3, C), cpart (ceil(R / rows_per_chunk), F). C and F
// multiples of 4, C at most rows::kMaxChannels (4096).
extern "C" int mlp_bwd_f32(const float* x, const float* dout, const float* y,
                           const float* gamma, const float* beta, const float* w1,
                           const float* w2, float* dx, float* dw1, float* db1,
                           float* dw2, float* sums, float* stats, float* dy,
                           float* dln, float* wpart, float* rpart, float* cpart,
                           int R, int C, int F, int splits, int rows_per_cta,
                           int rows_per_chunk, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 4 != 0 || rows_per_chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cf = static_cast<int64_t>(C) * F;
  float2* st = reinterpret_cast<float2*>(stats);
  cudaError_t err = rows::row_stats(x, st, R, C, eps, s);
  if (err != cudaSuccess) return err;
  // 2. dy = (dO W2^T) * gelu'(y); B(k = c, n = f) = w2[f][c].
  err = sgemm::gemm<false, true>(dout, C, w2, C, R, F, C, 1, sgemm::Identity{},
                                 GeluGradStore{y, dy, F}, s);
  if (err != cudaSuccess) return err;
  // 3. dW2 (F, C) = gelu(y)^T dO, A(m = f, k = r) = gelu(y[r][f]).
  err = sgemm::gemm<true, false>(y, F, dout, C, F, C, R, splits, Gelu{},
                                 Store{wpart, C, cf}, s);
  if (err != cudaSuccess) return err;
  err = rows::sum_slices(wpart, dw2, splits, cf, s);
  if (err != cudaSuccess) return err;
  // 4. dW1 (C, F) = LN(x)^T dy, A(m = c, k = r) = LN(x)[r][c].
  err = sgemm::gemm<true, false>(x, C, dy, F, C, F, R, splits,
                                 LnCols{st, gamma, beta}, Store{wpart, F, cf}, s);
  if (err != cudaSuccess) return err;
  err = rows::sum_slices(wpart, dw1, splits, cf, s);
  if (err != cudaSuccess) return err;
  // 5. dln = dy W1^T; B(k = f, n = c) = w1[c][f].
  err = sgemm::gemm<false, true>(dy, F, w1, F, R, C, F, 1, sgemm::Identity{},
                                 Store{dln, C, 0}, s);
  if (err != cudaSuccess) return err;
  // 6. dx, and (dgamma, dbeta, db2) in sums.
  err = rows::ln_backward(x, dln, gamma, dout, dx, rpart, sums, R, C, rows_per_cta,
                          eps, s);
  if (err != cudaSuccess) return err;
  // 7. db1 = sum over rows of dy.
  const int n_chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
  rows::colsum_kernel<<<dim3((F + 31) / 32, n_chunks), rows::kThreads, 0, s>>>(
      dy, cpart, R, F, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rows::sum_slices(cpart, db1, n_chunks, F, s);
}
