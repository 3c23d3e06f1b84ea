// The pieces of the fused LayerNorm -> W1 -> exact GELU -> W2 -> residual
// block shared by mlp_fwd.cu and mlp_bwd.cu: the GELU and its derivative,
// the operand transforms and epilogues of sgemm.cuh's products, the
// forward's pre-activation stage and the backward's stages over a range of
// rows (see mlp_bwd.cu for the order they run in).

#pragma once

#include <algorithm>

#include "rows.cuh"
#include "sgemm.cuh"

namespace mlp {

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

// A(m = row, k = channel) = (x - mean) * rstd * gamma + beta: LN(x).
struct LnRows {
  const float2* stats;
  const float* gamma;
  const float* beta;
  __device__ float operator()(int m, int k, float v) const {
    const float2 s = stats[m];
    return (v - s.x) * s.y * gamma[k] + beta[k];
  }
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

// Per-row (mean, rstd) of x and y = LN(x) W1 + b1 (R, F), the LayerNorm
// applied to each float4 of x as the product loads it.
inline cudaError_t preact(const float* x, const float* gamma, const float* beta,
                          const float* w1, const float* b1, float* y, float2* st,
                          int R, int C, int F, float eps, cudaStream_t s) {
  cudaError_t err = rows::row_stats(x, st, R, C, eps, s);
  if (err != cudaSuccess) return err;
  return sgemm::gemm<false, false>(x, C, w1, F, R, F, C, 1, LnRows{st, gamma, beta},
                                   sgemm::BiasStore<false>{b1, nullptr, y, F}, s);
}

// The backward's operands and outputs, all contiguous float32: x, dout
// (R, C), y (R, F), gamma, beta (C,), w1 (C, F), w2 (F, C); dx (R, C), dw1
// (C, F), db1 (F,), dw2 (F, C), sums (3, C) = (dgamma, dbeta, db2). Scratch:
// st (R) row statistics, dy (R, F), dln (R, C), per-part weight-gradient
// partials wpart2 and wpart1 (parts, C * F; the same buffer where the
// stages run one after the other), rpart (ceil(R / rows_per_cta), 3, C)
// and cpart (ceil(R / rows_per_chunk), F). Parts of the R rows hold
// part_rows rows each, a multiple of rows_per_cta (and of sgemm::BK), so
// that a part's LayerNorm partials are whole CTAs of the same rows on
// every route.
struct Backward {
  const float* x;
  const float* dout;
  const float* y;
  const float* gamma;
  const float* beta;
  const float* w1;
  const float* w2;
  float* dx;
  float* dw1;
  float* db1;
  float* dw2;
  float* sums;
  const float2* st;
  float* dy;
  float* dln;
  float* wpart2;
  float* wpart1;
  float* rpart;
  float* cpart;
  int R, C, F, part_rows, rows_per_cta, rows_per_chunk;
  float eps;

  int parts() const { return (R + part_rows - 1) / part_rows; }
  int64_t cf() const { return static_cast<int64_t>(C) * F; }

  // Rows [r0, r0 + n) of dy = (dO W2^T) * gelu'(y), a product over C.
  cudaError_t dy_rows(int r0, int n, cudaStream_t s) const {
    return sgemm::gemm<false, true>(
        dout + static_cast<int64_t>(r0) * C, C, w2, C, n, F, C, 1, sgemm::Identity{},
        GeluGradStore{y + static_cast<int64_t>(r0) * F, dy + static_cast<int64_t>(r0) * F,
                      F},
        s);
  }

  // db1 = sum dy: per-chunk column sums of all R rows of dy, added in order.
  cudaError_t db1_sum(cudaStream_t s) const {
    const int n_chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
    rows::colsum_kernel<<<dim3((F + 31) / 32, n_chunks), rows::kThreads, 0, s>>>(
        dy, cpart, R, F, rows_per_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return rows::sum_slices(cpart, db1, n_chunks, F, s);
  }

  // The partial products of parts [p0, p0 + np) over their rows, each part
  // summed in row order by one thread an element and written to its slice:
  // dW2 = gelu(y)^T dO into wpart2, A(m = f, k = r) = gelu(y[r][f]).
  cudaError_t dw2_parts(int p0, int np, cudaStream_t s) const {
    const int r0 = p0 * part_rows, n = std::min(R - r0, np * part_rows);
    return sgemm::gemm_parts<true, false>(
        y + static_cast<int64_t>(r0) * F, F, dout + static_cast<int64_t>(r0) * C, C, F, C,
        n, np, part_rows, Gelu{}, Store{wpart2 + p0 * cf(), C, cf()}, s);
  }

  // dW1 = LN(x)^T dy into wpart1, A(m = c, k = r) = LN(x)[r][c].
  cudaError_t dw1_parts(int p0, int np, cudaStream_t s) const {
    const int r0 = p0 * part_rows, n = std::min(R - r0, np * part_rows);
    return sgemm::gemm_parts<true, false>(
        x + static_cast<int64_t>(r0) * C, C, dy + static_cast<int64_t>(r0) * F, F, C, F, n,
        np, part_rows, LnCols{st + r0, gamma, beta}, Store{wpart1 + p0 * cf(), F, cf()}, s);
  }

  // Rows [r0, r0 + n): dln = dy W1^T, then the LayerNorm backward of dln
  // + dO into dx, with the per-CTA partial sums (rows_per_cta rows each) of
  // dln * xhat, dln and dO.
  cudaError_t dx_rows(int r0, int n, cudaStream_t s) const {
    const int64_t rc = static_cast<int64_t>(r0) * C;
    cudaError_t err = sgemm::gemm<false, true>(dy + static_cast<int64_t>(r0) * F, F, w1, F,
                                               n, C, F, 1, sgemm::Identity{},
                                               Store{dln + rc, C, 0}, s);
    if (err != cudaSuccess) return err;
    return rows::ln_backward_rows(x + rc, dln + rc, gamma, dout + rc, dx + rc,
                                  rpart + static_cast<int64_t>(r0 / rows_per_cta) * 3 * C,
                                  n, C, rows_per_cta, eps, s);
  }

  // Partials added in a fixed order: the parts' dW2 and dW1, and the
  // per-CTA (dgamma, dbeta, db2).
  cudaError_t sum_dw2(cudaStream_t s) const {
    return rows::sum_slices(wpart2, dw2, parts(), cf(), s);
  }
  cudaError_t sum_dw1(cudaStream_t s) const {
    return rows::sum_slices(wpart1, dw1, parts(), cf(), s);
  }
  cudaError_t sum_ln(cudaStream_t s) const {
    return rows::sum_slices(rpart, sums, (R + rows_per_cta - 1) / rows_per_cta, 3 * C, s);
  }

  bool valid() const {
    return R > 0 && F % 4 == 0 && rows_per_cta > 0 && rows_per_chunk > 0 &&
           part_rows > 0 && part_rows % rows_per_cta == 0 && part_rows % sgemm::BK == 0;
  }

  // Every stage over all rows, on one stream; wpart2 and wpart1 may be
  // one buffer.
  cudaError_t run(cudaStream_t s) const {
    if (!valid()) return cudaErrorInvalidValue;
    cudaError_t err = dy_rows(0, R, s);
    if (err == cudaSuccess) err = dw2_parts(0, parts(), s);
    if (err == cudaSuccess) err = sum_dw2(s);
    if (err == cudaSuccess) err = dw1_parts(0, parts(), s);
    if (err == cudaSuccess) err = sum_dw1(s);
    if (err == cudaSuccess) err = dx_rows(0, R, s);
    if (err == cudaSuccess) err = sum_ln(s);
    if (err == cudaSuccess) err = db1_sum(s);
    return err;
  }
};

}  // namespace mlp
