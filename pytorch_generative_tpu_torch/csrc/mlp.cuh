// The pieces of the fused LayerNorm -> W1 -> exact GELU -> W2 -> residual
// block shared by mlp_fwd.cu and mlp_bwd.cu: the GELU and its derivative,
// the epilogues of its products, the forward's pre-activation stage and the
// backward's stages over a range of rows (see mlp_bwd.cu for the order they
// run in).
//
// Every product is a 3xTF32 tensor-core product of gemm_tf32x3.cuh in
// 64 x 128 CTA tiles (kBM x kBN). Its operands LN(x) and gelu(y) are made
// once, each element by one thread, and written to device memory: LN(x)
// (R, C) by rows.cuh's LayerNorm kernels, gelu(y) (R, F) by the epilogue
// of the product that already holds y (y = LN(x) W1 + b1 in the forward,
// dy = (dO W2^T) * gelu'(y) in the backward). Applied instead to A as it
// landed in each CTA's shared memory, they were computed again for each of
// the N / kBN column tiles that read it (16 times for LN(x) at C = 512),
// which cost more on an H100 than the extra writes (PERF.md section 6
// times both). The LayerNorm is never folded into the weights: the mean
// is subtracted before the product, as in the plain version.

#pragma once

#include <algorithm>

#include "gemm_tf32x3.cuh"
#include "rows.cuh"

namespace mlp {

constexpr int kBM = 64, kBN = 128;  // the products' CTA tile

constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.f + erff(y * kSqrtHalf));
}

__device__ __forceinline__ float gelu_grad(float y) {
  const float cdf = 0.5f * (1.f + erff(y * kSqrtHalf));
  return cdf + y * (expf(-0.5f * y * y) * kInvSqrt2Pi);
}

// y[m][n, n + 1] = acc + bias[n, n + 1] and, unless g is null,
// g[m][n, n + 1] = gelu(y).
struct PreactStore {
  const float* bias;
  float* y;
  float* g;
  int64_t ld;
  __device__ void operator()(int m, int n, float2 acc, int) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + n);
    const float2 v = make_float2(acc.x + b.x, acc.y + b.y);
    *reinterpret_cast<float2*>(y + m * ld + n) = v;
    if (g) *reinterpret_cast<float2*>(g + m * ld + n) = make_float2(gelu(v.x), gelu(v.y));
  }
};

// out[m][n, n + 1] = acc + bias[n, n + 1] + resid[m][n, n + 1].
struct BiasResidStore {
  const float* bias;
  const float* resid;
  float* out;
  int64_t ld;
  __device__ void operator()(int m, int n, float2 acc, int) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + n);
    const float2 r = *reinterpret_cast<const float2*>(resid + m * ld + n);
    *reinterpret_cast<float2*>(out + m * ld + n) =
        make_float2(acc.x + b.x + r.x, acc.y + b.y + r.y);
  }
};

// dy[m][n, n + 1] = acc * gelu'(y[m][n, n + 1]), g[m][n, n + 1] = gelu(y).
struct GeluGradStore {
  const float* y;
  float* dy;
  float* g;
  int64_t ld;
  __device__ void operator()(int m, int n, float2 acc, int) const {
    const float2 v = *reinterpret_cast<const float2*>(y + m * ld + n);
    *reinterpret_cast<float2*>(dy + m * ld + n) =
        make_float2(acc.x * gelu_grad(v.x), acc.y * gelu_grad(v.y));
    *reinterpret_cast<float2*>(g + m * ld + n) = make_float2(gelu(v.x), gelu(v.y));
  }
};

// out[part][m][n, n + 1] = acc.
struct Store {
  float* out;
  int64_t ld;
  int64_t part_stride;
  __device__ void operator()(int m, int n, float2 acc, int part) const {
    *reinterpret_cast<float2*>(out + part * part_stride + m * ld + n) = acc;
  }
};

// out = A B by the MLP's tile, K in one part.
template <bool kAT, bool kBT, class Epi>
cudaError_t product(const float* a, int64_t lda, const float* b, int64_t ldb, int M, int N,
                    int K, Epi epi, cudaStream_t s) {
  const int k_split = (K + gemm3::kBK - 1) / gemm3::kBK * gemm3::kBK;
  return gemm3::gemm_parts<kBM, kBN, kAT, kBT>(a, lda, b, ldb, M, N, K, 1, k_split, epi, s);
}

// xn = LN(x) (R, C), then y = xn W1 + b1 (R, F) and, unless g is null,
// g = gelu(y).
inline cudaError_t preact(const float* x, const float* gamma, const float* beta,
                          const float* w1, const float* b1, float* xn, float* y, float* g,
                          int R, int C, int F, float eps, cudaStream_t s) {
  cudaError_t err = rows::layer_norm(x, gamma, beta, xn, R, C, eps, s);
  if (err != cudaSuccess) return err;
  return product<false, false>(xn, C, w1, F, R, F, C, PreactStore{b1, y, g, F}, s);
}

// The backward's operands and outputs, all contiguous float32: x, dout
// (R, C), y (R, F), gamma, beta (C,), w1 (C, F), w2 (F, C); dx (R, C), dw1
// (C, F), db1 (F,), dw2 (F, C), sums (3, C) = (dgamma, dbeta, db2). Scratch:
// xn = LN(x) (R, C), g = gelu(y) and dy (R, F), dln (R, C), per-slice
// weight-gradient partials wpart2 and wpart1 (slices, C * F; the same buffer where the
// stages run one after the other), rpart (ceil(R / rows_per_cta), 3, C)
// and cpart (ceil(R / rows_per_chunk), F). The R rows are cut into slices
// of part_rows rows, a multiple of rows_per_cta and of the GEMM's k-step,
// for the dW products; every route cuts them alike, so that a slice's
// partials, and its LayerNorm partials (whole CTAs of the same rows), are
// the same on every route.
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
  const float* xn;
  float* g;
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

  // Rows [r0, r0 + n) of dy = (dO W2^T) * gelu'(y), a product over C with
  // W2 K-contiguous, and of g = gelu(y).
  cudaError_t dy_rows(int r0, int n, cudaStream_t s) const {
    const int64_t rf = static_cast<int64_t>(r0) * F;
    return product<false, true>(dout + static_cast<int64_t>(r0) * C, C, w2, C, n, F, C,
                                GeluGradStore{y + rf, dy + rf, g + rf, F}, s);
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

  // The partial products of slices [p0, p0 + np) over their rows, in one
  // grid of np parts, each summed in row order and written to its slice:
  // dW2 = g^T dO into wpart2, A(m = f, k = r) = g[r][f] M-contiguous.
  cudaError_t dw2_parts(int p0, int np, cudaStream_t s) const {
    const int r0 = p0 * part_rows, n = std::min(R - r0, np * part_rows);
    return gemm3::gemm_parts<kBM, kBN, true, false>(
        g + static_cast<int64_t>(r0) * F, F, dout + static_cast<int64_t>(r0) * C, C, F, C,
        n, np, part_rows, Store{wpart2 + p0 * cf(), C, cf()}, s);
  }

  // dW1 = LN(x)^T dy into wpart1, A(m = c, k = r) = xn[r][c].
  cudaError_t dw1_parts(int p0, int np, cudaStream_t s) const {
    const int r0 = p0 * part_rows, n = std::min(R - r0, np * part_rows);
    return gemm3::gemm_parts<kBM, kBN, true, false>(
        xn + static_cast<int64_t>(r0) * C, C, dy + static_cast<int64_t>(r0) * F, F, C, F, n,
        np, part_rows, Store{wpart1 + p0 * cf(), F, cf()}, s);
  }

  // Rows [r0, r0 + n): dln = dy W1^T (W1 K-contiguous), then the LayerNorm
  // backward of dln + dO into dx, with the per-CTA partial sums
  // (rows_per_cta rows each) of dln * xhat, dln and dO.
  cudaError_t dx_rows(int r0, int n, cudaStream_t s) const {
    const int64_t rc = static_cast<int64_t>(r0) * C;
    cudaError_t err = product<false, true>(dy + static_cast<int64_t>(r0) * F, F, w1, F, n,
                                           C, F, Store{dln + rc, C, 0}, s);
    if (err != cudaSuccess) return err;
    return rows::ln_backward_rows(x + rc, dln + rc, gamma, dout + rc, dx + rc,
                                  rpart + static_cast<int64_t>(r0 / rows_per_cta) * 3 * C,
                                  n, C, rows_per_cta, eps, s);
  }

  // Partials added in slice order: the dW2 and dW1 slices, and the
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
    return R > 0 && C % 4 == 0 && F % 4 == 0 && rows_per_cta > 0 && rows_per_chunk > 0 &&
           part_rows > 0 && part_rows % rows_per_cta == 0 && part_rows % gemm3::kBK == 0;
  }

  // Every stage after xn over all rows on one stream, each dW product as
  // one grid over every slice; wpart2 and wpart1 may be one buffer.
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
