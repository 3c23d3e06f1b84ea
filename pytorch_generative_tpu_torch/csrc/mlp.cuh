// The pieces of the fused LayerNorm -> W1 -> exact GELU -> W2 -> residual
// block shared by mlp_fwd.cu and mlp_bwd.cu: the GELU and its derivative,
// the epilogues of its products, the forward's pre-activation stage and the
// backward's stages over a range of rows (see mlp_bwd.cu for the order they
// run in).
//
// Every f32 product is a 3xTF32 tensor-core product of gemm_tf32x3.cuh in
// 64 x 128 CTA tiles (kBM x kBN), every bf16 one a wgmma product of
// gemm_wgmma_bf16.cuh in 128 x 128 tiles. Their operands LN(x) and gelu(y)
// are made
// once, each element by one thread, and written to device memory: LN(x)
// (R, C) by rows.cuh's LayerNorm kernels, gelu(y) (R, F) by the epilogue
// of the product that already holds y (y = LN(x) W1 + b1 in the forward,
// dy = (dO W2^T) * gelu'(y) in the backward). Applied instead to A as it
// landed in each CTA's shared memory, they were computed again for each of
// the N / kBN column tiles that read it (16 times for LN(x) at C = 512),
// which cost more on an H100 than the extra writes (PERF.md section 6
// times both). The LayerNorm is never folded into the weights: the mean
// is subtracted before the product, as in the plain version.
//
// Every piece is a template on the element type T of the rows, the
// weights and the scratch (float, or bf16 for the bf16 entries). In bf16
// the products run on gemm_wgmma_bf16.cuh (wgmma with f32 sums, fed by
// TMA), and each bf16 store rounds to nearest even where the TPU kernel
// casts (mlp_pallas.py:83-99, :138-184 with bf16 operands): LN(x) (xn)
// before W1; y stored bf16 while the forward's gelu takes the f32 y;
// gelu(y) before W2; out = f32 sum + x, then rounded; in the backward,
// gelu and gelu' of the stored bf16 y, dy rounded for dW1 and dln (dy)
// while db1 sums the f32 dy: the dy product's epilogue sums it over each
// 64-row block, column by column, and the blocks' partials are added in
// order; dln, the weight-gradient partials and every sum stay f32.

#pragma once

#include <algorithm>

#include <type_traits>

#include "gemm_tf32x3.cuh"
#include "gemm_wgmma_bf16.cuh"
#include "rows.cuh"

namespace mlp {

constexpr int kBM = 64, kBN = 128;  // the f32 products' CTA tile

// The k-step of T's GEMM: the f32 products' and the bf16 ones'.
template <class T>
constexpr int k_step() {
  return std::is_same<T, float>::value ? gemm3::kBK : wgemm::kBK;
}

constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.f + erff(y * kSqrtHalf));
}

__device__ __forceinline__ float gelu_grad(float y) {
  const float cdf = 0.5f * (1.f + erff(y * kSqrtHalf));
  return cdf + y * (expf(-0.5f * y * y) * kInvSqrt2Pi);
}

// gelu(y) and gelu'(y) from one erff, for the bf16 epilogue: y times the
// cdf is gelu(y) up to rounding.
__device__ __forceinline__ float2 gelu_and_grad(float y) {
  const float cdf = 0.5f * (1.f + erff(y * kSqrtHalf));
  return make_float2(y * cdf, cdf + y * (expf(-0.5f * y * y) * kInvSqrt2Pi));
}

// Two neighbouring values as f32 (ld2), and their store (a bf16 store
// rounds to nearest even). The loads read operands that no launch writes
// (ld.global.nc); raw2 loads the pair as stored (one register for bf16),
// wide2 widens it.
__device__ __forceinline__ float2 raw2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ uint32_t raw2(const bf16::T* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float2 wide2(float2 v) { return v; }
__device__ __forceinline__ float2 wide2(uint32_t v) { return make_float2(bf16::lo(v), bf16::hi(v)); }
template <class T>
__device__ __forceinline__ float2 ld2(const T* p) {
  return wide2(raw2(p));
}
template <class T>
using Raw2 = decltype(raw2(static_cast<const T*>(nullptr)));
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void st2(bf16::T* p, float2 v) {
  *reinterpret_cast<uint32_t*>(p) = bf16::pack(v.x, v.y);
}
__device__ __forceinline__ float2 gelu2(float2 v) { return make_float2(gelu(v.x), gelu(v.y)); }

// The epilogues. Each reads what it needs of (m, n) by load(m, n), which
// the bf16 GEMM calls for a thread's rows before it stores any (so that
// the reads are in flight together), and writes by operator()(m, n, acc,
// part, loaded); the f32 GEMM calls operator()(m, n, acc, part), both at
// once. kColSums says whether it returns values for the bf16 GEMM to sum
// by column (gemm_wgmma_bf16.cuh).

// y[m][n, n + 1] = acc + bias[n, n + 1] and, unless g is null,
// g[m][n, n + 1] = gelu(y), of the f32 y.
template <class T>
struct PreactStore {
  static constexpr bool kColSums = false;
  const T* bias;
  T* y;
  T* g;
  int64_t ld;
  __device__ int load(int, int) const { return 0; }  // the bias is the same on every row
  __device__ void operator()(int m, int n, float2 acc, int, int = 0) const {
    const float2 b = ld2(bias + n);
    const float2 v = make_float2(acc.x + b.x, acc.y + b.y);
    st2(y + m * ld + n, v);
    if (g) st2(g + m * ld + n, gelu2(v));
  }
};

// out[m][n, n + 1] = acc + bias[n, n + 1] + resid[m][n, n + 1].
template <class T>
struct BiasResidStore {
  static constexpr bool kColSums = false;
  const T* bias;
  const T* resid;
  T* out;
  int64_t ld;
  __device__ Raw2<T> load(int m, int n) const { return raw2(resid + m * ld + n); }
  __device__ void operator()(int m, int n, float2 acc, int, Raw2<T> raw) const {
    const float2 b = ld2(bias + n), r = wide2(raw);
    st2(out + m * ld + n, make_float2(acc.x + b.x + r.x, acc.y + b.y + r.y));
  }
  __device__ void operator()(int m, int n, float2 acc, int part) const {
    (*this)(m, n, acc, part, load(m, n));
  }
};

// dy[m][n, n + 1] = acc * gelu'(y[m][n, n + 1]), returned in f32 for the
// column sums; g[m][n, n + 1] = gelu(y). The bf16 GEMM hands the f32 dy's
// column sums over each 64-row block to col_sum, which writes them to row
// `block` of colsum (the f32 GEMM does not: there db1 sums the f32 dy).
template <class T>
struct GeluGradStore {
  static constexpr bool kColSums = true;
  const T* y;
  T* dy;
  T* g;
  int64_t ld;
  float* colsum;
  __device__ Raw2<T> load(int m, int n) const { return raw2(y + m * ld + n); }
  __device__ float2 operator()(int m, int n, float2 acc, int, Raw2<T> raw) const {
    const float2 v = wide2(raw);
    if constexpr (std::is_same<T, float>::value) {  // the f32 route's bits
      const float2 d = make_float2(acc.x * gelu_grad(v.x), acc.y * gelu_grad(v.y));
      st2(dy + m * ld + n, d);
      st2(g + m * ld + n, gelu2(v));
      return d;
    } else {
      const float2 gx = gelu_and_grad(v.x), gy = gelu_and_grad(v.y);
      const float2 d = make_float2(acc.x * gx.y, acc.y * gy.y);
      st2(dy + m * ld + n, d);
      st2(g + m * ld + n, make_float2(gx.x, gy.x));
      return d;
    }
  }
  __device__ float2 operator()(int m, int n, float2 acc, int part) const {
    return (*this)(m, n, acc, part, load(m, n));
  }
  __device__ void col_sum(int block, int n, float s) const { colsum[block * ld + n] = s; }
};

// out[part][m][n, n + 1] = acc.
struct Store {
  static constexpr bool kColSums = false;
  float* out;
  int64_t ld;
  int64_t part_stride;
  __device__ int load(int, int) const { return 0; }
  __device__ void operator()(int m, int n, float2 acc, int part, int = 0) const {
    *reinterpret_cast<float2*>(out + part * part_stride + m * ld + n) = acc;
  }
};

// The product over `np` parts of K: 3xTF32 by the MLP's tile for float
// operands, wgmma for bf16 ones.
template <bool kAT, bool kBT, class Epi>
cudaError_t parts(const float* a, int64_t lda, const float* b, int64_t ldb, int M, int N,
                  int K, int np, int k_split, Epi epi, cudaStream_t s) {
  return gemm3::gemm_parts<kBM, kBN, kAT, kBT>(a, lda, b, ldb, M, N, K, np, k_split, epi, s);
}
template <bool kAT, bool kBT, class Epi>
cudaError_t parts(const bf16::T* a, int64_t lda, const bf16::T* b, int64_t ldb, int M, int N,
                  int K, int np, int k_split, Epi epi, cudaStream_t s) {
  return wgemm::gemm_parts<kAT, kBT>(a, lda, b, ldb, M, N, K, np, k_split, epi, s);
}

// out = A B, K in one part.
template <bool kAT, bool kBT, class T, class Epi>
cudaError_t product(const T* a, int64_t lda, const T* b, int64_t ldb, int M, int N, int K,
                    Epi epi, cudaStream_t s) {
  const int k_split = (K + k_step<T>() - 1) / k_step<T>() * k_step<T>();
  return parts<kAT, kBT>(a, lda, b, ldb, M, N, K, 1, k_split, epi, s);
}

// Values a 16-byte copy of T moves: C and F are multiples of it.
template <class T>
constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// gelu as the bf16 GEMM's tile-store activation.
struct Gelu {
  static __device__ __forceinline__ float apply(float v) { return gelu(v); }
};

// xn = LN(x) (R, C), then y = xn W1 + b1 (R, F) and, unless g is null,
// g = gelu(y): in f32 on the 3xTF32 GEMM with PreactStore, in bf16 on the
// wgmma GEMM's tile-store epilogue (PreactStore's bits: y and g rounded
// from the same f32 y).
template <class T>
cudaError_t preact(const T* x, const T* gamma, const T* beta, const T* w1, const T* b1, T* xn,
                   T* y, T* g, int R, int C, int F, float eps, cudaStream_t s) {
  cudaError_t err = rows::layer_norm(x, gamma, beta, xn, R, C, eps, s);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value) {
    return product<false, false>(xn, C, w1, F, R, F, C, PreactStore<T>{b1, y, g, F}, s);
  } else {
    if (g != nullptr) return wgemm::bias_products<Gelu>(xn, R, C, 1, &w1, &b1, &y, &F, g, s);
    return wgemm::bias_products(xn, R, C, 1, &w1, &b1, &y, &F, nullptr, s);
  }
}

// The forward: out = x + gelu(LN(x) W1 + b1) W2 + b2, y = LN(x) W1 + b1;
// xn (R, C) and g (R, F) are scratch.
template <class T>
cudaError_t forward(const T* x, const T* gamma, const T* beta, const T* w1, const T* b1,
                    const T* w2, const T* b2, T* out, T* y, T* xn, T* g, int R, int C, int F,
                    float eps, cudaStream_t s) {
  if (F % vec<T>() != 0 || C % vec<T>() != 0) return cudaErrorInvalidValue;
  cudaError_t err = preact(x, gamma, beta, w1, b1, xn, y, g, R, C, F, eps, s);
  if (err != cudaSuccess) return err;
  return product<false, false>(g, F, w2, C, R, C, F, BiasResidStore<T>{b2, x, out, C}, s);
}

// The backward's operands and outputs, all contiguous, of type T: x, dout
// (R, C), y (R, F), gamma, beta (C,), w1 (C, F), w2 (F, C); dx (R, C).
// f32 outputs: dw1 (C, F), db1 (F,), dw2 (F, C), sums (3, C) = (dgamma,
// dbeta, db2). Scratch of type T: xn = LN(x) (R, C), g = gelu(y) and dy
// (R, F); f32 scratch: dln (R, C), per-slice weight-gradient partials
// wpart2 and wpart1 (slices, C * F; the same buffer where the stages run
// one after the other), rpart (ceil(R / rows_per_cta), 3, C) and cpart
// (ceil(R / rows_per_chunk), F), db1's partials: column sums of the f32 dy
// over chunks of rows_per_chunk rows (for bf16 the dy product's 64-row
// blocks, wgemm::kGroupRows). The R rows are cut into slices of part_rows
// rows, a multiple of rows_per_cta and of the GEMM's k-step (for bf16 also
// of its 128-row tile, so that the pipelined route's granules start on a
// tile and a 64-row block), for the dW products; every route cuts them
// alike, so that a slice's partials, and its LayerNorm and db1 partials
// (whole CTAs and blocks of the same rows), are the same on every route.
template <class T>
struct Backward {
  const T* x;
  const T* dout;
  const T* y;
  const T* gamma;
  const T* beta;
  const T* w1;
  const T* w2;
  T* dx;
  float* dw1;
  float* db1;
  float* dw2;
  float* sums;
  const T* xn;
  T* g;
  T* dy;
  float* dln;
  float* wpart2;
  float* wpart1;
  float* rpart;
  float* cpart;
  int R, C, F, part_rows, rows_per_cta, rows_per_chunk;
  float eps;

  int parts() const { return (R + part_rows - 1) / part_rows; }
  int64_t cf() const { return static_cast<int64_t>(C) * F; }

  static constexpr bool kF32 = std::is_same<T, float>::value;

  // Rows [r0, r0 + n) of dy = (dO W2^T) * gelu'(y), a product over C with
  // W2 K-contiguous, and of g = gelu(y); for bf16 also the rows' chunks of
  // db1's partials (r0 is a multiple of rows_per_chunk).
  cudaError_t dy_rows(int r0, int n, cudaStream_t s) const {
    const int64_t rf = static_cast<int64_t>(r0) * F;
    float* colsum = kF32 ? nullptr : cpart + static_cast<int64_t>(r0 / rows_per_chunk) * F;
    return product<false, true>(dout + static_cast<int64_t>(r0) * C, C, w2, C, n, F, C,
                                GeluGradStore<T>{y + rf, dy + rf, g + rf, F, colsum}, s);
  }

  // db1 = sum dy: per-chunk column sums of all R rows of the f32 dy (for
  // f32 by a kernel over dy; for bf16 written by the dy product), added in
  // order.
  cudaError_t db1_sum(cudaStream_t s) const {
    const int n_chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
    if constexpr (kF32) {
      rows::colsum_kernel<<<dim3((F + 31) / 32, n_chunks), rows::kThreads, 0, s>>>(
          dy, cpart, R, F, rows_per_chunk);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return rows::sum_slices(cpart, db1, n_chunks, F, s);
  }

  // The partial products of slices [p0, p0 + np) over their rows, in one
  // grid of np parts, each summed in row order and written to its slice:
  // dW2 = g^T dO into wpart2, A(m = f, k = r) = g[r][f] M-contiguous.
  cudaError_t dw2_parts(int p0, int np, cudaStream_t s) const {
    const int r0 = p0 * part_rows, n = std::min(R - r0, np * part_rows);
    return mlp::parts<true, false>(
        g + static_cast<int64_t>(r0) * F, F, dout + static_cast<int64_t>(r0) * C, C, F, C,
        n, np, part_rows, Store{wpart2 + p0 * cf(), C, cf()}, s);
  }

  // dW1 = LN(x)^T dy into wpart1, A(m = c, k = r) = xn[r][c].
  cudaError_t dw1_parts(int p0, int np, cudaStream_t s) const {
    const int r0 = p0 * part_rows, n = std::min(R - r0, np * part_rows);
    return mlp::parts<true, false>(
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
    return R > 0 && C % vec<T>() == 0 && F % vec<T>() == 0 && rows_per_cta > 0 &&
           rows_per_chunk > 0 && part_rows > 0 && part_rows % rows_per_cta == 0 &&
           part_rows % k_step<T>() == 0 &&
           (kF32 || (rows_per_chunk == wgemm::kGroupRows && part_rows % wgemm::kBM == 0));
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
