// A tiled float32 matrix product on the CUDA cores, with a transform on the
// A operand as it is loaded and a functor as the epilogue; shared by
// mlp_fwd.cu, mlp_bwd.cu and attn_block_fwd.cu.
//
//   out(m, n) = sum over k in the CTA's split of A(m, k) * B(k, n),
//   A(m, k) = pro(m, k, a[m * lda + k])  (kAT false: K contiguous)
//             pro(m, k, a[k * lda + m])  (kAT true:  M contiguous)
//   B(k, n) = b[k * ldb + n]             (kBT false: N contiguous)
//             b[n * ldb + k]             (kBT true:  K contiguous)
//   epi(m, n, out(m, n .. n + 3), split) for every in-range m and n % 4 == 0.
//
// A CTA of 256 threads owns a 128 x 128 tile of the output; each thread
// keeps an 8 x 8 block of it in registers (rows ty*4 + i and 64 + ty*4 + i,
// columns tx*4 + j and 64 + tx*4 + j, so that its shared-memory reads are
// float4s that the warp broadcasts or spreads over all banks). The K loop
// steps 8 at a time through two shared-memory buffers: the next step's
// float4 of A and of B are loaded into registers while the current step is
// multiplied, then stored into the other buffer, one barrier per step.
// Each output element is summed by one thread in k order, so a product is
// the same run to run; blockIdx.z cuts K into splits whose partial products
// the epilogue writes apart, for a fixed-order sum later.
//
// Bounds: the edges of M, N and K are masked (loads past them read 0, and
// pro is not applied there). The contiguous dimension of each operand must
// be a multiple of 4 and its rows 16-byte aligned (float4 loads), and N must
// be a multiple of 4. No tensor cores: f32 on the FMA pipes, 67 TFLOP/s at
// most on an H100 SXM; wgmma (TF32 or lower) and TMA pipelining are later
// work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgemm {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // floats of padding per shared row: transposed
                         // stores of neighbouring k fall on other banks

struct Identity {
  __device__ float operator()(int, int, float v) const { return v; }
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kAT, bool kBT, class Pro, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const float* __restrict__ a, int64_t lda, const float* __restrict__ b,
            int64_t ldb, int M, int N, int K, int k_split, Pro pro, Epi epi) {
  __shared__ __align__(16) float As[2][BK][BM + kPad];
  __shared__ __align__(16) float Bs[2][BK][BN + kPad];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * k_split;
  const int k1 = min(K, k0 + k_split);

  // The float4 of each tile that this thread loads: (row, column) inside
  // the tile, along the operand's contiguous dimension.
  const int a_r = kAT ? tid / 32 : tid / 2;               // k (kAT) or m
  const int a_c = kAT ? (tid % 32) * 4 : (tid % 2) * 4;   // m (kAT) or k
  const int b_r = kBT ? tid / 2 : tid / 32;               // n (kBT) or k
  const int b_c = kBT ? (tid % 2) * 4 : (tid % 32) * 4;   // k (kBT) or n

  auto load_a = [&](int kk) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!kAT) {
      const int m = m0 + a_r, k = kk + a_c;
      if (m < M && k < k1) {
        v = ldg4(a + m * lda + k);
        v = make_float4(pro(m, k, v.x), pro(m, k + 1, v.y), pro(m, k + 2, v.z),
                        pro(m, k + 3, v.w));
      }
    } else {
      const int k = kk + a_r, m = m0 + a_c;
      if (k < k1 && m < M) {
        v = ldg4(a + k * lda + m);
        v = make_float4(pro(m, k, v.x), pro(m + 1, k, v.y), pro(m + 2, k, v.z),
                        pro(m + 3, k, v.w));
      }
    }
    return v;
  };
  auto load_b = [&](int kk) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!kBT) {
      const int k = kk + b_r, n = n0 + b_c;
      if (k < k1 && n < N) v = ldg4(b + k * ldb + n);
    } else {
      const int n = n0 + b_r, k = kk + b_c;
      if (n < N && k < k1) v = ldg4(b + n * ldb + k);
    }
    return v;
  };
  auto store = [&](int buf, float4 va, float4 vb) {
    if (!kAT) {
      As[buf][a_c + 0][a_r] = va.x;
      As[buf][a_c + 1][a_r] = va.y;
      As[buf][a_c + 2][a_r] = va.z;
      As[buf][a_c + 3][a_r] = va.w;
    } else {
      *reinterpret_cast<float4*>(&As[buf][a_r][a_c]) = va;
    }
    if (!kBT) {
      *reinterpret_cast<float4*>(&Bs[buf][b_r][b_c]) = vb;
    } else {
      Bs[buf][b_c + 0][b_r] = vb.x;
      Bs[buf][b_c + 1][b_r] = vb.y;
      Bs[buf][b_c + 2][b_r] = vb.z;
      Bs[buf][b_c + 3][b_r] = vb.w;
    }
  };

  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load_a(k0), rb = load_b(k0);
  store(0, ra, rb);
  __syncthreads();
  int buf = 0;
  for (int kk = k0; kk < k1; kk += BK) {
    const bool more = kk + BK < k1;
    if (more) {
      ra = load_a(kk + BK);
      rb = load_b(kk + BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(buf ^ 1, ra, rb);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n < N)
        epi(m, n, make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                              acc[i][4 * h + 3]),
            blockIdx.z);
    }
  }
}

// Launches the product over `splits` parts of K of k_split each
// (blockIdx.z); a part may be empty, and then its epilogue sees zeros.
template <bool kAT, bool kBT, class Pro, class Epi>
cudaError_t gemm_parts(const float* a, int64_t lda, const float* b, int64_t ldb,
                       int M, int N, int K, int splits, int k_split, Pro pro, Epi epi,
                       cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || k_split <= 0 || k_split % BK != 0
      || N % 4 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_kernel<kAT, kBT, Pro, Epi>
      <<<grid, kThreads, 0, stream>>>(a, lda, b, ldb, M, N, K, k_split, pro, epi);
  return cudaGetLastError();
}

// The product over `splits` parts of K of equal size, rounded up to BK.
template <bool kAT, bool kBT, class Pro, class Epi>
cudaError_t gemm(const float* a, int64_t lda, const float* b, int64_t ldb, int M,
                 int N, int K, int splits, Pro pro, Epi epi, cudaStream_t stream) {
  if (splits <= 0) return cudaErrorInvalidValue;
  const int k_split = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  return gemm_parts<kAT, kBT>(a, lda, b, ldb, M, N, K, splits, k_split, pro, epi,
                              stream);
}

// out[m][n..n+3] = acc + bias[n..n+3] (+ resid[m][n..n+3]).
template <bool kResid>
struct BiasStore {
  const float* bias;
  const float* resid;
  float* out;
  int64_t ld;
  __device__ void operator()(int m, int n, float4 acc, int) const {
    const float4 b = ldg4(bias + n);
    float4 o = make_float4(acc.x + b.x, acc.y + b.y, acc.z + b.z, acc.w + b.w);
    if constexpr (kResid) {
      const float4 r = ldg4(resid + m * ld + n);
      o = make_float4(o.x + r.x, o.y + r.y, o.z + r.z, o.w + r.w);
    }
    *reinterpret_cast<float4*>(out + m * ld + n) = o;
  }
};

}  // namespace sgemm
