// bf16 matrix products on the tensor cores with f32 sums, either operand
// K-contiguous or not, and a functor as the epilogue: the bf16 sibling of
// gemm_tf32x3.cuh, with its layouts, parts and epilogue contract.
//
//   out(m, n) = sum over k in the CTA's part of A(m, k) B(k, n),
//   A(m, k) = a[m * lda + k]  (kAT false: K contiguous)
//             a[k * lda + m]  (kAT true:  M contiguous)
//   B(k, n) = b[k * ldb + n]  (kBT false: N contiguous)
//             b[n * ldb + k]  (kBT true:  K contiguous)
//   epi(m, n, out(m, n .. n + 1), part) for every in-range m and even n,
//   out in f32.
//
// blockIdx.z cuts K into parts of k_split (a multiple of the k-step), whose
// products the epilogue writes apart for a fixed-order sum later. The fused
// MLP's bf16 entries (mlp.cuh) run every product here.
//
// Every product is one mma.sync m16n8k16 with bf16 operands and f32
// accumulators (no split: the operands are bf16 already). The tensor
// cores' f32 sums round toward zero, as they do for TF32, so each k-step's
// products (two mma deep) go into fresh accumulators, which are added into
// the running f32 sums by ordinary adds (fmma::tile_sum). Every output is
// summed by one warp in a fixed k order: two calls give the same bits, and
// a part's sum does not depend on the parts launched beside it.
//
// A CTA of BM / 64 x BN / 32 warps owns a BM x BN tile of out (64 x 128:
// 4 warps); a warp a 64 x 32 block of it (4 x 4 mma blocks). The K loop
// steps kBK = 32 values at a time through a kStages-deep cp.async ring of
// 16-byte copies (8 values); past an edge the copies write zeros. Every
// tile row is padded by 16 bytes (K-contiguous rows of kBK + 8 values,
// M- or N-contiguous rows of BM + 8 or BN + 8), which puts the 8 rows of
// each ldmatrix phase on 32 distinct banks. All fragments come by
// ldmatrix: plain for A [m][k] and B [n][k], transposed for A [k][m] and
// B [k][n].
//
// Bounds: the edges of M, N and K are masked. N must be a multiple of 8,
// and so must the contiguous dimension of each operand (K for a
// K-contiguous one, M where kAT), its leading dimension and the 16-byte
// alignment of its start. What bounds it on an H100: 2 M N K operations at
// 989 TFLOP/s against 2 (M K + K N) + 4 M N bytes at 3.35 TB/s: operations
// at the MLP's shapes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "mma_bf16.cuh"

namespace gemmb {

using bf16::T;

constexpr int kBK = 32;      // the k-step, in values: two mma deep
constexpr int kStages = 3;   // depth of the cp.async ring
constexpr int kWarpM = 64, kWarpN = 32;              // a warp's block of out
constexpr int kMB = kWarpM / 16, kNB = kWarpN / 8;   // its mma blocks
constexpr int kSK = kBK + 8;  // row stride of a K-contiguous tile

template <int BM, int BN, bool kAT, bool kBT>
struct Tiling {
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0, "whole warp blocks");
  static constexpr int kWarpsN = BN / kWarpN;
  static constexpr int kThreads = 32 * (BM / kWarpM) * kWarpsN;
  static constexpr int kSA = kAT ? BM + 8 : kSK;  // A tile [k][m] or [m][k]
  static constexpr int kSB = kBT ? kSK : BN + 8;  // B tile [n][k] or [k][n]
  static constexpr int kAElems = kAT ? kBK * kSA : BM * kSA;
  static constexpr int kStageElems = kAElems + (kBT ? BN * kSB : kBK * kSB);
  static constexpr size_t kSmemBytes = sizeof(T) * kStages * kStageElems;
  // 16-byte chunks of a step's A and B tiles.
  static constexpr int kAChunks = BM * kBK / 8, kBChunks = BN * kBK / 8;

  // Row r and column c (in values) of chunk i of a tile whose rows are
  // `width` values wide.
  __device__ static void chunk(int i, int width, int& r, int& c) {
    r = i / (width / 8);
    c = (i % (width / 8)) * 8;
  }
};

template <int BM, int BN, bool kAT, bool kBT, class Epi>
__global__ void __launch_bounds__(Tiling<BM, BN, kAT, kBT>::kThreads)
gemm_kernel(const T* __restrict__ a, int64_t lda, const T* __restrict__ b, int64_t ldb,
            int M, int N, int K, int k_split, Epi epi) {
  using Tl = Tiling<BM, BN, kAT, kBT>;
  extern __shared__ float smem[];  // kStages slots of [A | B] tiles
  T* ring = reinterpret_cast<T*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_split, kend = min(K, kbeg + k_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / Tl::kWarpsN) * kWarpM, wn = (warp % Tl::kWarpsN) * kWarpN;
  const int n_k = (kend - kbeg + kBK - 1) / kBK;

  // Starts the copies of k-step kt's A and B tiles into ring slot
  // kt % kStages.
  auto fetch = [&](int kt) {
    T* as = ring + (kt % kStages) * Tl::kStageElems;
    T* bs = as + Tl::kAElems;
    const int k0 = kbeg + kt * kBK;
    for (int i = threadIdx.x; i < Tl::kAChunks; i += Tl::kThreads) {
      int r, c;
      Tl::chunk(i, kAT ? BM : kBK, r, c);
      const int m = m0 + (kAT ? c : r), k = k0 + (kAT ? r : c);
      const bool ok = m < M && k < kend;
      const int64_t at = kAT ? k * lda + m : m * lda + k;
      bf16::cp_async16(as + r * Tl::kSA + c, ok ? a + at : a, ok);
    }
    for (int i = threadIdx.x; i < Tl::kBChunks; i += Tl::kThreads) {
      int r, c;
      Tl::chunk(i, kBT ? kBK : BN, r, c);
      const int k = k0 + (kBT ? c : r), n = n0 + (kBT ? r : c);
      const bool ok = k < kend && n < N;
      const int64_t at = kBT ? n * ldb + k : k * ldb + n;
      bf16::cp_async16(bs + r * Tl::kSB + c, ok ? b + at : b, ok);
    }
  };

  float acc[kMB][kNB][4];
#pragma unroll
  for (int i = 0; i < kMB; ++i) fmma::zero(acc[i]);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) fetch(s);
    tf32::cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    tf32::cp_async_wait<kStages - 2>();  // k-step kt has landed
    __syncthreads();  // ... for every thread, and slot (kt - 1) % kStages is read
    if (kt + kStages - 1 < n_k) fetch(kt + kStages - 1);
    tf32::cp_async_commit();
    const T* as = ring + (kt % kStages) * Tl::kStageElems;
    const T* bs = as + Tl::kAElems;

    float part[kMB][kNB][4];
#pragma unroll
    for (int i = 0; i < kMB; ++i) fmma::zero(part[i]);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[kMB][4], fb[kNB][2];
#pragma unroll
      for (int i = 0; i < kMB; ++i) {
        const int m = wm + i * 16;
        if (kAT) {
          // Blocks (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
          // (k 8-15, m 8-15), each transposed: lane l gives row
          // kk + l % 8 + 8 (l / 16), column m + 8 ((l / 8) % 2).
          bf16::ldmatrix_x4_trans(fa[i], as + (kk + lane % 8 + 8 * (lane / 16)) * Tl::kSA +
                                             m + 8 * ((lane / 8) % 2));
        } else {
          fmma::load_a_bf16<Tl::kSA>(fa[i], as + m * Tl::kSA + kk, lane);
        }
      }
#pragma unroll
      for (int j = 0; j < kNB; j += 2) {
        if (kBT)
          fmma::load_bt_bf16<Tl::kSB>(fb[j], fb[j + 1], bs + (wn + j * 8) * Tl::kSB + kk,
                                      lane);
        else
          fmma::load_b_bf16<Tl::kSB>(fb[j], fb[j + 1], bs + kk * Tl::kSB + wn + j * 8, lane);
      }
#pragma unroll
      for (int i = 0; i < kMB; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) bf16::mma(part[i][j], fa[i], fb[j]);
    }
#pragma unroll
    for (int i = 0; i < kMB; ++i) fmma::tile_sum(acc[i], part[i]);
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kMB; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if (n >= N) continue;  // N % 8 == 0: n + 1 < N too
        epi(m, n, make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]), blockIdx.z);
      }
    }
  }
}

inline bool aligned16(const void* p, int64_t ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

// Launches the product over `parts` parts of K of k_split each (blockIdx.z;
// the last may be shorter) on `stream`; returns the launch's error.
template <int BM, int BN, bool kAT, bool kBT, class Epi>
cudaError_t gemm_parts(const T* a, int64_t lda, const T* b, int64_t ldb, int M, int N, int K,
                       int parts, int k_split, Epi epi, cudaStream_t stream) {
  using Tl = Tiling<BM, BN, kAT, kBT>;
  const bool k_chunks = !kAT || kBT;  // some operand is copied 8 k at a time
  if (M <= 0 || N <= 0 || K <= 0 || parts <= 0 || k_split <= 0 || k_split % kBK != 0 ||
      N % 8 != 0 || (kAT && M % 8 != 0) || (k_chunks && K % 8 != 0))
    return cudaErrorInvalidValue;
  if (!aligned16(a, lda) || !aligned16(b, ldb)) return cudaErrorMisalignedAddress;
  auto kernel = gemm_kernel<BM, BN, kAT, kBT, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Tl::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, parts);
  kernel<<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(a, lda, b, ldb, M, N, K, k_split,
                                                          epi);
  return cudaGetLastError();
}

}  // namespace gemmb
