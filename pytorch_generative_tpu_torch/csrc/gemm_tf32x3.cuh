// Float32 matrix products on the tensor cores, to about f32's accuracy,
// with either operand K-contiguous or not and a functor as the epilogue:
//
//   out(m, n) = sum over k in the CTA's part of A(m, k) B(k, n),
//   A(m, k) = a[m * lda + k]  (kAT false: K contiguous)
//             a[k * lda + m]  (kAT true:  M contiguous)
//   B(k, n) = b[k * ldb + n]  (kBT false: N contiguous)
//             b[n * ldb + k]  (kBT true:  K contiguous)
//   epi(m, n, out(m, n .. n + 1), part) for every in-range m and even n.
//
// blockIdx.z cuts K into parts of k_split (a multiple of the k-step), whose
// products the epilogue writes apart for a fixed-order sum later. The fused
// attention block's three products (attn_block_fwd.cu) run as gemm(): out =
// a b + bias, one part. Every product of the fused MLP (mlp.cuh) runs as
// gemm_parts() with the MLP's epilogues.
//
// Every product runs as mma.sync m16n8k8 with TF32 operands by 3xTF32, as
// the flash kernels' (flash_mma.cuh): each f32 operand x is split into
// big = tf32(x) and small = x - big, and a b is summed as small_a big_b +
// big_a small_b + big_a big_b. The tensor cores' f32 sums round toward zero,
// so each k-step's products go into fresh accumulators, which are added
// into the running f32 sums by ordinary adds (fmma::tile_sum). Every output
// is summed by one warp in a fixed k order: two calls give the same bits,
// and a part's sum does not depend on the parts launched beside it.
//
// A CTA of BM / 64 x BN / 32 warps owns a BM x BN tile of out (128 x 64 or
// 64 x 128: 4 warps, 2 CTAs an SM); a warp a 64 x 32 block of it (4 x 4 mma
// blocks), so that each split A fragment is used 4 times and each split B
// fragment 4 times. The running sums and the fresh ones take 128 registers
// a thread, which rules out wider warp blocks. The K loop steps kBK at a
// time through a kStages-deep cp.async ring: the tiles of the next steps
// load while the current one is multiplied, with one barrier a step; past
// an edge the copies write zeros. Tiles are padded so that every
// fragment's 32 lanes hit distinct banks: a K-contiguous tile ([m][k] or
// [n][k]) has rows of kBK + 4 floats and gives its fragments by ldmatrix
// (8 rows of 16 bytes a phase); an M- or N-contiguous one ([k][m] or
// [k][n]) has rows of BM + 8 or BN + 8 floats (8 t + g spans 32 banks) and
// gives them by 32-bit loads.
//
// Tilings of 64 x 64 to 128 x 128, rings of 2 to 4 stages of k-steps of 16
// or 32, and a trial on Hopper's wgmma (tools/gemm_wgmma_trial.cuh) were
// timed on an H100 by tools/torch_gemm_variants.py (PERF.md section 6):
// 128 x 64 and 64 x 128 were as fast as any at C = 512 (~57 TFLOP/s); the
// wgmma trial reached ~49-52.
//
// Bounds: the edges of M, N and K are masked (the copies read zeros past
// them). N must be a multiple of 4, and so must the contiguous dimension
// of each operand (K for a K-contiguous one, M where kAT), its leading
// dimension, and the 16-byte alignment of its start (16-byte copies). What
// bounds it on an H100: 2 M N K operations at the 3xTF32 rate, 495 / 3 =
// 165 TFLOP/s, against 4 (M K + K N + M N) bytes at 3.35 TB/s: operations
// at the block's and the MLP's shapes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "mma_tf32.cuh"

namespace gemm3 {

constexpr int kBK = 32;      // the k-step
constexpr int kStages = 3;   // depth of the cp.async ring
constexpr int kWarpM = 64, kWarpN = 32;              // a warp's block of out
constexpr int kMB = kWarpM / 16, kNB = kWarpN / 8;   // its mma blocks
constexpr int kSK = kBK + 4;  // row stride of a K-contiguous tile

// out[m][n, n + 1] = acc + bias[n, n + 1].
struct BiasStore {
  const float* bias;
  float* out;
  int64_t ld;
  __device__ void operator()(int m, int n, float2 acc, int) const {
    const float2 bb = *reinterpret_cast<const float2*>(bias + n);
    *reinterpret_cast<float2*>(out + m * ld + n) = make_float2(acc.x + bb.x, acc.y + bb.y);
  }
};

template <int BM, int BN, bool kAT, bool kBT>
struct Tiling {
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0, "whole warp blocks");
  static constexpr int kWarpsN = BN / kWarpN;
  static constexpr int kThreads = 32 * (BM / kWarpM) * kWarpsN;
  static constexpr int kSA = kAT ? BM + 8 : kSK;  // A tile [k][m] or [m][k]
  static constexpr int kSB = kBT ? kSK : BN + 8;  // B tile [n][k] or [k][n]
  static constexpr int kAFloats = kAT ? kBK * kSA : BM * kSA;
  static constexpr int kStageFloats = kAFloats + (kBT ? BN * kSB : kBK * kSB);
  static constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
  // 16-byte chunks of a step's A and B tiles.
  static constexpr int kAChunks = BM * kBK / 4, kBChunks = BN * kBK / 4;

  // Row r and column c (in floats) of chunk i of a tile whose rows are
  // `width` floats wide.
  __device__ static void chunk(int i, int width, int& r, int& c) {
    r = i / (width / 4);
    c = (i % (width / 4)) * 4;
  }
};

template <int BM, int BN, bool kAT, bool kBT, class Epi>
__global__ void __launch_bounds__(Tiling<BM, BN, kAT, kBT>::kThreads)
gemm_kernel(const float* __restrict__ a, int64_t lda, const float* __restrict__ b,
            int64_t ldb, int M, int N, int K, int k_split, Epi epi) {
  using T = Tiling<BM, BN, kAT, kBT>;
  extern __shared__ float smem[];  // kStages slots of [A | B] tiles
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_split, kend = min(K, kbeg + k_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / T::kWarpsN) * kWarpM, wn = (warp % T::kWarpsN) * kWarpN;
  const int n_k = (kend - kbeg + kBK - 1) / kBK;

  // Starts the copies of k-step kt's A and B tiles into ring slot
  // kt % kStages.
  auto fetch = [&](int kt) {
    float* as = smem + (kt % kStages) * T::kStageFloats;
    float* bs = as + T::kAFloats;
    const int k0 = kbeg + kt * kBK;
    for (int i = threadIdx.x; i < T::kAChunks; i += T::kThreads) {
      int r, c;
      T::chunk(i, kAT ? BM : kBK, r, c);
      const int m = m0 + (kAT ? c : r), k = k0 + (kAT ? r : c);
      const bool ok = m < M && k < kend;
      const int64_t at = kAT ? k * lda + m : m * lda + k;
      tf32::cp_async16(as + r * T::kSA + c, ok ? a + at : a, ok);
    }
    for (int i = threadIdx.x; i < T::kBChunks; i += T::kThreads) {
      int r, c;
      T::chunk(i, kBT ? kBK : BN, r, c);
      const int k = k0 + (kBT ? c : r), n = n0 + (kBT ? r : c);
      const bool ok = k < kend && n < N;
      const int64_t at = kBT ? n * ldb + k : k * ldb + n;
      tf32::cp_async16(bs + r * T::kSB + c, ok ? b + at : b, ok);
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
    const float* as = smem + (kt % kStages) * T::kStageFloats;
    const float* bs = as + T::kAFloats;

    float part[kMB][kNB][4];
#pragma unroll
    for (int i = 0; i < kMB; ++i) fmma::zero(part[i]);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      float a_big[kMB][4], a_small[kMB][4], b_big[kNB][2], b_small[kNB][2];
#pragma unroll
      for (int i = 0; i < kMB; ++i) {
        // a = {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]} of the
        // 16 x 8 block.
        float x[4];
        const int m = wm + i * 16;
        if (kAT) {
          const float* p = as + (kk + t) * T::kSA + m + g;
          x[0] = p[0];
          x[1] = p[8];
          x[2] = p[4 * T::kSA];
          x[3] = p[4 * T::kSA + 8];
        } else {  // lane l gives row l % 16, column 4 (l / 16) of the block
          tf32::ldmatrix_x4(x, as + (m + lane % 16) * T::kSA + kk + (lane / 16) * 4);
        }
        fmma::split(x, a_big[i], a_small[i]);
      }
      if (kBT) {
        // Two n-blocks an ldmatrix: lane l gives row l % 8 of n-block
        // j + l / 16, column 4 ((l / 8) % 2); b_j = {r[0], r[1]}, b_j+1 =
        // {r[2], r[3]}.
#pragma unroll
        for (int j = 0; j < kNB; j += 2) {
          float y[4];
          tf32::ldmatrix_x4(y, bs + (wn + (j + lane / 16) * 8 + lane % 8) * T::kSB + kk +
                                   ((lane / 8) % 2) * 4);
          const float y0[2] = {y[0], y[1]}, y1[2] = {y[2], y[3]};
          fmma::split(y0, b_big[j], b_small[j]);
          fmma::split(y1, b_big[j + 1], b_small[j + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          const float y[2] = {bs[(kk + t) * T::kSB + wn + j * 8 + g],
                              bs[(kk + t + 4) * T::kSB + wn + j * 8 + g]};
          fmma::split(y, b_big[j], b_small[j]);
        }
      }
      // fmma::mma3's three sweeps, over every (A, B) pair of the warp.
#pragma unroll
      for (int i = 0; i < kMB; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) tf32::mma(part[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < kMB; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) tf32::mma(part[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < kMB; ++i)
#pragma unroll
        for (int j = 0; j < kNB; ++j) tf32::mma(part[i][j], a_big[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < kMB; ++i) fmma::tile_sum(acc[i], part[i]);
  }

#pragma unroll
  for (int i = 0; i < kMB; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if (n >= N) continue;  // N % 4 == 0: n + 1 < N too
        epi(m, n, make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]), blockIdx.z);
      }
    }
  }
}

inline bool aligned16(const float* p, int64_t ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

// Launches the product over `parts` parts of K of k_split each (blockIdx.z;
// the last may be shorter) on `stream`; returns the launch's error.
template <int BM, int BN, bool kAT, bool kBT, class Epi>
cudaError_t gemm_parts(const float* a, int64_t lda, const float* b, int64_t ldb, int M,
                       int N, int K, int parts, int k_split, Epi epi, cudaStream_t stream) {
  using T = Tiling<BM, BN, kAT, kBT>;
  const bool k_chunks = !kAT || kBT;  // some operand is copied 4 k at a time
  if (M <= 0 || N <= 0 || K <= 0 || parts <= 0 || k_split <= 0 || k_split % kBK != 0 ||
      N % 4 != 0 || (kAT && M % 4 != 0) || (k_chunks && K % 4 != 0))
    return cudaErrorInvalidValue;
  if (!aligned16(a, lda) || !aligned16(b, ldb)) return cudaErrorMisalignedAddress;
  auto kernel = gemm_kernel<BM, BN, kAT, kBT, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, parts);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(a, lda, b, ldb, M, N, K, k_split, epi);
  return cudaGetLastError();
}

// out = a b + bias on `stream`, a (M, K), b (K, N), bias (N,) and out
// (M, N) row-major and contiguous; returns the launch's error.
template <int BM = 128, int BN = 64>
cudaError_t gemm(const float* a, const float* b, const float* bias, float* out, int M,
                 int N, int K, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(bias) % 8 || reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorMisalignedAddress;
  const int k_split = (K + kBK - 1) / kBK * kBK;
  return gemm_parts<BM, BN, false, false>(a, K, b, N, M, N, K, 1, k_split,
                                          BiasStore{bias, out, N}, stream);
}

}  // namespace gemm3
