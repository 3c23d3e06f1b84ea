// A float32 matrix product with a bias on the tensor cores, to about f32's
// accuracy: out (M, N) = a (M, K) b (K, N) + bias (N), each row-major and
// contiguous. The fused attention block's three products (attn_block_fwd.cu)
// run on it.
//
// Every product runs as mma.sync m16n8k8 with TF32 operands by 3xTF32, as
// the flash kernels' (flash_mma.cuh): each f32 operand x is split into
// big = tf32(x) and small = x - big, and a b is summed as small_a big_b +
// big_a small_b + big_a big_b. The tensor cores' f32 sums round toward zero,
// so each k-step's products go into fresh accumulators, which are added
// into the running f32 sums by ordinary adds (fmma::tile_sum). Every output
// is summed by one warp in a fixed k order: two calls give the same bits.
//
// A CTA of BM / 64 x BN / 32 warps owns a BM x BN tile of out (128 x 64, 4
// warps, 2 CTAs an SM, by default); a warp a 64 x 32 block of it (4 x 4 mma
// blocks), so that each split A fragment is used 4 times and each split B
// fragment 4 times. The running sums and the fresh ones take 128 registers
// a thread, which rules out wider warp blocks. The K loop steps kBK at a
// time through a kStages-deep cp.async ring: the tiles of the next steps
// load while the current one is multiplied, with one barrier a step. Rows of
// the A tile are padded to kBK + 4 floats and those of the B tile to BN + 8,
// so that the A fragments (ldmatrix, 8 rows of 16 bytes a phase) and the B
// fragments (k = t, t + 4 and n = g of each lane) hit distinct banks. The
// bias is added in the epilogue, which writes two floats a lane.
//
// Tilings of 64 x 64 to 128 x 128, rings of 2 to 4 stages of k-steps of 16
// or 32, and a trial on Hopper's wgmma (tools/gemm_wgmma_trial.cuh) were
// timed on an H100 by tools/torch_gemm_variants.py (PERF.md section 6):
// this one was as fast as any at C = 512 (~57 TFLOP/s) and among the
// fastest at N = 64; the wgmma trial reached ~49-52.
//
// Bounds: the edges of M, N and K are masked (the copies read zeros past
// them). N and K must be multiples of 4, a and b must start 16-byte aligned
// (16-byte copies), bias and out 8-byte aligned. What bounds it on an H100:
// 2 M N K operations at the 3xTF32 rate, 495 / 3 = 165 TFLOP/s, against
// 4 (M K + K N + M N) bytes at 3.35 TB/s: operations at the block's shapes.

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
constexpr int kSA = kBK + 4;                         // A tile row stride

template <int BM, int BN>
struct Tiling {
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0, "whole warp blocks");
  static constexpr int kWarpsN = BN / kWarpN;
  static constexpr int kThreads = 32 * (BM / kWarpM) * kWarpsN;
  static constexpr int kSB = BN + 8;  // B tile row stride: 8 t + g spans 32 banks
  static constexpr int kStageFloats = BM * kSA + kBK * kSB;
  static constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
};

template <int BM, int BN>
__global__ void __launch_bounds__(Tiling<BM, BN>::kThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K) {
  using T = Tiling<BM, BN>;
  extern __shared__ float smem[];  // kStages slots of [A | B] tiles
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / T::kWarpsN) * kWarpM, wn = (warp % T::kWarpsN) * kWarpN;
  const int n_k = (K + kBK - 1) / kBK;

  // Starts the copies of k-step kt's A (BM x kBK) and B (kBK x BN) tiles
  // into ring slot kt % kStages.
  auto fetch = [&](int kt) {
    float* as = smem + (kt % kStages) * T::kStageFloats;
    float* bs = as + BM * kSA;
    const int k0 = kt * kBK;
    for (int i = threadIdx.x; i < BM * (kBK / 4); i += T::kThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      tf32::cp_async16(as + r * kSA + c,
                       ok ? a + static_cast<int64_t>(m0 + r) * K + k0 + c : a, ok);
    }
    for (int i = threadIdx.x; i < kBK * (BN / 4); i += T::kThreads) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = k0 + r < K && n0 + c < N;
      tf32::cp_async16(bs + r * T::kSB + c,
                       ok ? b + static_cast<int64_t>(k0 + r) * N + n0 + c : b, ok);
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
    const float* as = smem + (kt % kStages) * T::kStageFloats + wm * kSA;
    const float* bs = smem + (kt % kStages) * T::kStageFloats + BM * kSA + wn;

    float part[kMB][kNB][4];
#pragma unroll
    for (int i = 0; i < kMB; ++i) fmma::zero(part[i]);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      float a_big[kMB][4], a_small[kMB][4], b_big[kNB][2], b_small[kNB][2];
#pragma unroll
      for (int i = 0; i < kMB; ++i) {
        // Lane l gives row l % 16, column 4 (l / 16) of the 16 x 8 block.
        float x[4];
        tf32::ldmatrix_x4(x, as + (i * 16 + lane % 16) * kSA + kk + (lane / 16) * 4);
        fmma::split(x, a_big[i], a_small[i]);
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float y[2] = {bs[(kk + t) * T::kSB + j * 8 + g],
                            bs[(kk + t + 4) * T::kSB + j * 8 + g]};
        fmma::split(y, b_big[j], b_small[j]);
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
        const float2 bb = *reinterpret_cast<const float2*>(bias + n);
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(m) * N + n) =
            make_float2(acc[i][j][2 * h] + bb.x, acc[i][j][2 * h + 1] + bb.y);
      }
    }
  }
}

// Launches out = a b + bias on `stream`; returns the launch's error.
template <int BM = 128, int BN = 64>
cudaError_t gemm(const float* a, const float* b, const float* bias, float* out, int M,
                 int N, int K, cudaStream_t stream) {
  using T = Tiling<BM, BN>;
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 4 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 8 || reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<BM, BN><<<grid, T::kThreads, T::kSmemBytes, stream>>>(a, b, bias, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace gemm3
