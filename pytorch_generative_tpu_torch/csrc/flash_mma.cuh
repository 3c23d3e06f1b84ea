// Building blocks of the tensor-core flash kernels: the d_k == d_v
// instances of flash_fwd.cu and of both passes of flash_bwd.cu.
//
// Every tile product runs on the tensor cores as mma.sync m16n8k8 with TF32
// operands and f32 accumulators, to about f32 accuracy by 3xTF32: each f32
// operand x is split into big = tf32(x) and small = x - big, and a b is
// summed as small_a big_b + big_a small_b + big_a big_b (the small_a
// small_b term, 2^-22 of the product, is dropped). One warp owns 16 rows of
// a product; its A fragments are split once and reused across every n-block
// of the tile, so shared memory is read once per fragment and not once per
// FMA. Operand tiles reach shared memory by 16-byte cp.async, rows padded to
// D + 4 floats, which makes every fragment load below free of bank
// conflicts (the 8 x 4 lanes of a fragment hit 32 distinct banks); the
// fragments of B = X^T come two at a time by ldmatrix (2-5% faster on an
// H100 than four 32-bit loads, the same bits).
//
// An accumulator block (rows g, g + 8; columns 2t, 2t + 1) does not have
// the layout of an A fragment (columns t, t + 4). Rather than move values
// between lanes, the products that take an accumulator as A (P V, dS K,
// P^T dO, dS^T Q) read their B rows in the accumulator's column order:
// k-index t of the mma stands for column 2t and t + 4 for 2t + 1. A sum over
// k is the same sum in another order.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace fmma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 16;                // one mma's M: rows (or keys) a warp owns
constexpr int kBlock = kWarps * kWarpRows;   // rows (or keys) a CTA owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row stride, in floats, of a shared tile of D features.
template <int D>
__host__ __device__ constexpr int stride() {
  return D + 4;
}

// Whether 16-byte copies can stage a packed operand: its start 16-byte
// aligned, its (batch, row) strides multiples of 4 floats.
inline bool aligned(const float* p, int64_t bs, int64_t rs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && bs % 4 == 0 && rs % 4 == 0;
}

// Tiling of the three kernels by head width D: keys a forward tile, keys
// (dq pass) or query rows (dk/dv pass) a backward tile, stages of the
// backward's cp.async ring, CTAs an SM (__launch_bounds__) and accumulator
// blocks an mma3 sweep takes. Chosen by timing variants in one call at
// ImageGPT's shapes on an H100 (tools/torch_flash_times.py, PERF.md section
// 6): 32-wide streamed tiles keep the S / dP fragments, and so the
// registers, small enough for two or three CTAs an SM; at d = 128 the
// backward's ring has one stage and a second CTA on the SM covers the
// copies; wider sweeps hide the mma latency where the registers allow.
template <int D>
__host__ __device__ constexpr int fwd_cols() {
  return D <= 32 ? 64 : 32;
}
template <int D>
__host__ __device__ constexpr int bwd_stages() {
  return D <= 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int bwd_ctas() {
  return D <= 64 ? 3 : 2;
}
template <int D>
__host__ __device__ constexpr int fwd_group() {
  return D <= 64 ? 8 : 4;
}
constexpr int kBwdCols = 32, kBwdGroup = 4, kFwdCtas = 2;

// Starts copies of rows [row0, row0 + R) of one head (D features, at
// feature offset h * D) of a packed operand into a shared tile of stride
// stride<D>(); rows past L become 0.
template <int R, int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t bs,
                                      int64_t rs, int b, int h, int row0, int L) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int row = row0 + r;
    const bool ok = row < L;
    tf32::cp_async16(dst + r * stride<D>() + c,
                     ok ? src + b * bs + row * rs + h * D + c : src, ok);
  }
}

// The A fragment of the 16 x 8 block at x (rows of stride S).
template <int S>
__device__ __forceinline__ void load_a(float (&a)[4], const float* x, int g, int t) {
  a[0] = x[g * S + t];
  a[1] = x[(g + 8) * S + t];
  a[2] = x[g * S + t + 4];
  a[3] = x[(g + 8) * S + t + 4];
}

// The B fragments of B = X^T (B[k][n] = X[n][k]) for the 8 x 8 block of X
// at x and the one 8 rows below it, by one ldmatrix.
template <int S>
__device__ __forceinline__ void load_bt2(float (&b0)[2], float (&b1)[2], const float* x,
                                         int lane) {
  const int m = lane / 8, r = lane % 8;
  float v[4];
  tf32::ldmatrix_x4(v, x + ((m / 2) * 8 + r) * S + (m % 2) * 4);
  b0[0] = v[0];
  b0[1] = v[1];
  b1[0] = v[2];
  b1[1] = v[3];
}

// The B fragment of B = X for the 8 x 8 block of X at x, its rows in an
// accumulator's column order (k-index t is row 2t, t + 4 is row 2t + 1).
template <int S>
__device__ __forceinline__ void load_bp(float (&b)[2], const float* x, int g, int t) {
  b[0] = x[2 * t * S + g];
  b[1] = x[(2 * t + 1) * S + g];
}

// An accumulator block as the A fragment that pairs with load_bp.
__device__ __forceinline__ void a_from_acc(float (&a)[4], const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// x = big + small: big = x rounded to TF32, small = x - big (exact in f32).
// small is not rounded again: the mma reads its top 19 bits, which cuts
// |small| (under 2^-11 |x|) to 10 mantissa bits, an error under 2^-21 |x|
// of either sign. On an H100 that was as accurate as rounding small to
// TF32 first (the flash kernels' largest errors against their plain
// versions at L = 784 moved by under 10%) and 6-12% faster.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], float (&big)[N],
                                      float (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = tf32::round(x[i]);
    small[i] = x[i] - big[i];
  }
}

// Blocks of N that an mma3 sweep takes at once: at most G.
template <int N, int G>
__host__ __device__ constexpr int group() {
  return N < G ? N : G;
}

// acc[n] += a b[n] for n < N, to about f32 accuracy: a given split, each b
// split here. The three products run as three sweeps over the N blocks, so
// that an mma never waits on the one before it.
template <int N>
__device__ __forceinline__ void mma3(float (*acc)[4], const float (&a_big)[4],
                                     const float (&a_small)[4], const float (&b)[N][2]) {
  float b_big[N][2], b_small[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) split(b[n], b_big[n], b_small[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma(acc[n], a_small, b_big[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma(acc[n], a_big, b_small[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma(acc[n], a_big, b_big[n]);
}

// acc[n] += part[n] for n < N by f32 adds, which round to nearest. The
// tensor cores' f32 sums round toward zero, so an accumulator that every
// tile's mma adds into drifts by up to an ulp an mma, all one way (dV at
// d = 64, L = 784 took 7e-5 so on an H100); a tile's products are summed in
// fresh accumulators and brought in here.
template <int N>
__device__ __forceinline__ void tile_sum(float (*acc)[4], const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// How many of a tile's NB 8-wide column blocks hold a column <= last (the
// rest are wholly masked).
template <int NB>
__device__ __forceinline__ int blocks_through(int last) {
  return last < 0 ? 0 : min(NB, last / 8 + 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
  }
}

// Stores row `row` (accumulator half i: rows g or g + 8) of N accumulator
// blocks, times mul, to dst (the row's first feature): 8 features a block,
// two a lane.
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[N][4], int i,
                                          int t, float mul) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    *reinterpret_cast<float2*>(dst + n * 8 + 2 * t) =
        make_float2(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

}  // namespace fmma
