// The causal flash-attention forward's SIMT tile pass over packed f32
// tensors, for flash_fwd_f32's d_k != d_v instances, (4, 32) and (4, 8)
// (PixelSNAIL; one CTA a (query tile, head, batch)). The d_k == d_v
// instances run on the tensor cores (flash_fwd_mma.cuh and, for bf16,
// flash_wgmma_bf16.cuh), as do the bf16 (4, 32) and (4, 8)
// (flash_fwd_small_bf16.cuh).
//
// tile<DK, DV> runs query tile qt of head h of batch row b with kThreads
// threads, two a query row: it stages the q tile through shared memory and
// keeps each row, pre-scaled into the base-2 domain, in registers; then for
// each key tile up to the diagonal it stages k and v through shared memory
// (coalesced over the packed row), rebuilds the scores, runs the online
// softmax in base 2 with f32 statistics and adds p v into the row's
// accumulators. Fully-masked rows (`offset` = 1, the mask_center shift, at
// row 0) give exactly 0 with lse = -inf; lse is stored as a natural log,
// (B, H, L). The ragged last tile (L % 64 != 0) is masked. Operands are
// read one value at a time, so any view with unit feature stride is taken
// (PixelSNAIL's k and v are column views of one kv tensor).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 2 * kBlockQ;  // two threads share one query row
constexpr int kHalfK = kBlockK / 2;    // keys per thread per tile
constexpr float kLn2 = 0.6931471805599453f;

// Floats of dynamic shared memory that the tile pass takes.
template <int DK, int DV>
constexpr int tile_smem_floats() {
  return kBlockK * (DK + 1) + kBlockK * DV + kBlockQ * (kBlockK + 1);
}

// q, k: rows of H * DK features, v and out: rows of H * DV, with the given
// (batch, row) strides in elements, unit stride over features; out is
// contiguous (B, L, H * DV).
template <int DK, int DV>
__device__ __forceinline__ void tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
    int L, int H, int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
    int64_t v_bs, int64_t v_rs, float scale_log2, int offset, float* smem, int qt,
    int h, int b) {
  static_assert(kBlockQ == kBlockK, "q is staged through the k tile");
  constexpr int DH = DV / 2;  // output features per thread
  float* ks = smem;                       // kBlockK x (DK + 1), padded rows
  float* vs = ks + kBlockK * (DK + 1);    // kBlockK x DV
  float* ps = vs + kBlockK * DV;          // kBlockQ x (kBlockK + 1)

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qrow = qt * kBlockQ + r;
  const bool row_ok = qrow < L;

  for (int idx = tid; idx < kBlockQ * DK; idx += kThreads) {
    const int rr = idx / DK, cc = idx % DK;
    const int row = qt * kBlockQ + rr;
    ks[rr * (DK + 1) + cc] =
        row < L ? q[b * q_bs + row * q_rs + h * DK + cc] * scale_log2 : 0.f;
  }
  __syncthreads();
  float qreg[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) qreg[d] = ks[r * (DK + 1) + d];

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  // kBlockQ == kBlockK, so the diagonal of query tile qt lies in key tile qt.
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every reader of the previous tile is done
    for (int idx = tid; idx < kBlockK * DK; idx += kThreads) {
      const int rr = idx / DK, cc = idx % DK;
      const int key = kt * kBlockK + rr;
      ks[rr * (DK + 1) + cc] =
          key < L ? k[b * k_bs + key * k_rs + h * DK + cc] : 0.f;
    }
    for (int idx = tid; idx < kBlockK * DV; idx += kThreads) {
      const int rr = idx / DV, cc = idx % DV;
      const int key = kt * kBlockK + rr;
      vs[rr * DV + cc] = key < L ? v[b * v_bs + key * v_rs + h * DV + cc] : 0.f;
    }
    __syncthreads();

    float s[kHalfK];
    float m_cur = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const int c = half * kHalfK + j;
      const int key = kt * kBlockK + c;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) dot += qreg[d] * ks[c * (DK + 1) + d];
      const bool ok = row_ok && key < L && key + offset <= qrow;
      s[j] = ok ? dot : -CUDART_INF_F;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m, m_cur);
    const float m_safe = isinf(m_new) ? 0.f : m_new;
    const float alpha = isinf(m) ? 0.f : exp2f(m - m_safe);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const float p = exp2f(s[j] - m_safe);  // masked: exp2(-inf) == 0
      p_sum += p;
      ps[r * (kBlockK + 1) + half * kHalfK + j] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();  // the row's two halves of p live in this warp

#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = ps[r * (kBlockK + 1) + c];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += p * vs[c * DV + half * DH + d];
    }
  }

  if (row_ok) {
    const float denom = l == 0.f ? 1.f : l;
    float* op = out + (static_cast<int64_t>(b) * L + qrow) * H * DV + h * DV + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = acc[d] / denom;
    if (half == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * L + qrow] =
          l == 0.f ? -CUDART_INF_F : m * kLn2 + logf(fmaxf(l, 1e-38f));
    }
  }
}

}  // namespace flash
