// PixelSNAIL's bf16 flash forward, (d_k, d_v) = (4, 32) and (4, 8), on bf16
// tensor cores (mma.sync with f32 sums): flash_fwd_bf16's pass for those
// pairs (flash_fwd.cu has the contract).
//
// Replaces, for those pairs and bf16 operands,
// pytorch_generative_tpu/ops/attention_pallas.py::_fwd_kernel at its
// rounding points for bf16 (attention_pallas.py:135-198): q2 = bf16(q scale
// log2 e) as it is staged, k unscaled; S = q2 k^T in f32; the online softmax
// in base 2 with f32 statistics; P rounded to bf16 for P V while the row
// sums take the f32 P; out = bf16(O / l) at its store, lse the natural log
// in f32. mask_center shifts the diagonal by one; a fully masked row (row 0
// under mask_center) gets out 0 and lse -inf.
//
// What bounds it on an H100: 2 (d_k + d_v) = 72 operations a causal (query,
// key) pair at (4, 32), 2.8 GFLOP a call at (B 128, L 784, H 1,
// mask_center), 3.1 once d_k is padded to the mma's depth (3 us at 989
// TFLOP/s), against ~15 MB of bf16 operands and outputs and f32 lse (4.4
// us at 3.35 TB/s): bytes bound it. On the tensor cores the products are
// small beside one exp2 a pair and each tile's latency: the SIMT pass this
// replaces did it all as f32 FMAs on the CUDA cores, two threads a row, at
// 1.8% of that bound.
//
// Design (the bf16 backward's tile plan, flash_bwd_mma_bf16.cuh, whose
// loaders and fragment helpers it shares). A CTA is 4 warps and owns 64
// query rows, 16 a warp, one mma's M; it walks the 64-key tiles up to the
// diagonal. A tile's keys (8 bytes a key) and its v transposed ([d][key],
// so that a B fragment is one 32-bit shared load) are loaded into
// registers while the tile before is computed, then staged:
//   S = q2 k^T   m16n8k8, A = the warp's q2 rows (registers, d_k
//                zero-padded to 8), B = k rows, 8 blocks of 8 keys;
//   the row max and sum over a row's 4 lanes (two xor-shuffles), alpha and
//   m_safe as flash_fwd.cuh's SIMT pass forms them;
//   O += P V     m16n8k16 over 16-key chunks, A = bf16(P) packed straight
//                from two 8-key S accumulators, B = v^T.
// Each tile's P V goes into fresh accumulators and is added in f32 to O
// rescaled by alpha (the tensor cores' sums round toward zero:
// flash_mma.cuh). Every output is one lane's in a fixed order: two calls
// give the same bits. An operand whose start and (batch, row) strides are
// 8-byte aligned is read 8 bytes a load, any other 2 bytes (smma::ld4).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_bwd_mma_bf16.cuh"

namespace smma {

// One key tile's k (one key a thread, for the first kBlock threads) and v
// (4 values at a time, kPer a thread) as loaded, before they are staged.
template <int DV>
struct FwdTile {
  static constexpr int kQuads = DV / 4;                   // 4-value pieces of a v row
  static constexpr int kPer = kBlock * kQuads / kThreads;  // of them a thread
  uint2 k, v[kPer];

  __device__ __forceinline__ void load(const Operand& ok, const Operand& ov, int b, int h,
                                       int key0, int L) {
    const int key = key0 + threadIdx.x;
    k = threadIdx.x < kBlock && key < L ? ld4<kDK>(ok, b, key, h, 0) : make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / kQuads;
      v[j] = key0 + r < L ? ld4<DV>(ov, b, key0 + r, h, 4 * (i % kQuads)) : make_uint2(0u, 0u);
    }
  }

  // k rows into k_s, v transposed into vt ([d][key], kTLd a row).
  __device__ __forceinline__ void put(uint2* k_s, unsigned short* vt) const {
    if (threadIdx.x < kBlock) k_s[threadIdx.x] = k;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / kQuads, d = 4 * (i % kQuads);
      put_t(vt, d, r, v[j].x);
      put_t(vt, d + 2, r, v[j].y);
    }
  }
};

// Forward: one CTA per (64-row q-tile, head, batch); warp w owns rows 16 w
// .. 16 w + 15 of the tile.
template <int DV>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Operand q, Operand k, Operand v, T* __restrict__ out, float* __restrict__ lse, int L,
           int H, float scale_log2, int offset) {
  constexpr int NB = kBlock / 8;  // 8-key blocks of a tile
  constexpr int ND = DV / 8;      // 8-feature blocks of O
  static_assert(kBlock * (DV / 4) % kThreads == 0, "whole v pieces a thread");
  __shared__ uint2 k_s[kBlock];
  __shared__ __align__(16) unsigned short vt_s[DV * kTLd];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {qt * kBlock + 16 * warp + g, qt * kBlock + 16 * warp + g + 8};

  uint32_t aq[2];  // q2 rows g, g + 8 (d_k zero-padded to 8)
  a_dk(aq, q, b, h, rows, L, t, scale_log2);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // l: the lane's columns
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  }
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  FwdTile<DV> tile;
  tile.load(k, v, b, h, 0, L);
  // 64 rows and keys a tile: the diagonal of q-tile qt is in key tile qt.
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every reader of the last tile is done
    tile.put(k_s, vt_s);
    __syncthreads();
    if (kt < qt) tile.load(k, v, b, h, (kt + 1) * kBlock, L);  // in flight while kt runs

    // S = q2 k^T; keys past the diagonal (and past L, which lie past it)
    // get -inf; the row max over the row's 4 lanes.
    float s[NB][4], mc[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int key = 8 * nb + g;  // this lane's column of the B fragment
      const uint32_t bk = t == 0 ? k_s[key].x : t == 1 ? k_s[key].y : 0u;
      mma_k8(s[nb], aq, bk, zero);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        if (kt == qt && kt * kBlock + 8 * nb + 2 * t + e % 2 + offset > rows[i])
          s[nb][e] = -CUDART_INF_F;
        mc[i] = fmaxf(mc[i], s[nb][e]);
      }
    }
    float ms[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float m_new = fmaxf(m[i], mc[i]);
      ms[i] = isinf(m_new) ? 0.f : m_new;
      alpha[i] = isinf(m[i]) ? 0.f : exp2f(m[i] - ms[i]);
      m[i] = m_new;
    }
    // P in place of S (masked: exp2(-inf) == 0); the lane's row sums.
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - ms[e / 2]);
        ps[e / 2] += s[nb][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + ps[i];

    // This tile's P V in fresh accumulators, then O = alpha O + it.
    float part[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
    }
#pragma unroll
    for (int ch = 0; ch < kBlock / kChunk; ++ch) {
      const float pc[2][4] = {{s[2 * ch][0], s[2 * ch][1], s[2 * ch][2], s[2 * ch][3]},
                              {s[2 * ch + 1][0], s[2 * ch + 1][1], s[2 * ch + 1][2],
                               s[2 * ch + 1][3]}};
      uint32_t ap[4];
      a_of(ap, pc);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bv[2];
        b_t(bv, vt_s, 8 * nd + g, kChunk * ch, t, DV);
        mma_k16(part[nd], ap, bv, part[nd]);
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = alpha[e / 2] * o[nd][e] + part[nd][e];
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= L) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* op = out + (static_cast<int64_t>(b) * L + rows[i]) * H * DV + h * DV + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(op + 8 * nd) =
          bf16::pack(o[nd][2 * i] / denom, o[nd][2 * i + 1] / denom);
    if (t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * L + rows[i]] =
          l[i] == 0.f ? -CUDART_INF_F : m[i] * kLn2 + logf(fmaxf(l[i], 1e-38f));
  }
}

// The forward on `stream`, d_k = 4 and d_v = DV (32 or 8); scale_log2 as the
// TPU kernel forms it (fwg::scale_log2_of). Returns the launch's error.
template <int DV>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, T* out, float* lse, int B, int L,
                       int H, int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                       int64_t v_bs, int64_t v_rs, int mask_center, float scale_log2,
                       cudaStream_t stream) {
  static_assert(DV % 8 == 0, "d_v: whole 8-feature blocks");
  const Operand oq{q, q_bs, q_rs, wide(q, q_bs, q_rs)};
  const Operand ok{k, k_bs, k_rs, wide(k, k_bs, k_rs)};
  const Operand ov{v, v_bs, v_rs, wide(v, v_bs, v_rs)};
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  fwd_kernel<DV><<<grid, kThreads, 0, stream>>>(oq, ok, ov, out, lse, L, H, scale_log2,
                                                mask_center ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace smma
