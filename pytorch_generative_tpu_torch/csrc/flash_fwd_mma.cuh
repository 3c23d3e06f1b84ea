// The tensor-core causal flash-attention forward for d_k == d_v = D over
// packed float32 tensors, shared by flash_fwd.cu (its d_k == d_v instances)
// and attn_block_fwd.cu (the fused attention block's tile pass, over its own
// q and [k | v] scratch). Contract as flash_fwd.cu's: heads cut out of the
// packed feature axis by offsets, the online softmax in base 2 with
// scale*log2(e) folded into q and f32 statistics, `mask_center` shifting the
// diagonal by one, fully-masked rows giving exactly 0 with lse = -inf, lse
// stored as a natural log, (B, H, L).
//
// Both products, S = Q K^T and O += P V, run by 3xTF32 mma.sync
// (flash_mma.cuh), about f32's accuracy at a third of the TF32 rate (495 / 3
// = 165 TFLOP/s). One CTA owns 64 query rows of one (head, batch), a warp 16
// of them, and keeps them in registers, scaled into the base-2 domain and
// split, as A fragments for the whole key loop. K and V tiles (64 keys at
// d <= 32, 32 above, which keeps the S fragments and so the registers small)
// stream through a two-stage cp.async ring, so the next tile loads while the
// current one is multiplied. The online softmax runs on the S fragments in
// registers (row max and sum across the four lanes of a row by shuffles),
// and P goes into P V from the same registers; each tile's P V is summed in
// fresh accumulators and added to O in f32, since the tensor cores' own sums
// round toward zero (flash_mma.cuh, tile_sum). Each 3xTF32 product runs as
// three sweeps over up to 8 independent accumulator blocks, so that no mma
// waits on the one before it. Key tiles wholly below the diagonal take no
// mask; in the diagonal tile a warp skips the key groups that none of its
// rows sees.

#pragma once

#include "flash_mma.cuh"

namespace fmma {

// One CTA per (64-row query tile, head, batch); warp w owns rows
// 16w..16w+15 of the tile.
template <int D>
__global__ void __launch_bounds__(fmma::kThreads, fmma::kFwdCtas)
flash_fwd_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int L, int H,
                     int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                     int64_t v_bs, int64_t v_rs, float scale_log2, int offset) {
  constexpr int S = stride<D>();
  constexpr int NK = fwd_cols<D>();  // keys a tile
  constexpr int KD = D / 8;           // 8-feature blocks
  constexpr int NB = NK / 8;          // 8-key blocks of a tile
  constexpr int GN = group<NB, fwd_group<D>()>();  // blocks an mma3 sweep takes
  constexpr int GD = group<KD, fwd_group<D>()>();
  extern __shared__ float smem[];     // two stages of [K | V], NK rows each

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = qt * kBlock + warp * kWarpRows;  // the warp's first row
  const int rows[2] = {r0 + g, r0 + g + 8};       // this lane's rows

  // Keys up to the tile's last row (or L): the causal loop's end.
  const int n_tiles = (min(L, (qt + 1) * kBlock) + NK - 1) / NK;
  auto fetch = [&](int kt) {
    float* ks = smem + (kt % 2) * 2 * NK * S;
    stage<NK, D>(ks, k, k_bs, k_rs, b, h, kt * NK, L);
    stage<NK, D>(ks + NK * S, v, v_bs, v_rs, b, h, kt * NK, L);
  };
  fetch(0);
  tf32::cp_async_commit();

  // The warp's rows of q, times scale * log2(e), as split A fragments.
  float q_big[KD][4], q_small[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e % 2];
      a[e] = row < L ? q[b * q_bs + row * q_rs + h * D + kk * 8 + t + 4 * (e / 2)] * scale_log2
                     : 0.f;
    }
    split(a, q_big[kk], q_small[kk]);
  }

  float o[KD][4];
  zero(o);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) fetch(kt + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const float* ks = smem + (kt % 2) * 2 * NK * S;
    const float* vs = ks + NK * S;
    const int key0 = kt * NK;
    const int live = blocks_through<NB>(r0 + kWarpRows - 1 - offset - key0);

    float s[NB][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < NB; n0 += GN) {
        if (n0 < live) {
          float bk[GN][2];
#pragma unroll
          for (int n = 0; n < GN; n += 2)
            load_bt2<S>(bk[n], bk[n + 1], ks + (n0 + n) * 8 * S + kk * 8, lane);
          mma3(s + n0, q_big[kk], q_small[kk], bk);
        }
      }
    }
    if (key0 + NK - 1 + offset > r0) {  // the tile reaches the warp's diagonal
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + n * 8 + 2 * t + e % 2 + offset > rows[e / 2]) s[n][e] = -CUDART_INF_F;
        }
      }
    }

    // Online softmax in base 2; a row masked so far keeps m = -inf, p = 0.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = isinf(mx[i]) ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - base[i]);  // 0 while m = -inf
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e / 2]);  // masked: exp2(-inf) == 0
        l[e / 2] += s[n][e];
      }
    }
    // O = alpha O + P V, P straight from the S fragments. The tile's P V
    // is summed in fresh accumulators, GD feature blocks at a time, and
    // added to O in f32 (see tile_sum).
#pragma unroll
    for (int n0 = 0; n0 < KD; n0 += GD) {
      float pv[GD][4];
      zero(pv);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < live) {
          float pa[4], p_big[4], p_small[4], bv[GD][2];
          a_from_acc(pa, s[j]);
          split(pa, p_big, p_small);
#pragma unroll
          for (int n = 0; n < GD; ++n)
            load_bp<S>(bv[n], vs + j * 8 * S + (n0 + n) * 8, g, t);
          mma3(pv, p_big, p_small, bv);
        }
      }
#pragma unroll
      for (int n = 0; n < GD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + n][e] = o[n0 + n][e] * alpha[e / 2] + pv[n][e];
      }
    }
    __syncthreads();  // every reader of this stage is done before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] < L) {
      const int64_t row = static_cast<int64_t>(b) * L + rows[i];
      store_row(out + row * H * D + h * D, o, i, t, 1.f / (l[i] == 0.f ? 1.f : l[i]));
      if (t == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * L + rows[i]] =
            l[i] == 0.f ? -CUDART_INF_F : m[i] * kLn2 + logf(fmaxf(l[i], 1e-38f));
      }
    }
  }
}

template <int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* out,
                       float* lse, int B, int L, int H, int64_t q_bs, int64_t q_rs,
                       int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                       int mask_center, cudaStream_t stream) {
  if (!aligned(q, q_bs, q_rs) || !aligned(k, k_bs, k_rs) || !aligned(v, v_bs, v_rs))
    return cudaErrorMisalignedAddress;
  const size_t smem = sizeof(float) * 2 * 2 * fwd_cols<D>() * stride<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale_log2,
      mask_center ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace fmma
