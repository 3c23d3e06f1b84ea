// Causal flash-attention backward over packed float32 tensors: q, k, dq and
// dk (B, L, H*d_k), v, out, dout and dv (B, L, H*d_v).
//
// Replaces pytorch_generative_tpu/ops/attention_pallas.py::_bwd_fused_kernel
// (launched by _flash_backward, the custom_vjp backward of
// causal_attention_packed). Same contract: heads are cut out of the packed
// feature axis by offsets, p is rebuilt from the forward's natural-log lse in
// base 2 (scale*log2(e) folded in), `mask_center` shifts the diagonal by
// one, fully-masked rows (lse = -inf: row 0 under `mask_center`) get p = 0
// and so an exactly-zero dq and no NaN, delta = rowsum(dO * O) per head is
// computed in the kernel, and
//   dv = p^T dO,  ds = p * (dO v^T - delta),  dq = ds k * scale,
//   dk = ds^T q * scale.
// The ragged last tile (L % 64 != 0) is masked in the kernel; dq, dk and dv
// come out in f32.
//
// Why two passes where the TPU kernel takes one: the TPU kernel runs one
// grid step per k-tile in order and keeps the whole dq of a sequence in one
// VMEM tile that every step revisits and adds to. On Hopper the blocks of a
// grid run in no order, so that carry does not exist; a fused pass would add
// dq across k-tiles by atomics (not run to run the same bits) or into one
// partial dq per k-tile (13 of them at L = 784: 1.3 GB written and read back
// at d = 64). So a dq pass, one CTA per (q-tile, head, batch), loops over
// the k-tiles up to the diagonal, computes delta for its rows and stores it;
// then a dk/dv pass, one CTA per (k-tile, head, batch), loops over the
// q-tiles from the diagonal on. Both rebuild p: 7 tile products where a
// fused pass needs 5. Every output element is summed by one thread in a
// fixed order, so two calls give the same bits (no atomics).
//
// What bounds it on an H100: ~10 d FLOPs per causal (query, key) pair and
// head (5 products), 101 GFLOP at ImageGPT's C = 512 (B 64, L 784, 8 heads
// of 64), against 0.2 GB of operands: operations, not device memory. The
// SIMT kernels this file used to run for d_k == d_v reached 5-11% of the
// CUDA cores' 67 TFLOP/s, paced by one shared-memory load per FMA.
//
// d_k == d_v (16, 32, 64, 128: ImageGPT's heads) runs on the tensor cores
// (flash_mma.cuh): every product, S = Q K^T, dP = dO V^T, dV += P^T dO, dQ +=
// dS K and dK += dS^T Q, by 3xTF32 mma.sync (about f32's accuracy at 495 / 3
// = 165 TFLOP/s); exp2, delta and the masks stay f32 on the CUDA cores, on
// the accumulator fragments. A warp owns 16 rows (dq pass) or 16 keys (dk/dv
// pass). The CTA's own 64 rows of q and dO (keys of k and v) stay in shared
// memory and are read as A fragments once per tile and 8-feature step; the
// streamed tiles of 32 keys (or rows, with their lse and delta) arrive by
// cp.async in a two-stage ring (one stage at d = 128, where a second CTA on
// the SM takes its place). The backward needs no row reduction, so the dq
// pass computes dS straight from the S and dP fragments and feeds it, in
// registers, to dQ += dS K; the dk/dv pass computes S^T and dP^T (keys as
// rows) and feeds P^T and dS^T to dV and dK the same way. Each tile's share
// of dQ, dK and dV is summed in fresh accumulators and added in f32, since
// the tensor cores' own sums round toward zero (flash_mma.cuh, tile_sum).
// Tiles wholly below the diagonal take no mask; a warp skips the column
// groups of the diagonal tile that it does not see.
//
// flash_bwd_bf16 takes bf16 operands and outputs (lse and delta f32) for
// d_k == d_v: two passes of warpgroup wgmma products fed by TMA
// (fwg::launch_bwd, flash_wgmma_bf16.cuh), at the TPU kernel's rounding
// points for bf16.
//
// (d_k, d_v) = (4, 32) and (4, 8) (PixelSNAIL) run on the tensor cores too:
// in f32 by 3xTF32 mma.sync with the m16n8k4 product, whose depth is d_k,
// for S and S^T and N = d_k zero-padded to 8 for dQ and dK
// (flash_bwd_mma_small.cuh); in bf16 (flash_bwd_bf16) by bf16 mma.sync, d_k
// zero-padded to the m16n8k8 product's depth (flash_bwd_mma_bf16.cuh). Both
// take any view with unit feature stride and choose each operand's load
// width by its alignment.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_bwd_mma_bf16.cuh"
#include "flash_bwd_mma_small.cuh"
#include "flash_mma.cuh"
#include "flash_wgmma_bf16.cuh"

namespace {

// dq pass: one CTA per (64-row q-tile, head, batch); warp w owns rows
// 16w..16w+15 of the tile. Writes dq and the tile's delta.
template <int D>
__global__ void __launch_bounds__(fmma::kThreads, fmma::bwd_ctas<D>())
flash_bwd_dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ out,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ delta, int L, int H, int64_t q_bs,
                        int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                        int64_t v_rs, int64_t o_bs, int64_t o_rs, int64_t do_bs,
                        int64_t do_rs, float scale, int offset) {
  using namespace fmma;
  constexpr int S = stride<D>();
  constexpr int NK = kBwdCols;             // keys a tile
  constexpr int STAGES = bwd_stages<D>();
  constexpr int KD = D / 8;                // 8-feature blocks
  constexpr int NB = NK / 8;               // 8-key blocks of a tile
  constexpr int GN = group<NB, kBwdGroup>();  // blocks an mma3 sweep takes
  constexpr int GD = group<KD, kBwdGroup>();
  extern __shared__ float smem[];
  float* qs = smem;                        // kBlock x S: the tile's q rows
  float* dos = qs + kBlock * S;            // kBlock x S: their dO rows
  float* lse_s = dos + kBlock * S;         // kBlock: lse * log2(e), +inf if p = 0
  float* delta_s = lse_s + kBlock;         // kBlock
  float* ring = delta_s + kBlock;          // STAGES x [K | V], NK x S each

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = qt * kBlock + warp * kWarpRows;  // the warp's first row
  const int rows[2] = {r0 + g, r0 + g + 8};       // this lane's rows
  const float scale_log2 = scale * kLog2e;

  const int n_tiles = (min(L, (qt + 1) * kBlock) + NK - 1) / NK;
  auto fetch = [&](int kt) {
    float* ks = ring + (kt % STAGES) * 2 * NK * S;
    stage<NK, D>(ks, k, k_bs, k_rs, b, h, kt * NK, L);
    stage<NK, D>(ks + NK * S, v, v_bs, v_rs, b, h, kt * NK, L);
  };
  stage<kBlock, D>(qs, q, q_bs, q_rs, b, h, qt * kBlock, L);
  stage<kBlock, D>(dos, dout, do_bs, do_rs, b, h, qt * kBlock, L);
  fetch(0);
  tf32::cp_async_commit();

  // delta = dO . O for the tile's rows, two threads a row, from global
  // memory; lse in base 2, +inf (p = 0) past L and on fully-masked rows.
  {
    const int rr = threadIdx.x / 2, half = threadIdx.x % 2;
    const int row = qt * kBlock + rr;
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
    float dlt = 0.f;
    if (row < L) {
      const float4* dp = reinterpret_cast<const float4*>(
          dout + b * do_bs + row * do_rs + h * D + half * (D / 2));
      const float* op = out + b * o_bs + row * o_rs + h * D + half * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 x = dp[i];
        dlt += x.x * op[4 * i] + x.y * op[4 * i + 1] + x.z * op[4 * i + 2] +
               x.w * op[4 * i + 3];
      }
    }
    dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
    if (half == 0) {
      delta_s[rr] = dlt;
      if (row < L) delta[stat] = dlt;
    } else {
      const float l2 = row < L ? lse[stat] : -CUDART_INF_F;
      lse_s[rr] = isinf(l2) ? CUDART_INF_F : l2 * kLog2e;
    }
  }

  __syncthreads();  // lse_s and delta_s are written
  float lse2[2], dlt[2];  // this lane's rows'
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[warp * kWarpRows + g + 8 * i];
    dlt[i] = delta_s[warp * kWarpRows + g + 8 * i];
  }

  float dqa[KD][4];
  zero(dqa);
  for (int kt = 0; kt < n_tiles; ++kt) {
    if constexpr (STAGES == 2) {
      if (kt + 1 < n_tiles) fetch(kt + 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();  // q, dO and tile kt have landed
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = ring + (kt % STAGES) * 2 * NK * S;
    const float* vs = ks + NK * S;
    const int key0 = kt * NK;
    const int live = blocks_through<NB>(r0 + kWarpRows - 1 - offset - key0);

    // S = Q K^T and dP = dO V^T.
    float s[NB][4], dp[NB][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      float a[4], q_big[4], q_small[4], do_big[4], do_small[4];
      load_a<S>(a, qs + warp * kWarpRows * S + kk * 8, g, t);
      split(a, q_big, q_small);
      load_a<S>(a, dos + warp * kWarpRows * S + kk * 8, g, t);
      split(a, do_big, do_small);
#pragma unroll
      for (int n0 = 0; n0 < NB; n0 += GN) {
        if (n0 < live) {
          float bf[GN][2];
#pragma unroll
          for (int n = 0; n < GN; n += 2)
            load_bt2<S>(bf[n], bf[n + 1], ks + (n0 + n) * 8 * S + kk * 8, lane);
          mma3(s + n0, q_big, q_small, bf);
#pragma unroll
          for (int n = 0; n < GN; n += 2)
            load_bt2<S>(bf[n], bf[n + 1], vs + (n0 + n) * 8 * S + kk * 8, lane);
          mma3(dp + n0, do_big, do_small, bf);
        }
      }
    }

    // dS = P (dP - delta), in place of S.
    const bool diag = key0 + NK - 1 + offset > r0;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * scale_log2 - lse2[e / 2]);
        if (diag && key0 + n * 8 + 2 * t + e % 2 + offset > rows[e / 2]) p = 0.f;
        s[n][e] = p * (dp[n][e] - dlt[e / 2]);
      }
    }

    // dQ += dS K, the tile's sum in fresh accumulators (see tile_sum).
#pragma unroll
    for (int n0 = 0; n0 < KD; n0 += GD) {
      float part[GD][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < live) {
          float a[4], ds_big[4], ds_small[4], bk[GD][2];
          a_from_acc(a, s[j]);
          split(a, ds_big, ds_small);
#pragma unroll
          for (int n = 0; n < GD; ++n)
            load_bp<S>(bk[n], ks + j * 8 * S + (n0 + n) * 8, g, t);
          mma3(part, ds_big, ds_small, bk);
        }
      }
      tile_sum(dqa + n0, part);
    }
    __syncthreads();  // every reader of this stage is done before it refills
    if constexpr (STAGES == 1) {
      if (kt + 1 < n_tiles) {
        fetch(kt + 1);
        tf32::cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] < L)
      store_row(dq + (static_cast<int64_t>(b) * L + rows[i]) * H * D + h * D, dqa, i, t,
                scale);
  }
}

// dk/dv pass: one CTA per (64-key k-tile, head, batch); warp w owns keys
// 16w..16w+15 of the tile. Reads the dq pass's delta.
template <int D>
__global__ void __launch_bounds__(fmma::kThreads, fmma::bwd_ctas<D>())
flash_bwd_dkdv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int L, int H, int64_t q_bs,
                          int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                          int64_t v_rs, int64_t do_bs, int64_t do_rs, float scale,
                          int offset) {
  using namespace fmma;
  constexpr int S = stride<D>();
  constexpr int NQ = kBwdCols;             // query rows a tile
  constexpr int STAGES = bwd_stages<D>();
  constexpr int KD = D / 8;                // 8-feature blocks
  constexpr int NB = NQ / 8;               // 8-row blocks of a tile
  constexpr int GN = group<NB, kBwdGroup>();  // blocks an mma3 sweep takes
  constexpr int GD = group<KD, kBwdGroup>();
  constexpr int kStage = 2 * NQ * S + 2 * NQ;
  extern __shared__ float smem[];
  float* ks = smem;                        // kBlock x S: the tile's k rows
  float* vs = ks + kBlock * S;             // kBlock x S: their v rows
  float* ring = vs + kBlock * S;           // STAGES x [Q | dO | lse2 | delta]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = kt * kBlock + warp * kWarpRows;  // the warp's first key
  const int keys[2] = {c0 + g, c0 + g + 8};       // this lane's keys
  const float scale_log2 = scale * kLog2e;

  // q-tiles before this k-tile hold no row that sees its keys.
  const int first = kt * kBlock / NQ, n_q = (L + NQ - 1) / NQ;
  auto fetch = [&](int qi) {
    float* st = ring + ((qi - first) % STAGES) * kStage;
    stage<NQ, D>(st, q, q_bs, q_rs, b, h, qi * NQ, L);
    stage<NQ, D>(st + NQ * S, dout, do_bs, do_rs, b, h, qi * NQ, L);
    if (threadIdx.x < NQ) {  // lse in base 2, +inf (p = 0) past L and on masked rows
      const int row = qi * NQ + threadIdx.x;
      const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
      const float l2 = row < L ? lse[stat] : -CUDART_INF_F;
      st[2 * NQ * S + threadIdx.x] = isinf(l2) ? CUDART_INF_F : l2 * kLog2e;
      st[2 * NQ * S + NQ + threadIdx.x] = row < L ? delta[stat] : 0.f;
    }
  };
  stage<kBlock, D>(ks, k, k_bs, k_rs, b, h, kt * kBlock, L);
  stage<kBlock, D>(vs, v, v_bs, v_rs, b, h, kt * kBlock, L);
  fetch(first);
  tf32::cp_async_commit();

  float dka[KD][4], dva[KD][4];
  zero(dka);
  zero(dva);
  for (int qi = first; qi < n_q; ++qi) {
    if constexpr (STAGES == 2) {
      if (qi + 1 < n_q) fetch(qi + 1);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();  // k, v and tile qi have landed
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = ring + ((qi - first) % STAGES) * kStage;
    const float* dos = qs + NQ * S;
    const float* lse_s = dos + NQ * S;
    const float* delta_s = lse_s + NQ;
    const int row0 = qi * NQ;
    // 8-row blocks wholly above the warp's first key + offset see none of it.
    const int skip = min(NB, max(0, c0 + offset - row0) / 8);

    // S^T = K Q^T and dP^T = V dO^T, keys as rows.
    float st[NB][4], dpt[NB][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      float a[4], k_big[4], k_small[4], v_big[4], v_small[4];
      load_a<S>(a, ks + warp * kWarpRows * S + kk * 8, g, t);
      split(a, k_big, k_small);
      load_a<S>(a, vs + warp * kWarpRows * S + kk * 8, g, t);
      split(a, v_big, v_small);
#pragma unroll
      for (int n0 = 0; n0 < NB; n0 += GN) {
        if (n0 + GN > skip) {
          float bf[GN][2];
#pragma unroll
          for (int n = 0; n < GN; n += 2)
            load_bt2<S>(bf[n], bf[n + 1], qs + (n0 + n) * 8 * S + kk * 8, lane);
          mma3(st + n0, k_big, k_small, bf);
#pragma unroll
          for (int n = 0; n < GN; n += 2)
            load_bt2<S>(bf[n], bf[n + 1], dos + (n0 + n) * 8 * S + kk * 8, lane);
          mma3(dpt + n0, v_big, v_small, bf);
        }
      }
    }

    // P^T in place of S^T, dS^T = P^T (dP^T - delta) in place of dP^T.
    const bool diag = c0 + kWarpRows - 1 + offset > row0;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * t + e % 2;
        float p = exp2f(st[n][e] * scale_log2 - lse_s[r]);
        if (diag && keys[e / 2] + offset > row0 + r) p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - delta_s[r]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the tile's sums in fresh accumulators
    // (see tile_sum).
#pragma unroll
    for (int n0 = 0; n0 < KD; n0 += GD) {
      float dv_part[GD][4], dk_part[GD][4];
      zero(dv_part);
      zero(dk_part);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= skip) {
          float a[4], a_big[4], a_small[4], bf[GD][2];
          a_from_acc(a, st[j]);
          split(a, a_big, a_small);
#pragma unroll
          for (int n = 0; n < GD; ++n)
            load_bp<S>(bf[n], dos + j * 8 * S + (n0 + n) * 8, g, t);
          mma3(dv_part, a_big, a_small, bf);
          a_from_acc(a, dpt[j]);
          split(a, a_big, a_small);
#pragma unroll
          for (int n = 0; n < GD; ++n)
            load_bp<S>(bf[n], qs + j * 8 * S + (n0 + n) * 8, g, t);
          mma3(dk_part, a_big, a_small, bf);
        }
      }
      tile_sum(dva + n0, dv_part);
      tile_sum(dka + n0, dk_part);
    }
    __syncthreads();  // every reader of this stage is done before it refills
    if constexpr (STAGES == 1) {
      if (qi + 1 < n_q) {
        fetch(qi + 1);
        tf32::cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] < L) {
      const int64_t row = static_cast<int64_t>(b) * L + keys[i];
      store_row(dk + row * H * D + h * D, dka, i, t, scale);
      store_row(dv + row * H * D + h * D, dva, i, t, 1.f);
    }
  }
}

template <int D>
cudaError_t launch_mma(const float* q, const float* k, const float* v,
                       const float* out, const float* dout, const float* lse,
                       float* dq, float* dk, float* dv, float* delta, int B, int L,
                       int H, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                       int64_t k_rs, int64_t v_bs, int64_t v_rs, int64_t o_bs,
                       int64_t o_rs, int64_t do_bs, int64_t do_rs, int mask_center,
                       cudaStream_t stream) {
  using namespace fmma;
  if (!aligned(q, q_bs, q_rs) || !aligned(k, k_bs, k_rs) || !aligned(v, v_bs, v_rs) ||
      !aligned(out, o_bs, o_rs) || !aligned(dout, do_bs, do_rs))
    return cudaErrorMisalignedAddress;
  constexpr int S = stride<D>(), NC = kBwdCols;
  const size_t smem_dq =
      sizeof(float) * (2 * kBlock * S + 2 * kBlock + bwd_stages<D>() * 2 * NC * S);
  const size_t smem_kv =
      sizeof(float) * (2 * kBlock * S + bwd_stages<D>() * (2 * NC * S + 2 * NC));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const int offset = mask_center ? 1 : 0;
  // Same stream: the dk/dv pass reads the delta that the dq pass stores.
  flash_bwd_dq_mma_kernel<D><<<grid, kThreads, smem_dq, stream>>>(
      q, k, v, out, dout, lse, dq, delta, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
      o_bs, o_rs, do_bs, do_rs, scale, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma_kernel<D><<<grid, kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
      do_bs, do_rs, scale, offset);
  return cudaGetLastError();
}

}  // namespace

// q, k: f32 (B, L, H*d_k); v, out, dout: f32 (B, L, H*d_v); each with unit
// stride over features and (batch, row) strides given in elements; for
// d_k == d_v each operand's start is 16-byte aligned and its strides
// multiples of 4. (d_k, d_v) is one of (16, 16), (32, 32), (64, 64),
// (128, 128), (4, 32), (4, 8) (any such view for the last two). lse:
// (B, H, L) natural log. dq, dk:
// contiguous (B, L, H*d_k); dv: contiguous (B, L, H*d_v); delta: (B, H, L)
// scratch.
extern "C" int flash_bwd_f32(const float* q, const float* k, const float* v,
                             const float* out, const float* dout,
                             const float* lse, float* dq, float* dk, float* dv,
                             float* delta, int B, int L, int H, int d_k,
                             int d_v, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                             int64_t k_rs, int64_t v_bs, int64_t v_rs,
                             int64_t o_bs, int64_t o_rs, int64_t do_bs,
                             int64_t do_rs, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_SMALL_CASE(DV)                                                     \
  if (d_k == fsmall::kDK && d_v == DV)                                               \
    return fsmall::launch<DV>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, L, H,   \
                              q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, \
                              do_rs, mask_center, s);
  FLASH_BWD_SMALL_CASE(32)
  FLASH_BWD_SMALL_CASE(8)
#undef FLASH_BWD_SMALL_CASE
#define FLASH_BWD_MMA_CASE(D)                                                    \
  if (d_k == D && d_v == D)                                                      \
    return launch_mma<D>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, L, H,    \
                         q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs,  \
                         do_rs, mask_center, s);
  FLASH_BWD_MMA_CASE(16)
  FLASH_BWD_MMA_CASE(32)
  FLASH_BWD_MMA_CASE(64)
  FLASH_BWD_MMA_CASE(128)
#undef FLASH_BWD_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_f32 for bf16 q, k, v, out, dout, dq, dk and dv (lse and
// delta f32): (d_k, d_v) = (4, 32) or (4, 8), any such view, on bf16
// mma.sync (flash_bwd_mma_bf16.cuh); or d_k == d_v, one of 16, 32, 64,
// 128, each operand's start 16-byte aligned and its (batch, row) strides
// multiples of 8 values.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const float* lse, void* dq, void* dk,
                              void* dv, float* delta, int B, int L, int H, int d_k, int d_v,
                              int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                              int64_t v_bs, int64_t v_rs, int64_t o_bs, int64_t o_rs,
                              int64_t do_bs, int64_t do_rs, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using P = const bf16::T*;
  using W = bf16::T*;
#define FLASH_BWD_SMALL_CASE(DV)                                                          \
  if (d_k == smma::kDK && d_v == DV)                                                      \
    return smma::launch<DV>(static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),       \
                            static_cast<P>(out), static_cast<P>(dout), lse,                \
                            static_cast<W>(dq), static_cast<W>(dk), static_cast<W>(dv),    \
                            delta, B, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, \
                            do_bs, do_rs, mask_center, fwg::scale_log2_of(smma::kDK), s);
  FLASH_BWD_SMALL_CASE(32)
  FLASH_BWD_SMALL_CASE(8)
#undef FLASH_BWD_SMALL_CASE
#define FLASH_BWD_BF16_CASE(D)                                                            \
  if (d_k == D && d_v == D)                                                               \
    return fwg::launch_bwd<D>(static_cast<P>(q), static_cast<P>(k), static_cast<P>(v),     \
                              static_cast<P>(out), static_cast<P>(dout), lse,              \
                              static_cast<W>(dq), static_cast<W>(dk), static_cast<W>(dv),  \
                              delta, B, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs,    \
                              o_rs, do_bs, do_rs, mask_center, s);
  FLASH_BWD_BF16_CASE(16)
  FLASH_BWD_BF16_CASE(32)
  FLASH_BWD_BF16_CASE(64)
  FLASH_BWD_BF16_CASE(128)
#undef FLASH_BWD_BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared-memory bytes of flash_bwd_bf16's CTAs at d_k == d_v == d: the dq
// pass's (pass 0) or the dk/dv pass's (pass 1); 0 for another d.
extern "C" int flash_bwd_bf16_smem(int d, int pass) {
#define FLASH_BWD_BF16_SMEM(D) \
  if (d == D) return pass == 0 ? fwg::Dq<D, fwg::groups<D>()>::kSmem \
                     : fwg::Dkdv<D, fwg::groups<D>()>::kSmem;
  FLASH_BWD_BF16_SMEM(16)
  FLASH_BWD_BF16_SMEM(32)
  FLASH_BWD_BF16_SMEM(64)
  FLASH_BWD_BF16_SMEM(128)
#undef FLASH_BWD_BF16_SMEM
  return 0;
}
