// PixelSNAIL's f32 flash backward, (d_k, d_v) = (4, 32) and (4, 8), on the
// tensor cores by 3xTF32 mma.sync: flash_bwd_f32's dq pass and dk/dv pass
// for those pairs (flash_bwd.cu has the contract and why there are two
// passes).
//
// Replaces, for those pairs,
// pytorch_generative_tpu/ops/attention_pallas.py::_bwd_fused_kernel in f32:
// p = exp2(S scale log2 e - lse log2 e), delta = rowsum(dO O), dS = p (dP -
// delta), dq = dS k scale, dk = dS^T q scale, dv = p^T dO; exp2, delta,
// the masks and lse stay f32 on the accumulator fragments, every product
// is 3xTF32 (flash_mma.cuh: a and b split into big + small, about f32's
// accuracy). mask_center shifts the diagonal by one; a fully masked row
// (lse = -inf: row 0 under mask_center) gets p = 0 and so dq = 0.
//
// What bounds it on an H100: 2 (3 d_k + 2 d_v) = 152 operations a causal
// (query, key) pair at (4, 32), 6.0 GFLOP a call at (B 128, L 784, H 1,
// mask_center): 0.036 ms at 3xTF32's 165 TFLOP/s, against ~58 MB of
// operands and outputs (0.017 ms at 3.35 TB/s). With S and dP rebuilt in
// both passes and dQ's and dK's N padded to 8 the tensor cores do ~1.6x
// that work, and one exp2 a pair in each pass runs beside them. The SIMT passes this replaces did it all as f32 FMAs on the CUDA
// cores, two threads a row, at 4.3% of the 3xTF32 bound.
//
// Design (the bf16 backward's tile plan, flash_bwd_mma_bf16.cuh, in TF32). A CTA
// is 4 warps and owns 64 query rows (dq pass) or 64 keys (dk/dv pass), 16
// a warp, one mma's M; it walks the other side's 64-row tiles up to (from)
// the diagonal, staged by cp.async into a two-stage ring, and takes each
// tile kGroup 8-key (8-row) blocks at a time:
//   dq pass:    S = q k^T      m16n8k4 (its depth is d_k), A = the warp's q
//                              rows (registers), B = k rows;
//               dP = dO v^T    m16n8k8 over d_v in steps of 8, A = the
//                              warp's dO rows (registers), B = v rows;
//               dQ += dS K     m16n8k8 over 8 keys, A = dS straight from
//                              the S / dP accumulators, B = k;
//   dk/dv pass: S^T = k q^T and dP^T = v dO^T likewise with the warp's k
//               and v rows as A; dV += P^T dO and dK += dS^T q with A =
//               P^T and dS^T from the accumulators, B = dO and q.
// An accumulator block (rows g, g + 8; columns 2t, 2t + 1) is read as an
// A fragment in flash_mma.cuh's permuted key order (a_from_acc: k-index t
// is key 2t, t + 4 is key 2t + 1) and B is loaded in that order (load_bp's
// rows), so P and dS never leave the registers. dQ's and dK's N = d_k = 4
// is zero-padded to 8; columns 4-7 are not stored. Each tile's share of
// dQ, dK and dV is summed in fresh accumulators (one a block of the group)
// and added in f32 in a fixed order, since the tensor cores' sums round
// toward zero. Every output is summed by one thread: two calls give the
// same bits. Shared rows are padded to d + 4 floats (d_k's to 4), which
// keeps every fragment load free of bank conflicts.
//
// Operands are any view with unit feature stride (PixelSNAIL's k and v are
// column views of one (B, L, d_k + d_v) kv tensor, v 16 bytes into a
// 144-byte row): an operand whose start is 16-byte aligned and whose
// (batch, row) strides are multiples of 4 floats is staged 16 bytes a
// cp.async, any other 4 bytes; the launch chooses per operand.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace fsmall {

constexpr int kBlock = 64;   // rows (keys) a CTA owns, and a streamed tile
constexpr int kWarps = 4;    // 16 rows (keys) a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kDK = 4;       // d_k
constexpr int kNB = kBlock / 8;  // 8-key (8-row) blocks of a tile
constexpr int kGroup = 4;    // blocks a sweep takes
constexpr int kStages = 2;   // of the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

// Row stride, in floats, of a staged tile of D features: D + 4, but 4 for
// d_k (rows g of a fragment load then sit 4 g or 36 g mod 32 banks apart,
// t on the next 4: no conflict).
template <int D>
__host__ __device__ constexpr int stride() {
  return D == kDK ? D : D + 4;
}

// Floats of one ring stage: the dq pass's k and v tile, the dk/dv pass's q
// and dO tile with the rows' lse and delta.
template <int DV>
__host__ __device__ constexpr int dq_stage() {
  return kBlock * (stride<kDK>() + stride<DV>());
}
template <int DV>
__host__ __device__ constexpr int dkdv_stage() {
  return dq_stage<DV>() + 2 * kBlock;
}

// A packed operand: element (b, row, h * D + d) at p[b bs + row rs + h D +
// d]; `wide` when 16-byte copies can stage it (fmma::aligned).
struct Operand {
  const float* p;
  int64_t bs, rs;
  bool wide;
};

template <int D>
__device__ __forceinline__ float ld(const Operand& o, int b, int row, int h, int d) {
  return __ldg(o.p + b * o.bs + row * o.rs + h * D + d);
}

// Starts copies of rows [row0, row0 + kBlock) of one head (D features) of
// o into a shared tile of stride stride<D>(); rows past L become 0.
template <int D>
__device__ __forceinline__ void stage(float* dst, const Operand& o, int b, int h, int row0,
                                      int L) {
  constexpr int S = stride<D>();
  if (o.wide) {
    constexpr int kChunks = D / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
      const int r = i / kChunks, c = 4 * (i % kChunks), row = row0 + r;
      const bool ok = row < L;
      tf32::cp_async16(dst + r * S + c, ok ? o.p + b * o.bs + row * o.rs + h * D + c : o.p, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
      const int r = i / D, c = i % D, row = row0 + r;
      const bool ok = row < L;
      tf32::cp_async4(dst + r * S + c, ok ? o.p + b * o.bs + row * o.rs + h * D + c : o.p, ok);
    }
  }
}

// acc[n] += a b[n] for n < N by m16n8k4, to about f32 accuracy: a given
// split, each b split here; three sweeps, as fmma::mma3.
template <int N>
__device__ __forceinline__ void mma3_k4(float (*acc)[4], const float (&a_big)[2],
                                        const float (&a_small)[2], const float (&b)[N]) {
  float b_big[N], b_small[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    b_big[n] = tf32::round(b[n]);
    b_small[n] = b[n] - b_big[n];
  }
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma_k4(acc[n], a_small, b_big[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma_k4(acc[n], a_big, b_small[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma_k4(acc[n], a_big, b_big[n]);
}

// The B fragment of B = X (8 rows of stride S at x, X's columns n = g,
// zero past n_valid) in an accumulator's column order: load_bp's rows.
template <int S>
__device__ __forceinline__ void b_rows(float (&b)[2], const float* x, int g, int t, int n_valid) {
  b[0] = g < n_valid ? x[2 * t * S + g] : 0.f;
  b[1] = g < n_valid ? x[(2 * t + 1) * S + g] : 0.f;
}

// dq pass: one CTA per (64-row q-tile, head, batch); warp w owns rows 16 w
// .. 16 w + 15 of the tile. Writes dq and the rows' delta.
template <int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Operand q, Operand k, Operand v, Operand o, Operand dout,
          const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
          int L, int H, float scale, int offset) {
  using namespace fmma;
  constexpr int SK = stride<kDK>(), SV = stride<DV>();
  constexpr int KD = DV / 8;  // 8-feature steps of dP
  __shared__ __align__(16) float ring[kStages * dq_stage<DV>()];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = qt * kBlock + 16 * warp;  // the warp's first row
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float scale_log2 = scale * kLog2e;

  auto fetch = [&](int kt) {
    float* st = ring + (kt % kStages) * dq_stage<DV>();
    stage<kDK>(st, k, b, h, kt * kBlock, L);
    stage<DV>(st + kBlock * SK, v, b, h, kt * kBlock, L);
  };
  fetch(0);
  tf32::cp_async_commit();

  // The warp's q and dO rows as split A fragments (zeros past L); delta =
  // rowsum(dO O) of the lane's rows over the columns it holds, then the
  // row's 4 lanes; lse in base 2, +inf (p = 0) past L and on fully masked
  // rows.
  float q_big[2], q_small[2], do_big[KD][4], do_small[KD][4], dlt[2] = {0.f, 0.f};
  {
    float a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = rows[i] < L ? ld<kDK>(q, b, rows[i], h, t) : 0.f;
    split(a, q_big, q_small);
  }
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i % 2], d = 8 * kk + t + 4 * (i / 2);
      a[i] = row < L ? ld<DV>(dout, b, row, h, d) : 0.f;
      if (row < L) dlt[i % 2] += a[i] * ld<DV>(o, b, row, h, d);
    }
    split(a, do_big[kk], do_small[kk]);
  }
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 1);
    dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 2);
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + rows[i];
    const float l = rows[i] < L ? lse[stat] : -CUDART_INF_F;
    lse2[i] = isinf(l) ? CUDART_INF_F : l * kLog2e;
    if (rows[i] < L && t == 0) delta[stat] = dlt[i];
  }

  float dqa[4] = {0.f, 0.f, 0.f, 0.f};
  // 64 rows and keys a tile: the diagonal of q-tile qt is in k-tile qt.
  for (int kt = 0; kt <= qt; ++kt) {
    if (kt + 1 <= qt) fetch(kt + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const float* ks = ring + (kt % kStages) * dq_stage<DV>();
    const float* vs = ks + kBlock * SK;
    const int key0 = kt * kBlock;
    // Blocks holding a key that the warp's last row sees.
    const int live = blocks_through<kNB>(r0 + 15 - offset - key0);
    float part[kGroup][4];  // this tile's dQ, one accumulator a block of the group
    zero(part);
#pragma unroll
    for (int n0 = 0; n0 < kNB; n0 += kGroup) {
      if (n0 < live) {
        // S = q k^T and dP = dO v^T for keys key0 + 8 (n0 + n) + [0, 8).
        float s[kGroup][4], dp[kGroup][4];
        zero(s);
        zero(dp);
        {
          float bk[kGroup];
#pragma unroll
          for (int n = 0; n < kGroup; ++n) bk[n] = ks[(8 * (n0 + n) + g) * SK + t];
          mma3_k4(s, q_big, q_small, bk);
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          float bv[kGroup][2];
#pragma unroll
          for (int n = 0; n < kGroup; ++n) {
            bv[n][0] = vs[(8 * (n0 + n) + g) * SV + 8 * kk + t];
            bv[n][1] = vs[(8 * (n0 + n) + g) * SV + 8 * kk + t + 4];
          }
          mma3(dp, do_big[kk], do_small[kk], bv);
        }
        // dS = P (dP - delta), in place of S; keys past the diagonal (and
        // past L, which lie past it) get p = 0.
        const bool diag = key0 + 8 * (n0 + kGroup) - 1 + offset > r0;
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2, key = key0 + 8 * (n0 + n) + 2 * t + e % 2;
            float p = exp2f(s[n][e] * scale_log2 - lse2[i]);
            if (diag && key + offset > rows[i]) p = 0.f;
            s[n][e] = p * (dp[n][e] - dlt[i]);
          }
        }
        // dQ += dS K.
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          float a[4], a_big[4], a_small[4], bk[1][2];
          a_from_acc(a, s[n]);
          split(a, a_big, a_small);
          b_rows<SK>(bk[0], ks + 8 * (n0 + n) * SK, g, t, kDK);
          mma3(&part[n], a_big, a_small, bk);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kGroup; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[e] += part[n][e];
    }
    __syncthreads();  // every reader of this stage is done before it refills
  }

  if (t < 2) {  // columns 2 t, 2 t + 1 of d_k = 4
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < L)
        *reinterpret_cast<float2*>(dq + (static_cast<int64_t>(b) * L + rows[i]) * H * kDK +
                                   h * kDK + 2 * t) =
            make_float2(dqa[2 * i] * scale, dqa[2 * i + 1] * scale);
    }
  }
}

// dk/dv pass: one CTA per (64-key tile, head, batch); warp w owns keys 16 w
// .. 16 w + 15 of the tile. Reads the dq pass's delta.
template <int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(Operand q, Operand k, Operand v, Operand dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
            int L, int H, float scale, int offset) {
  using namespace fmma;
  constexpr int SK = stride<kDK>(), SV = stride<DV>();
  constexpr int KD = DV / 8;  // 8-feature steps of dP^T and blocks of dV
  __shared__ __align__(16) float ring[kStages * dkdv_stage<DV>()];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = kt * kBlock + 16 * warp;  // the warp's first key
  const int keys[2] = {c0 + g, c0 + g + 8};
  const int n_q = (L + kBlock - 1) / kBlock;
  const float scale_log2 = scale * kLog2e;

  // q-tiles before this k-tile hold no row that sees its keys.
  auto fetch = [&](int qi) {
    float* st = ring + ((qi - kt) % kStages) * dkdv_stage<DV>();
    stage<kDK>(st, q, b, h, qi * kBlock, L);
    stage<DV>(st + kBlock * SK, dout, b, h, qi * kBlock, L);
    if (threadIdx.x < kBlock) {  // lse in base 2, +inf (p = 0) past L and on masked rows
      const int row = qi * kBlock + threadIdx.x;
      const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
      const float l = row < L ? lse[stat] : -CUDART_INF_F;
      st[dq_stage<DV>() + threadIdx.x] = isinf(l) ? CUDART_INF_F : l * kLog2e;
      st[dq_stage<DV>() + kBlock + threadIdx.x] = row < L ? delta[stat] : 0.f;
    }
  };
  fetch(kt);
  tf32::cp_async_commit();

  // The warp's k and v rows as split A fragments (zeros past L).
  float k_big[2], k_small[2], v_big[KD][4], v_small[KD][4];
  {
    float a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = keys[i] < L ? ld<kDK>(k, b, keys[i], h, t) : 0.f;
    split(a, k_big, k_small);
  }
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = keys[i % 2];
      a[i] = key < L ? ld<DV>(v, b, key, h, 8 * kk + t + 4 * (i / 2)) : 0.f;
    }
    split(a, v_big[kk], v_small[kk]);
  }

  float dka[4] = {0.f, 0.f, 0.f, 0.f}, dva[KD][4];
  zero(dva);
  for (int qi = kt; qi < n_q; ++qi) {
    if (qi + 1 < n_q) fetch(qi + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();  // tile qi has landed
    __syncthreads();
    const float* qs = ring + ((qi - kt) % kStages) * dkdv_stage<DV>();
    const float* dos = qs + kBlock * SK;
    const float* lse_s = qs + dq_stage<DV>();
    const float* delta_s = lse_s + kBlock;
    const int row0 = qi * kBlock;
    // 8-row blocks wholly above the warp's first key + offset see none of it.
    const int skip = min(kNB, max(0, c0 + offset - row0) / 8);
    float dv_part[KD][4], dk_part[kGroup][4];  // this tile's sums
    zero(dv_part);
    zero(dk_part);
#pragma unroll
    for (int n0 = 0; n0 < kNB; n0 += kGroup) {
      if (n0 + kGroup > skip) {
        // S^T = k q^T and dP^T = v dO^T for rows row0 + 8 (n0 + n) + [0, 8).
        float st[kGroup][4], dpt[kGroup][4];
        zero(st);
        zero(dpt);
        {
          float bq[kGroup];
#pragma unroll
          for (int n = 0; n < kGroup; ++n) bq[n] = qs[(8 * (n0 + n) + g) * SK + t];
          mma3_k4(st, k_big, k_small, bq);
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          float bo[kGroup][2];
#pragma unroll
          for (int n = 0; n < kGroup; ++n) {
            bo[n][0] = dos[(8 * (n0 + n) + g) * SV + 8 * kk + t];
            bo[n][1] = dos[(8 * (n0 + n) + g) * SV + 8 * kk + t + 4];
          }
          mma3(dpt, v_big[kk], v_small[kk], bo);
        }
        // P^T in place of S^T, dS^T = P^T (dP^T - delta) in place of dP^T.
        const bool diag = c0 + 15 + offset > row0 + 8 * n0;
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * (n0 + n) + 2 * t + e % 2;
            float p = exp2f(st[n][e] * scale_log2 - lse_s[r]);
            if (diag && keys[e / 2] + offset > row0 + r) p = 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - delta_s[r]);
          }
        }
        // dV += P^T dO and dK += dS^T q.
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          float a[4], a_big[4], a_small[4], bo[KD][2], bq[1][2];
          a_from_acc(a, st[n]);
          split(a, a_big, a_small);
#pragma unroll
          for (int nd = 0; nd < KD; ++nd)
            b_rows<SV>(bo[nd], dos + 8 * (n0 + n) * SV + 8 * nd, g, t, 8);
          mma3(dv_part, a_big, a_small, bo);
          a_from_acc(a, dpt[n]);
          split(a, a_big, a_small);
          b_rows<SK>(bq[0], qs + 8 * (n0 + n) * SK, g, t, kDK);
          mma3(&dk_part[n], a_big, a_small, bq);
        }
      }
    }
    tile_sum(dva, dv_part);
#pragma unroll
    for (int n = 0; n < kGroup; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[e] += dk_part[n][e];
    }
    __syncthreads();  // every reader of this stage is done before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= L) continue;
    const int64_t row = static_cast<int64_t>(b) * L + keys[i];
    if (t < 2)  // columns 2 t, 2 t + 1 of d_k = 4
      *reinterpret_cast<float2*>(dk + row * H * kDK + h * kDK + 2 * t) =
          make_float2(dka[2 * i] * scale, dka[2 * i + 1] * scale);
    store_row(dv + row * H * DV + h * DV, dva, i, t, 1.f);
  }
}

// Both passes on `stream` (the dk/dv pass reads the delta the dq pass
// stores), d_k = 4 and d_v = DV (32 or 8). Returns the launches' error.
template <int DV>
cudaError_t launch(const float* q, const float* k, const float* v, const float* out,
                   const float* dout, const float* lse, float* dq, float* dk, float* dv,
                   float* delta, int B, int L, int H, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                   int64_t k_rs, int64_t v_bs, int64_t v_rs, int64_t o_bs, int64_t o_rs,
                   int64_t do_bs, int64_t do_rs, int mask_center, cudaStream_t stream) {
  static_assert(DV % 8 == 0, "d_v: whole m16n8k8 steps");
  using fmma::aligned;
  const Operand oq{q, q_bs, q_rs, aligned(q, q_bs, q_rs)};
  const Operand ok{k, k_bs, k_rs, aligned(k, k_bs, k_rs)};
  const Operand ov{v, v_bs, v_rs, aligned(v, v_bs, v_rs)};
  const Operand oo{out, o_bs, o_rs, aligned(out, o_bs, o_rs)};
  const Operand od{dout, do_bs, do_rs, aligned(dout, do_bs, do_rs)};
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const float scale = 1.f / sqrtf(static_cast<float>(kDK));
  const int offset = mask_center ? 1 : 0;
  dq_kernel<DV><<<grid, kThreads, 0, stream>>>(oq, ok, ov, oo, od, lse, dq, delta, L, H, scale,
                                               offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DV><<<grid, kThreads, 0, stream>>>(oq, ok, ov, od, lse, delta, dk, dv, L, H,
                                                 scale, offset);
  return cudaGetLastError();
}

}  // namespace fsmall
