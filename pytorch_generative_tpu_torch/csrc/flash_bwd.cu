// Causal flash-attention backward over packed float32 tensors: q, k, dq and
// dk (B, L, H*d_k), v, out, dout and dv (B, L, H*d_v).
//
// Replaces pytorch_generative_tpu/ops/attention_pallas.py::_bwd_fused_kernel
// (launched by _flash_backward, the custom_vjp backward of
// causal_attention_packed). Same contract: heads are cut out of the packed
// feature axis by offsets, p is rebuilt from the forward's natural-log lse in
// base 2 (scale*log2(e) folded into one operand), fully-masked rows (lse =
// -inf: row 0 under `mask_center`) get p = 0 and so give no gradient and no
// NaN, delta = rowsum(dO * O) per head is computed in the kernel, and
//   dv = p^T dO,  ds = p * (dO v^T - delta),  dq = ds k * scale,
//   dk = ds^T q * scale.
// The ragged last tile (L % 64 != 0) is masked in the kernel.
//
// Why the design differs from the TPU's: the TPU kernel runs one grid step
// per k-tile in order and keeps the whole dq of a sequence in one VMEM tile
// that every step revisits and adds to. On Hopper the blocks of a grid run in
// no order, so that carry does not exist. This kernel takes two passes
// instead, each rebuilding p: a dq pass, one CTA per (q-tile, head, batch),
// that loops over the k-tiles up to the diagonal, computes delta for its rows
// and stores it for the second pass; then a dk/dv pass, one CTA per (k-tile,
// head, batch), that loops over the q-tiles from the diagonal on. Every
// output element is summed by one thread in a fixed order, so the result is
// deterministic run to run (no atomics). The price is recomputing
// q k^T and dO v^T in both passes: 7 tile products where a fused pass needs 5.
//
// What bounds it on an H100: at the ImageGPT shapes (L = 784, d = 32) the
// work is ~10*d FLOPs per causal (query, key) pair and head, ~12.6 GFLOP per
// call at batch 64, against ~100 MB of operands: f32 FMA work on the CUDA
// cores (67 TFLOP/s), not device memory. This first version is as simple as
// flash_fwd.cu: 64-row tiles, two threads per row, operand tiles staged
// through shared memory with loads coalesced over the packed row, rows held
// in registers. Tensor cores (wgmma) and TMA pipelining are later work.
//
// Wide heads (d = 128) take their own pair of passes (the *_wide kernels):
// two threads a row would hold the q, dO (or k, v) rows and 64 + 64
// accumulators each, past the register file. There four threads share a
// row, the operand rows stay in shared memory (~150-170 KB a CTA), and each
// thread takes every fourth column of a tile and every fourth output
// feature: 32 + 32 accumulators a thread. The narrower instances keep the
// two-threads-a-row passes above, bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;              // query rows and keys per tile
constexpr int kThreads = 2 * kBlock;    // two threads share one row
constexpr int kHalf = kBlock / 2;       // columns per thread per tile
constexpr int kPStride = kBlock + 2;    // p/ds rows: stride 2 mod 32 banks
constexpr float kLog2e = 1.4426950408889634f;

// Copies rows [row0, row0 + kBlock) of one head (D features wide) of a
// packed operand into a (kBlock, D + 1) shared tile, times `mul`, with the
// CTA's kNThreads threads; rows past L read as 0.
template <int D, int kNThreads = kThreads>
__device__ void stage_tile(float* dst, const float* src, int64_t bs, int64_t rs,
                           int b, int h, int row0, int L, float mul) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kNThreads) {
    const int rr = idx / D, cc = idx % D;
    const int row = row0 + rr;
    dst[rr * (D + 1) + cc] =
        row < L ? src[b * bs + row * rs + h * D + cc] * mul : 0.f;
  }
}

// dq pass: one CTA per (q-tile, head, batch). Thread (r, half) owns query row
// r, computes p and ds for the keys c = 2j + half of each k-tile, and sums
// dq over the half of the features it owns.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, int L, int H, int64_t q_bs,
                    int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                    int64_t v_rs, int64_t o_bs, int64_t o_rs, int64_t do_bs,
                    int64_t do_rs, float scale, int offset) {
  static_assert(DV + 1 <= kPStride, "O is staged through the ds tile");
  constexpr int DH = DK / 2;  // dq features per thread
  extern __shared__ float smem[];
  float* ks = smem;                        // kBlock x (DK + 1)
  float* vs = ks + kBlock * (DK + 1);      // kBlock x (DV + 1)
  float* dss = vs + kBlock * (DV + 1);     // kBlock x kPStride

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qrow = qt * kBlock + r;
  const bool row_ok = qrow < L;

  // q (pre-scaled into the base-2 domain), dO and O through shared memory,
  // then each row into registers; delta = dO . O for the row.
  stage_tile<DK>(ks, q, q_bs, q_rs, b, h, qt * kBlock, L, scale * kLog2e);
  stage_tile<DV>(vs, dout, do_bs, do_rs, b, h, qt * kBlock, L, 1.f);
  stage_tile<DV>(dss, out, o_bs, o_rs, b, h, qt * kBlock, L, 1.f);
  __syncthreads();
  float q2[DK], dor[DV];
  float dlt = 0.f;
#pragma unroll
  for (int d = 0; d < DK; ++d) q2[d] = ks[r * (DK + 1) + d];
#pragma unroll
  for (int d = 0; d < DV; ++d) {
    dor[d] = vs[r * (DV + 1) + d];
    dlt += dor[d] * dss[r * (DV + 1) + d];
  }
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + qrow;
  const float lse2 = row_ok ? lse[stat] * kLog2e : -CUDART_INF_F;
  const bool live = row_ok && !isinf(lse2);  // fully-masked rows: p = 0
  if (row_ok && half == 0) delta[stat] = dlt;

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  // kBlock rows and keys per tile: the diagonal of q-tile qt is in k-tile qt.
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every reader of the previous tiles is done
    stage_tile<DK>(ks, k, k_bs, k_rs, b, h, kt * kBlock, L, 1.f);
    stage_tile<DV>(vs, v, v_bs, v_rs, b, h, kt * kBlock, L, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kHalf; ++j) {
      const int c = 2 * j + half;  // neighbouring threads, neighbouring keys
      const int key = kt * kBlock + c;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) s += q2[d] * ks[c * (DK + 1) + d];
#pragma unroll
      for (int d = 0; d < DV; ++d) dp += dor[d] * vs[c * (DV + 1) + d];
      const bool ok = live && key < L && key + offset <= qrow;
      const float p = ok ? exp2f(s - lse2) : 0.f;
      dss[r * kPStride + c] = p * (dp - dlt);
    }
    __syncwarp();  // the row's two halves of ds live in this warp

    for (int c = 0; c < kBlock; ++c) {
      const float ds = dss[r * kPStride + c];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += ds * ks[c * (DK + 1) + half * DH + d];
    }
  }

  if (row_ok) {
    float* dqp = dq + (static_cast<int64_t>(b) * L + qrow) * H * DK + h * DK +
                 half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dqp[d] = acc[d] * scale;
  }
}

// dk/dv pass: one CTA per (k-tile, head, batch). Thread (c, half) owns key c,
// computes p and ds for the query rows r = 2j + half of each q-tile, and
// sums dk and dv over the half of the features it owns.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int L, int H, int64_t q_bs,
                      int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                      int64_t v_rs, int64_t do_bs, int64_t do_rs, float scale,
                      int offset) {
  constexpr int KH = DK / 2, VH = DV / 2;  // dk and dv features per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // kBlock x (DK + 1)
  float* dos = qs + kBlock * (DK + 1);     // kBlock x (DV + 1)
  float* ps = dos + kBlock * (DV + 1);     // kBlock keys x kPStride
  float* dss = ps + kBlock * kPStride;     // kBlock keys x kPStride
  float* lse_s = dss + kBlock * kPStride;  // kBlock (base 2)
  float* delta_s = lse_s + kBlock;         // kBlock

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int key = kt * kBlock + c;
  const bool key_ok = key < L;
  const int n_q_tiles = (L + kBlock - 1) / kBlock;

  // k (pre-scaled into the base-2 domain) and v rows into registers.
  stage_tile<DK>(qs, k, k_bs, k_rs, b, h, kt * kBlock, L, scale * kLog2e);
  stage_tile<DV>(dos, v, v_bs, v_rs, b, h, kt * kBlock, L, 1.f);
  __syncthreads();
  float k2[DK], vr[DV];
#pragma unroll
  for (int d = 0; d < DK; ++d) k2[d] = qs[c * (DK + 1) + d];
#pragma unroll
  for (int d = 0; d < DV; ++d) vr[d] = dos[c * (DV + 1) + d];
  float dk_acc[KH], dv_acc[VH];
#pragma unroll
  for (int d = 0; d < KH; ++d) dk_acc[d] = 0.f;
#pragma unroll
  for (int d = 0; d < VH; ++d) dv_acc[d] = 0.f;

  // q-tiles before this k-tile hold no row that sees its keys.
  for (int qt = kt; qt < n_q_tiles; ++qt) {
    __syncthreads();
    stage_tile<DK>(qs, q, q_bs, q_rs, b, h, qt * kBlock, L, 1.f);
    stage_tile<DV>(dos, dout, do_bs, do_rs, b, h, qt * kBlock, L, 1.f);
    if (threadIdx.x < kBlock) {
      const int row = qt * kBlock + threadIdx.x;
      const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
      lse_s[threadIdx.x] = row < L ? lse[stat] * kLog2e : -CUDART_INF_F;
      delta_s[threadIdx.x] = row < L ? delta[stat] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kHalf; ++j) {
      const int r = 2 * j + half;
      const int row = qt * kBlock + r;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) s += qs[r * (DK + 1) + d] * k2[d];
#pragma unroll
      for (int d = 0; d < DV; ++d) dp += dos[r * (DV + 1) + d] * vr[d];
      const float l2 = lse_s[r];  // -inf past L and on fully-masked rows
      const bool ok = key_ok && !isinf(l2) && key + offset <= row;
      const float p = ok ? exp2f(s - l2) : 0.f;
      ps[c * kPStride + r] = p;
      dss[c * kPStride + r] = p * (dp - delta_s[r]);
    }
    __syncwarp();  // the key's two halves of p and ds live in this warp

    for (int r = 0; r < kBlock; ++r) {
      const float p = ps[c * kPStride + r];
      const float ds = dss[c * kPStride + r];
#pragma unroll
      for (int d = 0; d < VH; ++d) dv_acc[d] += p * dos[r * (DV + 1) + half * VH + d];
#pragma unroll
      for (int d = 0; d < KH; ++d) dk_acc[d] += ds * qs[r * (DK + 1) + half * KH + d];
    }
  }

  if (key_ok) {
    const int64_t row = static_cast<int64_t>(b) * L + key;
    float* dkp = dk + row * H * DK + h * DK + half * KH;
    float* dvp = dv + row * H * DV + h * DV + half * VH;
#pragma unroll
    for (int d = 0; d < KH; ++d) dkp[d] = dk_acc[d] * scale;
#pragma unroll
    for (int d = 0; d < VH; ++d) dvp[d] = dv_acc[d];
  }
}

template <int DK, int DV>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* out, const float* dout, const float* lse,
                   float* dq, float* dk, float* dv, float* delta, int B, int L,
                   int H, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                   int64_t k_rs, int64_t v_bs, int64_t v_rs, int64_t o_bs,
                   int64_t o_rs, int64_t do_bs, int64_t do_rs, int mask_center,
                   cudaStream_t stream) {
  const size_t smem_dq =
      sizeof(float) * (kBlock * (DK + 1) + kBlock * (DV + 1) + kBlock * kPStride);
  const size_t smem_kv = sizeof(float) *
      (kBlock * (DK + 1) + kBlock * (DV + 1) + 2 * kBlock * kPStride + 2 * kBlock);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const float scale = 1.f / sqrtf(static_cast<float>(DK));
  const int offset = mask_center ? 1 : 0;
  // Same stream: the dk/dv pass reads the delta that the dq pass stores.
  flash_bwd_dq_kernel<DK, DV><<<grid, kThreads, smem_dq, stream>>>(
      q, k, v, out, dout, lse, dq, delta, L, H, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, o_bs, o_rs, do_bs, do_rs, scale, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<DK, DV><<<grid, kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, L, H, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, do_bs, do_rs, scale, offset);
  return cudaGetLastError();
}

constexpr int kWideTpr = 4;                   // threads per row
constexpr int kWideThreads = kWideTpr * kBlock;
constexpr int kWideCols = kBlock / kWideTpr;   // columns per thread per tile

// dq pass for wide heads: thread (r, part) owns query row r, computes p and
// ds for the keys c = 4j + part of each k-tile, and sums dq over the
// features 4d + part. q, dO, k and v rows stay in shared memory.
template <int DK, int DV>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ out,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ dq,
                         float* __restrict__ delta, int L, int H, int64_t q_bs,
                         int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                         int64_t v_rs, int64_t o_bs, int64_t o_rs, int64_t do_bs,
                         int64_t do_rs, float scale, int offset) {
  static_assert(DK % kWideTpr == 0, "dq features split over the row's threads");
  constexpr int DH = DK / kWideTpr;  // dq features per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // kBlock x (DK + 1), pre-scaled
  float* dos = qs + kBlock * (DK + 1);     // kBlock x (DV + 1)
  float* ks = dos + kBlock * (DV + 1);     // kBlock x (DK + 1)
  float* vs = ks + kBlock * (DK + 1);      // kBlock x (DV + 1); O at first
  float* dss = vs + kBlock * (DV + 1);     // kBlock x kPStride

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / kWideTpr, part = threadIdx.x % kWideTpr;
  const int qrow = qt * kBlock + r;
  const bool row_ok = qrow < L;

  stage_tile<DK, kWideThreads>(qs, q, q_bs, q_rs, b, h, qt * kBlock, L, scale * kLog2e);
  stage_tile<DV, kWideThreads>(dos, dout, do_bs, do_rs, b, h, qt * kBlock, L, 1.f);
  stage_tile<DV, kWideThreads>(vs, out, o_bs, o_rs, b, h, qt * kBlock, L, 1.f);
  __syncthreads();
  float dlt = 0.f;  // every thread of the row sums it in the same order
  for (int d = 0; d < DV; ++d) dlt += dos[r * (DV + 1) + d] * vs[r * (DV + 1) + d];
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + qrow;
  const float lse2 = row_ok ? lse[stat] * kLog2e : -CUDART_INF_F;
  const bool live = row_ok && !isinf(lse2);  // fully-masked rows: p = 0
  if (row_ok && part == 0) delta[stat] = dlt;

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every reader of the previous tiles (and of O) is done
    stage_tile<DK, kWideThreads>(ks, k, k_bs, k_rs, b, h, kt * kBlock, L, 1.f);
    stage_tile<DV, kWideThreads>(vs, v, v_bs, v_rs, b, h, kt * kBlock, L, 1.f);
    __syncthreads();

    for (int j = 0; j < kWideCols; ++j) {
      const int c = kWideTpr * j + part;
      const int key = kt * kBlock + c;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DK; ++d) s += qs[r * (DK + 1) + d] * ks[c * (DK + 1) + d];
#pragma unroll 16
      for (int d = 0; d < DV; ++d) dp += dos[r * (DV + 1) + d] * vs[c * (DV + 1) + d];
      const bool ok = live && key < L && key + offset <= qrow;
      const float p = ok ? exp2f(s - lse2) : 0.f;
      dss[r * kPStride + c] = p * (dp - dlt);
    }
    __syncwarp();  // the row's four parts of ds live in this warp

    for (int c = 0; c < kBlock; ++c) {
      const float ds = dss[r * kPStride + c];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += ds * ks[c * (DK + 1) + kWideTpr * d + part];
    }
  }

  if (row_ok) {
    float* dqp = dq + (static_cast<int64_t>(b) * L + qrow) * H * DK + h * DK + part;
#pragma unroll
    for (int d = 0; d < DH; ++d) dqp[kWideTpr * d] = acc[d] * scale;
  }
}

// dk/dv pass for wide heads: thread (c, part) owns key c, computes p and ds
// for the query rows r = 4j + part of each q-tile, and sums dk and dv over
// the features 4d + part. k, v, q and dO rows stay in shared memory.
template <int DK, int DV>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkdv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int L, int H, int64_t q_bs,
                           int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                           int64_t v_rs, int64_t do_bs, int64_t do_rs, float scale,
                           int offset) {
  static_assert(DK % kWideTpr == 0 && DV % kWideTpr == 0,
                "dk and dv features split over the key's threads");
  constexpr int KH = DK / kWideTpr, VH = DV / kWideTpr;
  extern __shared__ float smem[];
  float* ks = smem;                        // kBlock x (DK + 1), pre-scaled
  float* vsm = ks + kBlock * (DK + 1);     // kBlock x (DV + 1)
  float* qs = vsm + kBlock * (DV + 1);     // kBlock x (DK + 1)
  float* dos = qs + kBlock * (DK + 1);     // kBlock x (DV + 1)
  float* ps = dos + kBlock * (DV + 1);     // kBlock keys x kPStride
  float* dss = ps + kBlock * kPStride;     // kBlock keys x kPStride
  float* lse_s = dss + kBlock * kPStride;  // kBlock (base 2)
  float* delta_s = lse_s + kBlock;         // kBlock

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x / kWideTpr, part = threadIdx.x % kWideTpr;
  const int key = kt * kBlock + c;
  const bool key_ok = key < L;
  const int n_q_tiles = (L + kBlock - 1) / kBlock;

  stage_tile<DK, kWideThreads>(ks, k, k_bs, k_rs, b, h, kt * kBlock, L, scale * kLog2e);
  stage_tile<DV, kWideThreads>(vsm, v, v_bs, v_rs, b, h, kt * kBlock, L, 1.f);
  float dk_acc[KH], dv_acc[VH];
#pragma unroll
  for (int d = 0; d < KH; ++d) dk_acc[d] = 0.f;
#pragma unroll
  for (int d = 0; d < VH; ++d) dv_acc[d] = 0.f;

  for (int qt = kt; qt < n_q_tiles; ++qt) {
    __syncthreads();  // k, v staged; every reader of the previous tiles is done
    stage_tile<DK, kWideThreads>(qs, q, q_bs, q_rs, b, h, qt * kBlock, L, 1.f);
    stage_tile<DV, kWideThreads>(dos, dout, do_bs, do_rs, b, h, qt * kBlock, L, 1.f);
    if (threadIdx.x < kBlock) {
      const int row = qt * kBlock + threadIdx.x;
      const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
      lse_s[threadIdx.x] = row < L ? lse[stat] * kLog2e : -CUDART_INF_F;
      delta_s[threadIdx.x] = row < L ? delta[stat] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kWideCols; ++j) {
      const int r = kWideTpr * j + part;
      const int row = qt * kBlock + r;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DK; ++d) s += qs[r * (DK + 1) + d] * ks[c * (DK + 1) + d];
#pragma unroll 16
      for (int d = 0; d < DV; ++d) dp += dos[r * (DV + 1) + d] * vsm[c * (DV + 1) + d];
      const float l2 = lse_s[r];  // -inf past L and on fully-masked rows
      const bool ok = key_ok && !isinf(l2) && key + offset <= row;
      const float p = ok ? exp2f(s - l2) : 0.f;
      ps[c * kPStride + r] = p;
      dss[c * kPStride + r] = p * (dp - delta_s[r]);
    }
    __syncwarp();  // the key's four parts of p and ds live in this warp

    for (int r = 0; r < kBlock; ++r) {
      const float p = ps[c * kPStride + r];
      const float ds = dss[c * kPStride + r];
#pragma unroll
      for (int d = 0; d < VH; ++d) dv_acc[d] += p * dos[r * (DV + 1) + kWideTpr * d + part];
#pragma unroll
      for (int d = 0; d < KH; ++d) dk_acc[d] += ds * qs[r * (DK + 1) + kWideTpr * d + part];
    }
  }

  if (key_ok) {
    const int64_t row = static_cast<int64_t>(b) * L + key;
    float* dkp = dk + row * H * DK + h * DK + part;
    float* dvp = dv + row * H * DV + h * DV + part;
#pragma unroll
    for (int d = 0; d < KH; ++d) dkp[kWideTpr * d] = dk_acc[d] * scale;
#pragma unroll
    for (int d = 0; d < VH; ++d) dvp[kWideTpr * d] = dv_acc[d];
  }
}

template <int DK, int DV>
cudaError_t launch_wide(const float* q, const float* k, const float* v,
                        const float* out, const float* dout, const float* lse,
                        float* dq, float* dk, float* dv, float* delta, int B, int L,
                        int H, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                        int64_t k_rs, int64_t v_bs, int64_t v_rs, int64_t o_bs,
                        int64_t o_rs, int64_t do_bs, int64_t do_rs, int mask_center,
                        cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) *
      (2 * kBlock * (DK + 1) + 2 * kBlock * (DV + 1) + kBlock * kPStride);
  const size_t smem_kv = sizeof(float) *
      (2 * kBlock * (DK + 1) + 2 * kBlock * (DV + 1) + 2 * kBlock * kPStride +
       2 * kBlock);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wide_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const float scale = 1.f / sqrtf(static_cast<float>(DK));
  const int offset = mask_center ? 1 : 0;
  // Same stream: the dk/dv pass reads the delta that the dq pass stores.
  flash_bwd_dq_wide_kernel<DK, DV><<<grid, kWideThreads, smem_dq, stream>>>(
      q, k, v, out, dout, lse, dq, delta, L, H, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, o_bs, o_rs, do_bs, do_rs, scale, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wide_kernel<DK, DV><<<grid, kWideThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, L, H, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, do_bs, do_rs, scale, offset);
  return cudaGetLastError();
}

}  // namespace

// q, k: f32 (B, L, H*d_k); v, out, dout: f32 (B, L, H*d_v); each with unit
// stride over features and (batch, row) strides given in elements. (d_k,
// d_v) is one of (16, 16), (32, 32), (64, 64), (128, 128), (4, 32), (4, 8).
// lse: (B, H, L) natural log. dq, dk: contiguous (B, L, H*d_k); dv: contiguous
// (B, L, H*d_v); delta: (B, H, L) scratch.
extern "C" int flash_bwd_f32(const float* q, const float* k, const float* v,
                             const float* out, const float* dout,
                             const float* lse, float* dq, float* dk, float* dv,
                             float* delta, int B, int L, int H, int d_k,
                             int d_v, int64_t q_bs, int64_t q_rs, int64_t k_bs,
                             int64_t k_rs, int64_t v_bs, int64_t v_rs,
                             int64_t o_bs, int64_t o_rs, int64_t do_bs,
                             int64_t do_rs, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(DK, DV)                                                \
  if (d_k == DK && d_v == DV)                                                 \
    return launch<DK, DV>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, L,   \
                          H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,  \
                          do_bs, do_rs, mask_center, s);
  FLASH_BWD_CASE(16, 16)
  FLASH_BWD_CASE(32, 32)
  FLASH_BWD_CASE(64, 64)
  FLASH_BWD_CASE(4, 32)
  FLASH_BWD_CASE(4, 8)
#undef FLASH_BWD_CASE
  if (d_k == 128 && d_v == 128)
    return launch_wide<128, 128>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, L,
                                 H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
                                 do_bs, do_rs, mask_center, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
