// Row-wise LayerNorm pieces and fixed-order column sums, shared by
// ln_fwd.cu, ln_bwd.cu, mlp_fwd.cu and mlp_bwd.cu.
//
// The LayerNorm kernels take their rows (x, dy, resid, out, dx) and gamma,
// beta as float32 or bf16 (the element type T, and TD for dy), and hold
// everything in registers as f32: statistics, sums and the arithmetic are
// f32 in both, and a bf16 output is rounded to nearest even once, at its
// store (ln_pallas.py:41-66 with bf16 rows). Four channels are one 16-byte
// load of f32 or one 8-byte load of bf16, so the column layout below is
// the same for both types.
//
// A row of C float32 channels (C a multiple of 4, at most 512) is held by
// one warp: lane l owns the float4s at columns 4 * (l + 32 * i), i < NV,
// NV = 1, 2 or 4 for C up to 128, 256 or 512, so a row is read with
// coalesced 16-byte loads and its statistics come from warp shuffles,
// with no shared memory. The xor
// butterfly leaves the same sum in every lane (each step adds a pair in both
// orders, and float addition commutes exactly).
//
// A wider row (512 < C <= kMaxChannels) is held by one CTA of kThreads:
// thread t owns the float4s at columns 4 * (t + 256 * i), i < NVC, NVC = 1,
// 2 or 4 for C up to 1024, 2048 or 4096; its sums are warp sums added in
// warp order through shared memory (block_sum), the same in every thread.
// Rows of C <= 512 never take this path, so their results do not change.
//
// Sums over rows (dgamma, dbeta, bias gradients) never use atomics: a first
// pass writes one partial per CTA or row chunk, and sum_slices_kernel adds
// the partials in a fixed order. The result is the same run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace rows {

constexpr int kWarps = 8;  // rows in flight per CTA
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld4(const bf16::T* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16::lo(v.x), bf16::hi(v.x), bf16::lo(v.y), bf16::hi(v.y));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(bf16::T* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16::pack(v.x, v.y), bf16::pack(v.z, v.w));
}

__device__ __forceinline__ float hsum(float4 v) { return v.x + v.y + v.z + v.w; }

__device__ __forceinline__ int col(int lane, int i) { return 4 * (lane + 32 * i); }

// p[0..3] = v (first) or p[0..3] += v.
__device__ __forceinline__ void add_to(float* p, float4 v, bool first) {
  if (first) {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  } else {
    p[0] += v.x; p[1] += v.y; p[2] += v.z; p[3] += v.w;
  }
}

// The lane's float4s of one row; columns past C read as 0.
template <int NV, class T>
__device__ __forceinline__ void load_row(float4 (&v)[NV], const T* p, int C, int lane) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = col(lane, i) < C ? ld4(p + col(lane, i)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// (mean, 1 / sqrt(biased variance + eps)) of the row, in two passes over
// the registers as the plain version: mean first, then mean((x - mean)^2).
template <int NV>
__device__ __forceinline__ float2 row_stats(const float4 (&v)[NV], int C, int lane,
                                            float eps) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s += hsum(v[i]);  // padding lanes hold 0
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (col(lane, i) < C) {
      const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
      q += a * a + b * b + c * c + d * d;
    }
  }
  return make_float2(mu, rsqrtf(warp_sum(q) / C + eps));
}

// out = (x - mean) * rstd * gamma + beta over (R, C) rows, one warp per
// row (ln_fwd.cu, and the fused MLP's LN(x)).
template <int NV, class T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, T* __restrict__ out, int R, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int64_t base = static_cast<int64_t>(r) * C;
  float4 v[NV];
  load_row<NV>(v, x + base, C, lane);
  const float2 st = row_stats<NV>(v, C, lane, eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = col(lane, i);
    if (c >= C) continue;
    const float4 g = ld4(gamma + c), b = ld4(beta + c);
    st4(out + base + c,
        make_float4((v[i].x - st.x) * st.y * g.x + b.x,
                    (v[i].y - st.x) * st.y * g.y + b.y,
                    (v[i].z - st.x) * st.y * g.z + b.z,
                    (v[i].w - st.x) * st.y * g.w + b.w));
  }
}

// LayerNorm backward over the rows [r0, r0 + rows_per_cta) of one CTA:
//   xhat = (x - mean) * rstd, dxhat = dy * gamma,
//   dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd (+ resid),
// and the CTA's partial column sums written to part[blockIdx.x]:
// (sum dy * xhat, sum dy) and, with kResid, sum resid. Statistics are
// recomputed from x. Warp w takes rows r0 + w, r0 + w + 8, ...; the eight
// warps' sums are then added in warp order through shared memory
// (kAcc * C floats of dynamic shared memory). x, gamma, resid and dx are
// of type T, dy of TD (the fused MLP's f32 dln beside bf16 rows).
template <int NV, bool kResid, class T, class TD>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const TD* __restrict__ dy,
                   const T* __restrict__ gamma, const T* __restrict__ resid,
                   T* __restrict__ dx, float* __restrict__ part, int R, int C,
                   int rows_per_cta, float eps) {
  constexpr int kAcc = kResid ? 3 : 2;
  extern __shared__ float acc_s[];  // kAcc x C
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dg[NV], db[NV], dr[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) dg[i] = db[i] = dr[i] = zero;

  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(R, r0 + rows_per_cta);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int64_t base = static_cast<int64_t>(r) * C;
    float4 xh[NV], d[NV], dxh[NV];
    load_row<NV>(xh, x + base, C, lane);
    load_row<NV>(d, dy + base, C, lane);
    const float2 st = row_stats<NV>(xh, C, lane, eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      dxh[i] = zero;
      if (col(lane, i) < C) {
        const float4 g = ld4(gamma + col(lane, i));
        xh[i] = make_float4((xh[i].x - st.x) * st.y, (xh[i].y - st.x) * st.y,
                            (xh[i].z - st.x) * st.y, (xh[i].w - st.x) * st.y);
        dxh[i] = make_float4(d[i].x * g.x, d[i].y * g.y, d[i].z * g.z, d[i].w * g.w);
        s1 += hsum(dxh[i]);
        s2 += dxh[i].x * xh[i].x + dxh[i].y * xh[i].y + dxh[i].z * xh[i].z +
              dxh[i].w * xh[i].w;
        dg[i].x += d[i].x * xh[i].x; dg[i].y += d[i].y * xh[i].y;
        dg[i].z += d[i].z * xh[i].z; dg[i].w += d[i].w * xh[i].w;
        db[i].x += d[i].x; db[i].y += d[i].y; db[i].z += d[i].z; db[i].w += d[i].w;
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (col(lane, i) >= C) continue;
      float4 o = make_float4((dxh[i].x - m1 - xh[i].x * m2) * st.y,
                             (dxh[i].y - m1 - xh[i].y * m2) * st.y,
                             (dxh[i].z - m1 - xh[i].z * m2) * st.y,
                             (dxh[i].w - m1 - xh[i].w * m2) * st.y);
      if constexpr (kResid) {
        const float4 rr = ld4(resid + base + col(lane, i));
        o.x += rr.x; o.y += rr.y; o.z += rr.z; o.w += rr.w;
        dr[i].x += rr.x; dr[i].y += rr.y; dr[i].z += rr.z; dr[i].w += rr.w;
      }
      st4(dx + base + col(lane, i), o);
    }
  }

  // The warps' sums, added in warp order.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = col(lane, i);
        if (c >= C) continue;
        add_to(acc_s + c, dg[i], w == 0);
        add_to(acc_s + C + c, db[i], w == 0);
        if constexpr (kResid) add_to(acc_s + 2 * C + c, dr[i], w == 0);
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<int64_t>(blockIdx.x) * kAcc * C;
  for (int idx = threadIdx.x; idx < kAcc * C; idx += kThreads) out[idx] = acc_s[idx];
}

// out[j] = sum over s < S of part[s * n + j]. Warp w adds the slices
// s = w, w + 8, ... in order; the eight warp sums are added in warp order.
__global__ void __launch_bounds__(kThreads)
sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out, int S,
                  int64_t n) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (j < n)
    for (int k = warp; k < S; k += kWarps) s += part[k * n + j];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    out[j] = t;
  }
}

// part[blockIdx.y][j] = sum of src[r][j] over the rows r of chunk
// blockIdx.y of an (R, N) matrix, in a fixed order as sum_slices_kernel.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ src, float* __restrict__ part, int R, int N,
              int rows_per_chunk) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  float s = 0.f;
  if (j < N)
    for (int r = r0 + warp; r < r1; r += kWarps) s += src[static_cast<int64_t>(r) * N + j];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    part[static_cast<int64_t>(blockIdx.y) * N + j] = t;
  }
}

inline cudaError_t sum_slices(const float* part, float* out, int S, int64_t n,
                              cudaStream_t stream) {
  sum_slices_kernel<<<static_cast<unsigned>((n + 31) / 32), kThreads, 0, stream>>>(
      part, out, S, n);
  return cudaGetLastError();
}

// ---- Wide rows: one CTA a row (512 < C <= kMaxChannels). ----

constexpr int kMaxChannels = 4096;

__device__ __forceinline__ int wcol(int t, int i) { return 4 * (t + kThreads * i); }

// The sum of v over the CTA, the same in every thread: the warp sums added
// in warp order. red holds kWarps floats; it is free again on return.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The thread's float4s of one row; columns past C read as 0.
template <int NVC, class T>
__device__ __forceinline__ void load_row_wide(float4 (&v)[NVC], const T* p, int C) {
#pragma unroll
  for (int i = 0; i < NVC; ++i) {
    const int c = wcol(threadIdx.x, i);
    v[i] = c < C ? ld4(p + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// (mean, 1 / sqrt(biased variance + eps)) of a CTA's row, in two passes
// as row_stats.
template <int NVC>
__device__ __forceinline__ float2 row_stats_wide(const float4 (&v)[NVC], int C,
                                                 float eps, float* red) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NVC; ++i) s += hsum(v[i]);  // padding holds 0
  const float mu = block_sum(s, red) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NVC; ++i) {
    if (wcol(threadIdx.x, i) < C) {
      const float a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
      q += a * a + b * b + c * c + d * d;
    }
  }
  return make_float2(mu, rsqrtf(block_sum(q, red) / C + eps));
}

// ln_fwd_kernel for wide rows, one CTA a row.
template <int NVC, class T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const T* __restrict__ beta, T* __restrict__ out, int C, float eps) {
  __shared__ float red[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * C;
  float4 v[NVC];
  load_row_wide<NVC>(v, x + base, C);
  const float2 st = row_stats_wide<NVC>(v, C, eps, red);
#pragma unroll
  for (int i = 0; i < NVC; ++i) {
    const int c = wcol(threadIdx.x, i);
    if (c >= C) continue;
    const float4 g = ld4(gamma + c), b = ld4(beta + c);
    st4(out + base + c,
        make_float4((v[i].x - st.x) * st.y * g.x + b.x,
                    (v[i].y - st.x) * st.y * g.y + b.y,
                    (v[i].z - st.x) * st.y * g.z + b.z,
                    (v[i].w - st.x) * st.y * g.w + b.w));
  }
}

// ln_bwd_rows_kernel for wide rows: the CTA walks its rows one at a time,
// each thread keeping the column sums of the columns it owns, so the CTA's
// partial sums need no reduction across threads.
template <int NVC, bool kResid, class T, class TD>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_wide_kernel(const T* __restrict__ x, const TD* __restrict__ dy,
                        const T* __restrict__ gamma, const T* __restrict__ resid,
                        T* __restrict__ dx, float* __restrict__ part, int R, int C,
                        int rows_per_cta, float eps) {
  constexpr int kAcc = kResid ? 3 : 2;
  __shared__ float red[kWarps];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dg[NVC], db[NVC], dr[NVC];
#pragma unroll
  for (int i = 0; i < NVC; ++i) dg[i] = db[i] = dr[i] = zero;

  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(R, r0 + rows_per_cta);
  for (int r = r0; r < r1; ++r) {
    const int64_t base = static_cast<int64_t>(r) * C;
    float4 xh[NVC], d[NVC], dxh[NVC];
    load_row_wide<NVC>(xh, x + base, C);
    load_row_wide<NVC>(d, dy + base, C);
    const float2 st = row_stats_wide<NVC>(xh, C, eps, red);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NVC; ++i) {
      dxh[i] = zero;
      const int c = wcol(threadIdx.x, i);
      if (c < C) {
        const float4 g = ld4(gamma + c);
        xh[i] = make_float4((xh[i].x - st.x) * st.y, (xh[i].y - st.x) * st.y,
                            (xh[i].z - st.x) * st.y, (xh[i].w - st.x) * st.y);
        dxh[i] = make_float4(d[i].x * g.x, d[i].y * g.y, d[i].z * g.z, d[i].w * g.w);
        s1 += hsum(dxh[i]);
        s2 += dxh[i].x * xh[i].x + dxh[i].y * xh[i].y + dxh[i].z * xh[i].z +
              dxh[i].w * xh[i].w;
        dg[i].x += d[i].x * xh[i].x; dg[i].y += d[i].y * xh[i].y;
        dg[i].z += d[i].z * xh[i].z; dg[i].w += d[i].w * xh[i].w;
        db[i].x += d[i].x; db[i].y += d[i].y; db[i].z += d[i].z; db[i].w += d[i].w;
      }
    }
    const float m1 = block_sum(s1, red) / C, m2 = block_sum(s2, red) / C;
#pragma unroll
    for (int i = 0; i < NVC; ++i) {
      const int c = wcol(threadIdx.x, i);
      if (c >= C) continue;
      float4 o = make_float4((dxh[i].x - m1 - xh[i].x * m2) * st.y,
                             (dxh[i].y - m1 - xh[i].y * m2) * st.y,
                             (dxh[i].z - m1 - xh[i].z * m2) * st.y,
                             (dxh[i].w - m1 - xh[i].w * m2) * st.y);
      if constexpr (kResid) {
        const float4 rr = ld4(resid + base + c);
        o.x += rr.x; o.y += rr.y; o.z += rr.z; o.w += rr.w;
        dr[i].x += rr.x; dr[i].y += rr.y; dr[i].z += rr.z; dr[i].w += rr.w;
      }
      st4(dx + base + c, o);
    }
  }

  float* out = part + static_cast<int64_t>(blockIdx.x) * kAcc * C;
#pragma unroll
  for (int i = 0; i < NVC; ++i) {
    const int c = wcol(threadIdx.x, i);
    if (c >= C) continue;
    st4(out + c, dg[i]);
    st4(out + C + c, db[i]);
    if constexpr (kResid) st4(out + 2 * C + c, dr[i]);
  }
}

// Float4s per lane for C channels; 0 where the warp-per-row kernels do not
// take C.
inline int vecs_per_lane(int C) {
  if (C <= 0 || C % 4 != 0) return 0;
  if (C <= 128) return 1;
  if (C <= 256) return 2;
  if (C <= 512) return 4;
  return 0;
}

// Float4s per thread of the CTA-per-row kernels for C channels; 0 where
// they do not take C (C <= 512 takes the warp-per-row kernels).
inline int vecs_per_thread(int C) {
  if (C <= 512 || C % 4 != 0 || C > kMaxChannels) return 0;
  if (C <= 1024) return 1;
  if (C <= 2048) return 2;
  return 4;
}

// out = LN(x) over (R, C) rows: warp-per-row kernels up to C = 512, a CTA
// a row above.
template <class T>
cudaError_t layer_norm(const T* x, const T* gamma, const T* beta, T* out, int R, int C,
                       float eps, cudaStream_t stream) {
  const dim3 grid((R + kWarps - 1) / kWarps);
  switch (vecs_per_lane(C)) {
    case 1: ln_fwd_kernel<1, T><<<grid, kThreads, 0, stream>>>(x, gamma, beta, out, R, C, eps); break;
    case 2: ln_fwd_kernel<2, T><<<grid, kThreads, 0, stream>>>(x, gamma, beta, out, R, C, eps); break;
    case 4: ln_fwd_kernel<4, T><<<grid, kThreads, 0, stream>>>(x, gamma, beta, out, R, C, eps); break;
    default:
      if (R <= 0) return cudaErrorInvalidValue;
      switch (vecs_per_thread(C)) {
        case 1: ln_fwd_wide_kernel<1, T><<<R, kThreads, 0, stream>>>(x, gamma, beta, out, C, eps); break;
        case 2: ln_fwd_wide_kernel<2, T><<<R, kThreads, 0, stream>>>(x, gamma, beta, out, C, eps); break;
        case 4: ln_fwd_wide_kernel<4, T><<<R, kThreads, 0, stream>>>(x, gamma, beta, out, C, eps); break;
        default: return cudaErrorInvalidValue;
      }
  }
  return cudaGetLastError();
}

// The LayerNorm backward's first pass over R rows: dx and one partial
// (kAcc, C) per CTA of rows_per_cta rows in part. resid may be null
// (kAcc = 2).
template <class T, class TD>
cudaError_t ln_backward_rows(const T* x, const TD* dy, const T* gamma, const T* resid, T* dx,
                             float* part, int R, int C, int rows_per_cta, float eps,
                             cudaStream_t stream) {
  if (rows_per_cta <= 0 || R <= 0) return cudaErrorInvalidValue;
  const int n_ctas = (R + rows_per_cta - 1) / rows_per_cta;
  const int acc = resid ? 3 : 2;
  const size_t smem = sizeof(float) * acc * C;
#define PGT_LN_BWD(NV)                                                          \
  if (resid)                                                                    \
    ln_bwd_rows_kernel<NV, true, T, TD><<<n_ctas, kThreads, smem, stream>>>(   \
        x, dy, gamma, resid, dx, part, R, C, rows_per_cta, eps);                \
  else                                                                          \
    ln_bwd_rows_kernel<NV, false, T, TD><<<n_ctas, kThreads, smem, stream>>>(  \
        x, dy, gamma, resid, dx, part, R, C, rows_per_cta, eps);                \
  break;
#define PGT_LN_BWD_WIDE(NVC)                                                    \
  if (resid)                                                                    \
    ln_bwd_rows_wide_kernel<NVC, true, T, TD><<<n_ctas, kThreads, 0, stream>>>( \
        x, dy, gamma, resid, dx, part, R, C, rows_per_cta, eps);                \
  else                                                                          \
    ln_bwd_rows_wide_kernel<NVC, false, T, TD><<<n_ctas, kThreads, 0, stream>>>(\
        x, dy, gamma, resid, dx, part, R, C, rows_per_cta, eps);                \
  break;
  switch (vecs_per_lane(C)) {
    case 1: PGT_LN_BWD(1)
    case 2: PGT_LN_BWD(2)
    case 4: PGT_LN_BWD(4)
    default:
      switch (vecs_per_thread(C)) {
        case 1: PGT_LN_BWD_WIDE(1)
        case 2: PGT_LN_BWD_WIDE(2)
        case 4: PGT_LN_BWD_WIDE(4)
        default: return cudaErrorInvalidValue;
      }
  }
#undef PGT_LN_BWD
#undef PGT_LN_BWD_WIDE
  return cudaGetLastError();
}

// The LayerNorm backward over all rows: dx, then part (n_ctas, kAcc, C)
// summed in order into sums (kAcc, C).
template <class T>
cudaError_t ln_backward(const T* x, const T* dy, const T* gamma, const T* resid, T* dx,
                        float* part, float* sums, int R, int C, int rows_per_cta, float eps,
                        cudaStream_t stream) {
  const cudaError_t err =
      ln_backward_rows(x, dy, gamma, resid, dx, part, R, C, rows_per_cta, eps, stream);
  if (err != cudaSuccess) return err;
  const int n_ctas = (R + rows_per_cta - 1) / rows_per_cta;
  return sum_slices(part, sums, n_ctas, static_cast<int64_t>(resid ? 3 : 2) * C, stream);
}

}  // namespace rows
