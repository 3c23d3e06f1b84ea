// One ImageGPT raster position through the whole block stack, for all N
// samples at once: float32 arithmetic, the K/V cache in float32 or bfloat16.
//
// Replaces pytorch_generative_tpu/ops/decode_pallas.py::_step_kernel
// (launched by fused_decode_step). Inputs: the position i, from device
// memory (a 0-dim int32 tensor, as the TPU kernel reads i_ref from SMEM) or
// from the host; x (N, C), the masked input conv plus the positional
// embedding at position i; the packed cache (n_blocks, N, L, ck + cv), K and
// V side by side on the last axis; the stacked weights. Per block: ln1 ->
// q|k|v = t qkv_w + qkv_b -> per head a softmax over the cached keys at
// positions < i plus this position's own key as one explicit column (cache
// positions >= i are never read) -> out proj + residual -> ln2 -> W1 ->
// exact GELU (erff) -> W2 -> x = x + (x1 + mlp), the block residual plus the
// model-level skip. Outputs: act (N, C), the final LayerNorm of x; and this
// position's k|v, rounded to the cache's type, written into the cache at
// position i in place (what the TPU kernel's caller does with its kv_new
// output, a dynamic_update_slice). The current column enters the softmax
// unrounded, as on the TPU.
//
// What bounds it: each position reads every weight once (12.6 MB a block,
// 100.7 MB in all at C = 512) and the cache prefix, for only N = 16 rows, so
// it is bound by bytes, not arithmetic; and by the chain of dependent
// phases, each of which needs whole (N, C) rows of the one before.
//
// Design: six dependent launches a block and one at the end, issued by one
// C call on one stream; no grid, shared memory size or argument depends on
// i, so one launch sequence serves every position and a CUDA graph can
// capture it.
//  1. QKV product, LayerNorm 1 folded into it (below); its epilogue writes
//     q|k|v and this position's k|v into the cache;
//  2. attention split over keys (flash-decoding): one CTA per (chunk of
//     kChunk keys, sample, head) writes a partial (max, sum, acc[d_v]); a
//     CTA whose chunk starts at or past i exits at once;
//  3. the partials' combine, one CTA per (sample, head): chunk order, the
//     current column added once;
//  4. out product, the residual in its epilogue;
//  5. MLP 1 product, LayerNorm 2 folded into it, GELU in its epilogue;
//  6. MLP 2 product, the block residual in its epilogue;
//  and the final LayerNorm, one CTA a row.
// Each product runs on thread-block clusters of 4 or 16 CTAs that split its
// reduction axis; a CTA owns 64 output columns (two a lane) and its
// rank's rows, sums them over its warps, and each rank's sums go to the
// rank that owns those outputs through distributed shared memory, where
// they are added in rank order, so every product writes final values and no
// reader sums partials. A LayerNorm on a product's input is folded into the
// product: each rank centres its columns of the rows on their own mean m_q,
// and sum_k LN(a)_k W_kj = rstd sum_q (S_qj + (m_q - mean) U_qj) + sum_k
// b_k W_kj, with S_qj = sum_k (a_k - m_q) w_k W_kj and U_qj = sum_k w_k W_kj
// over rank q's rows of K; the rows' statistics cross the cluster with the
// sums. Centring first keeps the sums free of the rows' offset: a row whose
// mean is far from 0 loses no more than the plain version's own rounding.
// Every launch carries programmatic stream serialization: a kernel lets the
// next one launch at once (griddepcontrol.launch_dependents), and the next
// one copies its weight slice (cp.async) or, for attention, its keys and
// values at positions < i (written by earlier positions) into shared memory
// before it waits for the previous phase (griddepcontrol.wait), so those
// bytes stream while the previous phase finishes. Sums are taken in a fixed
// order and no atomics are used: two runs give equal bits.
//
// What bounds it on the card is now the chain itself: each phase's latency
// (the wait for the previous launch, the input's copy from L2, the product,
// the cluster's exchange) is several times its weight bytes' time; attention
// at late positions streams near the memory rate. tools/
// torch_sampler_times.py --timeline splits a step by launch (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // a product CTA
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;          // rows of A a product CTA holds at once
constexpr int kSubRows = 256;      // weight rows a product CTA holds at once
constexpr int kChunk = 64;         // keys an attention CTA
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kCombineThreads = 64;
constexpr int kLnThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // Hopper's dynamic shared memory a CTA

enum Mode { kQkv = 0, kOut = 1, kMlp1 = 2, kMlp2 = 3 };

// A product CTA's output columns (lane l owns l and l + 32) and a product's
// CTAs a cluster (ranks, which split its K axis). Chosen on the card (H100,
// C = 512) so that every product runs in one wave of at most 128 CTAs, with
// room on each SM for the next phase's CTAs, which copy their weights
// meanwhile, and no rank holds more than 128 x 64 weights: QKV 24 tiles of
// 4 CTAs, out 8 of 16, MLP 1 32 of 4, MLP 2 (K = 4C) 8 of 16 (a cluster
// size above 8 is one Hopper allows on request).
constexpr int kTile = 64;
constexpr int kCols = kTile / 32;
__host__ __device__ constexpr int cluster_of(int mode) {
  return mode == kQkv || mode == kMlp1 ? 4 : 16;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every thread gets the block-wide sum, taken in warp order.
template <int kNWarps>
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // earlier readers of `red` are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kNWarps; ++w) total += red[w];
  return total;
}

// Programmatic dependent launch: the next kernel on the stream may start
// now; this one waits until the previous kernel has finished and its
// writes are visible. Without the launch attribute both are no-ops.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The cluster barrier in two halves: a CTA may store into another's shared
// memory only once every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The position: from device memory when given (read through L2, since it
// was written by an earlier kernel), else the host's value; clamped to
// [0, L], so that a position out of range reads no key past the cache.
__device__ __forceinline__ int position(const int* i_ptr, int i_val, int L) {
  const int i = i_ptr != nullptr ? __ldcg(i_ptr) : i_val;
  return i < 0 ? 0 : (i > L ? L : i);
}

// Whether position i is a cache position: the k|v of a position out of
// range is written nowhere.
__device__ __forceinline__ bool in_cache(const int* i_ptr, int i_val, int L) {
  const int i = i_ptr != nullptr ? __ldcg(i_ptr) : i_val;
  return i >= 0 && i < L;
}

struct ProductArgs {
  const float* W;     // (K, J) row-major, this block's
  const float* bias;  // (J,)
  int K, J, N;
  int kc;             // rows of K a rank owns, a multiple of 4
  int vec;            // W's rows copied 16 bytes at a time (J % 4 == 0, aligned)
  // A's sources.
  const float* src;   // A's rows: kQkv, kMlp1 LayerNorm'd on load; kOut the
                      // attention output; kMlp2 gelu(h)
  int src_vec;        // src's rows copied 16 bytes at a time (K % 4 == 0, aligned)
  const float* ln_w;
  const float* ln_b;
  const int* i_ptr;
  int i_val, L;
  // Epilogue.
  float* out;         // kQkv: q|k|v; kOut: x1; kMlp1: gelu(h); kMlp2: x
  const float* xin;   // kOut, kMlp2: the block's input x (may alias out)
  const float* x1;    // kMlp2
  void* cache;        // kQkv: this block's (N, L, ck + cv) of the cache's type
  int ck;             // kQkv: columns >= ck go to the cache
};

// Shared memory of a product CTA, in floats. `stat` and `recv` take what
// the other ranks store into this one (row statistics; sums of this rank's
// share of the outputs, and of U and B), in two buffers used by turns of
// row groups.
struct ProductSmem {
  int w, a, red, stat, recv, lnp, bias, epi, total;
};

__host__ __device__ inline ProductSmem product_smem(int kc, int mode) {
  ProductSmem s;
  const int sub = kc < kSubRows ? kc : kSubRows;
  const int cluster = cluster_of(mode);
  const bool ln = mode == kQkv || mode == kMlp1;
  const int x = ln ? 2 : 0;
  int at = 0;
  s.w = at;     at += sub * kTile;
  s.a = at;     at += kRows * kc;
  s.red = at;   at += kWarps * (kRows + x) * kTile;
  s.stat = at;  at += ln ? 2 * cluster * kRows * 2 : 0;
  s.recv = at;  at += 2 * (kRows * kTile + cluster * x * kTile);
  s.lnp = at;   at += ln ? 2 * kc : 0;
  s.bias = at;  at += kTile;
  s.epi = at;   at += 2 * kRows * kTile / cluster;
  s.total = at;
  return s;
}

// A rank's rows of W, s0 to s0 + sub within its kc, columns j0 to j0 +
// kTile, into w_s (zeros past K and J).
__device__ __forceinline__ void copy_weights(const ProductArgs& a, float* w_s, int sub, int j0,
                                             int k0, int kn, int s0) {
  const int rows = min(sub, kn - s0);
  if (a.vec) {
    constexpr int kQuads = kTile / 4;
    for (int idx = threadIdx.x; idx < sub * kQuads; idx += kThreads) {
      const int r = idx / kQuads, q = (idx % kQuads) * 4, j = j0 + q;
      float* dst = w_s + r * kTile + q;
      if (r < rows && j < a.J)
        cp_async16(dst, a.W + static_cast<int64_t>(k0 + s0 + r) * a.J + j);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < sub * kTile; idx += kThreads) {
      const int r = idx / kTile, j = j0 + idx % kTile;
      if (r < rows && j < a.J)
        cp_async4(w_s + idx, a.W + static_cast<int64_t>(k0 + s0 + r) * a.J + j);
      else
        w_s[idx] = 0.f;
    }
  }
  cp_async_commit();
}

// a_s (kRows, kc) = this rank's columns of rows r0.. of a.src (N, K), all
// copies in flight at once (the caller waits for them); zeros past N and K.
__device__ __forceinline__ void copy_rows(const ProductArgs& a, float* a_s, int r0, int rows,
                                          int k0, int kn) {
  if (a.src_vec) {
    const int quads = a.kc / 4;
    for (int idx = threadIdx.x; idx < kRows * quads; idx += kThreads) {
      const int r = idx / quads, k = (idx % quads) * 4;
      float* dst = a_s + r * a.kc + k;
      if (r < rows && k < kn)
        cp_async16(dst, a.src + static_cast<int64_t>(r0 + r) * a.K + k0 + k);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * a.kc; idx += kThreads) {
      const int r = idx / a.kc, k = idx % a.kc;
      if (r < rows && k < kn)
        cp_async4(a_s + idx, a.src + static_cast<int64_t>(r0 + r) * a.K + k0 + k);
      else
        a_s[idx] = 0.f;
    }
  }
  cp_async_commit();
}

template <int kMode, typename T>
__device__ __forceinline__ void epilogue(const ProductArgs& a, int n, int j, float s, float bias,
                                         const float* epi, int t, int per) {
  const int64_t o = static_cast<int64_t>(n) * a.J + j;
  if (kMode == kQkv) {
    const float v = s + bias;
    a.out[o] = v;
    if (j >= a.ck && in_cache(a.i_ptr, a.i_val, a.L)) {
      const int i = a.i_ptr != nullptr ? __ldcg(a.i_ptr) : a.i_val;
      const int fc = a.J - a.ck;
      store(static_cast<T*>(a.cache) + (static_cast<int64_t>(n) * a.L + i) * fc + (j - a.ck), v);
    }
  } else if (kMode == kOut) {
    a.out[o] = epi[t] + (s + bias);
  } else if (kMode == kMlp1) {
    a.out[o] = gelu(s + bias);
  } else {
    a.out[o] = epi[t] + (epi[per + t] + (s + bias));
  }
}

// out (N, J) = epilogue(A W), W (K, J). Grid: kCl CTAs (ranks) per kTile
// columns; rank r owns K rows r kc .. r kc + kc. Lane l owns columns j0 +
// l, j0 + l + 32, ...; warp w takes the rank's rows in blocks of 4, w, w +
// kWarps, ...; the warps' sums meet in shared memory in warp order; each
// rank stores its sums of the tile's outputs into the rank that owns them
// (kPer outputs a rank), which adds the ranks' sums in rank order after the
// cluster barrier and applies the epilogue.
// With a LayerNorm on load (kQkv, kMlp1), LN(a)_k = (a_k - mean) rstd w_k +
// b_k, each rank first centres its columns of each row on their own mean
// m_q (in shared memory) and sends the row's sum and squared deviations to
// every rank; the product then takes S_qj = sum_k (a_k - m_q) (w_k W_kj)
// with U_qj = sum_k w_k W_kj and B_qj = sum_k b_k W_kj over the rank's rows
// of K, and the owner combines them in rank order: mean = sum / K, M2 =
// sum_q (M2_q + kn_q (m_q - mean)^2), out_j = rstd sum_q (S_qj + (m_q -
// mean) U_qj) + sum_q B_qj. The product needs no global statistic, and no
// sum carries the rows' offset (S_j - mean U_j on raw rows cancels).
template <int kMode, typename T>
__global__ void __launch_bounds__(kThreads) decode_proj_kernel(const ProductArgs a) {
  constexpr int kCl = cluster_of(kMode), kPer = kRows * kTile / kCl;
  constexpr bool kLn = kMode == kQkv || kMode == kMlp1;
  constexpr int kX = kLn ? 2 : 0;  // the rows U and B
  launch_dependents();
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = (blockIdx.x / kCl) * kTile;
  const int k0 = rank * a.kc;
  const int kn = max(0, min(a.kc, a.K - k0));
  const int sub = a.kc < kSubRows ? a.kc : kSubRows;
  const int n_sub = (kn + sub - 1) / sub;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const ProductSmem lay = product_smem(a.kc, kMode);
  float* w_s = smem + lay.w;
  float* a_s = smem + lay.a;
  float* red = smem + lay.red;
  float* lnp = smem + lay.lnp;   // kLn: this rank's w | b of the LayerNorm
  float* bias_s = smem + lay.bias;
  float* epi = smem + lay.epi;   // kOut: x; kMlp2: x, x1 at the outputs this rank owns

  // The weights, LayerNorm parameters and biases do not depend on the
  // previous phase: they stream in while it finishes.
  if (kLn) {
    for (int k = threadIdx.x; k < a.kc; k += kThreads) {
      if (k < kn) {
        cp_async4(lnp + k, a.ln_w + k0 + k);
        cp_async4(lnp + a.kc + k, a.ln_b + k0 + k);
      } else {
        lnp[k] = lnp[a.kc + k] = 0.f;
      }
    }
  }
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    if (j0 + c < a.J) cp_async4(bias_s + c, a.bias + j0 + c);
  }
  if (n_sub > 0) copy_weights(a, w_s, sub, j0, k0, kn, 0);
  wait_previous();
  cluster_wait();  // every rank has started: stores into its shared memory may begin

  for (int r0 = 0, turn = 0; r0 < a.N; r0 += kRows, turn ^= 1) {
    const int rows = min(kRows, a.N - r0);
    copy_rows(a, a_s, r0, rows, k0, kn);
    if (kMode == kOut || kMode == kMlp2) {
      for (int t = threadIdx.x; t < kPer; t += kThreads) {
        const int idx = rank * kPer + t, r = idx / kTile, j = j0 + idx % kTile;
        if (r < rows && j < a.J) {
          const int64_t o = static_cast<int64_t>(r0 + r) * a.J + j;
          cp_async4(epi + t, a.xin + o);
          if (kMode == kMlp2) cp_async4(epi + kPer + t, a.x1 + o);
        }
      }
    }
    cp_async_commit();
    float* recv = smem + lay.recv + turn * (kRows * kTile + kCl * kX * kTile);
    float* stat = smem + lay.stat + turn * kCl * kRows * 2;
    if (kLn) {  // centre this rank's columns of each row; its statistics to every rank
      cp_async_wait_all();
      __syncthreads();  // a_s is complete
      for (int r = warp; r < kRows; r += kWarps) {
        float* v = a_s + r * a.kc;
        float s = 0.f;
        for (int k = lane; k < kn; k += 32) s += v[k];
        s = warp_sum(s);
        const float mean = kn > 0 ? s / kn : 0.f;
        float m2 = 0.f;
        for (int k = lane; k < kn; k += 32) {
          const float d = v[k] - mean;
          v[k] = d;
          m2 += d * d;
        }
        m2 = warp_sum(m2);
        if (lane < kCl) {
          float* dst = cluster.map_shared_rank(stat, lane) + (rank * kRows + r) * 2;
          dst[0] = s;
          dst[1] = m2;
        }
      }
    }
    float acc[kRows + kX][kCols];
#pragma unroll
    for (int r = 0; r < kRows + kX; ++r)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[r][cc] = 0.f;
    for (int s = 0; s < n_sub; ++s) {
      if (n_sub > 1 && (s > 0 || r0 > 0)) {
        __syncthreads();  // every warp is done with the previous rows
        copy_weights(a, w_s, sub, j0, k0, kn, s * sub);
      }
      cp_async_wait_all();
      __syncthreads();  // the weights and a_s are complete
      const int kb = min(sub, kn - s * sub);
      const float* as = a_s + s * sub;
      for (int k = 4 * warp; k < kb; k += 4 * kWarps) {
        float w[4][kCols];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) w[u][cc] = w_s[(k + u) * kTile + lane + 32 * cc];
        if (kLn) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float lw = lnp[s * sub + k + u], lb = lnp[a.kc + s * sub + k + u];
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc) {
              acc[kRows][cc] = fmaf(lw, w[u][cc], acc[kRows][cc]);
              acc[kRows + 1][cc] = fmaf(lb, w[u][cc], acc[kRows + 1][cc]);
              w[u][cc] *= lw;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(as + r * a.kc + k);
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            float t = acc[r][cc];
            t = fmaf(av.x, w[0][cc], t);
            t = fmaf(av.y, w[1][cc], t);
            t = fmaf(av.z, w[2][cc], t);
            acc[r][cc] = fmaf(av.w, w[3][cc], t);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows + kX; ++r)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        red[(warp * (kRows + kX) + r) * kTile + lane + 32 * cc] = acc[r][cc];
    cp_async_wait_all();  // a rank without rows of K skipped the product's wait
    __syncthreads();
    for (int idx = threadIdx.x; idx < (kRows + kX) * kTile; idx += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * (kRows + kX) * kTile + idx];
      if (idx < kRows * kTile) {
        cluster.map_shared_rank(recv, idx / kPer)[rank * kPer + idx % kPer] = s;
      } else {  // U and B, to every rank
        const int e = idx - kRows * kTile;
        for (int q = 0; q < kCl; ++q)
          cluster.map_shared_rank(recv, q)[kRows * kTile + rank * kX * kTile + e] = s;
      }
    }
    cluster.sync();  // every rank's sums of this rank's share (and statistics) are here
    for (int t = threadIdx.x; t < kPer; t += kThreads) {
      const int idx = rank * kPer + t;
      const int r = idx / kTile, c = idx % kTile, j = j0 + c;
      float s = 0.f;
      if (kLn) {
        float total = 0.f;
        for (int q = 0; q < kCl; ++q) total += stat[(q * kRows + r) * 2];
        const float mean = total / a.K;
        float m2 = 0.f, b = 0.f;
        for (int q = 0; q < kCl; ++q) {
          const int nq = min(a.kc, a.K - q * a.kc);
          if (nq <= 0) continue;  // a rank without rows of K sent zeros
          const float d = stat[(q * kRows + r) * 2] / nq - mean;  // m_q - mean
          m2 += stat[(q * kRows + r) * 2 + 1] + nq * d * d;
          s += recv[q * kPer + t] + d * recv[kRows * kTile + (q * kX + 0) * kTile + c];
          b += recv[kRows * kTile + (q * kX + 1) * kTile + c];
        }
        s = rsqrtf(m2 / a.K + 1e-5f) * s + b;
      } else {
        for (int q = 0; q < kCl; ++q) s += recv[q * kPer + t];
      }
      if (r < rows && j < a.J) epilogue<kMode, T>(a, r0 + r, j, s, bias_s[c], epi, t, kPer);
    }
  }
}

// One CTA per (chunk c of kChunk keys, sample n, head h): the partial
// softmax of q . k over the chunk's cached keys at positions < i, part
// (nch, N H, dv + 2) = (max m, sum of exp(s - m), sum of exp(s - m) v). A
// chunk that starts at or past i has no keys and writes nothing. The keys and values are copied
// into shared memory before the wait for the QKV product (they were
// written at earlier positions); q is read after it.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_kernel(const int* i_ptr, int i_val, const float* __restrict__ qkv,
                   const T* __restrict__ cache, float* __restrict__ part, int N, int L, int H,
                   int dk, int dv, int nch, int vec, float scale) {
  launch_dependents();
  const int i = position(i_ptr, i_val, L);
  // Chunk-major, so that the CTAs of the chunks with keys come first.
  const int c = blockIdx.x / (N * H), nh = blockIdx.x % (N * H);
  const int l0 = c * kChunk;
  if (l0 >= i) {
    wait_previous();  // the grid ends only after the phase before it
    return;
  }
  const int n = nh / H, h = nh % H;
  const int nk = min(kChunk, i - l0);
  const int ck = H * dk, fc = ck + H * dv, F = 2 * ck + H * dv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ float4 sm4[];
  T* ks = reinterpret_cast<T*>(sm4);            // kChunk * dk
  T* vs = ks + kChunk * dk;                     // kChunk * dv
  float* q = reinterpret_cast<float*>(vs + kChunk * dv);  // dk
  float* sc = q + dk;                           // kChunk
  float* red = sc + kChunk;                     // groups * dv

  const T* rows = cache + (static_cast<int64_t>(n) * L + l0) * fc;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int kq = dk / V, vq = dv / V;
    for (int idx = threadIdx.x; idx < nk * kq; idx += kAttnThreads) {
      const int l = idx / kq, e = (idx % kq) * V;
      cp_async16(ks + l * dk + e, rows + static_cast<int64_t>(l) * fc + h * dk + e);
    }
    for (int idx = threadIdx.x; idx < nk * vq; idx += kAttnThreads) {
      const int l = idx / vq, e = (idx % vq) * V;
      cp_async16(vs + l * dv + e, rows + static_cast<int64_t>(l) * fc + ck + h * dv + e);
    }
    cp_async_commit();
  } else {
    for (int idx = threadIdx.x; idx < nk * dk; idx += kAttnThreads) {
      const int l = idx / dk, e = idx % dk;
      ks[idx] = rows[static_cast<int64_t>(l) * fc + h * dk + e];
    }
    for (int idx = threadIdx.x; idx < nk * dv; idx += kAttnThreads) {
      const int l = idx / dv, e = idx % dv;
      vs[idx] = rows[static_cast<int64_t>(l) * fc + ck + h * dv + e];
    }
  }
  wait_previous();
  for (int e = threadIdx.x; e < dk; e += kAttnThreads)
    q[e] = qkv[static_cast<int64_t>(n) * F + h * dk + e] * scale;
  cp_async_wait_all();
  __syncthreads();

  for (int l = warp; l < nk; l += kAttnWarps) {
    float d = 0.f;
    for (int e = lane; e < dk; e += 32) d += q[e] * load(ks + l * dk + e);
    d = warp_sum(d);
    if (lane == 0) sc[l] = d;
  }
  __syncthreads();
  float* pt = part + (static_cast<int64_t>(c) * N * H + nh) * (dv + 2);
  if (warp == 0) {
    float m = -CUDART_INF_F;
    for (int l = lane; l < nk; l += 32) m = fmaxf(m, sc[l]);
    m = warp_max(m);
    float s = 0.f;
    for (int l = lane; l < nk; l += 32) {
      const float e = expf(sc[l] - m);
      sc[l] = e;
      s += e;
    }
    s = warp_sum(s);
    if (lane == 0) {
      pt[0] = m;
      pt[1] = s;
    }
  }
  __syncthreads();
  const int groups = kAttnThreads / dv > 0 ? kAttnThreads / dv : 1;
  for (int idx = threadIdx.x; idx < groups * dv; idx += kAttnThreads) {
    const int g = idx / dv, e = idx % dv;
    float acc = 0.f;
    for (int l = g; l < nk; l += groups) acc += sc[l] * load(vs + l * dv + e);
    red[idx] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < dv; e += kAttnThreads) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += red[g * dv + e];
    pt[2 + e] = s;
  }
}

// One CTA per (sample n, head h): the attention output att[n, h dv + d] =
// (sum_c f_c acc_c[d] + e_self v[d]) / (sum_c f_c s_c + e_self), with
// f_c = exp(m_c - M), e_self = exp(s_self - M), M the largest of the
// chunks' maxima and s_self, the score of this position's own unrounded
// key; sums in chunk order. Each thread's first kBatch chunks' acc are
// loaded while warp 0 finds the factors.
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const int* i_ptr, int i_val, const float* __restrict__ qkv,
                      const float* __restrict__ part, float* __restrict__ att, int N, int L,
                      int H, int dk, int dv, int nch, float scale) {
  constexpr int kBatch = 16;
  launch_dependents();
  wait_previous();
  const int i = position(i_ptr, i_val, L);
  const int nca = min(nch, (i + kChunk - 1) / kChunk);  // chunks with keys
  const int nh = blockIdx.x, n = nh / H, h = nh % H;
  const int ck = H * dk, F = 2 * ck + H * dv, pw = dv + 2;
  const int64_t cs = static_cast<int64_t>(N) * H * pw;  // a chunk's partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* pt = part + static_cast<int64_t>(nh) * pw;
  const float* row = qkv + static_cast<int64_t>(n) * F;
  extern __shared__ float f[];  // factors (nch), chunk sums (nch), e_self, denominator
  float v[kBatch];
  const int d0 = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kBatch; ++c) v[c] = d0 < dv && c < nca ? pt[c * cs + 2 + d0] : 0.f;
  if (warp == 0) {
    float dot = 0.f, m = -CUDART_INF_F;
    for (int e = lane; e < dk; e += 32) dot += (row[h * dk + e] * scale) * row[ck + h * dk + e];
    for (int c = lane; c < nca; c += 32) {
      const float mc = pt[c * cs], sc = pt[c * cs + 1];
      f[c] = mc;
      f[nch + c] = sc;
      m = fmaxf(m, mc);
    }
    const float s_self = warp_sum(dot);
    m = fmaxf(warp_max(m), s_self);
    float denom = 0.f;
    for (int c = lane; c < nca; c += 32) {
      const float fc = expf(f[c] - m);
      f[c] = fc;
      denom += fc * f[nch + c];
    }
    denom = warp_sum(denom);
    if (lane == 0) {
      const float e_self = expf(s_self - m);
      f[2 * nch] = e_self;
      f[2 * nch + 1] = denom + e_self;
    }
  }
  __syncthreads();
  for (int d = d0; d < dv; d += kCombineThreads) {
    float num = 0.f;
    if (d == d0) {
#pragma unroll
      for (int c = 0; c < kBatch; ++c)
        if (c < nca) num += f[c] * v[c];
    } else {
      for (int c = 0; c < min(nca, kBatch); ++c) num += f[c] * pt[c * cs + 2 + d];
    }
    for (int c = kBatch; c < nca; ++c) num += f[c] * pt[c * cs + 2 + d];
    att[static_cast<int64_t>(n) * H * dv + h * dv + d] =
        (num + f[2 * nch] * row[2 * ck + h * dv + d]) / f[2 * nch + 1];
  }
}

// One CTA per row: out = LayerNorm(x) * w + b.
__global__ void __launch_bounds__(kLnThreads)
decode_lnf_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ out, int C) {
  launch_dependents();
  extern __shared__ float row[];  // C, then kLnThreads / 32
  float* red = row + C;
  wait_previous();
  const int64_t off = static_cast<int64_t>(blockIdx.x) * C;
  float s1 = 0.f;
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    row[c] = x[off + c];
    s1 += row[c];
  }
  const float mean = block_sum<kLnThreads / 32>(s1, red) / C;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    const float d = row[c] - mean;
    s2 += d * d;
  }
  const float rstd = rsqrtf(block_sum<kLnThreads / 32>(s2, red) / C + 1e-5f);
  for (int c = threadIdx.x; c < C; c += kLnThreads)
    out[off + c] = (row[c] - mean) * rstd * w[c] + b[c];
}

struct Weights {
  const float* ln1_w;   // (NB, C)
  const float* ln1_b;
  const float* qkv_w;   // (NB, C, 2*ck + cv)
  const float* qkv_b;   // (NB, 2*ck + cv)
  const float* out_w;   // (NB, cv, C)
  const float* out_b;   // (NB, C)
  const float* ln2_w;   // (NB, C)
  const float* ln2_b;
  const float* mlp1_w;  // (NB, C, M)
  const float* mlp1_b;  // (NB, M)
  const float* mlp2_w;  // (NB, M, C)
  const float* mlp2_b;  // (NB, C)
  const float* lnf_w;   // (C,)
  const float* lnf_b;
};

struct Dims {
  int N, L, NB, C, H, dk, dv, M;
  int ck() const { return H * dk; }
  int cv() const { return H * dv; }
  int F() const { return 2 * H * dk + H * dv; }
  int nch() const { return (L + kChunk - 1) / kChunk; }
};

// Rows of K a rank owns, a multiple of 4.
int rank_rows(int K, int mode) {
  const int cluster = cluster_of(mode);
  return ((K + cluster - 1) / cluster + 3) / 4 * 4;
}

size_t proj_smem(int K, int mode, const Dims& d) {
  return sizeof(float) * product_smem(rank_rows(K, mode), mode).total;
}

template <typename T>
size_t attn_smem(const Dims& d) {
  const int groups = kAttnThreads / d.dv > 0 ? kAttnThreads / d.dv : 1;
  return sizeof(T) * kChunk * (d.dk + d.dv) + sizeof(float) * (d.dk + kChunk + groups * d.dv);
}

size_t combine_smem(const Dims& d) { return sizeof(float) * (2 * d.nch() + 2); }

template <typename T>
size_t max_smem(const Dims& d) {
  size_t m = attn_smem<T>(d) > combine_smem(d) ? attn_smem<T>(d) : combine_smem(d);
  const int Ks[] = {d.C, d.cv(), d.C, d.M};
  for (int mode = 0; mode < 4; ++mode) {
    const size_t s = proj_smem(Ks[mode], mode, d);
    m = s > m ? s : m;
  }
  const size_t ln = sizeof(float) * (d.C + kLnThreads / 32);
  return ln > m ? ln : m;
}

// Lets a kernel take `smem` bytes of dynamic shared memory and, on
// clusters of more than 8 CTAs, a cluster size above the portable 8.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, int cluster) {
  cudaError_t err = cudaSuccess;
  if (cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess || smem <= kDefaultSmem) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int blocks, int threads, size_t smem, int cluster,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = configure(kernel, smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (cluster > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = cluster;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[n].val.programmaticStreamSerializationAllowed = 1;
  ++n;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kMode, typename T>
cudaError_t product(ProductArgs a, const Dims& d, cudaStream_t stream) {
  a.kc = rank_rows(a.K, kMode);
  a.vec = a.J % 4 == 0 && reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
  a.src_vec = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.src) % 16 == 0;
  a.N = d.N;
  a.L = d.L;
  const int tiles = (a.J + kTile - 1) / kTile;
  return launch(decode_proj_kernel<kMode, T>, tiles * cluster_of(kMode), kThreads,
                proj_smem(a.K, kMode, d), cluster_of(kMode), stream, a);
}

template <typename T>
cudaError_t run_step(const int* i_ptr, int i_val, const float* x, T* cache, float* act,
                     float* scratch, const Weights& wt, const Dims& d,
                     cudaStream_t stream) {
  if (max_smem<T>(d) > kMaxSmem) return cudaErrorInvalidValue;
  const int C = d.C, F = d.F(), M = d.M, ck = d.ck(), cv = d.cv(), fc = ck + cv;
  const int64_t nc = static_cast<int64_t>(d.N) * C;
  float* xs = scratch;  // the running x
  float* x1 = xs + nc;  // x + attention
  float* qkv = x1 + nc;
  float* hid = qkv + static_cast<int64_t>(d.N) * F;
  float* att = hid + static_cast<int64_t>(d.N) * M;
  float* part = att + static_cast<int64_t>(d.N) * cv;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(d.dk)));
  constexpr int V = 16 / sizeof(T);
  const bool attn_vec = d.dk % V == 0 && d.dv % V == 0 &&
                        reinterpret_cast<uintptr_t>(cache) % 16 == 0;
  const int64_t cache_stride = static_cast<int64_t>(d.N) * d.L * fc;  // a block's
  cudaError_t err;
  for (int b = 0; b < d.NB; ++b) {
    const float* xin = b == 0 ? x : xs;
    T* cache_b = cache + static_cast<int64_t>(b) * cache_stride;
    ProductArgs a = {};
    a.i_ptr = i_ptr;
    a.i_val = i_val;

    a.W = wt.qkv_w + static_cast<int64_t>(b) * C * F;
    a.bias = wt.qkv_b + static_cast<int64_t>(b) * F;
    a.K = C;
    a.J = F;
    a.src = xin;
    a.ln_w = wt.ln1_w + static_cast<int64_t>(b) * C;
    a.ln_b = wt.ln1_b + static_cast<int64_t>(b) * C;
    a.out = qkv;
    a.cache = cache_b;
    a.ck = ck;
    if ((err = product<kQkv, T>(a, d, stream)) != cudaSuccess) return err;

    err = launch(decode_attn_kernel<T>, d.N * d.H * d.nch(), kAttnThreads, attn_smem<T>(d), 1,
                 stream, i_ptr, i_val, static_cast<const float*>(qkv),
                 static_cast<const T*>(cache_b), part, d.N, d.L, d.H, d.dk, d.dv, d.nch(),
                 static_cast<int>(attn_vec), scale);
    if (err != cudaSuccess) return err;
    err = launch(decode_combine_kernel, d.N * d.H, kCombineThreads, combine_smem(d), 1,
                 stream, i_ptr, i_val, static_cast<const float*>(qkv),
                 static_cast<const float*>(part), att, d.N, d.L, d.H, d.dk, d.dv, d.nch(),
                 scale);
    if (err != cudaSuccess) return err;

    a.W = wt.out_w + static_cast<int64_t>(b) * cv * C;
    a.bias = wt.out_b + static_cast<int64_t>(b) * C;
    a.K = cv;
    a.J = C;
    a.src = att;
    a.out = x1;
    a.xin = xin;
    if ((err = product<kOut, T>(a, d, stream)) != cudaSuccess) return err;

    a.W = wt.mlp1_w + static_cast<int64_t>(b) * C * M;
    a.bias = wt.mlp1_b + static_cast<int64_t>(b) * M;
    a.K = C;
    a.J = M;
    a.src = x1;
    a.ln_w = wt.ln2_w + static_cast<int64_t>(b) * C;
    a.ln_b = wt.ln2_b + static_cast<int64_t>(b) * C;
    a.out = hid;
    if ((err = product<kMlp1, T>(a, d, stream)) != cudaSuccess) return err;

    a.W = wt.mlp2_w + static_cast<int64_t>(b) * M * C;
    a.bias = wt.mlp2_b + static_cast<int64_t>(b) * C;
    a.K = M;
    a.J = C;
    a.src = hid;
    a.xin = xin;
    a.x1 = x1;
    a.out = xs;
    if ((err = product<kMlp2, T>(a, d, stream)) != cudaSuccess) return err;
  }
  return launch(decode_lnf_kernel, d.N, kLnThreads, sizeof(float) * (C + kLnThreads / 32), 1,
                stream, d.NB > 0 ? static_cast<const float*>(xs) : x, wt.lnf_w,
                wt.lnf_b, act, C);
}

}  // namespace

// Floats of device scratch the step needs: x and x1 (N, C), q|k|v
// (N, 2 ck + cv), the MLP's hidden units (N, M), the attention output (N,
// cv) and its partials (ceil(L / kChunk), N * n_heads, d_v + 2).
extern "C" long long decode_step_scratch_floats(int N, int L, int C, int n_heads, int d_k,
                                                int d_v, int M) {
  const Dims d{N, L, 0, C, n_heads, d_k, d_v, M};
  return 2LL * N * C + static_cast<long long>(N) * d.F() + static_cast<long long>(N) * M +
         static_cast<long long>(N) * d.cv() +
         static_cast<long long>(N) * n_heads * d.nch() * (d_v + 2);
}

// The most dynamic shared memory a CTA of the step takes, in bytes; the
// step refuses (cudaErrorInvalidValue) widths where it exceeds 232,448.
extern "C" long long decode_step_smem_bytes(int N, int L, int C, int n_heads, int d_k, int d_v,
                                            int M, int bf16_cache) {
  const Dims d{N, L, 0, C, n_heads, d_k, d_v, M};
  return static_cast<long long>(bf16_cache ? max_smem<__nv_bfloat16>(d) : max_smem<float>(d));
}

// i_ptr: the position as one int32 in device memory, or null to take i;
// x, act: (N, C) float32; cache: (NB, N, L, ck + cv) of the cache's type,
// read at positions < i and written at i; scratch:
// decode_step_scratch_floats floats; weights as stacked by
// ops/decode_cuda.py. All contiguous, on one device; 0 <= i < L.
#define DECODE_STEP_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(                                                                 \
      const int* i_ptr, int i, const float* x, void* cache, float* act, float* scratch, \
      const float* ln1_w, const float* ln1_b, const float* qkv_w, const float* qkv_b,   \
      const float* out_w, const float* out_b, const float* ln2_w, const float* ln2_b,   \
      const float* mlp1_w, const float* mlp1_b, const float* mlp2_w,                    \
      const float* mlp2_b, const float* lnf_w, const float* lnf_b, int N, int L,        \
      int n_blocks, int C, int n_heads, int d_k, int d_v, int M, void* stream) {          \
    const Weights wt{ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_w,                  \
                     ln2_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b, lnf_w, lnf_b};             \
    const Dims d{N, L, n_blocks, C, n_heads, d_k, d_v, M};                             \
    return run_step<T>(i_ptr, i, x, static_cast<T*>(cache), act, scratch, wt, d,       \
                       static_cast<cudaStream_t>(stream));                             \
  }

DECODE_STEP_ENTRY(decode_step_f32, float)
DECODE_STEP_ENTRY(decode_step_bf16, __nv_bfloat16)
