// Fused vector quantization over float32 rows: for (M, D) inputs x and a
// (K, D) codebook e,
//   idx[m]       = argmax_k (2 x_m . e_k - |e_k|^2), the first k on ties,
//   quantized[m] = e[idx[m]]            (the codebook row, copied exactly),
//   counts[k]    = #{m : idx[m] == k}   (as float32),
//   sums[k]      = sum of x_m over {m : idx[m] == k},
// the nearest-codebook search of the VQ-VAE forward and the batch
// statistics of its EMA codebook update.
//
// Replaces pytorch_generative_tpu/ops/vq_pallas.py::_vq_kernel (launched by
// vq_quantize_fused). Same outputs; what differs is the TPU's layout: that
// kernel pads M to a multiple of its row block, masks the padding rows out
// of the one-hot, and adds counts and sums into output tiles that its
// sequential grid revisits. CUDA blocks run in no order and nothing carries
// over between them, so this runs as three launches, none with padding or
// atomics:
//   1. vq_assign_kernel: one CTA per 64 rows (128 CTAs at M = 8192, about
//      one wave on 132 SMs). The codebook is staged in shared memory in
//      chunks of up to 128 KB (the whole 512 x 64 codebook at once),
//      transposed, with |e|^2 computed once a chunk; each of 256 threads
//      scores 4 rows against 4 codes of every 64-code tile (a 4 x 4
//      register tile over D), keeps its best (score, index) for each row,
//      and the 16 threads of a row then merge theirs by shuffles. A lower
//      index wins an equal score, and NaN wins as in torch.argmax and
//      jnp.argmax (the first NaN). Rows past M are never scored. It writes
//      idx and the quantized rows.
//   2. vq_stats_kernel: one CTA per (4 codes, slice of 256 rows); thread
//      (code, float4 of D) walks the slice's idx in row order and adds the
//      rows assigned to its code into the slice's partial sums;
//   3. vq_reduce_kernel: adds the slices' partials in slice order.
//      Every sum is taken in a fixed order and is the same run to run.
//
// What bounds it on an H100: the scores, 2 M K D FLOPs (0.54 GFLOP at M =
// 8192, K = 512, D = 64; ~8 us at 67 TFLOP/s f32) against ~4.5 MB of x,
// quantized, codebook and sums (~1.3 us at 3.35 TB/s): operations, on the
// CUDA cores (f32, no tensor cores: TF32 could change which code wins).
// The statistics walk idx in 256-row slices so that ~4,000 CTAs share it
// (one CTA walking all 8192 rows a code made it latency-bound: 0.42 ms for
// the two launches, against 0.31 ms for the plain version).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // rows per CTA of the assign pass
constexpr int kTile = 64;            // codes per register-tiled step
constexpr int kThreads = 256;        // 16 x 16 threads, 4 rows x 4 codes each
constexpr int kPad = 4;              // keeps transposed tiles' float4s aligned
constexpr int kMaxDim = 256;         // D the assign pass takes
constexpr int kChunkFloats = 32768;  // codebook floats staged at once (128 KB)
constexpr int kStatCodes = 4;        // codes per CTA of the statistics pass
constexpr int kMaxSlice = 1024;      // rows a statistics CTA walks, at most

// (s, i) beats (best, bi) under argmax's rule: larger score, then lower
// index; NaN is the largest (the first NaN wins).
__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  if (isnan(s)) return !isnan(best) || i < bi;
  if (isnan(best)) return false;
  return s > best || (s == best && i < bi);
}

__global__ void __launch_bounds__(kThreads)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                 float* __restrict__ quant, int* __restrict__ idx, int M, int K,
                 int D, int chunk) {
  extern __shared__ float smem[];
  float* xs = smem;                          // D x (kRows + kPad), transposed
  float* cs = xs + D * (kRows + kPad);       // D x (chunk + kPad), transposed
  float* ns = cs + D * (chunk + kPad);       // chunk: |e|^2
  const int xs_ld = kRows + kPad, cs_ld = chunk + kPad;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;  // rows 4 tr + i, codes 4 tc + j
  const int m0 = blockIdx.x * kRows;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    xs[d * xs_ld + r] = m0 + r < M ? x[static_cast<int64_t>(m0 + r) * D + d] : 0.f;
  }

  float best[4];
  int bi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -CUDART_INF_F;
    bi[i] = K;  // beaten by any scored code
  }

  for (int c0 = 0; c0 < K; c0 += chunk) {
    const int nc = min(chunk, K - c0);
    __syncthreads();  // every reader of the previous chunk is done
    for (int e = tid; e < nc * D; e += kThreads) {
      const int c = e / D, d = e % D;
      cs[d * cs_ld + c] = cb[static_cast<int64_t>(c0 + c) * D + d];
    }
    for (int e = nc * D + tid; e < chunk * D; e += kThreads) {
      const int c = e / D, d = e % D;  // codes past K: never scored
      cs[d * cs_ld + c] = 0.f;
    }
    __syncthreads();
    for (int c = tid; c < nc; c += kThreads) {
      float n = 0.f;
      for (int d = 0; d < D; ++d) n += cs[d * cs_ld + c] * cs[d * cs_ld + c];
      ns[c] = n;
    }
    __syncthreads();

    for (int t0 = 0; t0 < nc; t0 += kTile) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(xs + d * xs_ld + 4 * tr);
        const float4 b = *reinterpret_cast<const float4*>(cs + d * cs_ld + t0 + 4 * tc);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t0 + 4 * tc + j;
        if (c >= nc) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = 2.f * acc[i][j] - ns[c];
          if (better(s, c0 + c, best[i], bi[i])) {
            best[i] = s;
            bi[i] = c0 + c;
          }
        }
      }
    }
  }

  // The 16 threads of a row group are lanes 16 (tr % 2) + tc of one warp.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int j = __shfl_xor_sync(0xffffffffu, bi[i], o);
      if (better(s, j, best[i], bi[i])) {
        best[i] = s;
        bi[i] = j;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tr + i;
    if (m >= M) continue;
    const int k = bi[i] < K ? bi[i] : 0;  // D == 0 aside, every row scores
    if (tc == 0) idx[m] = k;
    for (int d = 4 * tc; d < D; d += 64) {
      *reinterpret_cast<float4*>(quant + static_cast<int64_t>(m) * D + d) =
          *reinterpret_cast<const float4*>(cb + static_cast<int64_t>(k) * D + d);
    }
  }
}

// Thread (j, v) of CTA (b, sl) owns code k = kStatCodes b + j and the
// float4 v of D; it adds, in row order, the rows of slice sl whose idx is
// k, into part[sl][k] (and pcount[sl][k]).
__global__ void vq_stats_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                                float* __restrict__ pcount, float* __restrict__ part,
                                int M, int K, int D, int slice) {
  __shared__ int idx_s[kMaxSlice];
  const int nv = D / 4;
  const int j = threadIdx.x / nv, v = threadIdx.x % nv;
  const int k = blockIdx.x * kStatCodes + j;
  const int m0 = blockIdx.y * slice;
  const int len = min(slice, M - m0);
  for (int e = threadIdx.x; e < len; e += blockDim.x) idx_s[e] = idx[m0 + e];
  __syncthreads();
  if (k >= K) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float n = 0.f;
  for (int e = 0; e < len; ++e) {
    if (idx_s[e] != k) continue;
    const float4 r = __ldg(reinterpret_cast<const float4*>(
        x + static_cast<int64_t>(m0 + e) * D) + v);
    acc.x += r.x; acc.y += r.y; acc.z += r.z; acc.w += r.w;
    n += 1.f;
  }
  const int64_t row = static_cast<int64_t>(blockIdx.y) * K + k;
  reinterpret_cast<float4*>(part + row * D)[v] = acc;
  if (v == 0) pcount[row] = n;
}

// sums[k][d] = sum over slices s of part[s][k][d] (and counts from
// pcount), in slice order.
__global__ void vq_reduce_kernel(const float* __restrict__ pcount,
                                 const float* __restrict__ part, float* __restrict__ counts,
                                 float* __restrict__ sums, int K, int D, int n_slices) {
  const int64_t kd = static_cast<int64_t>(K) * D;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < kd) {
    float t = 0.f;
    for (int s = 0; s < n_slices; ++s) t += part[s * kd + e];
    sums[e] = t;
  }
  if (e < K) {
    float t = 0.f;
    for (int s = 0; s < n_slices; ++s) t += pcount[static_cast<int64_t>(s) * K + e];
    counts[e] = t;
  }
}

}  // namespace

// x (M, D), codebook (K, D): contiguous float32; D a multiple of 4 up to
// 256, M and K at least 1. Writes quantized (M, D), counts (K,), sums
// (K, D) and idx (M,) int32; pcount (ceil(M / slice), K) and part
// (ceil(M / slice), K, D) are scratch, slice (rows a statistics CTA
// walks) from 1 to 1024.
extern "C" int vq_f32(const float* x, const float* codebook, float* quantized,
                      float* counts, float* sums, int* idx, float* pcount, float* part,
                      int M, int K, int D, int slice, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || D < 4 || D % 4 != 0 || D > kMaxDim || slice < 1 ||
      slice > kMaxSlice)
    return static_cast<int>(cudaErrorInvalidValue);
  // Codes staged at once: all of K (rounded up to whole tiles) if it fits.
  const int fit = (kChunkFloats / D) / kTile * kTile;
  const int chunk = min((K + kTile - 1) / kTile * kTile, fit);
  const size_t smem =
      sizeof(float) * (D * (kRows + kPad) + D * (chunk + kPad) + chunk);
  cudaError_t err = cudaFuncSetAttribute(
      vq_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_assign_kernel<<<(M + kRows - 1) / kRows, kThreads, smem, s>>>(
      x, codebook, quantized, idx, M, K, D, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (M + slice - 1) / slice;
  vq_stats_kernel<<<dim3((K + kStatCodes - 1) / kStatCodes, n_slices),
                    kStatCodes * (D / 4), 0, s>>>(x, idx, pcount, part, M, K, D, slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t kd = static_cast<int64_t>(K) * D;
  vq_reduce_kernel<<<static_cast<unsigned>((kd + 255) / 256), 256, 0, s>>>(
      pcount, part, counts, sums, K, D, n_slices);
  return static_cast<int>(cudaGetLastError());
}
