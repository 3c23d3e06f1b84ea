// The whole ImageGPT raster-scan sampler in one launch, float32.
//
// Replaces pytorch_generative_tpu/ops/decode_pallas.py::_sample_loop_kernel
// (launched by fused_sample_loop). Per raster position i, for each sample:
// the 4 live taps of the masked 3x3 type-A input conv (canvas + pos at p0,
// p0+1, p0+2, p0+Wp of the zero-padded canvas), then per block LN ->
// fused QKV -> write this position's k/v to the cache -> softmax attention
// over the cached keys <= i -> out proj -> residual -> LN -> exact-GELU MLP
// -> block residual + the model's extra skip; then the final LN, the head,
// the Bernoulli draw `u < sigmoid(logit)` and the inpainting merge (pixels
// >= 0 are kept; sampled pixels are stored as exact 0.0 or 1.0).
//
// Design: one CTA per sample. The TPU kernel's sequential grid axis over
// positions becomes a loop inside the CTA; samples are independent, so no
// CTA waits on another. Unlike the TPU's 128 MB of VMEM, a CTA has at most
// 227 KB of shared memory, so the K/V caches (n_blocks * L * (H*d_k + H*d_v)
// floats per sample, 3.2 MB at the ImageGPT reproduce config) live in a
// device scratch buffer the wrapper allocates; at small n they stay in the
// 50 MB L2. The canvas, positional embedding, activations and scores live in
// shared memory; weights are read from device memory (through L1/L2) at
// every position. What bounds it: per position each CTA streams all the
// weights (~1.6 MB at the reproduce config) and its cache prefix, with only
// n CTAs busy, so it is latency- and L2-bandwidth-bound, not FLOP-bound.
// Batching samples per CTA, clusters and a cooperative grid are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Weights {
  const float* in_w4;   // (4, C): live taps of the type-A 3x3 conv
  const float* in_b;    // (C,)
  const float* head_w;  // (C,)
  const float* head_b;  // (1,)
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
  int N, h, w, n_blocks, C, n_heads, d_k, d_v, M;
};

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every thread gets the block-wide result. `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // earlier readers of `red` are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kWarps; ++i) total += red[i];
  return total;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int i = 0; i < kWarps; ++i) m = fmaxf(m, red[i]);
  return m;
}

// dst = LayerNorm(src) * w + b over n floats in shared memory (eps 1e-5).
__device__ void layer_norm(const float* src, const float* w, const float* b,
                           float* dst, int n, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < n; c += kThreads) s += src[c];
  const float mean = block_sum(s, red) / n;
  float v = 0.f;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const float d = src[c] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / n + 1e-5f);
  for (int c = threadIdx.x; c < n; c += kThreads)
    dst[c] = (src[c] - mean) * rstd * w[c] + b[c];
  __syncthreads();
}

// out[j] = act(sum_k a[k] * W[k, j] + bias[j]) for W (K, J) row-major; the
// threads run over j, so each row of W is read coalesced.
template <bool kGelu>
__device__ void matvec(const float* a, const float* W, const float* bias,
                       float* out, int K, int J) {
  for (int j = threadIdx.x; j < J; j += kThreads) {
    float acc = bias[j];
    for (int k = 0; k < K; ++k) acc += a[k] * W[static_cast<int64_t>(k) * J + j];
    if (kGelu) acc = 0.5f * acc * (1.f + erff(acc * 0.70710678118654752f));
    out[j] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sample_loop_kernel(const float* __restrict__ canvas0,
                   const float* __restrict__ pos_pad,
                   const float* __restrict__ uniforms,
                   float* __restrict__ canvas_out, float* __restrict__ kcache,
                   float* __restrict__ vcache, Weights wt, Dims dm) {
  const int n = blockIdx.x;
  const int N = dm.N, C = dm.C, H = dm.n_heads, dk = dm.d_k, dv = dm.d_v;
  const int ck = H * dk, cv = H * dv, F = 2 * ck + cv, M = dm.M;
  const int wp = dm.w + 2, lp = (dm.h + 2) * wp, L = dm.h * dm.w;
  const int groups = kThreads / cv > 0 ? kThreads / cv : 1;
  const float scale = rsqrtf(static_cast<float>(dk));

  extern __shared__ float smem[];
  float* canvas = smem;           // lp
  float* pos = canvas + lp;       // lp
  float* x = pos + lp;            // C
  float* t = x + C;               // C
  float* x1 = t + C;              // C
  float* qkv = x1 + C;            // F (also the MLP output)
  float* att = qkv + F;           // cv
  float* hmid = att + cv;         // M
  float* sc = hmid + M;           // H * L scores, then exponentials
  float* part = sc + H * L;       // groups * cv partial sums
  float* den = part + groups * cv;  // H
  float* red = den + H;           // kWarps

  for (int p = threadIdx.x; p < lp; p += kThreads) {
    canvas[p] = canvas0[static_cast<int64_t>(p) * N + n];
    pos[p] = pos_pad[p];
  }
  __syncthreads();

  for (int i = 0; i < L; ++i) {
    const int row = i / dm.w, col = i % dm.w;
    const int p0 = row * wp + col;
    const float t0 = canvas[p0] + pos[p0];
    const float t1 = canvas[p0 + 1] + pos[p0 + 1];
    const float t2 = canvas[p0 + 2] + pos[p0 + 2];
    const float t3 = canvas[p0 + wp] + pos[p0 + wp];
    for (int c = threadIdx.x; c < C; c += kThreads)
      x[c] = wt.in_b[c] + t0 * wt.in_w4[c] + t1 * wt.in_w4[C + c] +
             t2 * wt.in_w4[2 * C + c] + t3 * wt.in_w4[3 * C + c];
    __syncthreads();

    for (int b = 0; b < dm.n_blocks; ++b) {
      float* kc = kcache + (static_cast<int64_t>(b) * N + n) * L * ck;
      float* vc = vcache + (static_cast<int64_t>(b) * N + n) * L * cv;
      layer_norm(x, wt.ln1_w + b * C, wt.ln1_b + b * C, t, C, red);
      matvec<false>(t, wt.qkv_w + static_cast<int64_t>(b) * C * F,
                    wt.qkv_b + b * F, qkv, C, F);
      // This position's k/v go into the cache before attention reads it.
      for (int j = threadIdx.x; j < ck; j += kThreads)
        kc[static_cast<int64_t>(i) * ck + j] = qkv[ck + j];
      for (int j = threadIdx.x; j < cv; j += kThreads)
        vc[static_cast<int64_t>(i) * cv + j] = qkv[2 * ck + j];
      __syncthreads();  // makes the cache writes visible to the whole CTA

      const int n_keys = i + 1;
      for (int idx = threadIdx.x; idx < H * n_keys; idx += kThreads) {
        const int hh = idx / n_keys, l = idx % n_keys;
        const float* kr = kc + static_cast<int64_t>(l) * ck + hh * dk;
        const float* qh = qkv + hh * dk;
        float dot = 0.f;
        for (int d = 0; d < dk; ++d) dot += qh[d] * kr[d];
        sc[hh * L + l] = dot * scale;
      }
      __syncthreads();
      for (int hh = 0; hh < H; ++hh) {
        float m = -CUDART_INF_F;
        for (int l = threadIdx.x; l < n_keys; l += kThreads)
          m = fmaxf(m, sc[hh * L + l]);
        m = block_max(m, red);
        float s = 0.f;
        for (int l = threadIdx.x; l < n_keys; l += kThreads) {
          const float e = expf(sc[hh * L + l] - m);
          sc[hh * L + l] = e;
          s += e;
        }
        s = block_sum(s, red);
        if (threadIdx.x == 0) den[hh] = s;
      }
      __syncthreads();
      // Weighted sum of values: `groups` thread groups split the keys.
      for (int idx = threadIdx.x; idx < groups * cv; idx += kThreads) {
        const int g = idx / cv, oc = idx % cv, hh = oc / dv;
        float acc = 0.f;
        for (int l = g; l < n_keys; l += groups)
          acc += sc[hh * L + l] * vc[static_cast<int64_t>(l) * cv + oc];
        part[g * cv + oc] = acc;
      }
      __syncthreads();
      for (int oc = threadIdx.x; oc < cv; oc += kThreads) {
        float acc = 0.f;
        for (int g = 0; g < groups; ++g) acc += part[g * cv + oc];
        att[oc] = acc / den[oc / dv];
      }
      __syncthreads();

      matvec<false>(att, wt.out_w + static_cast<int64_t>(b) * cv * C,
                    wt.out_b + b * C, t, cv, C);
      for (int c = threadIdx.x; c < C; c += kThreads) x1[c] = x[c] + t[c];
      __syncthreads();
      layer_norm(x1, wt.ln2_w + b * C, wt.ln2_b + b * C, t, C, red);
      matvec<true>(t, wt.mlp1_w + static_cast<int64_t>(b) * C * M,
                   wt.mlp1_b + b * M, hmid, C, M);
      matvec<false>(hmid, wt.mlp2_w + static_cast<int64_t>(b) * M * C,
                    wt.mlp2_b + b * C, qkv, M, C);
      // Block residual + the model-level extra skip: x = x + (x1 + mlp).
      for (int c = threadIdx.x; c < C; c += kThreads)
        x[c] = x[c] + (x1[c] + qkv[c]);
      __syncthreads();
    }

    layer_norm(x, wt.lnf_w, wt.lnf_b, t, C, red);
    float part_logit = 0.f;
    for (int c = threadIdx.x; c < C; c += kThreads)
      part_logit += t[c] * wt.head_w[c];
    const float logit = block_sum(part_logit, red) + wt.head_b[0];
    if (threadIdx.x == 0) {
      const float prob = 1.f / (1.f + expf(-logit));
      const float u = uniforms[static_cast<int64_t>(i) * N + n];
      const int pw = (row + 1) * wp + col + 1;
      if (canvas[pw] < 0.f) canvas[pw] = u < prob ? 1.f : 0.f;
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < lp; p += kThreads)
    canvas_out[static_cast<int64_t>(p) * N + n] = canvas[p];
}

}  // namespace

// canvas0, canvas_out: (Lp, N); pos_pad: (Lp,); uniforms: (L, N);
// kcache: (NB, N, L, H*d_k); vcache: (NB, N, L, H*d_v). All float32,
// contiguous, on one device.
extern "C" int sample_loop_f32(
    const float* canvas0, const float* pos_pad, const float* uniforms,
    float* canvas_out, float* kcache, float* vcache, const float* in_w4,
    const float* in_b, const float* head_w, const float* head_b,
    const float* ln1_w, const float* ln1_b, const float* qkv_w,
    const float* qkv_b, const float* out_w, const float* out_b,
    const float* ln2_w, const float* ln2_b, const float* mlp1_w,
    const float* mlp1_b, const float* mlp2_w, const float* mlp2_b,
    const float* lnf_w, const float* lnf_b, int N, int h, int w, int n_blocks,
    int C, int n_heads, int d_k, int d_v, int M, void* stream) {
  const Weights wt{in_w4, in_b, head_w, head_b, ln1_w, ln1_b, qkv_w, qkv_b,
                   out_w, out_b, ln2_w, ln2_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b,
                   lnf_w, lnf_b};
  const Dims dm{N, h, w, n_blocks, C, n_heads, d_k, d_v, M};
  const int ck = n_heads * d_k, cv = n_heads * d_v, F = 2 * ck + cv;
  const int lp = (h + 2) * (w + 2), L = h * w;
  const int groups = kThreads / cv > 0 ? kThreads / cv : 1;
  const size_t smem = sizeof(float) *
      (2 * lp + 3 * C + F + cv + M + n_heads * L + groups * cv + n_heads +
       kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      sample_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sample_loop_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      canvas0, pos_pad, uniforms, canvas_out, kcache, vcache, wt, dm);
  return cudaGetLastError();
}
