// One ImageGPT raster position through the whole block stack, for all N
// samples at once: float32 arithmetic, the K/V cache in float32 or bfloat16.
//
// Replaces pytorch_generative_tpu/ops/decode_pallas.py::_step_kernel
// (launched by fused_decode_step). Inputs: x (N, C), the masked input conv
// plus the positional embedding at position i; the packed cache
// (n_blocks, N, L, ck + cv), K and V side by side on the last axis; the
// stacked weights. Per block: ln1 -> q|k|v = t qkv_w + qkv_b -> per head a
// softmax over the cached keys at positions < i plus this position's own
// key as one explicit column (cache positions >= i are never read) -> out
// proj + residual -> ln2 -> W1 -> exact GELU (erff) -> W2 -> x = x + (x1 +
// mlp), the block residual plus the model-level skip. Outputs: act (N, C),
// the final LayerNorm of x; and this position's k|v, rounded to the cache's
// type, written into the cache at position i in place (what the TPU
// kernel's caller does with its kv_new output, a dynamic_update_slice). The
// current column enters the softmax unrounded, as on the TPU.
//
// What bounds it: each position reads every weight once (12.6 MB a block,
// 100.7 MB in all at C = 512) and the cache prefix, for only N = 16 rows, so
// it is bound by bytes, not arithmetic. The TPU kernel walks the blocks as a
// sequential grid and carries x in VMEM; on Hopper the blocks of one
// position are a chain of dependent phases that each need whole (N, C)
// rows. Design: a sequence of ordinary launches on one stream, 7 per block
// (QKV product, attention, out product, residual + ln2, W1 product, W2
// product, residual + the next LayerNorm), issued by one C call. Chosen over
// one cooperative persistent launch with grid syncs because nothing can
// deadlock or depend on co-residency, and every phase sizes its own grid;
// the cost is ~57 launch latencies a position, which a CUDA graph or a
// persistent kernel can remove later. Each product splits its output
// columns (128 per CTA, 4 per lane, coalesced) and its reduction axis over
// ~264 CTAs, so every weight byte is read once per position and used for
// all N rows while in registers; the K-split partials are summed in a
// fixed order by whoever reads the product (no atomics: two runs give the
// same bits). Attention runs one CTA per (sample, head) over the i cached
// positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileJ = 128;       // output columns per CTA of a product
constexpr int kRowGroup = 16;     // rows of A a product CTA holds at once
constexpr int kTargetCtas = 264;  // two per SM of an H100; fixed, so the
                                  // summation order does not depend on the card
constexpr int kMaxSplit = 32;     // most K-split partials a reader sums
constexpr int kMaxChunk = 256;    // most K rows per product CTA
constexpr int kRowThreads = 512;   // one row CTA per sample
constexpr int kAttnThreads = 512;  // one attention CTA per (sample, head)
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kKeysPerWarp = 8;    // keys a warp scores at once
constexpr int kValuesInFlight = 8; // value loads a thread issues at once

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

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every thread gets the block-wide result, summed in warp order.
template <int kNWarps = kWarps>
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // earlier readers of `red` are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kNWarps; ++w) total += red[w];
  return total;
}

template <int kNWarps = kWarps>
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = -CUDART_INF_F;
  for (int w = 0; w < kNWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// sum_{p < n} src[p * stride] in a fixed order: eight interleaved partial
// sums, so that eight loads are in flight, added pairwise at the end.
__device__ __forceinline__ float sum_strided(const float* src, int n, int64_t stride) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int p = 0;
  for (; p + 7 < n; p += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] += src[(p + u) * stride];
  }
  for (; p < n; ++p) s[0] += src[p * stride];
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// P[ks, n, j] = sum over the k of chunk ks of A[n, k] * W[k, j], W (K, J)
// row-major. With kGelu, A[n, k] = gelu(sum_s Pa[s, n, k] + a_bias[k]), the
// previous product's ksa partials. Grid: (column tiles, K chunks of kc).
// Lane l owns columns j0 + l + 32 c, c < 4, so each load of a W row is one
// coalesced 128-byte line per warp; warp w takes the chunk's rows w, w + 8,
// ...; the 8 warps' sums meet in shared memory in warp order.
template <bool kGelu>
__global__ void __launch_bounds__(kThreads)
decode_gemv_kernel(const float* __restrict__ A, int ksa,
                   const float* __restrict__ a_bias,
                   const float* __restrict__ W, float* __restrict__ P, int N,
                   int K, int J, int kc) {
  extern __shared__ float smem[];
  float* a_s = smem;                   // kRowGroup * kc
  float* red = a_s + kRowGroup * kc;   // kWarps * kRowGroup * kTileJ
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kTileJ;
  const int k0 = blockIdx.y * kc;
  const int kn = min(kc, K - k0);

  for (int r0 = 0; r0 < N; r0 += kRowGroup) {
    const int rows = min(kRowGroup, N - r0);
    for (int idx = threadIdx.x; idx < kRowGroup * kn; idx += kThreads) {
      const int r = idx / kn, k = idx % kn;
      float v = 0.f;  // rows past N hold zeros
      if (r < rows) {
        const int64_t off = static_cast<int64_t>(r0 + r) * K + k0 + k;
        if (kGelu) {
          v = gelu(sum_strided(A + off, ksa, static_cast<int64_t>(N) * K) + a_bias[k0 + k]);
        } else {
          v = A[off];
        }
      }
      a_s[r * kc + k] = v;
    }
    __syncthreads();

    float acc[kRowGroup][4];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
    for (int k = warp; k < kn; k += kWarps) {
      const float* wrow = W + static_cast<int64_t>(k0 + k) * J;
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + lane + 32 * c;
        wv[c] = j < J ? wrow[j] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        const float a = a_s[r * kc + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a * wv[c];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * kRowGroup + r) * kTileJ + lane + 32 * c] = acc[r][c];
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * kTileJ; idx += kThreads) {
      const int r = idx / kTileJ, jj = idx % kTileJ, j = j0 + jj;
      if (j < J) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[(w * kRowGroup + r) * kTileJ + jj];
        P[(static_cast<int64_t>(blockIdx.y) * N + r0 + r) * J + j] = s;
      }
    }
    __syncthreads();  // a_s and red are refilled by the next row group
  }
}

// One CTA per row n: v = base + s, or base + (extra + s) when `extra` is
// given, with s = sum_p P[p, n] + bias (v = base when P is null); out_x = v
// when given (it may alias base); out_t = LayerNorm(v) * ln_w + ln_b.
__global__ void __launch_bounds__(kRowThreads)
decode_rows_kernel(const float* base, const float* extra,
                   const float* __restrict__ P, int ksp,
                   const float* __restrict__ bias, float* out_x,
                   const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, float* __restrict__ out_t,
                   int N, int C) {
  extern __shared__ float row[];  // C, then kRowThreads / 32
  float* red = row + C;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * C;
  float s1 = 0.f;
  for (int c = threadIdx.x; c < C; c += kRowThreads) {
    float v = base[off + c];
    if (P != nullptr) {
      const float s = sum_strided(P + off + c, ksp, static_cast<int64_t>(N) * C) + bias[c];
      v = extra != nullptr ? v + (extra[off + c] + s) : v + s;
    }
    row[c] = v;
    if (out_x != nullptr) out_x[off + c] = v;
    s1 += v;
  }
  const float mean = block_sum<kRowThreads / 32>(s1, red) / C;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += kRowThreads) {
    const float d = row[c] - mean;
    s2 += d * d;
  }
  const float rstd = rsqrtf(block_sum<kRowThreads / 32>(s2, red) / C + 1e-5f);
  for (int c = threadIdx.x; c < C; c += kRowThreads)
    out_t[off + c] = (row[c] - mean) * rstd * ln_w[c] + ln_b[c];
}

// One CTA per (sample n, head h). q|k|v of this position are the sum of the
// QKV product's ksp partials plus qkv_b; k and v go to the cache at position
// i in its type (no CTA reads that position). Softmax over the scores of
// the cached keys at positions < i and the unrounded current key, in f32;
// att (N, cv) = probabilities times values.
// The cache reads bound it, so each thread keeps several loads in flight: a
// warp scores kKeysPerWarp keys at once (lanes over the head dimension, one
// coalesced line per key), and for the values `groups` thread groups split
// the keys, each thread loading kValuesInFlight rows before it adds them.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_kernel(const float* __restrict__ P, int ksp,
                   const float* __restrict__ qkv_b, T* __restrict__ cache,
                   float* __restrict__ att, int i,
                   int N, int L, int H, int dk, int dv) {
  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ck = H * dk, cv = H * dv, F = 2 * ck + cv, fc = ck + cv;
  const int groups = kAttnThreads / dv > 0 ? kAttnThreads / dv : 1;
  const float scale = 1.f / sqrtf(static_cast<float>(dk));

  extern __shared__ float sm[];
  float* q = sm;                       // dk, scaled
  float* kself = q + dk;               // dk
  float* vself = kself + dk;           // dv
  float* part = vself + dv;            // groups * dv
  float* red = part + groups * dv;     // kAttnWarps
  float* s_self = red + kAttnWarps;    // 1
  float* sc = s_self + 1;              // i scores, then exponentials

  T* rows = cache + static_cast<int64_t>(n) * L * fc;
  T* kv_i = rows + static_cast<int64_t>(i) * fc;
  for (int e = threadIdx.x; e < 2 * dk + dv; e += kAttnThreads) {
    const int col = e < dk ? h * dk + e
                  : e < 2 * dk ? ck + h * dk + (e - dk)
                  : 2 * ck + h * dv + (e - 2 * dk);
    const float s = sum_strided(P + static_cast<int64_t>(n) * F + col, ksp,
                                static_cast<int64_t>(N) * F) + qkv_b[col];
    if (e < dk) {
      q[e] = s * scale;
    } else if (e < 2 * dk) {
      kself[e - dk] = s;
      store(kv_i + h * dk + (e - dk), s);
    } else {
      vself[e - 2 * dk] = s;
      store(kv_i + ck + h * dv + (e - 2 * dk), s);
    }
  }
  __syncthreads();

  const T* keys = rows + h * dk;
  for (int l0 = warp * kKeysPerWarp; l0 < i; l0 += kAttnWarps * kKeysPerWarp) {
    float dot[kKeysPerWarp];
#pragma unroll
    for (int kk = 0; kk < kKeysPerWarp; ++kk) dot[kk] = 0.f;
    for (int e = lane; e < dk; e += 32) {
      float kv[kKeysPerWarp];
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk)
        kv[kk] = l0 + kk < i ? load(keys + static_cast<int64_t>(l0 + kk) * fc + e) : 0.f;
      const float qe = q[e];
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk) dot[kk] += qe * kv[kk];
    }
#pragma unroll
    for (int kk = 0; kk < kKeysPerWarp; ++kk) {
      const float d = warp_sum(dot[kk]);
      if (lane == 0 && l0 + kk < i) sc[l0 + kk] = d;
    }
  }
  if (warp == 0) {
    float dot = 0.f;
    for (int e = lane; e < dk; e += 32) dot += q[e] * kself[e];
    dot = warp_sum(dot);
    if (lane == 0) *s_self = dot;
  }
  __syncthreads();

  const float self = *s_self;
  float m = self;
  for (int l = threadIdx.x; l < i; l += kAttnThreads) m = fmaxf(m, sc[l]);
  m = block_max<kAttnWarps>(m, red);
  float s = 0.f;
  for (int l = threadIdx.x; l < i; l += kAttnThreads) {
    const float e = expf(sc[l] - m);
    sc[l] = e;
    s += e;
  }
  const float e_self = expf(self - m);
  // Its barriers also publish the exponentials in sc.
  const float denom = block_sum<kAttnWarps>(s, red) + e_self;

  for (int idx = threadIdx.x; idx < groups * dv; idx += kAttnThreads) {
    const int g = idx / dv, e = idx % dv;
    const T* vcol = rows + ck + h * dv + e;
    float acc = 0.f;
    int l = g;
    for (; l + (kValuesInFlight - 1) * groups < i; l += kValuesInFlight * groups) {
      float v[kValuesInFlight];
#pragma unroll
      for (int kk = 0; kk < kValuesInFlight; ++kk)
        v[kk] = load(vcol + static_cast<int64_t>(l + kk * groups) * fc);
#pragma unroll
      for (int kk = 0; kk < kValuesInFlight; ++kk) acc += sc[l + kk * groups] * v[kk];
    }
    for (; l < i; l += groups) acc += sc[l] * load(vcol + static_cast<int64_t>(l) * fc);
    part[g * dv + e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < dv; e += kAttnThreads) {
    float num = 0.f;
    for (int g = 0; g < groups; ++g) num += part[g * dv + e];
    num += e_self * vself[e];
    att[static_cast<int64_t>(n) * cv + h * dv + e] = num / denom;
  }
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

// How a product of K rows and J columns is cut: kc rows per CTA (a multiple
// of the warps, at most kMaxChunk), ks chunks, ~kTargetCtas CTAs in all.
void split_k(int K, int J, int* ks, int* kc) {
  const int tiles = (J + kTileJ - 1) / kTileJ;
  int want = (kTargetCtas + tiles - 1) / tiles;
  if (want > kMaxSplit) want = kMaxSplit;
  int c = (K + want - 1) / want;
  c = (c + kWarps - 1) / kWarps * kWarps;
  if (c > kMaxChunk) c = kMaxChunk;
  *kc = c;
  *ks = (K + c - 1) / c;
}

int64_t partial_floats(int N, int K, int J) {
  int ks, kc;
  split_k(K, J, &ks, &kc);
  return static_cast<int64_t>(ks) * N * J;
}

int64_t max_partial_floats(int N, int C, int ck, int cv, int M) {
  const int F = 2 * ck + cv;
  int64_t p = partial_floats(N, C, F);
  const int64_t others[] = {partial_floats(N, cv, C), partial_floats(N, C, M),
                            partial_floats(N, M, C)};
  for (int64_t o : others) p = o > p ? o : p;
  return p;
}

constexpr size_t kGemvMaxSmem =
    sizeof(float) * (kRowGroup * kMaxChunk + kWarps * kRowGroup * kTileJ);
constexpr int kMaxDevices = 64;

// Lets the product kernels take their shared memory (above the default 48
// KB) on the current device; once per device, not at every launch.
cudaError_t allow_gemv_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  const void* kernels[] = {reinterpret_cast<const void*>(decode_gemv_kernel<false>),
                           reinterpret_cast<const void*>(decode_gemv_kernel<true>)};
  for (const void* fn : kernels) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kGemvMaxSmem));
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <bool kGelu>
cudaError_t gemv(const float* A, int ksa, const float* a_bias, const float* W,
                 float* P, int N, int K, int J, int* ks_out,
                 cudaStream_t stream) {
  int ks, kc;
  split_k(K, J, &ks, &kc);
  const size_t smem = sizeof(float) * (kRowGroup * kc + kWarps * kRowGroup * kTileJ);
  const dim3 grid((J + kTileJ - 1) / kTileJ, ks);
  decode_gemv_kernel<kGelu><<<grid, kThreads, smem, stream>>>(A, ksa, a_bias, W, P,
                                                             N, K, J, kc);
  *ks_out = ks;
  return cudaGetLastError();
}

cudaError_t rows(const float* base, const float* extra, const float* P,
                 int ksp, const float* bias, float* out_x, const float* ln_w,
                 const float* ln_b, float* out_t, int N, int C,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * (C + kRowThreads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_rows_kernel<<<N, kRowThreads, smem, stream>>>(base, extra, P, ksp, bias, out_x,
                                                    ln_w, ln_b, out_t, N, C);
  return cudaGetLastError();
}

template <typename T>
int run_step(int i, const float* x, T* cache, float* act, float* scratch,
             const Weights& wt, int N, int L, int NB, int C, int H, int dk,
             int dv, int M, cudaStream_t stream) {
  const int ck = H * dk, cv = H * dv, F = 2 * ck + cv, fc = ck + cv;
  const int64_t nc = static_cast<int64_t>(N) * C;
  float* xs = scratch;            // the running x
  float* x1s = xs + nc;           // x + attention
  float* t = x1s + nc;            // a LayerNorm's output, the next product's input
  float* att = t + nc;            // (N, cv)
  float* pa = att + static_cast<int64_t>(N) * cv;
  float* pb = pa + max_partial_floats(N, C, ck, cv, M);
  const int groups = kAttnThreads / dv > 0 ? kAttnThreads / dv : 1;
  const size_t attn_smem =
      sizeof(float) * (2 * dk + dv + groups * dv + kAttnWarps + 1 + (i > 0 ? i : 1));
  cudaError_t err = allow_gemv_smem();
  if (err != cudaSuccess) return err;
  if (attn_smem > 48 * 1024) {  // only for caches of ~11,000 positions or more
    err = cudaFuncSetAttribute(decode_attn_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(attn_smem));
    if (err != cudaSuccess) return err;
  }

  err = rows(x, nullptr, nullptr, 0, nullptr, xs, NB > 0 ? wt.ln1_w : wt.lnf_w,
             NB > 0 ? wt.ln1_b : wt.lnf_b, NB > 0 ? t : act, N, C, stream);
  if (err != cudaSuccess) return err;
  for (int b = 0; b < NB; ++b) {
    int ks_qkv, ks_out, ks_m1, ks_m2;
    err = gemv<false>(t, 0, nullptr, wt.qkv_w + static_cast<int64_t>(b) * C * F, pa,
                      N, C, F, &ks_qkv, stream);
    if (err != cudaSuccess) return err;
    decode_attn_kernel<T><<<N * H, kAttnThreads, attn_smem, stream>>>(
        pa, ks_qkv, wt.qkv_b + static_cast<int64_t>(b) * F,
        cache + static_cast<int64_t>(b) * N * L * fc, att, i, N, L, H, dk, dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = gemv<false>(att, 0, nullptr, wt.out_w + static_cast<int64_t>(b) * cv * C,
                      pa, N, cv, C, &ks_out, stream);
    if (err != cudaSuccess) return err;
    err = rows(xs, nullptr, pa, ks_out, wt.out_b + b * C, x1s, wt.ln2_w + b * C,
               wt.ln2_b + b * C, t, N, C, stream);
    if (err != cudaSuccess) return err;
    err = gemv<false>(t, 0, nullptr, wt.mlp1_w + static_cast<int64_t>(b) * C * M, pa,
                      N, C, M, &ks_m1, stream);
    if (err != cudaSuccess) return err;
    err = gemv<true>(pa, ks_m1, wt.mlp1_b + static_cast<int64_t>(b) * M,
                     wt.mlp2_w + static_cast<int64_t>(b) * M * C, pb, N, M, C, &ks_m2,
                     stream);
    if (err != cudaSuccess) return err;
    const bool last = b == NB - 1;
    err = rows(xs, x1s, pb, ks_m2, wt.mlp2_b + b * C, xs,
               last ? wt.lnf_w : wt.ln1_w + (b + 1) * C,
               last ? wt.lnf_b : wt.ln1_b + (b + 1) * C, last ? act : t, N, C,
               stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of device scratch the step needs: three (N, C) rows, att (N, cv)
// and two buffers of product partials.
extern "C" long long decode_step_scratch_floats(int N, int C, int n_heads,
                                                int d_k, int d_v, int M) {
  const int ck = n_heads * d_k, cv = n_heads * d_v;
  return 3LL * N * C + static_cast<long long>(N) * cv +
         2 * max_partial_floats(N, C, ck, cv, M);
}

// x, act: (N, C) float32; cache: (NB, N, L, ck + cv) of the cache's type,
// read at positions < i and written at i; scratch:
// decode_step_scratch_floats floats; weights as stacked by
// ops/decode_cuda.py. All contiguous, on one device; 0 <= i < L.
#define DECODE_STEP_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                          \
      int i, const float* x, void* cache, float* act, float* scratch,           \
      const float* ln1_w, const float* ln1_b,                                   \
      const float* qkv_w, const float* qkv_b, const float* out_w,               \
      const float* out_b, const float* ln2_w, const float* ln2_b,               \
      const float* mlp1_w, const float* mlp1_b, const float* mlp2_w,            \
      const float* mlp2_b, const float* lnf_w, const float* lnf_b, int N,       \
      int L, int n_blocks, int C, int n_heads, int d_k, int d_v, int M,         \
      void* stream) {                                                           \
    const Weights wt{ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_w,           \
                     ln2_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b, lnf_w, lnf_b};      \
    return run_step<T>(i, x, static_cast<T*>(cache), act, scratch, wt, N, L,    \
                       n_blocks, C, n_heads, d_k, d_v, M,                       \
                       static_cast<cudaStream_t>(stream));                      \
  }

DECODE_STEP_ENTRY(decode_step_f32, float)
DECODE_STEP_ENTRY(decode_step_bf16, __nv_bfloat16)
