// The whole PixelSNAIL raster-scan sampler in one launch, float32.
//
// Replaces pytorch_generative_tpu/ops/snail_decode_pallas.py::
// _snail_loop_kernel (launched by fused_snail_sample_loop). Per raster
// position i, for each sample: the 4 live taps of the masked 3x3 type-A
// input conv on the raw canvas; per block, per residual block elu(res) into
// the elu cache at i, mid = elu(2x2 conv of the elu cache over rows
// {row-1, row} x cols {col-1, col}) into the mid cache, out = 2x2 conv of
// the mid cache, res += out[:C] * sigmoid(out[C:]); q from [pos(2), res];
// one-head attention over the cached keys < i (mask_center; at i = 0 no key
// is valid and the output is out_proj's bias); elu(conv(elu(.))) on the
// residual and attention branches, their sum, `out`, x += block_out. Then
// the head (two 1x1 convs), the draw `u < sigmoid(logit)`, the inpainting
// merge (pixels >= 0 are kept, sampled ones stored as exact 0.0 or 1.0) and,
// for every block, kv_proj of [pos, res_b, merged pixel] appended to that
// block's K/V cache at i: k/v read the merged pixel (the layer's extra
// input), so q_in of every block is kept until after the draw.
//
// Design: one CTA per sample; the TPU kernel's sequential grid axis over
// positions is a loop inside the CTA, and samples are independent, so no
// CTA waits on another, at any n. A CTA has at most 227 KB of shared
// memory, against the TPU's 128 MB of VMEM, and per sample the K/V caches
// are NB * L * (d_k + d_v) floats (903 KB at the reproduce config) and the
// elu/mid caches, as rolling two-row buffers like the TPU kernel's, 2 * NB
// * NR * 2 * (w + 1) * C floats (475 KB). So the caches live in a device
// scratch buffer the wrapper allocates (~22 MB at n = 16: it stays in the
// 50 MB L2). The canvas, the activations, the taps, the scores and the
// partial sums live in shared memory (~20 KB). Every product is a matvec:
// threads run over the outputs (weight rows read coalesced from L2) and
// split the inputs in a few slices whose partial sums are added in a fixed
// order, so the result is deterministic.
//
// What bounds it on an H100: per position a CTA runs ~180 dependent phases,
// each ending at a CTA barrier, and streams all the weights (~3.6 MB at the
// reproduce config) from L2; the work, ~2 MFLOP a position and sample, is
// far below the card's f32 rate at n = 16-64 CTAs. So it is latency-bound:
// the chain of phases and L2 round trips. Samples per CTA (the weights read
// once for several samples), splitting a sample's products over a cluster
// and tensor cores are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Weights {
  const float* in_w4;  // (4, C): live taps of the type-A 3x3 conv
  const float* in_b;   // (C,)
  const float* rb1_w;  // (NB, NR, 4C, C): 2x2 taps (0,0),(0,1),(1,0),(1,1)
  const float* rb1_b;  // (NB, NR, C)
  const float* rb2_w;  // (NB, NR, 4C, 2C)
  const float* rb2_b;  // (NB, NR, 2C)
  const float* q_w;    // (NB, C + 2, DK)
  const float* q_b;    // (NB, DK)
  const float* kv_w;   // (NB, C + 3, DK + DV)
  const float* kv_b;   // (NB, DK + DV)
  const float* op_w;   // (NB, DV, DV)
  const float* op_b;   // (NB, DV)
  const float* ro_w;   // (NB, C, C)
  const float* ro_b;   // (NB, C)
  const float* ao_w;   // (NB, DV, C)
  const float* ao_b;   // (NB, C)
  const float* o_w;    // (NB, C, C)
  const float* o_b;    // (NB, C)
  const float* h1_w;   // (C, C2)
  const float* h1_b;   // (C2,)
  const float* h2_w;   // (C2, 1)
  const float* h2_b;   // (1,)
};

struct Dims {
  int N, h, w, NB, NR, C, C2, DK, DV;
};

// Floats of one sample's elu (or mid) cache: NB * NR rolling two-row
// buffers of (w + 1) entries of C channels.
__host__ __device__ int64_t conv_cache_floats(const Dims& d) {
  return static_cast<int64_t>(d.NB) * d.NR * 2 * (d.w + 1) * d.C;
}

// One sample's scratch: the elu cache, the mid cache, K (NB, L, DK) and V
// (NB, L, DV).
__host__ __device__ int64_t sample_scratch_floats(const Dims& d) {
  return 2 * conv_cache_floats(d) +
         static_cast<int64_t>(d.NB) * d.h * d.w * (d.DK + d.DV);
}

// Slices of K in a matvec to J outputs: enough to give every thread work.
__host__ __device__ int groups(int K, int J) {
  int g = kThreads / J;
  if (g < 1) g = 1;
  return g < K ? g : K;
}

__host__ __device__ int partial_floats(int K, int J) { return groups(K, J) * J; }

// Partial sums of the largest phase: the K/V append of all blocks at once,
// residual_out and attention_out side by side, or any one matvec (at most
// max(kThreads, J) floats, J <= 2C).
__host__ __device__ int part_floats(const Dims& d) {
  const int kv = d.NB * partial_floats(d.C + 3, d.DK + d.DV);
  const int two = partial_floats(d.C, d.C) + partial_floats(d.DV, d.C);
  int m = kv > two ? kv : two;
  m = m > kThreads ? m : kThreads;
  m = m > 2 * d.C ? m : 2 * d.C;
  return m > d.DV + d.DK ? m : d.DV + d.DK;
}

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

// part[g * J + j] = sum over the g-th slice of k of a[k] * W[k, j], for W
// (K, J) row-major and `a` in shared memory; the threads run over j, so each
// row of W is read coalesced. The caller synchronises before matvec_sum.
__device__ void matvec_partial(const float* a, const float* __restrict__ W,
                               int K, int J, float* part) {
  const int G = groups(K, J);
  const int slice = (K + G - 1) / G;
  for (int idx = threadIdx.x; idx < G * J; idx += kThreads) {
    const int g = idx / J, j = idx - g * J;
    const int k1 = min(K, (g + 1) * slice);
    float acc = 0.f;
#pragma unroll 8
    for (int k = g * slice; k < k1; ++k)
      acc += a[k] * W[static_cast<int64_t>(k) * J + j];
    part[idx] = acc;
  }
}

// bias[j] plus output j's partial sums, added in slice order.
__device__ float matvec_sum(const float* part, const float* __restrict__ bias,
                            int K, int J, int j) {
  const int G = groups(K, J);
  float acc = bias[j];
  for (int g = 0; g < G; ++g) acc += part[g * J + j];
  return acc;
}

// The caches are written and read back by the same CTA, so they are plain
// (coherent) pointers: no __restrict__, no read-only loads.
__global__ void __launch_bounds__(kThreads)
snail_loop_kernel(const float* __restrict__ canvas0,
                  const float* __restrict__ uniforms,
                  float* __restrict__ canvas_out, float* scratch, Weights wt,
                  Dims dm) {
  const int s = blockIdx.x;
  const int N = dm.N, C = dm.C, NB = dm.NB, NR = dm.NR, DK = dm.DK, DV = dm.DV;
  const int C2 = dm.C2, h = dm.h, w = dm.w;
  const int wp = w + 2, lp = (h + 2) * wp, L = h * w, wc = w + 1;
  const int CQ = C + 2, CKV = C + 3, FKV = DK + DV;
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf(static_cast<float>(DK));

  const int64_t conv_floats = conv_cache_floats(dm);
  float* elu_c = scratch + s * sample_scratch_floats(dm);  // [NB][NR][2 wc][C]
  float* mid_c = elu_c + conv_floats;                      // [NB][NR][2 wc][C]
  float* kc = mid_c + conv_floats;                         // [NB][L][DK]
  float* vc = kc + static_cast<int64_t>(NB) * L * DK;      // [NB][L][DV]

  extern __shared__ float smem[];
  float* canvas = smem;          // lp
  float* x = canvas + lp;        // C
  float* res = x + C;            // C
  float* ta = res + C;           // 4C: the elu cache's 2x2 taps
  float* tb = ta + 4 * C;        // 4C: the mid cache's 2x2 taps
  float* qin = tb + 4 * C;       // NB x (C + 3): [pos, res_b, merged pixel]
  float* q = qin + NB * CKV;     // DK
  float* att = q + DK;           // DV
  float* er = att + DV;          // C: elu(res)
  float* u2 = er + C;            // max(C, C2)
  float* sc = u2 + (C > C2 ? C : C2);  // L scores, then exponentials
  float* part = sc + L;          // part_floats(dm)
  float* red = part + part_floats(dm);  // kWarps
  float* merged = red + kWarps;  // 1

  // The conv caches are read before they are written (their zero padding).
  for (int64_t idx = tid; idx < 2 * conv_floats; idx += kThreads) elu_c[idx] = 0.f;
  for (int p = tid; p < lp; p += kThreads)
    canvas[p] = canvas0[static_cast<int64_t>(p) * N + s];
  __syncthreads();

  for (int i = 0; i < L; ++i) {
    const int row = i / w, col = i % w;
    // Logical cache entry (r + 1, c + 1) holds position (r, c); logical row
    // r lives at rolling parity r % 2. The 2x2 taps at (row, col) read
    // logical rows row (parity pr) and row + 1 (parity pw, being written).
    const int pw = ((row + 1) & 1) * wc, pr = (row & 1) * wc;
    const int tap_entry[4] = {pr + col, pr + col + 1, pw + col, pw + col + 1};
    const float pos_y = static_cast<float>(row) / static_cast<float>(h) - 0.5f;
    const float pos_x = static_cast<float>(col) / static_cast<float>(w) - 0.5f;

    // The masked input conv's 4 live taps; at col == 0 the left-pad entry
    // of the parity row being reused is zeroed again (a rolling buffer may
    // hold data from two rows up there; this scheme never writes it).
    {
      const int p0 = row * wp + col;
      const float t0 = canvas[p0], t1 = canvas[p0 + 1], t2 = canvas[p0 + 2],
                  t3 = canvas[p0 + wp];
      for (int c = tid; c < C; c += kThreads) {
        const float v = wt.in_b[c] + t0 * wt.in_w4[c] + t1 * wt.in_w4[C + c] +
                        t2 * wt.in_w4[2 * C + c] + t3 * wt.in_w4[3 * C + c];
        x[c] = v;
        res[c] = v;
      }
      if (col == 0) {
        for (int idx = tid; idx < NB * NR * C; idx += kThreads) {
          const int br = idx / C, c = idx - br * C;
          const int64_t e = (static_cast<int64_t>(br) * 2 * wc + pw) * C + c;
          elu_c[e] = 0.f;
          mid_c[e] = 0.f;
        }
      }
      __syncthreads();
    }

    for (int b = 0; b < NB; ++b) {
      float* qb = qin + b * CKV;
      for (int j = 0; j < NR; ++j) {
        const int br = b * NR + j;
        float* ec = elu_c + static_cast<int64_t>(br) * 2 * wc * C;
        float* mc = mid_c + static_cast<int64_t>(br) * 2 * wc * C;
        // elu(res) into the elu cache at i and into tap 3; taps 0-2 (earlier
        // positions) from the cache.
        for (int idx = tid; idx < 4 * C; idx += kThreads) {
          const int t = idx / C, c = idx - t * C;
          if (t == 3) {
            const float v = elu(res[c]);
            ta[idx] = v;
            ec[tap_entry[3] * C + c] = v;
          } else {
            ta[idx] = ec[tap_entry[t] * C + c];
          }
        }
        __syncthreads();
        matvec_partial(ta, wt.rb1_w + static_cast<int64_t>(br) * 4 * C * C,
                       4 * C, C, part);
        __syncthreads();
        // mid = elu(conv) into the mid cache at i and into tap 3.
        for (int idx = tid; idx < 4 * C; idx += kThreads) {
          const int t = idx / C, c = idx - t * C;
          if (t == 3) {
            const float v = elu(matvec_sum(part, wt.rb1_b + br * C, 4 * C, C, c));
            tb[idx] = v;
            mc[tap_entry[3] * C + c] = v;
          } else {
            tb[idx] = mc[tap_entry[t] * C + c];
          }
        }
        __syncthreads();
        matvec_partial(tb, wt.rb2_w + static_cast<int64_t>(br) * 8 * C * C,
                       4 * C, 2 * C, part);
        __syncthreads();
        for (int c = tid; c < C; c += kThreads) {
          const float* bias = wt.rb2_b + br * 2 * C;
          const float top = matvec_sum(part, bias, 4 * C, 2 * C, c);
          const float gate = matvec_sum(part, bias, 4 * C, 2 * C, C + c);
          res[c] += top * sigmoid(gate);
        }
        __syncthreads();
      }
      // q_in = [pos, res] (kept for the K/V append) and elu(res).
      for (int c = tid; c < C; c += kThreads) {
        qb[2 + c] = res[c];
        er[c] = elu(res[c]);
      }
      if (tid == 0) {
        qb[0] = pos_y;
        qb[1] = pos_x;
      }
      __syncthreads();
      matvec_partial(qb, wt.q_w + static_cast<int64_t>(b) * CQ * DK, CQ, DK, part);
      __syncthreads();
      for (int d = tid; d < DK; d += kThreads)
        q[d] = matvec_sum(part, wt.q_b + b * DK, CQ, DK, d) * scale;
      __syncthreads();

      // Softmax attention over the cached keys < i.
      const float* kb = kc + static_cast<int64_t>(b) * L * DK;
      const float* vb = vc + static_cast<int64_t>(b) * L * DV;
      float m = -CUDART_INF_F;
      for (int l = tid; l < i; l += kThreads) {
        float dot = 0.f;
        for (int d = 0; d < DK; ++d) dot += q[d] * kb[static_cast<int64_t>(l) * DK + d];
        sc[l] = dot;
        m = fmaxf(m, dot);
      }
      m = block_max(m, red);
      const float m_safe = i > 0 ? m : 0.f;
      float e_sum = 0.f;
      for (int l = tid; l < i; l += kThreads) {
        const float e = expf(sc[l] - m_safe);
        sc[l] = e;
        e_sum += e;
      }
      const float den = block_sum(e_sum, red);  // 0 only at i == 0
      const int gv = groups(1 << 30, DV);        // groups of DV threads split the keys
      for (int idx = tid; idx < gv * DV; idx += kThreads) {
        const int g = idx / DV, d = idx - g * DV;
        float acc = 0.f;
        for (int l = g; l < i; l += gv) acc += sc[l] * vb[static_cast<int64_t>(l) * DV + d];
        part[idx] = acc;
      }
      __syncthreads();
      for (int d = tid; d < DV; d += kThreads) {
        float acc = 0.f;
        for (int g = 0; g < gv; ++g) acc += part[g * DV + d];
        att[d] = den > 0.f ? acc / den : 0.f;
      }
      __syncthreads();
      matvec_partial(att, wt.op_w + static_cast<int64_t>(b) * DV * DV, DV, DV, part);
      __syncthreads();
      for (int d = tid; d < DV; d += kThreads)
        att[d] = elu(matvec_sum(part, wt.op_b + b * DV, DV, DV, d));
      __syncthreads();

      // res2 = elu(residual_out(elu(res))), att2 = elu(attention_out(elu(att))),
      // block_out = elu(out(elu(res2 + att2))), x += block_out.
      float* part2 = part + partial_floats(C, C);
      matvec_partial(er, wt.ro_w + static_cast<int64_t>(b) * C * C, C, C, part);
      matvec_partial(att, wt.ao_w + static_cast<int64_t>(b) * DV * C, DV, C, part2);
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        const float r2 = elu(matvec_sum(part, wt.ro_b + b * C, C, C, c));
        const float a2 = elu(matvec_sum(part2, wt.ao_b + b * C, DV, C, c));
        u2[c] = elu(r2 + a2);
      }
      __syncthreads();
      matvec_partial(u2, wt.o_w + static_cast<int64_t>(b) * C * C, C, C, part);
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        const float v = x[c] + elu(matvec_sum(part, wt.o_b + b * C, C, C, c));
        x[c] = v;
        res[c] = v;
      }
      __syncthreads();
    }

    // The head, the draw and the inpainting merge.
    matvec_partial(x, wt.h1_w, C, C2, part);
    __syncthreads();
    for (int c = tid; c < C2; c += kThreads) u2[c] = matvec_sum(part, wt.h1_b, C, C2, c);
    __syncthreads();
    matvec_partial(u2, wt.h2_w, C2, 1, part);
    __syncthreads();
    if (tid == 0) {
      const float prob = sigmoid(matvec_sum(part, wt.h2_b, C2, 1, 0));
      const float u = uniforms[static_cast<int64_t>(i) * N + s];
      const int p = (row + 1) * wp + col + 1;
      float v = canvas[p];
      if (v < 0.f) v = u < prob ? 1.f : 0.f;
      canvas[p] = v;
      merged[0] = v;
    }
    __syncthreads();

    // Every block's k|v at i from [pos, res_b, merged pixel].
    for (int b = tid; b < NB; b += kThreads) qin[b * CKV + CQ] = merged[0];
    __syncthreads();
    const int pkv = partial_floats(CKV, FKV);
    for (int b = 0; b < NB; ++b)
      matvec_partial(qin + b * CKV, wt.kv_w + static_cast<int64_t>(b) * CKV * FKV, CKV,
                     FKV, part + b * pkv);
    __syncthreads();
    for (int idx = tid; idx < NB * FKV; idx += kThreads) {
      const int b = idx / FKV, f = idx - b * FKV;
      const float v = matvec_sum(part + b * pkv, wt.kv_b + b * FKV, CKV, FKV, f);
      if (f < DK)
        kc[(static_cast<int64_t>(b) * L + i) * DK + f] = v;
      else
        vc[(static_cast<int64_t>(b) * L + i) * DV + f - DK] = v;
    }
    __syncthreads();
  }

  for (int p = tid; p < lp; p += kThreads)
    canvas_out[static_cast<int64_t>(p) * N + s] = canvas[p];
}

}  // namespace

// Floats of device scratch the kernel needs per sample: the rolling elu and
// mid caches and the K/V caches.
extern "C" long long snail_loop_scratch_floats(int h, int w, int n_blocks, int n_rb,
                                               int C, int d_k, int d_v) {
  return sample_scratch_floats(Dims{1, h, w, n_blocks, n_rb, C, 0, d_k, d_v});
}

// canvas0, canvas_out: (Lp, N); uniforms: (L, N); scratch: N *
// snail_loop_scratch_floats(...) floats; weights as in struct Weights. All
// float32, contiguous, on one device.
extern "C" int snail_loop_f32(
    const float* canvas0, const float* uniforms, float* canvas_out, float* scratch,
    const float* in_w4, const float* in_b, const float* rb1_w, const float* rb1_b,
    const float* rb2_w, const float* rb2_b, const float* q_w, const float* q_b,
    const float* kv_w, const float* kv_b, const float* op_w, const float* op_b,
    const float* ro_w, const float* ro_b, const float* ao_w, const float* ao_b,
    const float* o_w, const float* o_b, const float* h1_w, const float* h1_b,
    const float* h2_w, const float* h2_b, int N, int h, int w, int n_blocks, int n_rb,
    int C, int C2, int d_k, int d_v, void* stream) {
  const Weights wt{in_w4, in_b, rb1_w, rb1_b, rb2_w, rb2_b, q_w, q_b, kv_w, kv_b, op_w,
                   op_b, ro_w, ro_b, ao_w, ao_b, o_w, o_b, h1_w, h1_b, h2_w, h2_b};
  const Dims dm{N, h, w, n_blocks, n_rb, C, C2, d_k, d_v};
  const int lp = (h + 2) * (w + 2), L = h * w;
  const size_t smem = sizeof(float) *
      (lp + 2 * C + 8 * C + n_blocks * (C + 3) + d_k + d_v + C + (C > C2 ? C : C2) + L +
       part_floats(dm) + kWarps + 1);
  cudaError_t err = cudaFuncSetAttribute(
      snail_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  snail_loop_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      canvas0, uniforms, canvas_out, scratch, wt, dm);
  return cudaGetLastError();
}
