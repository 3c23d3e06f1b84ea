// Causal flash-attention forward over packed (B, L, H*d) float32 tensors.
//
// Replaces pytorch_generative_tpu/ops/attention_pallas.py::_fwd_kernel (the
// packed forward that _flash_forward launches). Same contract: heads are cut
// out of the packed feature axis by offsets (no transposes), the online
// softmax runs in base 2 with scale*log2(e) folded into q and f32 statistics,
// `mask_center` shifts the diagonal by one, fully-masked rows give exactly 0
// with lse = -inf, and lse is stored as a natural log, (B, H, L).
//
// What bounds it on an H100: at the ImageGPT shapes (L = 784, d = 32) the
// work is ~2*L^2*d FLOPs per head, a few GFLOP per forward, against a few MB
// of q/k/v. It is bound by the f32 FMA rate of the CUDA cores and by shared
// memory bandwidth, not by device memory. This first version keeps the
// design simple: one CTA per (64-row query tile, head, batch), 2 threads per
// query row, K/V tiles staged through shared memory with loads coalesced over
// the packed row, and a k-loop that stops at the causal diagonal. The ragged
// last tile (L % 64 != 0) is masked in the kernel. Tensor cores (wgmma) and
// TMA pipelining are left to later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 2 * kBlockQ;  // two threads share one query row
constexpr int kHalfK = kBlockK / 2;    // keys per thread per tile
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int L, int H,
                 int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                 int64_t v_bs, int64_t v_rs, float scale_log2, int offset) {
  constexpr int DH = D / 2;  // output features per thread
  extern __shared__ float smem[];
  float* ks = smem;                       // kBlockK x (D + 1), padded rows
  float* vs = ks + kBlockK * (D + 1);     // kBlockK x D
  float* ps = vs + kBlockK * D;           // kBlockQ x (kBlockK + 1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qrow = qt * kBlockQ + r;
  const bool row_ok = qrow < L;

  // Stage the q tile through shared memory (coalesced), then keep each row,
  // pre-scaled into the base-2 domain, in registers.
  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int rr = idx / D, cc = idx % D;
    const int row = qt * kBlockQ + rr;
    ks[rr * (D + 1) + cc] =
        row < L ? q[b * q_bs + row * q_rs + h * D + cc] * scale_log2 : 0.f;
  }
  __syncthreads();
  float qreg[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qreg[d] = ks[r * (D + 1) + d];

  float m = -CUDART_INF_F, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  // kBlockQ == kBlockK, so the diagonal of query tile qt lies in key tile qt.
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every reader of the previous tile is done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int rr = idx / D, cc = idx % D;
      const int key = kt * kBlockK + rr;
      float kval = 0.f, vval = 0.f;
      if (key < L) {
        kval = k[b * k_bs + key * k_rs + h * D + cc];
        vval = v[b * v_bs + key * v_rs + h * D + cc];
      }
      ks[rr * (D + 1) + cc] = kval;
      vs[rr * D + cc] = vval;
    }
    __syncthreads();

    float s[kHalfK];
    float m_cur = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const int c = half * kHalfK + j;
      const int key = kt * kBlockK + c;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qreg[d] * ks[c * (D + 1) + d];
      const bool ok = row_ok && key < L && key + offset <= qrow;
      s[j] = ok ? dot : -CUDART_INF_F;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m, m_cur);
    const float m_safe = isinf(m_new) ? 0.f : m_new;
    const float alpha = isinf(m) ? 0.f : exp2f(m - m_safe);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const float p = exp2f(s[j] - m_safe);  // masked: exp2(-inf) == 0
      p_sum += p;
      ps[r * (kBlockK + 1) + half * kHalfK + j] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();  // the row's two halves of p live in this warp

#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = ps[r * (kBlockK + 1) + c];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += p * vs[c * D + half * DH + d];
    }
  }

  if (row_ok) {
    const float denom = l == 0.f ? 1.f : l;
    float* op = out + (static_cast<int64_t>(b) * L + qrow) * H * D + h * D +
                half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = acc[d] / denom;
    if (half == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * L + qrow] =
          l == 0.f ? -CUDART_INF_F : m * kLn2 + logf(fmaxf(l, 1e-38f));
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int B, int L, int H, int64_t q_bs, int64_t q_rs,
                   int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                   int mask_center, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, L, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale_log2,
      mask_center ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: f32 with unit stride over features; (batch, row) strides given in
// elements. d_k == d_v == D. out: contiguous (B, L, H*D); lse: (B, H, L).
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* out, float* lse, int B, int L, int H, int D,
                             int64_t q_bs, int64_t q_rs, int64_t k_bs,
                             int64_t k_rs, int64_t v_bs, int64_t v_rs,
                             int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, out, lse, B, L, H, q_bs, q_rs, k_bs,
                               k_rs, v_bs, v_rs, mask_center, s);
    case 32: return launch<32>(q, k, v, out, lse, B, L, H, q_bs, q_rs, k_bs,
                               k_rs, v_bs, v_rs, mask_center, s);
    case 64: return launch<64>(q, k, v, out, lse, B, L, H, q_bs, q_rs, k_bs,
                               k_rs, v_bs, v_rs, mask_center, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
