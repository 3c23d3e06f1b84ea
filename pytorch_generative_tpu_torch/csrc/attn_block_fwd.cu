// The fused attention block's forward over (B, L, C) float32 rows x:
//   q = x Wq + bq (E = H * d), [k | v] = x Wkv + bkv (E + O, O = H * d),
//   attn = causal flash attention of (q, k, v) over H heads (B, L, O),
//   y = attn Wo + bo (B, L, C'), with lse (B, H, L) for the backward.
//
// Replaces pytorch_generative_tpu/ops/attn_block_pallas.py::_fwd_block_kernel
// (launched by _fwd_block, the forward of attention_block_packed under
// PGT_FUSED_ATTN=1). Same contract: the attention is flash_fwd.cu's (base-2
// online softmax with f32 statistics, `mask_center` shifts the diagonal by
// one, a fully-masked row gives exactly 0 with lse = -inf), y's width is
// Wo's (the TPU kernel sizes it by x, a defect not copied here), and the
// pre-Wo attention and lse are written for the backward.
//
// Why the design differs from the TPU's: the TPU kernel projects a whole
// batch row into VMEM at its first query step and relies on its sequential
// grid to reuse it at the later steps. CUDA blocks run in no order, so this
// kernel runs two launches from one call:
//   (a) the projection stage: q and [k | v] for all rows, each one
//       sgemm.cuh product with the bias added in its epilogue, into scratch
//       that the caller frees after the call. The backward recomputes q, k
//       and v by attn_block_project_f32, which runs this same stage, so it
//       differentiates through the forward's bits;
//   (b) the tile pass with the output projection in its epilogue: one CTA
//       owns a 64-row query tile of one batch row across all heads. It runs
//       flash_fwd.cuh's tile pass for each head in turn, each writing its
//       columns of attn, then multiplies the tile's attn rows (written by
//       this CTA, read back through L2) by Wo and adds bo to write y. The
//       attn tile is not held in shared memory: at C = 512 it alone would
//       take 128 KB and leave one CTA an SM; read back, the CTA needs the
//       tile pass's shared memory only (50 KB at d = 64).
//   The heaviest query tiles (those nearest the end of the sequence, with
//   the most key tiles) are started first.
//
// What bounds it on an H100: 2 B L C (2E + O) FLOPs of projection, 2 B L O C'
// of output projection and the attention's 2 (d_k + d_v) per causal pair and
// head: ~145 GFLOP at B = 64, L = 784, C = 512, 8 heads, ~2.2 ms at 67
// TFLOP/s f32 on the CUDA cores. The products are sgemm.cuh's SIMT tiles and
// a 64 x 128 (or 64 x 256) register-tiled product in (b)'s epilogue; tensor
// cores (f32 would need TF32) are later work. Head widths: d = 32 and 64 on
// the two-threads-a-row tile pass, d = 128 on the four-threads-a-row one.

#include "flash_fwd.cuh"
#include "sgemm.cuh"

namespace {

using namespace flash;

constexpr int kEpiK = 16;  // depth of each staged step of the epilogue product

template <int NT>
constexpr int epilogue_smem_floats() {
  return kEpiK * (kBlockQ + 4) + kEpiK * (NT + 4);
}

// y rows [r0, r0 + n) of batch row b = attn rows @ wo + bo, by NT threads.
// Each pass over the output columns covers NT of them: thread (ty, tx) of
// 8 x NT/8 keeps an 8 x 8 block, rows ty*4 + i and 32 + ty*4 + i, columns
// tx*4 + j and NT/2 + tx*4 + j, summed over k in order. attn is read with
// ordinary loads: this CTA wrote it.
template <int NT>
__device__ __forceinline__ void project_out(const float* attn, const float* __restrict__ wo,
                                            const float* __restrict__ bo,
                                            float* __restrict__ y, int64_t row0, int n,
                                            int O, int Cout, float* smem) {
  float* as = smem;                          // kEpiK x (kBlockQ + 4), k-major
  float* bs = as + kEpiK * (kBlockQ + 4);    // kEpiK x (NT + 4)
  const int tid = threadIdx.x;
  const int tx = tid % (NT / 8), ty = tid / (NT / 8);
  for (int n0 = 0; n0 < Cout; n0 += NT) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < O; k0 += kEpiK) {
      __syncthreads();  // the previous step's readers are done
      for (int idx = tid; idx < kBlockQ * kEpiK; idx += NT) {
        const int r = idx / kEpiK, kk = idx % kEpiK;
        as[kk * (kBlockQ + 4) + r] =
            r < n && k0 + kk < O ? attn[(row0 + r) * O + k0 + kk] : 0.f;
      }
      for (int idx = tid; idx < kEpiK * NT; idx += NT) {
        const int kk = idx / NT, cc = idx % NT;
        bs[kk * (NT + 4) + cc] = k0 + kk < O && n0 + cc < Cout
                                     ? wo[static_cast<int64_t>(k0 + kk) * Cout + n0 + cc]
                                     : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kEpiK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk * (kBlockQ + 4) + ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[kk * (kBlockQ + 4) + 32 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk * (NT + 4) + tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[kk * (NT + 4) + NT / 2 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4;
      if (r >= n) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = n0 + hh * (NT / 2) + tx * 4;
        if (c >= Cout) continue;
        const float4 bb = sgemm::ldg4(bo + c);
        *reinterpret_cast<float4*>(y + (row0 + r) * Cout + c) =
            make_float4(acc[i][4 * hh] + bb.x, acc[i][4 * hh + 1] + bb.y,
                        acc[i][4 * hh + 2] + bb.z, acc[i][4 * hh + 3] + bb.w);
      }
    }
  }
}

// One CTA: query tile (n_q - 1 - blockIdx.x) of batch row blockIdx.y, every
// head, then its rows of y. q (B, L, H*D) and kv (B, L, 2*H*D) contiguous.
template <int D, bool kWide>
__global__ void __launch_bounds__(kWide ? kWideThreads : kThreads)
attn_block_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                  float* attn, float* __restrict__ lse, const float* __restrict__ wo,
                  const float* __restrict__ bo, float* __restrict__ y, int L, int H,
                  int Cout, float scale_log2, int offset) {
  constexpr int NT = kWide ? kWideThreads : kThreads;
  extern __shared__ float smem[];
  const int qt = gridDim.x - 1 - blockIdx.x, b = blockIdx.y;
  const int E = H * D;
  const int64_t q_bs = static_cast<int64_t>(L) * E, kv_rs = 2 * E;
  const int64_t kv_bs = static_cast<int64_t>(L) * kv_rs;
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's readers of shared memory are done
    if constexpr (kWide)
      wide_tile<D, D>(q, kv, kv + E, attn, lse, L, H, q_bs, E, kv_bs, kv_rs, kv_bs, kv_rs,
                      scale_log2, offset, smem, qt, h, b);
    else
      tile<D, D>(q, kv, kv + E, attn, lse, L, H, q_bs, E, kv_bs, kv_rs, kv_bs, kv_rs,
                 scale_log2, offset, smem, qt, h, b);
  }
  __syncthreads();  // every head's attn rows of the tile are written
  const int n = min(kBlockQ, L - qt * kBlockQ);
  project_out<NT>(attn, wo, bo, y, static_cast<int64_t>(b) * L + qt * kBlockQ, n, E,
                  Cout, smem);
}

template <int D, bool kWide>
cudaError_t launch(const float* q, const float* kv, float* attn, float* lse,
                   const float* wo, const float* bo, float* y, int B, int L, int H,
                   int Cout, int mask_center, cudaStream_t stream) {
  constexpr int NT = kWide ? kWideThreads : kThreads;
  constexpr int tile_floats =
      kWide ? wide_tile_smem_floats<D, D>() : tile_smem_floats<D, D>();
  const size_t smem =
      sizeof(float) * (tile_floats > epilogue_smem_floats<NT>() ? tile_floats
                                                                : epilogue_smem_floats<NT>());
  cudaError_t err = cudaFuncSetAttribute(attn_block_kernel<D, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  attn_block_kernel<D, kWide><<<grid, NT, smem, stream>>>(
      q, kv, attn, lse, wo, bo, y, L, H, Cout, scale_log2, mask_center ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// The projection stage alone: q = x wq + bq (R, E), kv = x wkv + bkv
// (R, E + O), from x (R, C), wq (C, E), wkv (C, E + O); contiguous float32,
// C, E and O multiples of 4.
extern "C" int attn_block_project_f32(const float* x, const float* wq, const float* bq,
                                      const float* wkv, const float* bkv, float* q,
                                      float* kv, int R, int C, int E, int O,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 != 0 || E % 4 != 0 || O % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = sgemm::gemm<false, false>(x, C, wq, E, R, E, C, 1, sgemm::Identity{},
                                              sgemm::BiasStore<false>{bq, nullptr, q, E}, s);
  if (err != cudaSuccess) return err;
  return sgemm::gemm<false, false>(x, C, wkv, E + O, R, E + O, C, 1, sgemm::Identity{},
                                   sgemm::BiasStore<false>{bkv, nullptr, kv, E + O}, s);
}

// x (B, L, C), wq (C, E), bq (E,), wkv (C, 2E), bkv (2E,), wo (E, Cout),
// bo (Cout,): contiguous float32, E = H * d with d one of 32, 64 and 128
// (d_k == d_v), C and Cout multiples of 4. Writes attn (B, L, E), lse
// (B, H, L) and y (B, L, Cout); q (B, L, E) and kv (B, L, 2E) are scratch.
extern "C" int attn_block_fwd_f32(const float* x, const float* wq, const float* bq,
                                  const float* wkv, const float* bkv, const float* wo,
                                  const float* bo, float* q, float* kv, float* attn,
                                  float* lse, float* y, int B, int L, int C, int H,
                                  int d, int Cout, int mask_center, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int E = H * d;
  cudaError_t err = static_cast<cudaError_t>(
      attn_block_project_f32(x, wq, bq, wkv, bkv, q, kv, B * L, C, E, E, stream));
  if (err != cudaSuccess) return err;
  switch (d) {
    case 32: return launch<32, false>(q, kv, attn, lse, wo, bo, y, B, L, H, Cout, mask_center, s);
    case 64: return launch<64, false>(q, kv, attn, lse, wo, bo, y, B, L, H, Cout, mask_center, s);
    case 128: return launch<128, true>(q, kv, attn, lse, wo, bo, y, B, L, H, Cout, mask_center, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
