// Test entries of the bf16 GEMM (gemm_wgmma_bf16.cuh) alone, in each of its
// four layouts and with its tile-store epilogue over one or two outputs,
// for tests/test_torch_kernels.py; the port's paths reach the GEMM through
// mlp_fwd.cu, mlp_bwd.cu and attn_block_fwd.cu only.

#include "gemm_wgmma_bf16.cuh"

namespace {

// out[part][m][n, n + 1] = acc.
struct PartStore {
  static constexpr bool kColSums = false;
  float* out;
  int64_t ld, part_stride;
  __device__ int load(int, int) const { return 0; }
  __device__ void operator()(int m, int n, float2 acc, int part, int) const {
    *reinterpret_cast<float2*>(out + part * part_stride + m * ld + n) = acc;
  }
};

}  // namespace

// out (parts, M, N) f32 = the parts' products of a and b (bf16) in the
// layout (at, bt) = (kAT, kBT), as gemm_wgmma_bf16.cuh defines them.
extern "C" int wgemm_check(const void* a, int64_t lda, const void* b, int64_t ldb, float* out,
                           int M, int N, int K, int parts, int k_split, int at, int bt,
                           void* stream) {
  using P = const bf16::T*;
  const PartStore epi{out, N, static_cast<int64_t>(M) * N};
  const auto s = static_cast<cudaStream_t>(stream);
  const P pa = static_cast<P>(a), pb = static_cast<P>(b);
  cudaError_t err;
  if (at && bt) err = wgemm::gemm_parts<true, true>(pa, lda, pb, ldb, M, N, K, parts, k_split, epi, s);
  else if (at) err = wgemm::gemm_parts<true, false>(pa, lda, pb, ldb, M, N, K, parts, k_split, epi, s);
  else if (bt) err = wgemm::gemm_parts<false, true>(pa, lda, pb, ldb, M, N, K, parts, k_split, epi, s);
  else err = wgemm::gemm_parts<false, false>(pa, lda, pb, ldb, M, N, K, parts, k_split, epi, s);
  return static_cast<int>(err);
}

// out_i = bf16(a w_i + bias_i) (M x n_i) for i < count by the tile-store
// epilogue in one launch (wgemm::bias_products); a (M x K).
extern "C" int wgemm_bias_check(const void* a, int M, int K, int count, const void* w0,
                                const void* bias0, void* out0, int n0, const void* w1,
                                const void* bias1, void* out1, int n1, void* stream) {
  using P = const bf16::T*;
  const P w[2] = {static_cast<P>(w0), static_cast<P>(w1)};
  const P bias[2] = {static_cast<P>(bias0), static_cast<P>(bias1)};
  bf16::T* out[2] = {static_cast<bf16::T*>(out0), static_cast<bf16::T*>(out1)};
  const int n[2] = {n0, n1};
  return static_cast<int>(wgemm::bias_products(static_cast<P>(a), M, K, count, w, bias, out, n,
                                               nullptr, static_cast<cudaStream_t>(stream)));
}

// Shared-memory bytes of a CTA of the GEMM: with a functor epilogue (tile
// 0) or the tile-store one (tile 1).
extern "C" int wgemm_smem(int tile) { return tile ? wgemm::kSmemTile : wgemm::kSmem; }
