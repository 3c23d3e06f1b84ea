// bf16 matrix products for Hopper on warpgroup wgmma with f32 sums, either
// operand K-contiguous or not, fed by TMA through an mbarrier ring, and a
// functor as the epilogue: every product of the fused MLP's bf16 entries
// (mlp.cuh), with the layouts, parts and epilogue contract of the 3xTF32
// GEMM (gemm_tf32x3.cuh); or a tile-store epilogue (below): the fused
// attention block's products (attn_block_fwd.cu) and the MLP's y = LN(x)
// W1 + b1 with gelu(y).
//
//   out(m, n) = sum over k in the part of A(m, k) B(k, n),
//   A(m, k) = a[m * lda + k]  (kAT false: K contiguous)
//             a[k * lda + m]  (kAT true:  M contiguous)
//   B(k, n) = b[k * ldb + n]  (kBT false: N contiguous)
//             b[n * ldb + k]  (kBT true:  K contiguous)
//   epi(m, n, out(m, n .. n + 1), part, epi.load(m, n)) for every in-range
//   m and even n, out in f32. K is cut into `parts` parts of k_split values
//   (a multiple of the k-step; the last may be shorter), whose products the
//   epilogue writes apart for a fixed-order sum later.
//
// What bounds it on an H100: 2 M N K operations at 989 TFLOP/s against
// 2 (M K + K N) + 2-4 M N bytes at 3.35 TB/s: operations at the MLP's
// shapes (K = 512 to 6,272). Between L2 and the SMs, a k-step of the
// 128 x 128 tile moves 32 KB for 2.1 MFLOP: the products without a heavy
// epilogue ran at ~430-470 TFLOP/s, ~6.7 TB/s out of L2. A 128 x 256 tile
// (48 KB for 4.2 MFLOP) ran the weight-gradient products at ~570 TFLOP/s
// with a 4-stage ring, but ptxas spilled its consumers (8 bytes with the
// plainest epilogue, up to 412 with GELU's), and with the 3 stages that
// fit beside a spill-free epilogue it was no faster than 128 x 128.
//
// Design. A persistent grid, one CTA an SM, walks the work items (part,
// m-tile, n-tile), n-tile fastest, so that the CTAs running together read
// the same rows of A and all of B from L2. A CTA is one producer warpgroup
// and two consumer warpgroups, each consumer the 64 rows of the 128 x 128
// tile on its side (wgmma m64n128k16). One thread of the producer issues
// 2-D TMA loads of each k-step's A and B tiles (kBK = 64 values, one
// 128-byte swizzled row) into a kStages-deep ring, with a `full` barrier
// (the copies' bytes) and an `empty` barrier (one arrival from each
// consumer warp once its products have read the stage); it walks on into
// the next work item while the consumers run the epilogue of the last.
// The producer gives up registers (setmaxnreg) to the consumers. Each
// tensor map's extent is the operand's range in this launch: past it TMA
// writes zeros, which take the place of masks at the edges of M, N and K.
// A K-contiguous operand lands K-major; an M- or N-contiguous one lands as
// 64-column blocks of kBK rows, read MN-major through the descriptor's
// transpose bit.
//
// Sums. The tensor cores' f32 sums round toward zero (flash_mma.cuh,
// tile_sum), so the products of kFold k-steps go into a fresh part
// accumulator (scale_d = 0 on the first), which is added into the running
// f32 sums by ordinary adds after its wait_group: the fold interval is
// kFold kBK = 128 values. A part is waited for before it is read (one
// group in flight a consumer), so that ptxas serialises no wgmma (C7514);
// the two consumers' products interleave on the tensor cores. Every output
// is summed by one consumer thread in k order: two calls give the same
// bits, and a part's sum does not depend on the parts launched beside it.
//
// The tile-store epilogue (BiasTile: the products with a bias alone, or a
// bias and an activation, at K = 512, where the functor epilogue below sat
// on the tensor cores' critical path, ~200 TFLOP/s): each consumer thread
// reads the bias of its 32 columns once per tile, before the tile's
// products; after them it writes
// bf16(sum + bias) of its 64 sums straight from the accumulator layout
// into a 128-byte swizzled 64 x 64 block of shared memory (no bank
// conflict), and one thread of the consumer stores the consumer's two
// blocks by TMA (cp.async.bulk.tensor, a bulk group) and goes on: the
// consumer's next products start at once, and it waits for the group to
// have read the staging only at its next tile's epilogue. Such a launch
// may also walk two outputs side by side, the n-tiles of the first then
// those of the second, each with its own B and output maps and bias (the
// attention block's q and [k | v] in one launch); or one output and its
// activation (the MLP's y and gelu(y)), staged and stored one after the
// other through the same blocks.
//
// Epilogue. A consumer's sums go through shared memory kPassCols columns
// at a time and come back a row segment a warp, so that the epilogue's
// reads and writes of a row are contiguous; a thread reads what the
// epilogue needs of all its rows (epi.load) before it stores any, so that
// those reads are in flight together. An epilogue with kColSums also
// returns, for each pair, two f32 values, which the kernel sums over each
// consumer's 64 rows column by column in a fixed order (a thread's rows in
// order, the two half-warps, then the four warps through shared memory)
// and hands to epi.col_sum(block, n, sum) once per 64-row block.
//
// Bounds: M, N, K >= 1, parts >= 1, k_split a positive multiple of kBK; N
// a multiple of 8, and so the contiguous dimension of each operand (K for
// a K-contiguous one, M where kAT), its leading dimension and the 16-byte
// alignment of its start (TMA reads rows at 16-byte strides); for a tile
// store the same of each output. Anything else returns an error before
// any launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "wgmma.cuh"

namespace wgemm {

using T = bf16::T;

constexpr int kBM = 128, kBN = 128;  // a CTA's tile of out
constexpr int kBK = 64;              // the k-step, in values
constexpr int kFold = 2;             // k-steps a part accumulator sums
constexpr int kStages = 6;           // depth of the TMA ring
constexpr int kConsumers = 2;        // consumer warpgroups of 64 rows
constexpr int kGroupRows = 64;       // a consumer's rows, and a block of column sums
constexpr int kThreads = 128 * (1 + kConsumers);
// Registers a thread once the producer has given its share up: 128 x 24 +
// 256 x 240 = 64,512 of the SM's 65,536 (ptxas itself caps a 384-thread
// kernel at 168).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// Bytes of a stage's A (kBM x kBK) and B (kBK x kBN) tiles; a 64-column
// block of an MN-major tile (kBK rows of 128 bytes).
constexpr int kTileBytes = kBM * kBK * 2;
constexpr int kBlockBytes = kBK * 128;
constexpr int kStage = 2 * kTileBytes;
// The epilogue's staging: each consumer's 64 rows of kPassCols columns in
// f32 at a row stride of kStageLd floats (the accumulator layout's stores
// are free of bank conflicts), and a float per column of each consumer
// warp for the column sums.
constexpr int kPassCols = 32;
constexpr int kStageLd = kPassCols + 8;
constexpr int kEpilogueBytes = kConsumers * 64 * kStageLd * 4 + kConsumers * 4 * kPassCols * 4;
// 1024 of slack to align the ring, the ring, the epilogue's staging, the
// barriers.
constexpr int kSmem = 1024 + kStages * kStage + kEpilogueBytes + 8 * 2 * kStages;
// The tile-store epilogue's staging instead: the bf16 tile, each
// consumer's 64 rows as two 64 x 64 blocks of 128-byte swizzled rows (one
// TMA store box each).
constexpr int kOutBlock = 64 * 128;
constexpr int kOutBytes = kBM * kBN * 2;
constexpr int kSmemTile = 1024 + kStages * kStage + kOutBytes + 8 * 2 * kStages;

static_assert(kBM == 2 * 64 && kBN == 2 * 64, "64-row and 64-column blocks of A and B");
static_assert(kBK * 2 == 128, "a k-step is one 128-byte swizzled row");
static_assert(kStageLd % 32 == 8, "rows g and g + 1 of a staged tile 8 banks apart");
static_assert(kOutBytes == 2 * kConsumers * kOutBlock, "a consumer's two 64-column blocks");

// The tensor maps of a tile-store launch (tile_kernel): A; B of the first
// output's n-tiles and of the second's (b[1] unused with one output); each
// output's, which the consumers store through.
struct Maps {
  CUtensorMap a;
  CUtensorMap b[2];
  CUtensorMap out[2];
};

// No activation: a tile-store launch writes bf16(sum + bias) alone.
struct NoAct {};

// The tile-store epilogue: out[which](m, n) = bf16(v), v = sum +
// bias[which][n], the f32 sum plus the widened bias rounded to nearest even
// once (mlp.cuh's PreactStore without g, bit for bit); n[which] is the
// output's width. With an activation Act (Act::apply(float)), the launch
// walks one output and also writes bf16(Act::apply(v)) of the same tile
// to the second output's map (PreactStore with g).
template <class Act = NoAct>
struct BiasTile {
  const T* bias[2];
  int n[2];
};

// Whether Epi is a tile-store epilogue, and its activation.
template <class Epi>
struct TileOf {
  static constexpr bool kTile = false;
  using Act = NoAct;
};
template <class A>
struct TileOf<BiasTile<A>> {
  static constexpr bool kTile = true;
  using Act = A;
};

// One work item: a part of K and a tile of output `which` (n0 within it).
struct Work {
  int part, m0, n0, which, kbeg, n_k;
};

// Work item w: n-tiles fastest; with kTwo, the first n_tiles0 of each row
// of tiles the first output's, the rest the second's.
template <bool kTwo>
__device__ __forceinline__ Work work_of(int w, int n_tiles, int n_tiles0, int per_part, int K,
                                        int k_split) {
  Work x;
  x.part = w / per_part;
  const int r = w % per_part;
  const int j = r % n_tiles;
  x.m0 = r / n_tiles * kBM;
  x.which = kTwo && j >= n_tiles0 ? 1 : 0;
  x.n0 = (j - x.which * n_tiles0) * kBN;
  x.kbeg = x.part * k_split;
  const int kend = min(K, x.kbeg + k_split);
  x.n_k = kend > x.kbeg ? (kend - x.kbeg + kBK - 1) / kBK : 0;
  return x;
}

// Descriptor of A at k-step kk (16 values) for consumer group c: K-major
// [m][k] rows of 128 bytes, the group's 64 rows from row 64 c; or MN-major
// [k][m], the group's 64-column block.
template <bool kAT>
__device__ __forceinline__ uint64_t a_desc(const unsigned char* a, int c, int kk) {
  if (kAT) return wg::desc<128>(a + c * kBlockBytes + kk * 16 * 128, kBlockBytes, 8 * 128);
  return wg::desc<128>(a + c * 64 * 128 + kk * 32, 16, 8 * 128);
}

// Descriptor of B at k-step kk: K-major [n][k] rows of 128 bytes; or
// MN-major [k][n], its two 64-column blocks.
template <bool kBT>
__device__ __forceinline__ uint64_t b_desc(const unsigned char* b, int kk) {
  if (kBT) return wg::desc<128>(b + kk * 32, 16, 8 * 128);
  return wg::desc<128>(b + kk * 16 * 128, kBlockBytes, 8 * 128);
}

__device__ __forceinline__ void fold(float (&acc)[64], float (&part)[64]) {
  wg::hold(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i];
}

// The kernel's body over the maps of A, of B for each output and, for the
// tile-store epilogue (BiasTile), of each output (with an activation: the
// activation's output); gemm_kernel (a functor epilogue, one output) and
// tile_kernel launch it.
template <bool kAT, bool kBT, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* ta, const CUtensorMap* tb0,
                                    const CUtensorMap* tb1, const CUtensorMap* tout0,
                                    const CUtensorMap* tout1, int M, int N, int n_tiles,
                                    int n_tiles0, int K, int k_split, int parts, const Epi& epi) {
  constexpr bool kTile = TileOf<Epi>::kTile;
  using Act = typename TileOf<Epi>::Act;
  constexpr bool kAct = !std::is_same<Act, NoAct>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out_s = ring + kStages * kStage;  // the tile store's staging
  float* ep_s = reinterpret_cast<float*>(out_s);  // or the functor epilogue's
  float* col_s = ep_s + kConsumers * 64 * kStageLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      kTile ? out_s + kOutBytes : reinterpret_cast<unsigned char*>(col_s + kConsumers * 4 * kPassCols));
  uint64_t* empty = full + kStages;

  const int per_part = (M + kBM - 1) / kBM * n_tiles;
  const int n_work = parts * per_part;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4 * kConsumers);
    }
    wg::fence_bar_init();
  }
  __syncthreads();

  if (warp < 4) {  // the producer
    wg::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;  // k-steps issued, over every work item
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work x = work_of<kTile>(w, n_tiles, n_tiles0, per_part, K, k_split);
        const CUtensorMap* tb = x.which ? tb1 : tb0;
        for (int kt = 0; kt < x.n_k; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) wg::wait(&empty[s], ((it / kStages) & 1) ^ 1);
          wg::arrive_expect(&full[s], kStage);
          unsigned char* as = ring + s * kStage;
          unsigned char* bs = as + kTileBytes;
          const int k0 = x.kbeg + kt * kBK;
          if (kAT) {
            wg::load_2d(as, ta, &full[s], x.m0, k0);
            wg::load_2d(as + kBlockBytes, ta, &full[s], x.m0 + 64, k0);
          } else {
            wg::load_2d(as, ta, &full[s], k0, x.m0);
          }
          if (kBT) {
            wg::load_2d(bs, tb, &full[s], k0, x.n0);
          } else {
            wg::load_2d(bs, tb, &full[s], x.n0, k0);
            wg::load_2d(bs + kBlockBytes, tb, &full[s], x.n0 + 64, k0);
          }
        }
      }
    }
    return;
  }

  wg::regs_inc<kConsumerRegs>();
  const int c = warp / 4 - 1, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  float* stage_s = ep_s + c * 64 * kStageLd;
  float* sums_s = col_s + c * 4 * kPassCols;

  // The thread of this consumer that issues and waits for its tile stores.
  const bool issuer = threadIdx.x % 128 == 0;
  float acc[64], part[64];
  int it = 0;  // k-steps consumed, over every work item
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const Work x = work_of<kTile>(w, n_tiles, n_tiles0, per_part, K, k_split);
    // A tile store's bias, read once per tile: this thread's columns 8 j +
    // 2 t and 8 j + 2 t + 1 of the tile, j = 0 ... 15, as stored.
    uint32_t bias[kTile ? kBN / 8 : 1];
    if constexpr (kTile) {
      const T* bp = x.which ? epi.bias[1] : epi.bias[0];
      const int nw = x.which ? epi.n[1] : epi.n[0];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = x.n0 + 8 * j + 2 * t;  // nw % 8 == 0: n + 1 is in range too
        bias[j] = n < nw ? __ldg(reinterpret_cast<const unsigned int*>(bp + n)) : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // kFold k-steps at a time: their products into the fresh part
    // accumulator, waited for and added.
    for (int kt = 0; kt < x.n_k; kt += kFold) {
      const int nq = min(kFold, x.n_k - kt);
      for (int q = 0; q < nq; ++q) {
        const int u = it + kt + q;
        wg::wait(&full[u % kStages], (u / kStages) & 1);
      }
      wg::fence();
#pragma unroll
      for (int q = 0; q < kFold; ++q) {
        if (q < nq) {
          const unsigned char* as = wg::launder(ring) + (it + kt + q) % kStages * kStage;
          const unsigned char* bs = as + kTileBytes;
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wg::Mma<128>::template ss<kAT ? 1 : 0, kBT ? 0 : 1>(
                part, a_desc<kAT>(as, c, kk), b_desc<kBT>(bs, kk), q > 0 || kk > 0);
        }
      }
      wg::commit();
      wg::wait_group<0>();
      fold(acc, part);
      __syncwarp();
      if (lane == 0) {  // this warp has read the stages
        for (int q = 0; q < nq; ++q) wg::arrive(&empty[(it + kt + q) % kStages]);
      }
    }
    it += x.n_k;

    if constexpr (kTile) {
      // bf16(v), v = sum + bias, into this consumer's two staging blocks,
      // acc[4 j + e] (row r = 16 wq + g + 8 (e / 2), column 8 j + 2 t + e %
      // 2) at block j / 8, row r, 16-byte chunk (j % 8) ^ (r % 8) (TMA's
      // 128-byte swizzle; r % 8 == g), once the last stores have read
      // them; then the TMA stores. With an activation, acc takes Act(v),
      // which follows through the same blocks once the first stores have
      // read them.
      unsigned char* st = out_s + c * 2 * kOutBlock;
      const int m = x.m0 + 64 * c;
      const int nw = x.which ? epi.n[1] : epi.n[0];
#pragma unroll
      for (int pass = 0; pass < (kAct ? 2 : 1); ++pass) {
        if (issuer) wg::store_wait<0, true>();
        wg::sync_threads(1 + c, 128);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + g + 8 * h;
            float& lo = acc[4 * j + 2 * h];
            float& hi = acc[4 * j + 2 * h + 1];
            if (pass == 0) {
              lo += bf16::lo(bias[j]);
              hi += bf16::hi(bias[j]);
            }
            *reinterpret_cast<uint32_t*>(st + (j / 8) * kOutBlock + r * 128 +
                                         ((j % 8) ^ g) * 16 + 4 * t) = bf16::pack(lo, hi);
            if constexpr (kAct) {
              if (pass == 0) {
                lo = Act::apply(lo);
                hi = Act::apply(hi);
              }
            }
          }
        }
        wg::fence_async_shared();  // the writes, before the async proxy reads them
        wg::sync_threads(1 + c, 128);
        if (issuer) {
          const CUtensorMap* map = pass == 1 || x.which ? tout1 : tout0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m < M && x.n0 + 64 * h < nw)
              wg::store_2d(map, st + h * kOutBlock, x.n0 + 64 * h, m);
          }
          wg::store_commit();
        }
      }
    } else {
      // The epilogue, kPassCols columns at a time: acc[4 j + e] (row 16 wq +
      // g + 8 (e / 2) of the group's 64, column 8 j + 2 t + e % 2) goes to
      // shared memory and comes back with lane l of warp wq holding columns
      // 2 p and 2 p + 1, p = l % 16, of rows 16 wq + 2 i + l / 16, i = 0 ...
      // 7.
      const int m_first = x.m0 + 64 * c;
      constexpr int kJ = kPassCols / 8, kIters = 8;
      const int p = lane % 16;
#pragma unroll
      for (int pp = 0; pp < kBN / kPassCols; ++pp) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int j = pp * kJ + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(stage_s + (16 * wq + g + 8 * h) * kStageLd + 8 * jj + 2 * t) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        wg::sync_threads(1 + c, 128);
        const int n = x.n0 + kPassCols * pp + 2 * p;
        using In = decltype(epi.load(0, 0));
        In in[kIters];
#pragma unroll
        for (int i = 0; i < kIters; ++i) {
          const int r = 16 * wq + 2 * i + lane / 16;
          if (m_first + r < M && n < N) in[i] = epi.load(m_first + r, n);
        }
        float2 cs = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kIters; ++i) {
          const int r = 16 * wq + 2 * i + lane / 16;
          if (m_first + r < M && n < N) {  // N % 8 == 0: n + 1 < N too
            const float2 v = *reinterpret_cast<const float2*>(stage_s + r * kStageLd + 2 * p);
            if constexpr (Epi::kColSums) {
              const float2 d = epi(m_first + r, n, v, x.part, in[i]);
              cs.x += d.x;
              cs.y += d.y;
            } else {
              epi(m_first + r, n, v, x.part, in[i]);
            }
          }
        }
        if constexpr (Epi::kColSums) {
          cs.x += __shfl_xor_sync(0xffffffffu, cs.x, 16);
          cs.y += __shfl_xor_sync(0xffffffffu, cs.y, 16);
          if (lane < 16) *reinterpret_cast<float2*>(sums_s + wq * kPassCols + 2 * lane) = cs;
          wg::sync_threads(1 + c, 128);
          const int col = threadIdx.x % 128;
          if (col < kPassCols && m_first < M && x.n0 + kPassCols * pp + col < N)
            epi.col_sum(m_first / 64, x.n0 + kPassCols * pp + col,
                        ((sums_s[col] + sums_s[kPassCols + col]) + sums_s[2 * kPassCols + col]) +
                            sums_s[3 * kPassCols + col]);
        }
        wg::sync_threads(1 + c, 128);  // read before it is written again
      }
    }
  }
  if constexpr (kTile) {
    if (issuer) wg::store_wait<0, false>();
  }
}

template <bool kAT, bool kBT, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            int M, int N, int K, int k_split, int parts, Epi epi) {
  const int n_tiles = (N + kBN - 1) / kBN;
  run<kAT, kBT>(&ta, &tb, &tb, nullptr, nullptr, M, N, n_tiles, n_tiles, K, k_split, parts, epi);
}

// The tile-store epilogue's launch: A K-contiguous, B N-contiguous, K in
// one part; n_tiles n-tiles, the first n_tiles0 of them the first output's.
template <class Act>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(const __grid_constant__ Maps maps, int M, int n_tiles, int n_tiles0, int K,
            int k_split, BiasTile<Act> epi) {
  run<false, false>(&maps.a, &maps.b[0], &maps.b[1], &maps.out[0], &maps.out[1], M, 0, n_tiles,
                    n_tiles0, K, k_split, 1, epi);
}

inline bool aligned16(const void* p, int64_t ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

// The map of A (M x K) as run loads it.
template <bool kAT>
bool map_a(CUtensorMap* map, const T* a, int64_t lda, int M, int K) {
  return kAT ? wg::encode_bf16_2d(map, a, M, K, lda, kBK) : wg::encode_bf16_2d(map, a, K, M, lda, kBM);
}

// The map of B (K x N) as run loads it.
template <bool kBT>
bool map_b(CUtensorMap* map, const T* b, int64_t ldb, int K, int N) {
  return kBT ? wg::encode_bf16_2d(map, b, K, N, ldb, kBN) : wg::encode_bf16_2d(map, b, N, K, ldb, kBK);
}

// The grid of a launch of `work` items: one CTA an SM, at most one an
// item; sets the kernel's shared memory. Returns 0 on an error.
template <class Kernel>
int persistent_grid(Kernel kernel, int smem, int64_t work, cudaError_t* err) {
  *err = work > INT32_MAX ? cudaErrorInvalidValue : cudaSuccess;
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (*err == cudaSuccess) *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return *err == cudaSuccess ? static_cast<int>(work < sms ? work : sms) : 0;
}

// Launches the product over `parts` parts of K of k_split each (the last
// may be shorter) on `stream`, its epilogue a functor; returns the
// launch's error. The tensor maps are encoded here, each over the
// operand's range in this launch.
template <bool kAT, bool kBT, class Epi>
cudaError_t gemm_parts(const T* a, int64_t lda, const T* b, int64_t ldb, int M, int N, int K,
                       int parts, int k_split, Epi epi, cudaStream_t stream) {
  const bool k_chunks = !kAT || kBT;  // some operand is K-contiguous
  if (M <= 0 || N <= 0 || K <= 0 || parts <= 0 || k_split <= 0 || k_split % kBK != 0 ||
      N % 8 != 0 || (kAT && M % 8 != 0) || (k_chunks && K % 8 != 0))
    return cudaErrorInvalidValue;
  if (!aligned16(a, lda) || !aligned16(b, ldb)) return cudaErrorMisalignedAddress;
  CUtensorMap ta, tb;
  if (!map_a<kAT>(&ta, a, lda, M, K) || !map_b<kBT>(&tb, b, ldb, K, N))
    return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<kAT, kBT, Epi>;
  cudaError_t err;
  const int grid = persistent_grid(
      kernel, kSmem, static_cast<int64_t>(parts) * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN),
      &err);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmem, stream>>>(ta, tb, M, N, K, k_split, parts, epi);
  return cudaGetLastError();
}

// out[i] = bf16(v), v = a w[i] + bias[i] (M x n[i], row stride n[i]) for
// the outputs i < count (1 or 2) in one launch, from a (M x K, K
// contiguous) and w[i] (K x n[i], N contiguous), K in one part; the
// tile-store epilogue. With an activation Act, count is 1 and act_out
// (M x n[0]) gets bf16(Act::apply(v)). Returns the launch's error.
template <class Act = NoAct>
cudaError_t bias_products(const T* a, int M, int K, int count, const T* const* w,
                          const T* const* bias, T* const* out, const int* n, T* act_out,
                          cudaStream_t stream) {
  constexpr bool kAct = !std::is_same<Act, NoAct>::value;
  if (M <= 0 || K <= 0 || K % 8 != 0 || count < 1 || count > (kAct ? 1 : 2) ||
      !aligned16(a, K))
    return cudaErrorInvalidValue;
  Maps maps = {};
  BiasTile<Act> epi = {};
  int tiles[2] = {0, 0};
  if (!map_a<false>(&maps.a, a, K, M, K)) return cudaErrorInvalidValue;
  if (kAct && (!aligned16(act_out, n[0]) ||
               !wg::encode_bf16_2d(&maps.out[1], act_out, n[0], M, n[0], 64)))
    return cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0 || n[i] % 8 != 0) return cudaErrorInvalidValue;
    if (!aligned16(w[i], n[i]) || !aligned16(out[i], n[i]) ||
        reinterpret_cast<uintptr_t>(bias[i]) % 4 != 0)
      return cudaErrorMisalignedAddress;
    if (!map_b<false>(&maps.b[i], w[i], n[i], K, n[i]) ||
        !wg::encode_bf16_2d(&maps.out[i], out[i], n[i], M, n[i], 64))
      return cudaErrorInvalidValue;
    epi.bias[i] = bias[i];
    epi.n[i] = n[i];
    tiles[i] = (n[i] + kBN - 1) / kBN;
  }
  const int k_split = (K + kBK - 1) / kBK * kBK;
  cudaError_t err;
  const int grid = persistent_grid(
      tile_kernel<Act>, kSmemTile,
      static_cast<int64_t>((M + kBM - 1) / kBM) * (tiles[0] + tiles[1]), &err);
  if (err != cudaSuccess) return err;
  tile_kernel<Act><<<grid, kThreads, kSmemTile, stream>>>(maps, M, tiles[0] + tiles[1], tiles[0],
                                                           K, k_split, epi);
  return cudaGetLastError();
}

}  // namespace wgemm
