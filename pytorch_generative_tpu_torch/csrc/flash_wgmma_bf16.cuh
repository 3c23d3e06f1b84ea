// The bf16 flash kernels (flash_fwd.cu's flash_fwd_bf16, flash_bwd.cu's
// flash_bwd_bf16) for Hopper: every product on warpgroup wgmma with bf16
// operands and f32 sums, operand tiles brought in by TMA into an mbarrier
// ring (wgmma.cuh).
//
// They replace pytorch_generative_tpu/ops/attention_pallas.py::_fwd_kernel
// and ::_bwd_fused_kernel for bf16 operands, at that kernel's rounding
// points (attention_pallas.py:137-198, :250-290): q2 = bf16(q * scale *
// log2 e) is the operand in place of q; S = q2 K^T with f32 sums and the
// online softmax in base 2 in f32; P rounded to bf16 for P V while the row
// sums take the f32 P; out = O / l rounded to bf16 once; lse a natural log
// in f32 (-inf, and out exactly 0, for a fully masked row). The backward
// rebuilds p from q2 and lse, delta = rowsum(dO O) in f32, dV = bf16(p)^T
// dO, dS = p (dO V^T - delta) in f32 rounded to bf16 as an A operand, dQ =
// bf16(dS) K * scale and dK = bf16(dS)^T q2 * ln 2, each summed in f32 and
// rounded once. `mask_center` shifts the diagonal by one.
//
// What bounds them on an H100: at ImageGPT's C = 512 (B 64, L 784, 8 heads
// of 64) the forward does 40 GFLOP (~0.041 ms at 989 TFLOP/s) against 4 x
// 51 MB of q, k, v and out (~0.061 ms at 3.35 TB/s), the backward 101 GFLOP
// against 8 x 51 MB: bytes, with the operations close behind. The mma.sync
// kernels these replace reached 7-18% of that bound: a warp of 16 rows read
// every K and V tile from shared memory by ldmatrix for itself, and the
// copies were issued by the warps that compute.
//
// Design. A CTA is one producer warpgroup and NC consumer warpgroups of 64
// rows each (forward and dq pass: query rows; dk/dv pass: keys), NC = 3 at
// d <= 64 and 2 at d = 128 (groups()): as many as the registers of their
// accumulators allow, since each group's chain of waits is long and the
// groups hide each other's. One thread of the producer issues the TMA
// loads: the CTA's resident tiles once, then the streamed tiles (64 keys,
// or 32 query rows in the dk/dv pass) into a ring of kStages stages, each
// with a `full` barrier (the copies' bytes) and an `empty` barrier (one
// arrival per consumer warp when its products have read the stage). The
// producer gives up registers (setmaxnreg) to the consumers. Tiles are read through 3-D
// tensor maps (feature, row, batch) over the packed (B, L, H d) operands
// with the box at column h d, so the ragged last tile (L = 784 = 12 x 64 +
// 16) is zero-filled by TMA rather than read from the next image; rows land
// with the 32-, 64- or 128-byte swizzle of their width (d = 128 as two
// 64-column parts), which is the layout wgmma reads: K-major where the
// product's k index runs along the features (q2 K^T, dO V^T, K q2^T,
// V dO^T), MN-major, by the descriptor's transpose bit, where it runs over
// the rows (P V, dS K, P^T dO, dS^T q2). P and dS go from the S and dP
// accumulators into the next product as register A operands, rounded to
// bf16 there: the accumulator of 16 rows x 16 columns is the A fragment.
// A consumer group issues a step's products together (a tile's scores with
// the previous tile's P V, or dS K, or dV and dK) and waits for all of
// them before it touches an accumulator, so ptxas serialises no wgmma
// (C7514); one group's softmax runs under the other groups' products.
//
// Sums. The forward adds each key tile's P V, summed in fresh accumulators,
// to O in f32, since O is rescaled by the softmax between tiles and the
// tensor cores' f32 sums round toward zero (flash_mma.cuh, tile_sum). The
// backward's dQ, dK and dV sum over tiles in the wgmma accumulators: a
// fresh part beside each would take 2 d more registers a thread than the
// d = 128 dk/dv pass has. Every output element is summed in one fixed
// order: two calls give equal bits.
//
// Backward: two passes, as the f32 route (flash_bwd.cu's preamble: blocks
// run in no order, and no atomics). The dq pass, one CTA per (64 NC-row
// query tile, head, batch), computes delta for its rows and stores it; the
// dk/dv pass, one CTA per (64 NC-key tile, head, batch), streams the query
// tiles from the diagonal on. Its streamed q tile becomes q2 in place, and its
// rows' lse and delta are staged beside it, by the producer's other three
// warps, which then arrive on the stage's `ready` barrier.
//
// The fused attention block's forward (attn_block_fwd.cu) runs the forward
// kernel with kQ2 = false, at that kernel's rounding points
// (attn_block_pallas.py:95-113): q stays bf16(q), and S = q K^T is scaled
// in f32 by scale * log2 e before the base-2 softmax, where the flash
// kernel rounds q * scale * log2 e to bf16 first.
//
// Scheduling: the tiles of one (head, batch) are the grid's fastest index,
// so the CTAs that read the same K and V (or q and dO) run together and
// find them in L2; among them the heavy tiles start first (the forward and
// dq pass count their query tiles down; the dk/dv pass's first key tiles
// see the most queries). Key tiles wholly below a warp's diagonal take no
// mask.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cmath>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma.cuh"

namespace fwg {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kStages = 3;

// Consumer warpgroups a CTA by head width: three where their accumulators
// fit in the 160 registers a thread that three groups leave (d <= 64),
// else two; and the registers of a producer and of a consumer thread once
// the producer has given its share up.
template <int D>
__host__ __device__ constexpr int groups() {
  return D <= 64 ? 3 : 2;
}
template <int NC>
__host__ __device__ constexpr int producer_regs() {
  return NC == 3 ? 32 : 40;  // 128 x 32 + 384 x 160 = 65,536; 128 x 40 + 256 x 232 = 64,512
}
template <int NC>
__host__ __device__ constexpr int consumer_regs() {
  return NC == 3 ? 160 : 232;
}

// A row of D bf16 features lands as parts() parts of part_cols() values;
// a part's row is swizzle() bytes.
template <int D>
__host__ __device__ constexpr int part_cols() {
  return D < 64 ? D : 64;
}
template <int D>
__host__ __device__ constexpr int parts() {
  return D / part_cols<D>();
}
template <int D>
__host__ __device__ constexpr int swizzle() {
  return 2 * part_cols<D>();
}
// Keys a forward or dq pass key tile; query rows a dk/dv pass tile: sizes
// at which every instance's accumulators fit its registers without a
// spill (the dk/dv pass holds dK and dV, 2 d / 2 values a thread, besides
// S^T and dP^T).
constexpr int kFwdCols = 64;
constexpr int kDqCols = 64;
constexpr int kDkdvRows = 32;

// Rows of one TMA box: every tile that a map loads is a whole number of
// boxes.
constexpr int kBoxRows = kDkdvRows;

// Bytes of a tile of R rows of D features (parts() parts of R rows each).
template <int R, int D>
__host__ __device__ constexpr int tile_bytes() {
  return R * D * 2;
}

// Starts the loads of rows [row0, row0 + R) of head h of batch b into the
// tile at dst, completing on bar.
template <int R, int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row0, int b) {
  constexpr int PC = part_cols<D>(), SW = swizzle<D>(), BR = kBoxRows;
  static_assert(R % BR == 0, "a tile is a whole number of TMA boxes");
#pragma unroll
  for (int p = 0; p < parts<D>(); ++p) {
#pragma unroll
    for (int r = 0; r < R; r += BR)
      wg::load_3d(dst + (p * R + r) * SW, map, bar, h * D + p * PC, row0 + r, b);
  }
}

// K-major descriptor of rows [r0, r0 + 64 or N) of a tile of R rows, at
// k-step kk (features 16 kk ... 16 kk + 15).
template <int R, int D>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int r0, int kk) {
  constexpr int PC = part_cols<D>(), SW = swizzle<D>();
  const int p = kk * 16 / PC, within = (kk * 16 % PC) * 2;
  return wg::desc<SW>(tile + (p * R + r0) * SW + within, 16, 8 * SW);
}

// MN-major descriptor of a tile of R rows as B (k index over rows 16 j ...
// 16 j + 15, N index over the features of part p).
template <int R, int D>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int j, int p) {
  constexpr int SW = swizzle<D>();
  return wg::desc<SW>(tile + (p * R + 16 * j) * SW, R * SW, 8 * SW);
}

// In place, rows [r0, r0 + R) of every part of a tile of RT rows: x times
// mul in f32, rounded to bf16; chunk i of this thread's share for i = first,
// first + step, ... The swizzle moves whole 16-byte chunks, which this
// leaves in place, so it needs no layout.
template <int RT, int R, int D>
__device__ __forceinline__ void scale_rows(unsigned char* tile, int r0, float mul, int first,
                                           int step) {
  constexpr int SW = swizzle<D>(), kChunks = R * SW / 16;
#pragma unroll
  for (int p = 0; p < parts<D>(); ++p) {
    uint4* c = reinterpret_cast<uint4*>(tile + (p * RT + r0) * SW);
    for (int i = first; i < kChunks; i += step) {
      uint4 v = c[i];
      v.x = bf16::pack(bf16::lo(v.x) * mul, bf16::hi(v.x) * mul);
      v.y = bf16::pack(bf16::lo(v.y) * mul, bf16::hi(v.y) * mul);
      v.z = bf16::pack(bf16::lo(v.z) * mul, bf16::hi(v.z) * mul);
      v.w = bf16::pack(bf16::lo(v.w) * mul, bf16::hi(v.w) * mul);
      c[i] = v;
    }
  }
}

// The 16-column blocks of an accumulator (N/2 values a thread), rounded to
// bf16, as register A fragments: block j's rows g and g + 8, columns 16 j +
// 2t, +1 and 16 j + 8 + 2t, +1.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = bf16::pack(c[8 * j + 2 * e], c[8 * j + 2 * e + 1]);
  }
}

// x (D/2 values a thread, part p's accumulators at [p]) times mul, rounded
// to bf16, to row `row` of a packed (., H D) output at dst (the row's head's
// first feature); half i picks rows g (0) or g + 8 (1).
template <int D>
__device__ __forceinline__ void store_row(bf16::T* dst, const float (&x)[parts<D>()][part_cols<D>() / 2],
                                          int i, int t, float mul) {
#pragma unroll
  for (int p = 0; p < parts<D>(); ++p) {
#pragma unroll
    for (int j = 0; j < part_cols<D>() / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + p * part_cols<D>() + 8 * j + 2 * t) =
          bf16::pack(x[p][4 * j + 2 * i] * mul, x[p][4 * j + 2 * i + 1] * mul);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&x)[parts<D>()][part_cols<D>() / 2]) {
#pragma unroll
  for (int p = 0; p < parts<D>(); ++p) {
#pragma unroll
    for (int i = 0; i < part_cols<D>() / 2; ++i) x[p][i] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ void hold_parts(float (&x)[parts<D>()][part_cols<D>() / 2]) {
#pragma unroll
  for (int p = 0; p < parts<D>(); ++p) wg::hold(x[p]);
}

// 2^x by one MUFU.EX2 (ex2.approx.ftz: results under 2^-126, which no
// output can tell from 0, flush to 0; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- forward ----

template <int D, int NC>
struct Fwd {
  static constexpr int BM = 64 * NC, BN = kFwdCols;
  static constexpr int kQ = tile_bytes<BM, D>(), kKV = tile_bytes<BN, D>();
  static constexpr int kStage = 2 * kKV;
  // 1024 of slack to align the tiles, then Q, the ring and the barriers.
  static constexpr int kSmem = 1024 + kQ + kStages * kStage + 8 * (1 + 2 * kStages);
};

// One CTA per (BM-row query tile, head, batch): grid (query tiles, H, B),
// the last query tile first. kQ2: q2 = bf16(q * scale_log2) in place of q
// (the flash kernel), or q as it is and S scaled in f32 (the fused block).
template <int D, int NC, bool kQ2>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16::T* __restrict__ out,
                       float* __restrict__ lse, int L, int H, float scale_log2, int offset) {
  using F = Fwd<D, NC>;
  constexpr int BM = F::BM, BN = F::BN, PC = part_cols<D>(), P = parts<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + F::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * F::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int n_tiles = (min(L, row0 + BM) + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    wg::bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4 * NC);
    }
    wg::fence_bar_init();
  }
  __syncthreads();

  if (warp < 4) {  // the producer
    wg::regs_dec<producer_regs<NC>()>();
    if (threadIdx.x == 0) {
      wg::arrive_expect(q_full, F::kQ);
      load_tile<BM, D>(qs, &tq, q_full, h, row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) wg::wait(&empty[s], ((j / kStages) & 1) ^ 1);
        wg::arrive_expect(&full[s], F::kStage);
        unsigned char* ks = ring + s * F::kStage;
        load_tile<BN, D>(ks, &tk, &full[s], h, j * BN, b);
        load_tile<BN, D>(ks + F::kKV, &tv, &full[s], h, j * BN, b);
      }
    }
    return;
  }

  wg::regs_inc<consumer_regs<NC>()>();
  const int grp = warp / 4 - 1, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = row0 + 64 * grp;      // the group's first row
  const int rw = r0 + 16 * w;          // the warp's
  const int rows[2] = {rw + g, rw + g + 8};
  const int n_mine = r0 < L ? (min(L, r0 + 64) + BN - 1) / BN : 0;

  // q2 = bf16(q * scale * log2 e), the group's rows, in place.
  wg::wait(q_full, 0);
  if constexpr (kQ2) {
    scale_rows<BM, 64, D>(qs, 64 * grp, scale_log2, threadIdx.x % 128, 128);
    wg::fence_async_shared();
    wg::sync_threads(1 + grp, 128);
  }

  float o[P][PC / 2];
  zero<D>(o);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  // The key tiles as a pipeline, a step a tile and one more: step j issues
  // tile j's scores and tile j - 1's P V together, so that one wait covers
  // both (and the tensor cores run them back to back), adds the P V to O,
  // then forms tile j's P. Each part is written once, so it stays in
  // registers, and no accumulator is touched while a product that writes
  // it is in flight. Every group takes every step, and waits for and
  // releases the stages of the tiles it skips.
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];      // bf16(P) of tile j - 1
  float alpha[2] = {0.f, 0.f};  // its rescale of O
  for (int j = 0; j <= n_tiles; ++j) {
    const bool fresh = j < n_mine, prev = j > 0 && j - 1 < n_mine;
    if (fresh) wg::wait(&full[j % kStages], (j / kStages) & 1);
    if (fresh) {  // S = q2 K_j^T
      const int s = j % kStages;
      const unsigned char* ks = ring + s * F::kStage;
      const unsigned char* q2s = wg::launder(qs);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::Mma<BN>::ss(sc, kmajor<BM, D>(q2s, 64 * grp, kk), kmajor<BN, D>(ks, 0, kk), kk > 0);
    }
    float pv[P][PC / 2];
    if (prev) {  // tile j - 1's bf16(P) V in fresh accumulators
      const unsigned char* vs = ring + ((j - 1) % kStages) * F::kStage + F::kKV;
      wg::hold(pa);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          wg::Mma<PC>::template rs<1>(pv[p], pa[kk], mnmajor<BN, D>(vs, kk, p), kk > 0);
      }
    }
    wg::commit();
    wg::wait_group<0>();
    if (prev) {  // O = alpha O + tile j - 1's P V
      hold_parts<D>(pv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < PC / 2; ++i) o[p][i] = o[p][i] * alpha[(i % 4) / 2] + pv[p][i];
      }
      __syncwarp();
      if (lane == 0) wg::arrive(&empty[(j - 1) % kStages]);  // this warp has read the stage
    }
    if (fresh) {
      // Online softmax of tile j in base 2; a row masked so far keeps m =
      // -inf, p = 0.
      wg::hold(sc);
      if constexpr (!kQ2) {  // S = (q K^T) scale, in base 2
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
      }
      const int key0 = j * BN;
      if (key0 + BN - 1 + offset > rw) {  // the tile reaches the warp's diagonal
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          if (key0 + 8 * (i / 4) + 2 * t + i % 2 + offset > rows[(i % 4) / 2])
            sc[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = isinf(mx[r]) ? 0.f : mx[r];
        alpha[r] = ex2(m[r] - base[r]);  // 0 while m = -inf
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = ex2(sc[i] - base[(i % 4) / 2]);  // masked: exp2(-inf) == 0
        l[(i % 4) / 2] += sc[i];
      }
      to_a<BN>(pa, sc);
    } else if (j < n_tiles) {
      // A tile this group skips: an arrival on `empty` before the stage is
      // full would count toward a later use.
      wg::wait(&full[j % kStages], (j / kStages) & 1);
      __syncwarp();
      if (lane == 0) wg::arrive(&empty[j % kStages]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] < L) {
      const int64_t row = static_cast<int64_t>(b) * L + rows[i];
      store_row<D>(out + row * H * D + h * D, o, i, t, 1.f / (l[i] == 0.f ? 1.f : l[i]));
      if (t == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * L + rows[i]] =
            l[i] == 0.f ? -CUDART_INF_F : m[i] * kLn2 + logf(fmaxf(l[i], 1e-38f));
      }
    }
  }
}

// ---- backward: dq pass ----

template <int D, int NC>
struct Dq {
  static constexpr int BM = 64 * NC, BN = kDqCols;
  static constexpr int kQ = tile_bytes<BM, D>(), kKV = tile_bytes<BN, D>();
  static constexpr int kStage = 2 * kKV;
  // slack, q2 | dO, the ring, lse2 | delta (BM f32 each), barriers.
  static constexpr int kSmem = 1024 + 2 * kQ + kStages * kStage + 8 * BM + 8 * (1 + 2 * kStages);
};

// One CTA per (BM-row query tile, head, batch), the last first. Writes dq
// and the tile's delta.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const bf16::T* __restrict__ out, const bf16::T* __restrict__ dout,
                          const float* __restrict__ lse, bf16::T* __restrict__ dq,
                          float* __restrict__ delta, int L, int H, int64_t o_bs, int64_t o_rs,
                          int64_t do_bs, int64_t do_rs, float scale, float scale_log2,
                          int offset) {
  using F = Dq<D, NC>;
  constexpr int BM = F::BM, BN = F::BN, PC = part_cols<D>(), P = parts<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + F::kQ;
  unsigned char* ring = dos + F::kQ;
  float* lse_s = reinterpret_cast<float*>(ring + kStages * F::kStage);  // base 2, +inf: p = 0
  float* delta_s = lse_s + BM;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(delta_s + BM);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int n_tiles = (min(L, row0 + BM) + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    wg::bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4 * NC);
    }
    wg::fence_bar_init();
  }
  __syncthreads();

  if (warp < 4) {  // the producer
    wg::regs_dec<producer_regs<NC>()>();
    if (threadIdx.x == 0) {
      wg::arrive_expect(q_full, 2 * F::kQ);
      load_tile<BM, D>(qs, &tq, q_full, h, row0, b);
      load_tile<BM, D>(dos, &tdo, q_full, h, row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) wg::wait(&empty[s], ((j / kStages) & 1) ^ 1);
        wg::arrive_expect(&full[s], F::kStage);
        unsigned char* ks = ring + s * F::kStage;
        load_tile<BN, D>(ks, &tk, &full[s], h, j * BN, b);
        load_tile<BN, D>(ks + F::kKV, &tv, &full[s], h, j * BN, b);
      }
    }
    return;
  }

  wg::regs_inc<consumer_regs<NC>()>();
  const int grp = warp / 4 - 1, w = warp % 4, tid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int r0 = row0 + 64 * grp;
  const int rw = r0 + 16 * w;
  const int rows[2] = {rw + g, rw + g + 8};
  const int n_mine = r0 < L ? (min(L, r0 + 64) + BN - 1) / BN : 0;

  // delta = dO . O in f32 for the group's rows, two threads a row, from
  // global memory; lse in base 2, +inf (p = 0) past L and on fully-masked
  // rows.
  {
    const int rr = tid / 2, half = tid % 2;
    const int row = r0 + rr;
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
    float dlt = 0.f;
    if (row < L) {
      const uint4* dp = reinterpret_cast<const uint4*>(dout + b * do_bs + row * do_rs + h * D +
                                                       half * (D / 2));
      const uint4* op = reinterpret_cast<const uint4*>(out + b * o_bs + row * o_rs + h * D +
                                                       half * (D / 2));
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        float x[8], y[8];
        bf16::unpack8(x, dp[i]);
        bf16::unpack8(y, op[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) dlt += x[e] * y[e];
      }
    }
    dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
    if (half == 0) {
      delta_s[64 * grp + rr] = dlt;
      if (row < L) delta[stat] = dlt;
    } else {
      const float l2 = row < L ? lse[stat] : -CUDART_INF_F;
      lse_s[64 * grp + rr] = isinf(l2) ? CUDART_INF_F : l2 * kLog2e;
    }
  }
  wg::wait(q_full, 0);
  scale_rows<BM, 64, D>(qs, 64 * grp, scale_log2, tid, 128);  // q becomes q2
  wg::fence_async_shared();
  wg::sync_threads(1 + grp, 128);
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[64 * grp + 16 * w + g + 8 * i];
    dlt[i] = delta_s[64 * grp + 16 * w + g + 8 * i];
  }

  // The key tiles as a pipeline, as in the forward: step j issues tile
  // j's S and dP and tile j - 1's dS K together, then forms tile j's dS.
  float acc[P][PC / 2];
  zero<D>(acc);
  float sc[BN / 2], dp[BN / 2];
  uint32_t a[BN / 16][4];  // bf16(dS) of tile j - 1
  for (int j = 0; j <= n_tiles; ++j) {
    const bool fresh = j < n_mine, prev = j > 0 && j - 1 < n_mine;
    if (fresh) wg::wait(&full[j % kStages], (j / kStages) & 1);
    if (fresh) {  // S = q2 K_j^T and dP = dO V_j^T
      const int s = j % kStages;
      const unsigned char* ks = ring + s * F::kStage;
      const unsigned char* vs = ks + F::kKV;
      const unsigned char* q2s = wg::launder(qs);
      const unsigned char* dos_l = wg::launder(dos);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::Mma<BN>::ss(sc, kmajor<BM, D>(q2s, 64 * grp, kk), kmajor<BN, D>(ks, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::Mma<BN>::ss(dp, kmajor<BM, D>(dos_l, 64 * grp, kk), kmajor<BN, D>(vs, 0, kk), kk > 0);
    }
    if (prev) {  // dQ += bf16(dS) K, tile j - 1
      const unsigned char* ks = ring + ((j - 1) % kStages) * F::kStage;
      wg::hold(a);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          wg::Mma<PC>::template rs<1>(acc[p], a[kk], mnmajor<BN, D>(ks, kk, p), 1);
      }
    }
    wg::commit();
    wg::wait_group<0>();
    if (prev) {
      hold_parts<D>(acc);
      __syncwarp();
      if (lane == 0) wg::arrive(&empty[(j - 1) % kStages]);
    }
    if (fresh) {  // dS = P (dP - delta) in f32, rounded to bf16
      wg::hold(sc);
      wg::hold(dp);
      const int key0 = j * BN;
      const bool diag = key0 + BN - 1 + offset > rw;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i % 4) / 2;
        float p = ex2(sc[i] - lse2[r]);
        if (diag && key0 + 8 * (i / 4) + 2 * t + i % 2 + offset > rows[r]) p = 0.f;
        sc[i] = p * (dp[i] - dlt[r]);
      }
      to_a<BN>(a, sc);
    } else if (j < n_tiles) {  // a tile this group skips (as in the forward)
      wg::wait(&full[j % kStages], (j / kStages) & 1);
      __syncwarp();
      if (lane == 0) wg::arrive(&empty[j % kStages]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] < L)
      store_row<D>(dq + (static_cast<int64_t>(b) * L + rows[i]) * H * D + h * D, acc, i, t,
                   scale);
  }
}

// ---- backward: dk/dv pass ----

template <int D, int NC>
struct Dkdv {
  static constexpr int BM = 64 * NC, BQ = kDkdvRows;
  static constexpr int kKV = tile_bytes<BM, D>(), kQ = tile_bytes<BQ, D>();
  // A stage: q (q2 once ready) | dO | lse2 | delta, rounded up to 1024.
  static constexpr int kStage = (2 * kQ + 8 * BQ + 1023) / 1024 * 1024;
  static constexpr int kSmem = 1024 + 2 * kKV + kStages * kStage + 8 * (1 + 3 * kStages);
};

// One CTA per (BM-key tile, head, batch), the first key tiles (the most
// query tiles) first. Reads the dq pass's delta.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16::T* __restrict__ dk, bf16::T* __restrict__ dv, int L, int H,
                            float scale_log2, int offset) {
  using F = Dkdv<D, NC>;
  constexpr int BM = F::BM, BQ = F::BQ, PC = part_cols<D>(), P = parts<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + F::kKV;
  unsigned char* ring = vs + F::kKV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + kStages * F::kStage);
  uint64_t* full = kv_full + 1;
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;

  const int h = blockIdx.y, b = blockIdx.z, kt = blockIdx.x;
  const int first = kt * BM / BQ, n_q = (L + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kHelpers = 96;  // the producer's warps 1-3

  if (threadIdx.x == 0) {
    wg::bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&ready[s], kHelpers);
      wg::bar_init(&empty[s], 4 * NC);
    }
    wg::fence_bar_init();
  }
  __syncthreads();

  if (warp < 4) {  // the producer
    wg::regs_dec<producer_regs<NC>()>();
    if (threadIdx.x == 0) {
      wg::arrive_expect(kv_full, 2 * F::kKV);
      load_tile<BM, D>(ks, &tk, kv_full, h, kt * BM, b);
      load_tile<BM, D>(vs, &tv, kv_full, h, kt * BM, b);
      for (int qi = first; qi < n_q; ++qi) {
        const int u = qi - first, s = u % kStages;
        if (u >= kStages) wg::wait(&empty[s], ((u / kStages) & 1) ^ 1);
        wg::arrive_expect(&full[s], 2 * F::kQ);
        unsigned char* st = ring + s * F::kStage;
        load_tile<BQ, D>(st, &tq, &full[s], h, qi * BQ, b);
        load_tile<BQ, D>(st + F::kQ, &tdo, &full[s], h, qi * BQ, b);
      }
    } else if (warp > 0) {
      // Helpers: q becomes q2 in place, and the rows' lse (base 2, +inf
      // where p = 0) and delta go beside it; then the stage is ready.
      const int hid = threadIdx.x - 32;
      for (int qi = first; qi < n_q; ++qi) {
        const int u = qi - first, s = u % kStages;
        wg::wait(&full[s], (u / kStages) & 1);
        unsigned char* st = ring + s * F::kStage;
        scale_rows<BQ, BQ, D>(st, 0, scale_log2, hid, kHelpers);
        float* stats = reinterpret_cast<float*>(st + 2 * F::kQ);
        if (hid < BQ) {
          const int row = qi * BQ + hid;
          const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
          const float l2 = row < L ? lse[stat] : -CUDART_INF_F;
          stats[hid] = isinf(l2) ? CUDART_INF_F : l2 * kLog2e;
          stats[BQ + hid] = row < L ? delta[stat] : 0.f;
        }
        wg::fence_async_shared();
        wg::arrive(&ready[s]);
      }
    }
    return;
  }

  wg::regs_inc<consumer_regs<NC>()>();
  const int grp = warp / 4 - 1, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int c0 = kt * BM + 64 * grp;  // the group's first key
  const int cw = c0 + 16 * w;         // the warp's
  const int keys[2] = {cw + g, cw + g + 8};
  // Query tiles before the group's first key see none of its keys.
  const int mine = c0 < L ? c0 / BQ : n_q;

  wg::wait(kv_full, 0);
  float dka[P][PC / 2], dva[P][PC / 2];
  zero<D>(dka);
  zero<D>(dva);
  // The query tiles as a pipeline, as in the forward: step i issues tile
  // i's S^T and dP^T and tile i - 1's dV and dK products together, then
  // forms tile i's P^T and dS^T.
  float st[BQ / 2], dpt[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // bf16(P^T), bf16(dS^T) of tile i - 1
  for (int qi = first; qi <= n_q; ++qi) {
    const bool fresh = qi >= mine && qi < n_q, prev = qi > mine;
    if (fresh) wg::wait(&ready[(qi - first) % kStages], ((qi - first) / kStages) & 1);
    if (fresh) {  // S^T = K q2^T and dP^T = V dO^T, keys as rows
      const int u = qi - first;
      const unsigned char* q2s = ring + (u % kStages) * F::kStage;
      const unsigned char* dos = q2s + F::kQ;
      const unsigned char* ks_l = wg::launder(ks);
      const unsigned char* vs_l = wg::launder(vs);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::Mma<BQ>::ss(st, kmajor<BM, D>(ks_l, 64 * grp, kk), kmajor<BQ, D>(q2s, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::Mma<BQ>::ss(dpt, kmajor<BM, D>(vs_l, 64 * grp, kk), kmajor<BQ, D>(dos, 0, kk), kk > 0);
    }
    if (prev) {  // dV += bf16(P^T) dO and dK += bf16(dS^T) q2, tile i - 1
      const unsigned char* q2s = ring + ((qi - 1 - first) % kStages) * F::kStage;
      const unsigned char* dos = q2s + F::kQ;
      wg::hold(pa);
      wg::hold(da);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          wg::Mma<PC>::template rs<1>(dva[p], pa[kk], mnmajor<BQ, D>(dos, kk, p), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          wg::Mma<PC>::template rs<1>(dka[p], da[kk], mnmajor<BQ, D>(q2s, kk, p), 1);
      }
    }
    wg::commit();
    wg::wait_group<0>();
    if (prev) {
      hold_parts<D>(dva);
      hold_parts<D>(dka);
      __syncwarp();
      if (lane == 0) wg::arrive(&empty[(qi - 1 - first) % kStages]);
    }
    if (fresh) {  // P^T, and dS^T = P^T (dP^T - delta) in f32, rounded to bf16
      wg::hold(st);
      wg::hold(dpt);
      const float* lse_s =
          reinterpret_cast<const float*>(ring + ((qi - first) % kStages) * F::kStage + 2 * F::kQ);
      const float* delta_s = lse_s + BQ;
      const int row0 = qi * BQ;
      const bool diag = cw + 15 + offset > row0;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * t + i % 2;  // the query row in the tile
        float p = ex2(st[i] - lse_s[c]);
        if (diag && keys[(i % 4) / 2] + offset > row0 + c) p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta_s[c]);
      }
      to_a<BQ>(pa, st);
      to_a<BQ>(da, dpt);
    } else if (qi < n_q) {  // a tile this group skips (as in the forward)
      const int u = qi - first;
      wg::wait(&ready[u % kStages], (u / kStages) & 1);
      __syncwarp();
      if (lane == 0) wg::arrive(&empty[u % kStages]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] < L) {
      const int64_t row = static_cast<int64_t>(b) * L + keys[i];
      store_row<D>(dk + row * H * D + h * D, dka, i, t, kLn2);
      store_row<D>(dv + row * H * D + h * D, dva, i, t, 1.f);
    }
  }
}

// ---- host ----

// scale * log2(e) for head width D as the TPU kernel forms it: the product
// in double (Python's), rounded once to f32.
inline float scale_log2_of(int D) {
  return static_cast<float>((1.0 / sqrt(static_cast<double>(D))) * 1.4426950408889634);
}

// Whether TMA can read a packed bf16 operand: its start 16-byte aligned,
// its (batch, row) strides multiples of 8 values.
inline bool aligned(const void* p, int64_t bs, int64_t rs) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && bs % 8 == 0 && rs % 8 == 0;
}

template <int D>
inline bool map_of(CUtensorMap* map, const bf16::T* x, int B, int L, int H, int64_t bs,
                   int64_t rs) {
  return wg::encode_bf16(map, x, B, L, H * D, bs, rs, part_cols<D>(), kBoxRows);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// kQ2 as for the kernel: true for the flash forward, false for the fused
// block's attention.
template <int D, bool kQ2 = true>
cudaError_t launch_fwd(const bf16::T* q, const bf16::T* k, const bf16::T* v, bf16::T* out,
                       float* lse, int B, int L, int H, int64_t q_bs, int64_t q_rs,
                       int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs, int mask_center,
                       cudaStream_t stream) {
  constexpr int NC = groups<D>();
  using F = Fwd<D, NC>;
  if (!aligned(q, q_bs, q_rs) || !aligned(k, k_bs, k_rs) || !aligned(v, v_bs, v_rs))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!map_of<D>(&tq, q, B, L, H, q_bs, q_rs) || !map_of<D>(&tk, k, B, L, H, k_bs, k_rs) ||
      !map_of<D>(&tv, v, B, L, H, v_bs, v_rs))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D, NC, kQ2>;
  cudaError_t err = allow_smem(kernel, F::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + F::BM - 1) / F::BM, H, B);
  kernel<<<grid, 128 * (NC + 1), F::kSmem, stream>>>(tq, tk, tv, out, lse, L, H,
                                                          scale_log2_of(D), mask_center ? 1 : 0);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const bf16::T* q, const bf16::T* k, const bf16::T* v, const bf16::T* out,
                       const bf16::T* dout, const float* lse, bf16::T* dq, bf16::T* dk,
                       bf16::T* dv, float* delta, int B, int L, int H, int64_t q_bs,
                       int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                       int64_t o_bs, int64_t o_rs, int64_t do_bs, int64_t do_rs,
                       int mask_center, cudaStream_t stream) {
  constexpr int NC = groups<D>();
  using A = Dq<D, NC>;
  using C = Dkdv<D, NC>;
  if (!aligned(q, q_bs, q_rs) || !aligned(k, k_bs, k_rs) || !aligned(v, v_bs, v_rs) ||
      !aligned(out, o_bs, o_rs) || !aligned(dout, do_bs, do_rs))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo;
  if (!map_of<D>(&tq, q, B, L, H, q_bs, q_rs) || !map_of<D>(&tk, k, B, L, H, k_bs, k_rs) ||
      !map_of<D>(&tv, v, B, L, H, v_bs, v_rs) || !map_of<D>(&tdo, dout, B, L, H, do_bs, do_rs))
    return cudaErrorInvalidValue;
  auto dq_kernel = flash_bwd_dq_wgmma_kernel<D, NC>;
  auto dkdv_kernel = flash_bwd_dkdv_wgmma_kernel<D, NC>;
  cudaError_t err = allow_smem(dq_kernel, A::kSmem);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkdv_kernel, C::kSmem);
  if (err != cudaSuccess) return err;
  // As the TPU kernel forms them: scale in double, rounded to f32 where it
  // multiplies dq; scale * log2(e) likewise for q2.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const float scale_log2 = scale_log2_of(D);
  const int offset = mask_center ? 1 : 0;
  constexpr int kThreads = 128 * (NC + 1);
  // Same stream: the dk/dv pass reads the delta that the dq pass stores.
  dq_kernel<<<dim3((L + A::BM - 1) / A::BM, H, B), kThreads, A::kSmem, stream>>>(
      tq, tk, tv, tdo, out, dout, lse, dq, delta, L, H, o_bs, o_rs, do_bs, do_rs, scale,
      scale_log2, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((L + C::BM - 1) / C::BM, H, B), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, L, H, scale_log2, offset);
  return cudaGetLastError();
}

}  // namespace fwg
