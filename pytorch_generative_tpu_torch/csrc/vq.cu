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
// over between them, so this runs as two launches, with no padding of the
// outputs and no atomics:
//   1. vq_assign_kernel: one CTA of 8 warps per block of R = 64 rows (128
//      CTAs at M = 8192). The scores run on the tensor cores by 3xTF32
//      mma.sync m16n8k8 (flash_mma.cuh: x = big + small, small_a big_b +
//      big_a small_b + big_a big_b), to about f32's accuracy. Warp w owns
//      rows 16 (w % 4) .. + 15 and, of every 64-code tile, the 32 codes of
//      half w / 4; its rows' split A fragments stay in registers for the
//      whole codebook walk (D <= 64; wider rows reload them from shared
//      memory a 64-wide chunk of D at a time). The codebook streams in its
//      own K-contiguous layout, 64 codes x 64 features an item, by 16-byte
//      cp.async into a 3-slot ring, so the first products start after one
//      item. One step later the CTA splits each item once into big and
//      small planes (2 slots) and sums each code's |e_k|^2 in f32 in one
//      fixed order, so every CTA has the same bits for a code; a step then
//      multiplies item it while it splits item it + 1 and item it + 2
//      lands, with one CTA barrier. Each k-step of 32 features sums its
//      products in fresh accumulators, added in f32 (the tensor cores' sums
//      round toward zero). The epilogue forms 2 acc - |e|^2 per fragment
//      and merges a tile's scores by a tree in index order into a running
//      best (score, index) per row, without branches; the lanes and the
//      two halves then merge theirs by better(), a total order (a lower
//      index wins an equal score, the first NaN wins, as in torch.argmax
//      and jnp.argmax), so the merge order cannot change the winner. Codes
//      past K and rows past M are zero in shared memory and never win or
//      written. The CTA writes the quantized rows, sorts its own rows
//      stably by code (rank counting, R^2 compares), sums the rows of each
//      code it holds in row order from the x tile in shared memory, and
//      writes its (count, sum) entries into slot b of an (ceil(M / R), R)
//      table and, for every code, the code's entry there or -1 into row b
//      of an (ceil(M / R), K) byte map.
//   2. vq_gather_kernel, with programmatic dependent launch (its launch
//      hides behind launch 1): one CTA per 4 codes; a thread reads one
//      block's map bytes of the CTA's codes, and the CTA adds the entries
//      of each code in a fixed order: the entries split over the threads of
//      a float4 of the code, each adding its share in block order, the
//      shares then added in order. A code gathers at most ceil(M / R)
//      entries whatever the skew, and unused codes get zeros.
// Every sum is taken in a fixed order: two calls give the same bits.
//
// vq_bf16 takes bf16 rows beside the f32 codebook (the VQ-VAE under a bf16
// compute dtype, whose EMA codebook stays f32), as the TPU kernel does
// (vq_pallas.py:30-31, :64-79): launch 1 widens each row to f32 as it
// stages its x tile (16-byte loads of 8 values, so D is a multiple of 8)
// and writes the quantized rows rounded to bf16 from the f32 codebook row;
// the scores, counts and sums are the f32 route's. A bf16 value has 8
// significant bits and TF32 11, so the 3xTF32 split of a row is exact
// (big = x, small = 0): codes, counts and sums equal, bit for bit, those of
// vq_f32 on the rows widened to f32, and the quantized rows that kernel's
// rounded to bf16.
//
// What bounds it on an H100: the scores, 2 M K D operations (0.54 GFLOP at
// M = 8192, K = 512, D = 64): 3.3 us at the 3xTF32 rate (495 / 3 = 165
// TFLOP/s), 8 us at the CUDA cores' 67 TFLOP/s f32, against ~4.5 MB of x,
// quantized, codebook and sums (1.3 us at 3.35 TB/s). The table adds
// ~2 MB written and read at that shape. Measured there (PERF.md sections
// 5-6, tools/torch_flash_times.py --vq --stages): ~0.030 ms of the card's
// time a call, of which the codebook walk takes ~30,000 SM cycles: every
// warp passes the one barrier a step at once, so a step's split, products
// and epilogue run one after the other on each warp, 2 warps to a
// scheduler. The tail (sort, sums, stores) takes ~7,500 cycles, the
// gather ~4,800 after launch 1.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kRows = 64;               // R: rows a CTA of launch 1 owns
constexpr int kSplit = 2;               // warps a 16-row block, each a part of every tile
constexpr int kThreads = 32 * kRows / 16 * kSplit;
constexpr int kTile = 64;               // codes an item holds
constexpr int kCodes = kTile / kSplit;  // codes a warp takes of each tile
constexpr int kNB = kCodes / 8;         // its mma n-blocks
static_assert(kNB % 2 == 0 && kThreads >= 4 * kRows && kThreads == 4 * kTile,
              "n-blocks in pairs; 4 threads a row and a code");
constexpr int kChunk = 64;              // features an item holds
constexpr int kSC = kChunk + 4;         // row stride of a slot or plane, floats
constexpr int kRaw = 3;                 // slots of the cp.async ring
constexpr int kPlanes = 2;              // slots of the split planes
constexpr int kSlotFloats = kTile * kSC;
constexpr int kPlaneFloats = 2 * kSlotFloats + kTile;  // big, small, |e|^2
constexpr int kMaxDim = 256;
constexpr int kGatherCodes = 4;         // codes a CTA of launch 2 owns
constexpr int kGatherThreads = 256;     // blocks a round of launch 2 reads
constexpr int kGatherBatch = 8;         // entries a thread loads at once
static_assert(kGatherThreads >= kGatherCodes * kMaxDim / 4,
              "a thread for each float4 of the CTA's codes");
constexpr unsigned kFull = 0xffffffffu;

// (s, i) beats (best, bi) under argmax's rule: larger score, then lower
// index; NaN is the largest (the first NaN wins).
__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  if (isnan(s)) return !isnan(best) || i < bi;
  if (isnan(best)) return false;
  return s > best || (s == best && i < bi);
}

__device__ __forceinline__ void take(float s, int i, float& best, int& bi) {
  if (better(s, i, best, bi)) {
    best = s;
    bi = i;
  }
}

// better() for an index above every one (best, bi) stands for: a larger
// score, or a first NaN. Branch-free.
__device__ __forceinline__ void take_next(float s, int i, float& best, int& bi) {
  const bool win = !(s <= best) && !isnan(best);
  best = win ? s : best;
  bi = win ? i : bi;
}

// Shared memory of launch 1 beyond its static arrays: the x tile (R rows of
// dp + 4 floats), the cp.async ring and the planes.
__host__ __device__ constexpr size_t assign_smem(int dp) {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * (dp + 4) + kRaw * kSlotFloats + kPlanes * kPlaneFloats);
}

// KS: k-slices (8 features each) of a chunk of D; the chunk is all of D
// rounded up to 8 when D <= 64, else 64 features of D rounded up to 64, in
// n_chunks chunks. dp = 8 KS n_chunks. An item is one chunk of one tile.
// T: the rows' type (and the quantized rows'), float or bf16.
template <int KS, class T>
__global__ void __launch_bounds__(kThreads, 1)
vq_assign_kernel(const T* __restrict__ x, const float* __restrict__ cb,
                 T* __restrict__ quant, int8_t* __restrict__ tpos, int* __restrict__ tcount,
                 float* __restrict__ tsum, int M, int K, int D, int n_chunks) {
  constexpr int kW = 8 * KS;  // features a chunk
  extern __shared__ __align__(16) float smem[];
  __shared__ float cand_s[kSplit][kRows];
  __shared__ int cand_i[kSplit][kRows], idx_s[kRows], order_s[kRows], start_s[kRows + 1];
  __shared__ int ecode_s[kRows];
  __shared__ int n_entries_s;
  const int dp = kW * n_chunks, sx = dp + 4;
  float* xs = smem;                          // [R][sx]
  float* raw = xs + kRows * sx;              // kRaw slots of [kTile][kSC]
  float* planes = raw + kRaw * kSlotFloats;  // kPlanes of big, small [kTile][kSC], |e|^2

  // Launch 2 may be scheduled now; it waits for this grid's end.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = (warp % (kRows / 16)) * 16, part_of = warp / (kRows / 16);
  const int m0 = blockIdx.x * kRows;
  const int n_items = (K + kTile - 1) / kTile * n_chunks;

  // Item it (chunk it % n_chunks of tile it / n_chunks; zeros past K and
  // past D, and all zeros past the last item) into raw slot it % kRaw.
  auto fetch = [&](int it) {
    float* slot = raw + (it % kRaw) * kSlotFloats;
    const int c0 = (it / n_chunks) * kTile, d0 = (it % n_chunks) * kW;
    for (int i = threadIdx.x; i < kTile * (kW / 4); i += kThreads) {
      const int r = i / (kW / 4), c = (i % (kW / 4)) * 4;
      const bool ok = it < n_items && c0 + r < K && d0 + c < D;
      tf32::cp_async16(slot + r * kSC + c,
                       ok ? cb + static_cast<int64_t>(c0 + r) * D + d0 + c : cb, ok);
    }
  };
  // Item it from its raw slot into plane slot it % kPlanes, split into big
  // and small: thread (r, q) takes a quarter of code r's float4s and sums
  // their squares, which the four threads of a code then add in a fixed
  // order into nrm, carried over the tile's chunks and stored with each
  // (all of |e_r|^2 with the tile's last chunk). With 16 or 8 float4s a
  // row, thread q takes 2q, 2q + 1, 2q + 8, 2q + 9: the 8 threads of a
  // shared-memory phase (two rows) then hit 32 distinct banks.
  float nrm = 0.f;
  auto transform = [&](int it) {
    constexpr int kF4 = kW / 4;  // float4s of a row
    const float* src = raw + (it % kRaw) * kSlotFloats;
    float* big = planes + (it % kPlanes) * kPlaneFloats;
    float* small = big + kSlotFloats;
    const int r = threadIdx.x / 4, q = threadIdx.x % 4, chunk = it % n_chunks;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < (kF4 + 3) / 4; ++jj) {
      const int j = kF4 % 8 == 0 ? 2 * q + jj % 2 + 8 * (jj / 2) : q + 4 * jj;
      if (j >= kF4) continue;
      const float4 v = *reinterpret_cast<const float4*>(src + r * kSC + 4 * j);
      const float e[4] = {v.x, v.y, v.z, v.w};
      float hi[4], lo[4];
      fmma::split(e, hi, lo);
#pragma unroll
      for (int u = 0; u < 4; ++u) part = fmaf(e[u], e[u], part);
      *reinterpret_cast<float4*>(big + r * kSC + 4 * j) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(small + r * kSC + 4 * j) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
    part += __shfl_xor_sync(kFull, part, 1);  // the same bits on the 4 threads of code r
    part += __shfl_xor_sync(kFull, part, 2);
    nrm = chunk == 0 ? part : nrm + part;
    if (q == 0) big[2 * kSlotFloats + r] = nrm;
  };
  float a_big[KS][4], a_small[KS][4];
  auto load_a = [&](int chunk) {  // ldmatrix: lane l gives row l % 16, column 4 (l / 16)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      float v[4];
      tf32::ldmatrix_x4(v, xs + (rb + lane % 16) * sx + chunk * kW + 8 * s + (lane / 16) * 4);
      fmma::split(v, a_big[s], a_small[s]);
    }
  };
  // Merges tile `tile`'s scores 2 acc - |e|^2 (ascending codes: n-block j,
  // column 2t + e) into best by a tree whose left side always holds the
  // lower index; scores of codes past K, or of a tile that is not done
  // (!valid), count as -inf.
  float best[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows rb + g, rb + g + 8
  int bi[2] = {K, K};                              // beaten by any scored code
  auto merge = [&](const float (&acc)[kNB][4], const float2 (&nrm2)[kNB], int tile, bool valid) {
    const int c0 = tile * kTile + part_of * kCodes + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[kNB];
      int i[kNB];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int c = c0 + j * 8;
        s[j] = valid && c < K ? 2.f * acc[j][2 * h] - nrm2[j].x : -CUDART_INF_F;
        i[j] = c;
        take_next(valid && c + 1 < K ? 2.f * acc[j][2 * h + 1] - nrm2[j].y : -CUDART_INF_F,
                  c + 1, s[j], i[j]);
      }
#pragma unroll
      for (int w = 1; w < kNB; w *= 2) {
#pragma unroll
        for (int j = 0; j + w < kNB; j += 2 * w) take_next(s[j + w], i[j + w], s[j], i[j]);
      }
      take_next(s[0], i[0], best[h], bi[h]);
    }
  };

  // Item 0, then the x tile (zeros past M and past D) with item 1; bf16
  // rows are widened to f32 by the threads, 8 values a load (D % 8 == 0),
  // and are in place at the barrier before transform(0).
  fetch(0);
  tf32::cp_async_commit();
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < kRows * (dp / 4); i += kThreads) {
      const int r = i / (dp / 4), c = (i % (dp / 4)) * 4;
      const bool ok = m0 + r < M && c < D;
      tf32::cp_async16(xs + r * sx + c, ok ? x + static_cast<int64_t>(m0 + r) * D + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * (dp / 8); i += kThreads) {
      const int r = i / (dp / 8), c = (i % (dp / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (m0 + r < M && c < D)
        bf16::unpack8(v, *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(m0 + r) * D + c));
      *reinterpret_cast<float4*>(xs + r * sx + c) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(xs + r * sx + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  fetch(1);
  tf32::cp_async_commit();
  tf32::cp_async_wait<1>();
  __syncthreads();
  transform(0);

  // Step it multiplies item it while item it + 1 is split and item it + 2
  // lands.
  float acc[kNB][4];
  float2 nrm2[kNB];
  fmma::zero(acc);
  for (int it = 0; it < n_items; ++it) {
    // Raw slot (it + 2) % kRaw held item it - 1, split two steps ago.
    fetch(it + kRaw - 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<kRaw - 2>();  // item it + 1 (and the x tile) has landed
    __syncthreads();  // ... for every thread; item it is split, item it - 1 multiplied
    transform(it + 1);
    const int chunk = it % n_chunks;
    if (n_chunks > 1 || it == 0) load_a(chunk);
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = chunk == 0 ? 0.f : acc[j][e];
    }
    const float* plane = planes + (it % kPlanes) * kPlaneFloats;
    const float* big = plane + part_of * kCodes * kSC;
    const float* small = big + kSlotFloats;
#pragma unroll
    for (int s0 = 0; s0 < KS; s0 += 4) {  // one k-step of 32 features
      float part[kNB][4];
      fmma::zero(part);
#pragma unroll
      for (int s = s0; s < s0 + 4 && s < KS; ++s) {
        float b_big[kNB][2], b_small[kNB][2];
#pragma unroll
        for (int j = 0; j < kNB; j += 2) {
          fmma::load_bt2<kSC>(b_big[j], b_big[j + 1], big + j * 8 * kSC + 8 * s, lane);
          fmma::load_bt2<kSC>(b_small[j], b_small[j + 1], small + j * 8 * kSC + 8 * s, lane);
        }
        // flash_mma.cuh's mma3 sweeps, on B split beforehand.
#pragma unroll
        for (int j = 0; j < kNB; ++j) tf32::mma(part[j], a_small[s], b_big[j]);
#pragma unroll
        for (int j = 0; j < kNB; ++j) tf32::mma(part[j], a_big[s], b_small[j]);
#pragma unroll
        for (int j = 0; j < kNB; ++j) tf32::mma(part[j], a_big[s], b_big[j]);
      }
      fmma::tile_sum(acc, part);
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j)  // |e|^2 of accumulator columns 2t, 2t + 1
      nrm2[j] = *reinterpret_cast<const float2*>(plane + 2 * kSlotFloats + part_of * kCodes +
                                                 j * 8 + 2 * t);
    merge(acc, nrm2, it / n_chunks, chunk == n_chunks - 1);
  }

  // The four lanes of a row, then the kSplit parts of the codebook.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float s = __shfl_xor_sync(kFull, best[h], o);
      const int i = __shfl_xor_sync(kFull, bi[h], o);
      take(s, i, best[h], bi[h]);
    }
    if (t == 0) {
      cand_s[part_of][rb + g + 8 * h] = best[h];
      cand_i[part_of][rb + g + 8 * h] = bi[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float best = cand_s[0][r];
    int bi = cand_i[0][r];
    for (int p = 1; p < kSplit; ++p) take(cand_s[p][r], cand_i[p][r], best, bi);
    idx_s[r] = bi < K ? bi : 0;  // code 0 is always scored: never K
  }
  __syncthreads();

  // The quantized rows: loaded now, stored once the statistics are done.
  const int nv = min(kRows, M - m0), nv4 = D / 4;
  constexpr int kQuant = kRows * (kMaxDim / 4) / kThreads;  // float4s a thread, at most
  float4 qv[kQuant];
#pragma unroll
  for (int u = 0; u < kQuant; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nv * nv4) {
      const float* row = cb + static_cast<int64_t>(idx_s[i / nv4]) * D;
      qv[u] = reinterpret_cast<const float4*>(row)[i % nv4];
    }
  }

  // The stable sort by code: thread (r, q) counts the rows of quarter q that
  // come before row r; rows past M sort last.
  if (threadIdx.x < 4 * kRows) {
    const int r = threadIdx.x / 4, q = threadIdx.x % 4;
    const int cr = r < nv ? idx_s[r] : K;
    int rank = 0;
#pragma unroll
    for (int o = 0; o < kRows / 4; ++o) {
      const int r2 = q * (kRows / 4) + o;
      const int c2 = r2 < nv ? idx_s[r2] : K;
      rank += c2 < cr || (c2 == cr && r2 < r);
    }
    rank += __shfl_xor_sync(kFull, rank, 1);
    rank += __shfl_xor_sync(kFull, rank, 2);
    if (q == 0) order_s[rank] = r;
  }
  __syncthreads();
  // Entries: the first sorted position of each code present, and its code.
  if (warp == 0) {
    int base = 0;
#pragma unroll
    for (int j0 = 0; j0 < kRows; j0 += 32) {
      const int j = j0 + lane;
      const bool head = j < nv && (j == 0 || idx_s[order_s[j]] != idx_s[order_s[j - 1]]);
      const unsigned heads = __ballot_sync(kFull, head);
      const int e = base + __popc(heads & ((1u << lane) - 1));
      if (head) {
        start_s[e] = j;
        ecode_s[e] = idx_s[order_s[j]];
      }
      base += __popc(heads);
    }
    if (lane == 0) {
      start_s[base] = nv;
      n_entries_s = base;
    }
  }
  __syncthreads();
  const int ne = n_entries_s;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * kRows;
  for (int i = threadIdx.x; i < ne * nv4; i += kThreads) {
    const int e = i / nv4, v = i % nv4, end = start_s[e + 1];
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = start_s[e]; j0 < end; j0 += 8) {  // row order, 8 rows' loads at a time
      float4 r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u < end)
          r[u] = *reinterpret_cast<const float4*>(xs + order_s[j0 + u] * sx + 4 * v);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u < end) {
          s.x += r[u].x;
          s.y += r[u].y;
          s.z += r[u].z;
          s.w += r[u].w;
        }
      }
    }
    reinterpret_cast<float4*>(tsum + (slot0 + e) * D)[v] = s;
  }
  for (int e = threadIdx.x; e < ne; e += kThreads)
    tcount[slot0 + e] = start_s[e + 1] - start_s[e];
  // Row b of the map: code k's entry, or -1; four codes a 32-bit store
  // (rows of K rounded up to 4 bytes).
  const int k4 = (K + 3) / 4;
  for (int w = threadIdx.x; w < k4; w += kThreads) {
    int lo = 0, hi = ne;  // the first entry whose code is >= 4 w; codes ascend
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (ecode_s[mid] < 4 * w) lo = mid + 1;
      else hi = mid;
    }
    uint32_t word = kFull;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = lo + u;
      const int k = e < ne ? ecode_s[e] : 4 * w + 4;
      if (k < 4 * w + 4) word ^= static_cast<uint32_t>(~e & 0xff) << (8 * (k - 4 * w));
    }
    reinterpret_cast<uint32_t*>(tpos + blockIdx.x * static_cast<int64_t>(4 * k4))[w] = word;
  }
#pragma unroll
  for (int u = 0; u < kQuant; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nv * nv4) {
      if constexpr (std::is_same<T, float>::value) {
        reinterpret_cast<float4*>(quant + static_cast<int64_t>(m0) * D)[i] = qv[u];
      } else {  // the f32 codebook row rounded to bf16 (nearest even)
        reinterpret_cast<uint2*>(quant + static_cast<int64_t>(m0) * D)[i] =
            make_uint2(bf16::pack(qv[u].x, qv[u].y), bf16::pack(qv[u].z, qv[u].w));
      }
    }
  }
}

// counts[k] and sums[k] for the kGatherCodes codes from blockIdx.x
// kGatherCodes, kGatherThreads blocks a round: the table's entries of each
// code split over `parts` threads for each of its float4s, thread u adding
// entries u, u + parts, ... in block order, and the parts added in order.
__global__ void __launch_bounds__(kGatherThreads)
vq_gather_kernel(const int8_t* __restrict__ tpos, const int* __restrict__ tcount,
                 const float* __restrict__ tsum, float* __restrict__ counts,
                 float* __restrict__ sums, int K, int D, int n_blocks) {
  __shared__ int list_s[kGatherCodes][kGatherThreads];  // table slots, block order
  __shared__ int warp_n[kGatherCodes][kGatherThreads / 32];
  __shared__ float4 part_s[kGatherThreads];
  __shared__ int part_n[kGatherThreads];
  const int k0 = blockIdx.x * kGatherCodes;
  const int64_t row = 4 * static_cast<int64_t>((K + 3) / 4);  // bytes of a map row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv4 = D / 4, pairs = kGatherCodes * nv4, parts = kGatherThreads / pairs;
  const int p = threadIdx.x % pairs, u = threadIdx.x / pairs, c = p / nv4, v = p % nv4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int cnt = 0;

  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // launch 1 is done
  for (int b0 = 0; b0 < n_blocks; b0 += kGatherThreads) {
    // Thread b reads block b's entries of the CTA's codes, a byte each.
    const int b = b0 + threadIdx.x;
    const uint32_t word =
        b < n_blocks ? *reinterpret_cast<const uint32_t*>(tpos + b * row + k0) : kFull;
    int found[kGatherCodes];
#pragma unroll
    for (int cc = 0; cc < kGatherCodes; ++cc) {
      const int e = static_cast<int8_t>(word >> (8 * cc));
      found[cc] = e >= 0 ? b * kRows + e : -1;
    }
    // The found entries of each code, in block order, into list_s.
    int pos[kGatherCodes];
#pragma unroll
    for (int cc = 0; cc < kGatherCodes; ++cc) {
      const unsigned m = __ballot_sync(kFull, found[cc] >= 0);
      pos[cc] = __popc(m & ((1u << lane) - 1));
      if (lane == 0) warp_n[cc][warp] = __popc(m);
    }
    __syncthreads();
    int n = 0;  // entries of code c
#pragma unroll
    for (int cc = 0; cc < kGatherCodes; ++cc) {
      int base = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kGatherThreads / 32; ++w) {
        base += w < warp ? warp_n[cc][w] : 0;
        total += warp_n[cc][w];
      }
      if (found[cc] >= 0) list_s[cc][base + pos[cc]] = found[cc];
      n = cc == c ? total : n;
    }
    __syncthreads();
    // This thread's part: entries u, u + parts, ..., kGatherBatch loads in
    // flight at a time.
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    int num = 0;
    if (u < parts) {
      for (int j0 = u; j0 < n; j0 += parts * kGatherBatch) {
        float4 r[kGatherBatch];
        int m[kGatherBatch];
#pragma unroll
        for (int w = 0; w < kGatherBatch; ++w) {
          const int j = j0 + parts * w;
          if (j < n) {
            const int slot = list_s[c][j];
            r[w] = reinterpret_cast<const float4*>(tsum + static_cast<int64_t>(slot) * D)[v];
            m[w] = v == 0 ? tcount[slot] : 0;
          }
        }
#pragma unroll
        for (int w = 0; w < kGatherBatch; ++w) {
          if (j0 + parts * w < n) {
            sum.x += r[w].x;
            sum.y += r[w].y;
            sum.z += r[w].z;
            sum.w += r[w].w;
            num += m[w];
          }
        }
      }
    }
    part_s[threadIdx.x] = sum;
    part_n[threadIdx.x] = num;
    __syncthreads();
    if (u == 0) {
      for (int uu = 0; uu < parts; ++uu) {
        const float4 r = part_s[p + uu * pairs];
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
        cnt += part_n[p + uu * pairs];
      }
    }
    __syncthreads();  // list_s and part_s are read before the next round writes them
  }
  if (u == 0 && k0 + c < K) {
    reinterpret_cast<float4*>(sums + static_cast<int64_t>(k0 + c) * D)[v] = acc;
    if (v == 0) counts[k0 + c] = static_cast<float>(cnt);
  }
}

// Launch 1 at KS with its dynamic shared memory, the attribute raised once
// per device to the most this instance takes (D = 256 for KS = 8).
template <int KS, class T>
cudaError_t assign(const T* x, const float* cb, T* quant, int8_t* tpos, int* tcount,
                   float* tsum, int M, int K, int D, int n_chunks, cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(vq_assign_kernel<KS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(assign_smem(KS == 8 ? kMaxDim : 8 * KS)));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  vq_assign_kernel<KS, T><<<(M + kRows - 1) / kRows, kThreads, assign_smem(8 * KS * n_chunks), s>>>(
      x, cb, quant, tpos, tcount, tsum, M, K, D, n_chunks);
  return cudaGetLastError();
}

// Both launches for rows of type T: launch 1 at the instance for D, then
// launch 2 with programmatic dependent launch.
template <class T>
cudaError_t vq(const T* x, const float* codebook, T* quantized, float* counts, float* sums,
               int8_t* tpos, int* tcount, float* tsum, int M, int K, int D, cudaStream_t s) {
  const int dp = D <= kChunk ? (D + 7) / 8 * 8 : (D + kChunk - 1) / kChunk * kChunk;
  const int ks = dp <= kChunk ? dp / 8 : 8, n_chunks = dp / (8 * ks);
  using Assign = cudaError_t (*)(const T*, const float*, T*, int8_t*, int*, float*, int, int,
                                 int, int, cudaStream_t);
  static constexpr Assign kAssign[] = {assign<1, T>, assign<2, T>, assign<3, T>, assign<4, T>,
                                       assign<5, T>, assign<6, T>, assign<7, T>, assign<8, T>};
  cudaError_t err =
      kAssign[ks - 1](x, codebook, quantized, tpos, tcount, tsum, M, K, D, n_chunks, s);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K + kGatherCodes - 1) / kGatherCodes, 1, 1);
  cfg.blockDim = dim3(kGatherThreads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, vq_gather_kernel, static_cast<const int8_t*>(tpos),
                           static_cast<const int*>(tcount), static_cast<const float*>(tsum),
                           counts, sums, K, D, (M + kRows - 1) / kRows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x (M, D), codebook (K, D): contiguous float32 starting on 16-byte
// boundaries; D a multiple of 4 up to 256, M and K at least 1. Writes
// quantized (M, D), counts (K,) and sums (K, D). Scratch, with B = ceil(M /
// 64): tpos (B, K rounded up to 4) int8, tcount (B, 64) int32 and tsum (B,
// 64, D) float32.
extern "C" int vq_f32(const float* x, const float* codebook, float* quantized, float* counts,
                      float* sums, int8_t* tpos, int* tcount, float* tsum, int M, int K, int D,
                      void* stream) {
  if (M < 1 || K < 1 || D < 4 || D % 4 != 0 || D > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vq(x, codebook, quantized, counts, sums, tpos, tcount, tsum, M, K, D,
                             static_cast<cudaStream_t>(stream)));
}

// As vq_f32 for bf16 rows x and quantized (the codebook, counts and sums
// f32): D a multiple of 8 up to 256.
extern "C" int vq_bf16(const void* x, const float* codebook, void* quantized, float* counts,
                       float* sums, int8_t* tpos, int* tcount, float* tsum, int M, int K, int D,
                       void* stream) {
  if (M < 1 || K < 1 || D < 8 || D % 8 != 0 || D > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vq(static_cast<const bf16::T*>(x), codebook,
                             static_cast<bf16::T*>(quantized), counts, sums, tpos, tcount, tsum,
                             M, K, D, static_cast<cudaStream_t>(stream)));
}
