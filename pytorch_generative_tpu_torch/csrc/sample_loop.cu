// The whole ImageGPT raster-scan sampler in one launch, float32, on
// thread-block clusters.
//
// Replaces pytorch_generative_tpu/ops/decode_pallas.py::_sample_loop_kernel
// (launched by fused_sample_loop). Per raster position i, for each sample:
// the 4 live taps of the masked 3x3 type-A input conv (canvas + pos at p0,
// p0+1, p0+2, p0+Wp of the zero-padded canvas), then per block LN ->
// fused QKV -> this position's k/v into the cache -> softmax attention over
// the cached keys <= i -> out proj -> residual -> LN -> exact-GELU MLP ->
// block residual + the model's extra skip; then the final LN, the head, the
// Bernoulli draw `u < sigmoid(logit)` and the inpainting merge (pixels >= 0
// are kept; sampled pixels are stored as exact 0.0 or 1.0).
//
// What bounds it: the dependency chain, not bytes or operations. A position
// is n_blocks blocks in order, each a chain of products and reductions over
// a few rows: per block and position 4 cluster barriers, each behind stores
// into the other ranks' shared memory, one round of cache loads, and ~12
// dependent CTA phases between them (6,272 block-steps a 28x28 image at 8
// blocks). The ~25 MFLOP a position at n = 16 would take the card
// microseconds. Before this design one CTA of 256 threads a sample read
// every weight from L2 at every position and split the keys over 4 thread
// groups; 74% of its time went to the scores and the value pass, each
// thread walking ~i/4 cache rows one dependent load at a time
// (tools/torch_sampler_times.py --stages, PERF.md section 6).
//
// Design: a thread-block cluster of `cluster` CTAs (ranks) serves a group
// of `samples` samples (decode_cuda.sample_plan: one wave of clusters, the
// fewest samples a cluster that serve n, so that every weight read from
// shared memory serves all of a group, as the TPU kernel's batch tile
// does). Clusters never wait on one another; a cluster takes groups
// blockIdx.x / cluster, + clusters, ... in turn.
//  - Weights: each rank keeps its slice of every block's products in shared
//    memory for the whole call (`resident`) or, where they do not fit,
//    streams them through a kRing-stage cp.async ring, two slices ahead.
//    A block's LayerNorm parameters and biases are prefetched one
//    block-step ahead by the warp that is idle during LayerNorm 2.
//  - QKV: rank r owns a slice of the output columns and writes it into
//    every rank's shared memory (distributed shared memory); between the
//    two halves of the cluster barrier (barrier.cluster.arrive.release /
//    wait.acquire) each rank starts loading its first cached keys.
//  - Attention is split over the cluster by key (flash-decoding): rank r
//    owns the positions l = r (mod cluster), writes k|v of position i when
//    it owns i, and reads only its own keys, laid out contiguously
//    (kv: (n_blocks, N, cluster, ceil(L / cluster), c_k + c_v)). Within the
//    CTA, groups of 8 lanes run over keys and lanes over 16-byte pieces of
//    a key row, 8 keys' k and v in flight a group, with a running max.
//    Every rank gets each rank's max and sum per head; the rank that owns
//    a value feature gets each rank's weighted sum of it.
//  - Out projection, split by value feature: each rank merges its own
//    features over the ranks in rank order, multiplies them by its rows of
//    Wo and sends the partial output to every rank. MLP, split by hidden
//    unit: each rank keeps gelu(LN(x1) W1) of its own units and sends its
//    partial of the second product to every rank. Partials are added in
//    rank order, so every rank holds the same bits.
//  - LayerNorms, residuals, the head and the draw are computed by every
//    rank alike, one warp a sample, so the canvas needs no exchange; rank
//    0 writes the drawn pixels to canvas_out.
// Per block and position: 4 cluster barriers (QKV, attention partials, out
// partials, MLP partials) against ~29 CTA barriers and 4 chains of L2
// loads before, and one round of cache loads, 1/cluster of the keys with
// many in flight.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 8;  // attention: groups of 8 lanes
constexpr int kKeyBatch = 8;           // keys a group has in flight
constexpr int kRing = 3;               // stages of the streamed weights' ring

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

// decode_cuda.sample_plan's numbers.
struct Plan {
  int cluster;   // CTAs a cluster (ranks)
  int samples;   // samples a group
  int groups;    // ceil(N / samples)
  int resident;  // 1: every block's weight slices stay in shared memory
  int stage;     // floats a ring stage when streamed
};

// Built with -DSAMPLE_LOOP_STAMPS (tools/torch_sampler_times.py --stages),
// thread 0 of CTA 0 adds the clocks between stamps to stage k: products
// 0-3 at 2p (sums and stores) and 2p + 1 (cluster barrier), attention 8
// and 9, the ranks' combine 10, LayerNorm 2 11, residual + LayerNorm 1 12,
// the head, draw and next input 13; within the products 14 (taking the
// weight slice); within attention 15 (the QKV barrier's wait and the
// owner's k|v store), 16 (keys), 17 (CTA barrier).
#ifdef SAMPLE_LOOP_STAMPS
constexpr int kStamps = 18;
__device__ long long stamp_clocks[kStamps];
__shared__ long long stamp_acc[kStamps + 1];  // the clocks, then the last stamp
#define STAMP(k)                                         \
  if (blockIdx.x == 0 && threadIdx.x == 0) {             \
    const long long now = clock64();                     \
    stamp_acc[k] += now - stamp_acc[kStamps];            \
    stamp_acc[kStamps] = now;                            \
  }
#else
#define STAMP(k)
#endif

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// A width J is cut over the R ranks in units of 4 when J % 4 == 0 (16-byte
// copies), else of 1: rank r owns units [r q / R, (r + 1) q / R), q = J /
// unit, as evenly as they go (a rank may own none).
__host__ __device__ inline int unit_of(int J) { return J % 4 == 0 ? 4 : 1; }
__host__ __device__ inline int max_cols(int J, int R) {
  const int g = unit_of(J);
  return (J / g + R - 1) / R * g;
}
__host__ __device__ inline void part_of(int J, int rank, int R, int& lo, int& cnt) {
  const int g = unit_of(J), q = J / g;
  lo = rank * q / R * g;
  cnt = (rank + 1) * q / R * g - lo;
}
// The rank that owns index x of a width-J cut.
__device__ inline int owner_of(int x, int J, int R) {
  const int g = unit_of(J), q = J / g;
  return ((x / g + 1) * R - 1) / q;
}

// Shared memory, in floats from the start, every region 16-byte aligned.
// sample_loop_smem_bytes gives the total, by which decode_cuda.sample_plan
// sizes a plan.
struct Layout {
  int w, prm, bp, step_prm, pos, ring, uni, x, x1, ea, eb, hl, t, red, total;
};

__host__ __device__ inline Layout layout(const Dims& d, const Plan& p) {
  const int R = p.cluster, S = p.samples, C = d.C, H = d.n_heads;
  const int ck = H * d.d_k, cv = H * d.d_v, F = 2 * ck + cv, M = d.M;
  const int wp = d.w + 2, lp = (d.h + 2) * wp;
  const int cf = max_cols(F, R), fv = max_cols(cv, R), hm = max_cols(M, R);
  Layout o;
  int at = 0;
  o.w = at;
  at += p.resident ? d.n_blocks * (up4(C * cf) + up4(fv * C) + up4(C * hm) + up4(hm * C))
                   : kRing * up4(p.stage);
  o.prm = at;  at += up4(8 * C + 1);  // in_w4, in_b, head_w, lnf_w, lnf_b, head_b
  // A block's LayerNorm parameters and biases, two slots: this block-step's
  // and the next one's, prefetched.
  o.step_prm = up4(4 * C) + up4(cf) + up4(C) + up4(hm) + up4(C);
  o.bp = at;   at += 2 * o.step_prm;
  o.pos = at;  at += up4(lp);
  o.ring = at; at += up4(S * 3 * wp);
  o.uni = at;  at += up4(S);          // each sample's uniform of this position
  o.x = at;    at += up4(S * C);
  o.x1 = at;   at += up4(S * C);
  // Written by every rank, in turn: qkv, key partials, out partials, MLP
  // partials; two regions, so that none is rewritten while still read.
  o.ea = at;   at += up4(S * imax(F, R * C));
  o.eb = at;   at += up4(S * imax(R * (2 * H + fv), R * C));
  o.hl = at;   at += up4(S * hm);     // this rank's hidden units
  o.t = at;    // LN output / own attention features, or the groups' partials
  at += imax(up4(S * imax(C, fv)), up4(imax(kGroups, S * H) * (d.d_v + 2)));
  o.red = at;  at += up4(S * imax(kThreads, imax(imax(cf, C), hm)));
  o.total = at;
  return o;
}

__device__ __forceinline__ void cp_async(float* smem, const float* gmem, int unit) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (unit == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest `kPending` groups of this thread's copies
// are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// The cluster barrier in two halves (what cluster.sync() does at once), so
// that work that needs no other rank can run between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst = LayerNorm(src) * w + b over C floats, by one warp (eps 1e-5); each
// lane reads only the channels it wrote, so src may be what it just wrote.
__device__ void warp_layer_norm(const float* src, const float* w, const float* b, float* dst,
                                int C, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += src[c];
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dd = src[c] - mean;
    v += dd * dd;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
  for (int c = lane; c < C; c += 32) dst[c] = (src[c] - mean) * rstd * w[c] + b[c];
}

// This rank's slice of one product's weights: rows [r_lo, r_lo + K) and
// columns [lo, lo + cols) of each block's (K_all, J) matrix.
struct Slice {
  const float* w;     // (n_blocks, K_all, J) in device memory
  const float* bias;  // (n_blocks, J)
  int K_all, J, r_lo, K, lo, cols, unit;
  int rows;     // rows of one unit of the feed (a chunk of the slice)
  int chunks;   // units a block
  int bias_at;  // the bias of columns [lo, lo + cols) in a block-step's parameters
};

// Hands out the weight slices in the order the products use them: per
// position, per block, QKV, out, MLP 1, MLP 2, each in `chunks` units;
// streamed, unit u + kRing - 1 starts loading when unit u is taken. It
// lives in shared memory (indexed by product at run time).
//
// Copy groups: each thread commits one per unit issued, and one at each
// block's LayerNorm 2 (the next block-step's parameters and uniforms,
// needed by its end). Taking unit u waits for all but the newest groups
// that are not needed yet: the kRing - 2 units issued after it, and at
// MLP 1's first unit that LayerNorm 2 group too, the newest then. From
// MLP 1's second unit on, units issued after it are newer than it, so it
// no longer counts among the kRing - 2 + 1 newest.
struct Feed {
  Slice sl[4];
  float* base;      // resident slices, or the kRing ring stages
  int stage;        // floats a stage
  int per_block;    // units a block
  int per_position;
  int block_floats;  // resident: floats of one block's slices
  int off[4];        // resident: a product's offset in a block
  int resident;

  // Starts the copy of unit u into its ring stage.
  __device__ void issue(int u) const {
    const int up = u % per_position, b = up / per_block;
    int p = 0, c = up % per_block;
    for (; p < 3 && c >= sl[p].chunks; ++p) c -= sl[p].chunks;
    const Slice& s = sl[p];
    const int r0 = c * s.rows, nr = min(s.rows, s.K - r0), per_row = s.cols / s.unit;
    const float* src = s.w + (static_cast<int64_t>(b) * s.K_all + s.r_lo + r0) * s.J + s.lo;
    float* dst = base + (u % kRing) * stage;
    for (int idx = threadIdx.x; idx < nr * per_row; idx += kThreads) {
      const int row = idx / per_row, q = (idx % per_row) * s.unit;
      cp_async(dst + row * s.cols + q, src + static_cast<int64_t>(row) * s.J + q, s.unit);
    }
    cp_async_commit();
  }

  // Unit u, chunk c of block b's slice of product p (resident: the whole
  // slice), once every thread may read it and the copies it needs have
  // landed (and every thread is done with unit u - 1: the stage it frees
  // is refilled here).
  __device__ const float* acquire(int u, int b, int p, int c) const {
    cp_async_wait((resident ? 0 : kRing - 2) + (p == 2 && c == 0));
    __syncthreads();
    if (resident) return base + b * block_floats + off[p];
    issue(u + kRing - 1);
    return base + (u % kRing) * stage;
  }

  // The resident slices: every block's, loaded once.
  __device__ void load_all() const {
    for (int b = 0; b < per_position / per_block; ++b)
      for (int p = 0; p < 4; ++p) {
        const Slice& s = sl[p];
        const int per_row = s.cols / s.unit;
        const float* src = s.w + (static_cast<int64_t>(b) * s.K_all + s.r_lo) * s.J + s.lo;
        float* dst = base + b * block_floats + off[p];
        for (int idx = threadIdx.x; idx < s.K * per_row; idx += kThreads) {
          const int row = idx / per_row, q = (idx % per_row) * s.unit;
          cp_async(dst + row * s.cols + q, src + static_cast<int64_t>(row) * s.J + q, s.unit);
        }
      }
    cp_async_commit();
  }
};

// A slice of rows [r_lo, r_lo + K) and columns [lo, lo + cols).
__device__ Slice make_slice(const float* w, const float* bias, int K_all, int J, int r_lo, int K,
                            int lo, int cols, int bias_at) {
  const int unit = J % 4 == 0 && lo % 4 == 0 && cols % 4 == 0 ? 4 : 1;
  return {w, bias, K_all, J, r_lo, K, lo, cols, unit, K, 1, bias_at};
}

// The cluster-wide state of one CTA.
struct Ctx {
  cg::cluster_group cluster;
  int rank, R;
  int S, ns;  // samples a group, samples of this group
  float* red;
};

// What a product does with its sums.
enum Mode {
  kColumns,  // + bias, into columns [lo, lo + cols) of every rank's dst
  kLocal,    // + bias, GELU, into this rank's dst, columns 0..cols
  kPartial,  // into every rank's dst at row `rank` (a K-split partial sum)
};

// What a product does with column j's sum v of sample s.
template <int kMode>
__device__ __forceinline__ void emit(const Ctx& cx, const float* bias, float* dst, int dst_ld,
                                     int lo, int s, int j, float v, int first, int step) {
  if (kMode != kPartial) v += bias[j];
  if (kMode == kLocal) {
    if (first == 0) dst[s * dst_ld + j] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    return;
  }
  float* d = kMode == kColumns ? dst + s * dst_ld + lo + j : dst + (cx.rank * cx.S + s) * dst_ld + j;
  for (int r = first; r < cx.R; r += step) *cx.cluster.map_shared_rank(d, r) = v;
}

// out[s, j] = sum_k a[s * K + k] W[b, r_lo + k, lo + j] over this rank's
// slice, for the group's samples, handled as `kMode` says (`prm`: this
// block-step's parameters, the bias at bias_at); a chunked slice's sums
// carry over chunks in `red`. kColumns leaves the cluster barrier's wait
// to the caller. Two ways to share the work, by SB (samples a thread sums
// at once):
//  - SB < 4 (1-2 samples a group): warp w owns columns [w cw, (w + 1) cw);
//    LC lanes share a column's rows and meet by shuffles in a fixed order,
//    with no CTA barrier, and share its stores into the other ranks.
//  - SB = 4: columns over lanes (padded to CL), the rows over KP parts
//    across warps; the parts meet in `red` behind a CTA barrier and are
//    added in a fixed order (fewer shuffles for many samples).
template <int kMode, int SB>
__device__ void product(const Ctx& cx, const Feed& feed, int& u, int p, int b, const float* prm,
                        const float* a, float* dst, int dst_ld) {
  const Slice& sl = feed.sl[p];
  const int jr = sl.cols, K = sl.K, S = cx.S, ns = cx.ns, lo = sl.lo, chunks = sl.chunks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const float* bias = prm + sl.bias_at;
  if constexpr (SB < 4) {
    const int cw = (jr + kWarps - 1) / kWarps;
    const int pw2 = cw <= 1 ? 1 : 1 << (32 - __clz(cw - 1));
    const int LC = pw2 >= 32 ? 1 : 32 / pw2, slots = 32 / LC;
    const int kp = lane % LC, slot = lane / LC;
    for (int c = 0; c < chunks; ++c) {
      const float* W = feed.acquire(u++, b, p, c);
      STAMP(14)
      const int k0 = c * sl.rows, rows = min(sl.rows, K - k0);
      for (int c0 = 0; c0 < cw; c0 += slots) {
        const int j = warp * cw + c0 + slot;
        const bool live = c0 + slot < cw && j < jr;
        for (int s0 = 0; s0 < ns; s0 += SB) {
          float acc[SB];
#pragma unroll
          for (int q = 0; q < SB; ++q) acc[q] = 0.f;
          if (live) {
#pragma unroll 4
            for (int k = kp; k < rows; k += LC) {
              const float wv = W[k * jr + j];
              const float* ak = a + k0 + k;
#pragma unroll
              for (int q = 0; q < SB; ++q)
                if (s0 + q < ns) acc[q] += ak[(s0 + q) * K] * wv;
            }
          }
#pragma unroll
          for (int q = 0; q < SB; ++q)
            for (int o = LC / 2; o > 0; o >>= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
#pragma unroll
          for (int q = 0; q < SB; ++q) {
            const int s = s0 + q;
            if (s >= ns || !live) continue;
            float* r = cx.red + s * jr + j;
            const float v = c == 0 ? acc[q] : *r + acc[q];
            if (c + 1 < chunks) {
              if (kp == 0) *r = v;
            } else {
              emit<kMode>(cx, bias, dst, dst_ld, lo, s, j, v, kp, LC);
            }
          }
        }
      }
    }
  } else {
    const int CL = jr <= 32 ? (jr <= 1 ? 1 : 1 << (32 - __clz(jr - 1))) : (jr + 31) / 32 * 32;
    const int KP = CL >= kThreads ? 1 : kThreads / CL;
    const int NG = CL < 32 ? kWarps : KP;  // partial sums a column after the shuffles
    const int kp = CL >= kThreads ? 0 : tid / CL;
    for (int c = 0; c < chunks; ++c) {
      const float* W = feed.acquire(u++, b, p, c);
      STAMP(14)
      const int k0 = c * sl.rows, rows = min(sl.rows, K - k0);
      for (int cl = CL >= kThreads ? tid : tid % CL; cl < CL && kp < KP; cl += kThreads) {
        for (int s0 = 0; s0 < ns; s0 += SB) {
          float acc[SB];
#pragma unroll
          for (int q = 0; q < SB; ++q) acc[q] = 0.f;
          if (cl < jr) {
#pragma unroll 4
            for (int k = kp; k < rows; k += KP) {
              const float wv = W[k * jr + cl];
              const float* ak = a + k0 + k;
#pragma unroll
              for (int q = 0; q < SB; ++q)
                if (s0 + q < ns) acc[q] += ak[(s0 + q) * K] * wv;
            }
          }
          if (CL < 32) {  // the warp's KP / 8 row parts of one column
#pragma unroll
            for (int q = 0; q < SB; ++q)
              for (int o = CL; o < 32; o <<= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
          }
          if (cl < jr && (CL >= 32 || lane < CL)) {
            const int part = CL < 32 ? warp : kp;
#pragma unroll
            for (int q = 0; q < SB; ++q)
              if (s0 + q < ns) {
                float* r = cx.red + (part * S + s0 + q) * jr + cl;
                *r = c == 0 ? acc[q] : *r + acc[q];
              }
          }
        }
      }
    }
    __syncthreads();
    for (int item = tid; item < ns * jr; item += kThreads) {
      const int s = item / jr, j = item % jr;
      float v = 0.f;
#pragma unroll 8
      for (int g = 0; g < NG; ++g) v += cx.red[(g * S + s) * jr + j];
      emit<kMode>(cx, bias, dst, dst_ld, lo, s, j, v, 0, 1);
    }
  }
  STAMP(2 * p)
  if (kMode == kPartial) cx.cluster.sync();
  if (kMode == kColumns) cluster_arrive();
  STAMP(2 * p + 1)
}

template <int V>
__device__ __forceinline__ void load_piece(float (&out)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    out[0] = *p;
  }
}

// This rank's share of attention at position i, block b, entered between
// the two halves of the QKV product's cluster barrier: over its keys
// l = rank (mod R), l <= i, for every sample and head, the max score m,
// the sum l of exp(score - m) and the sums o of exp(score - m) v. Every
// rank gets m and l of each head, and the rank that owns a value feature
// (the out product's row cut) gets its o: eb[rank, s, :] = m[H], l[H],
// o[its features]. Groups of 8 lanes take a (sample, head) and every KG-th
// key of it, 8 keys at a time with their k and v loads in flight together,
// and keep a running max (online softmax). A group's first batch of cached
// keys starts loading before the barrier's wait: it needs no other rank.
template <int V>
__device__ void attention(const Ctx& cx, const Dims& dm, const Layout& ly, float* smem,
                          float* kv, int64_t kv_sample0, int i) {
  const int H = dm.n_heads, dk = dm.d_k, dv = dm.d_v, R = cx.R, rank = cx.rank;
  const int ck = H * dk, cv = H * dv, F = 2 * ck + cv, row = ck + cv;
  const int lr = (dm.h * dm.w + R - 1) / R;
  const int ns = cx.ns, S = cx.S, T = ns * H;
  const int KG = T >= kGroups ? 1 : kGroups / T;  // groups a (sample, head)
  const int tid = threadIdx.x, g = tid / 8, l8 = tid % 8, warp = tid / 32, lane = tid & 31;
  const unsigned mask = 0xffu << (tid & 24);
  const int nprev = i > rank ? (i - 1 - rank) / R + 1 : 0;  // own keys < i
  const bool owner = i % R == rank;
  const int nk = nprev + owner;
  const float scale = rsqrtf(static_cast<float>(dk));
  const int64_t sample_stride = static_cast<int64_t>(R) * lr * row;
  const float* qkv = smem + ly.ea;
  float* gp = smem + ly.t;

  float vv[kKeyBatch][V], kp[kKeyBatch][V];
  const int task0 = g / KG;
  if (task0 < T) {
    const float* rows = kv + kv_sample0 + (task0 / H) * sample_stride;
    const int hh = task0 % H, d = l8 * V;
#pragma unroll
    for (int u = 0; u < kKeyBatch; ++u) {
      const int j = g % KG + u * KG;
      if (j < nprev && d < dk) load_piece<V>(kp[u], rows + static_cast<int64_t>(j) * row + hh * dk + d);
      if (j < nprev && d < dv)
        load_piece<V>(vv[u], rows + static_cast<int64_t>(j) * row + ck + hh * dv + d);
    }
  }
  cluster_wait();

  // The owner stores this position's k|v; later positions read it back.
  if (owner)
    for (int idx = tid; idx < ns * row; idx += kThreads) {
      const int s = idx / row, e = idx % row;
      kv[kv_sample0 + s * sample_stride + static_cast<int64_t>(nprev) * row + e] =
          qkv[s * F + ck + e];
    }
  STAMP(15)

  for (int task = g / KG; task < T; task += kGroups / KG) {
    const int sub = g % KG, s = task / H, hh = task % H;
    const float* rows = kv + kv_sample0 + s * sample_stride;
    const float* q = qkv + s * F + hh * dk;
    const float* knew = qkv + s * F + ck + hh * dk;
    const float* vnew = qkv + s * F + 2 * ck + hh * dv;
    float* gt = gp + (task * KG + sub) * (dv + 2);
    // Passes over 8 V-wide pieces of the head's values (one for dv <= 8 V).
    for (int d0 = 0; d0 < dv; d0 += 8 * V) {
      const int dvl = d0 + l8 * V;  // this lane's values
      float m = -CUDART_INF_F, l = 0.f, o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = 0.f;
      for (int j0 = sub; j0 < nk; j0 += KG * kKeyBatch) {
        // The first batch of the group's first task is in flight already.
        const bool ahead = task == task0 && d0 == 0 && j0 == sub;
        float dot[kKeyBatch];
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u) {
          const int j = j0 + u * KG;
          const float* vr = j < nprev ? rows + static_cast<int64_t>(j) * row + ck + hh * dv : vnew;
          if (j < nk && dvl < dv && !(ahead && j < nprev)) load_piece<V>(vv[u], vr + dvl);
          dot[u] = 0.f;
        }
        for (int d = l8 * V; d < dk; d += 8 * V) {
          float qv[V];
          load_piece<V>(qv, q + d);
#pragma unroll
          for (int u = 0; u < kKeyBatch; ++u) {
            const int j = j0 + u * KG;
            const float* kr = j < nprev ? rows + static_cast<int64_t>(j) * row + hh * dk : knew;
            if (j < nk && !(ahead && j < nprev && d == l8 * V)) load_piece<V>(kp[u], kr + d);
          }
#pragma unroll
          for (int u = 0; u < kKeyBatch; ++u)
            if (j0 + u * KG < nk)
#pragma unroll
              for (int e = 0; e < V; ++e) dot[u] += qv[e] * kp[u][e];
        }
        float mb = m;
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u) {
          for (int sh = 4; sh > 0; sh >>= 1) dot[u] += __shfl_xor_sync(mask, dot[u], sh);
          dot[u] *= scale;
          if (j0 + u * KG < nk) mb = fmaxf(mb, dot[u]);
        }
        const float corr = expf(m - mb);  // 0 while m = -inf
        l *= corr;
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] *= corr;
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u)
          if (j0 + u * KG < nk) {
            const float pr = expf(dot[u] - mb);
            l += pr;
            if (dvl < dv)
#pragma unroll
              for (int e = 0; e < V; ++e) o[e] += pr * vv[u][e];
          }
        m = mb;
      }
      if (dvl < dv)
#pragma unroll
        for (int e = 0; e < V; ++e) gt[2 + dvl + e] = o[e];
      if (l8 == 0 && d0 == 0) {
        gt[0] = m;
        gt[1] = l;
      }
    }
  }
  STAMP(16)
  __syncthreads();
  STAMP(17)

  // The groups' partials of each (sample, head), merged in group order by
  // one warp: M = max m, f_k = exp(m_k - M), L = sum l_k f_k, O = sum o_k
  // f_k; an empty set (every m_k = -inf) gives M = -inf, L = O = 0.
  float* part = smem + ly.eb;
  const int pw = 2 * H + max_cols(cv, R);
  float* fbuf = cx.red + warp * 32;
  for (int task = warp; task < T; task += kWarps) {
    const int s = task / H, hh = task % H;
    const float* src = gp + task * KG * (dv + 2);
    const float mk = lane < KG ? src[lane * (dv + 2)] : -CUDART_INF_F;
    const float M = warp_max(mk);
    const float f = mk == -CUDART_INF_F ? 0.f : expf(mk - M);
    const float L = warp_sum(lane < KG ? src[lane * (dv + 2) + 1] * f : 0.f);
    fbuf[lane] = f;
    __syncwarp();
    if (lane < R) {
      float* pd = cx.cluster.map_shared_rank(part, lane) + (rank * S + s) * pw;
      pd[hh] = M;
      pd[H + hh] = L;
    }
    for (int e = lane; e < dv; e += 32) {
      float o = 0.f;
#pragma unroll 8
      for (int k = 0; k < KG; ++k) o += src[k * (dv + 2) + 2 + e] * fbuf[k];
      const int fe = hh * dv + e, r = owner_of(fe, cv, R);
      int flo, fcnt;
      part_of(cv, r, R, flo, fcnt);
      cx.cluster.map_shared_rank(part, r)[(rank * S + s) * pw + 2 * H + fe - flo] = o;
    }
    __syncwarp();
  }
  STAMP(8)
  cx.cluster.sync();
  STAMP(9)
}

template <int V, int SB>
__global__ void __launch_bounds__(kThreads, 1)
sample_loop_kernel(const float* __restrict__ canvas0, const float* __restrict__ pos_pad,
                   const float* __restrict__ uniforms, float* __restrict__ canvas_out,
                   float* __restrict__ kv, Weights wt, Dims dm, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Feed feed;
  Ctx cx{cg::this_cluster(), 0, pl.cluster, pl.samples, 0, nullptr};
  cx.rank = static_cast<int>(cx.cluster.block_rank());
  const int R = cx.R, S = cx.S, rank = cx.rank;
  const int N = dm.N, C = dm.C, H = dm.n_heads, ck = H * dm.d_k, cv = H * dm.d_v;
  const int F = 2 * ck + cv, M = dm.M, NB = dm.n_blocks;
  const int wp = dm.w + 2, lp = (dm.h + 2) * wp, L = dm.h * dm.w, lr = (L + R - 1) / R;
  const Layout ly = layout(dm, pl);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  float* prm = smem + ly.prm;  // in_w4 (4C), in_b, head_w, lnf_w, lnf_b, head_b
  float* pos = smem + ly.pos;
  float* ring = smem + ly.ring;  // (S, 3, Wp): padded rows, row % 3
  float* uni = smem + ly.uni;
  float* x = smem + ly.x;
  float* x1 = smem + ly.x1;
  float* qkv = smem + ly.ea;
  float* outp = smem + ly.ea;   // (R, S, C): the ranks' partial out products
  float* keyp = smem + ly.eb;   // (R, S, 2H + features): the ranks' attention partials
  float* mlpp = smem + ly.eb;   // (R, S, C): the ranks' partial MLP outputs
  float* hl = smem + ly.hl;
  float* t = smem + ly.t;
  float* att = smem + ly.t;     // this rank's attention features
  cx.red = smem + ly.red;
  int f_lo, f_cnt, m_lo, m_cnt, c_lo, c_cnt;  // value features, hidden units, QKV columns
  part_of(cv, rank, R, f_lo, f_cnt);
  part_of(M, rank, R, m_lo, m_cnt);
  part_of(F, rank, R, c_lo, c_cnt);

  if (tid == 0) {
    const int qkv_at = up4(4 * C), out_at = qkv_at + up4(max_cols(F, R));
    const int mlp1_at = out_at + up4(C), mlp2_at = mlp1_at + up4(max_cols(M, R));
    feed.sl[0] = make_slice(wt.qkv_w, wt.qkv_b, C, F, 0, C, c_lo, c_cnt, qkv_at);
    feed.sl[1] = make_slice(wt.out_w, wt.out_b, cv, C, f_lo, f_cnt, 0, C, out_at);
    feed.sl[2] = make_slice(wt.mlp1_w, wt.mlp1_b, C, M, 0, C, m_lo, m_cnt, mlp1_at);
    feed.sl[3] = make_slice(wt.mlp2_w, wt.mlp2_b, M, C, m_lo, m_cnt, 0, C, mlp2_at);
    feed.base = smem + ly.w;
    feed.stage = up4(pl.stage);
    feed.resident = pl.resident;
    feed.per_block = 0;
    feed.block_floats = 0;
    for (int p = 0; p < 4; ++p) {
      Slice& s = feed.sl[p];
      if (!feed.resident && s.cols > 0 && s.K > 0) {
        s.rows = min(s.K, pl.stage / s.cols);
        s.chunks = (s.K + s.rows - 1) / s.rows;
      }
      feed.off[p] = feed.block_floats;
      feed.block_floats += up4(s.K * s.cols);
      feed.per_block += s.chunks;
    }
    feed.per_position = NB * feed.per_block;
  }
  __syncthreads();

  // Block-step k's LayerNorm parameters and biases into slot k % 2, by
  // `threads` threads from `first`; the caller commits.
  auto fetch_step = [&](int k, int first, int threads) {
    const int b = k % NB, me = tid - first;
    float* dst = smem + ly.bp + (k & 1) * ly.step_prm;
    auto copy = [&](float* d, const float* src, int n) {
      for (int j = me; j < n; j += threads) cp_async(d + j, src + j, 1);
    };
    copy(dst, wt.ln1_w + b * C, C);
    copy(dst + C, wt.ln1_b + b * C, C);
    copy(dst + 2 * C, wt.ln2_w + b * C, C);
    copy(dst + 3 * C, wt.ln2_b + b * C, C);
    for (int p = 0; p < 4; ++p) {
      const Slice& s = feed.sl[p];
      copy(dst + s.bias_at, s.bias + static_cast<int64_t>(b) * s.J + s.lo, s.cols);
    }
  };
  auto step_prm = [&](int k) { return smem + ly.bp + (k & 1) * ly.step_prm; };

  for (int c = tid; c < C; c += kThreads) {
    for (int j = 0; j < 4; ++j) prm[j * C + c] = wt.in_w4[j * C + c];
    prm[4 * C + c] = wt.in_b[c];
    prm[5 * C + c] = wt.head_w[c];
    prm[6 * C + c] = wt.lnf_w[c];
    prm[7 * C + c] = wt.lnf_b[c];
  }
  if (tid == 0) prm[8 * C] = wt.head_b[0];
  fetch_step(0, 0, kThreads);
  cp_async_commit();
  for (int p = tid; p < lp; p += kThreads) pos[p] = pos_pad[p];
  if (pl.resident)
    feed.load_all();
  else
    for (int j = 0; j < kRing - 1; ++j) feed.issue(j);
  cp_async_wait<0>();
  __syncthreads();
  int u = 0;  // the feed's next unit
  int k = 0;  // the block-step: position * n_blocks + block, over every group
#ifdef SAMPLE_LOOP_STAMPS
  if (tid == 0) {
    for (int j = 0; j < kStamps; ++j) stamp_acc[j] = 0;
    stamp_acc[kStamps] = clock64();
  }
#endif

  // The conv taps of position ii into x, then LayerNorm 1 of its first
  // block (ln1: that block-step's parameters) into t: sample s by warp
  // s % 8, which also owns its canvas rows.
  auto start_position = [&](int s, int ii, const float* ln1) {
    const int row = ii / dm.w, col = ii % dm.w;
    float* rs = ring + s * 3 * wp;
    const float* r0 = rs + (row % 3) * wp;
    const float* r1 = rs + ((row + 1) % 3) * wp;
    const int p0 = row * wp + col;
    const float t0 = r0[col] + pos[p0];
    const float t1 = r0[col + 1] + pos[p0 + 1];
    const float t2 = r0[col + 2] + pos[p0 + 2];
    const float t3 = r1[col] + pos[p0 + wp];
    float* xs = x + s * C;
    for (int c = lane; c < C; c += 32)
      xs[c] = prm[4 * C + c] + t0 * prm[c] + t1 * prm[C + c] + t2 * prm[2 * C + c] +
              t3 * prm[3 * C + c];
    warp_layer_norm(xs, ln1, ln1 + C, t + s * C, C, lane);
  };
  // Padded canvas row pr of sample s (global n) into its ring slot.
  auto load_row = [&](int s, int n, int pr) {
    float* dst = ring + (s * 3 + pr % 3) * wp;
    for (int c = lane; c < wp; c += 32)
      dst[c] = canvas0[static_cast<int64_t>(pr * wp + c) * N + n];
    __syncwarp();
  };

  const int n_clusters = gridDim.x / R;
  for (int grp = blockIdx.x / R; grp < pl.groups; grp += n_clusters) {
    const int n0 = grp * S;
    cx.ns = min(S, N - n0);
    const int ns = cx.ns;
    if (rank == 0)
      for (int idx = tid; idx < lp * ns; idx += kThreads) {
        const int64_t at = static_cast<int64_t>(idx / ns) * N + n0 + idx % ns;
        canvas_out[at] = canvas0[at];
      }
    for (int s = warp; s < ns; s += kWarps) {
      load_row(s, n0 + s, 0);
      load_row(s, n0 + s, 1);
      start_position(s, 0, step_prm(k));
    }
    cx.cluster.sync();  // the cluster's ranks are all running this group

    for (int i = 0; i < L; ++i) {
      const int row = i / dm.w, col = i % dm.w;
      for (int b = 0; b < NB; ++b, ++k) {
        const float* sp = step_prm(k);
        const int64_t kv0 = ((static_cast<int64_t>(b) * N + n0) * R + rank) * lr * (ck + cv);
        product<kColumns, SB>(cx, feed, u, 0, b, sp, t, qkv, F);
        attention<V>(cx, dm, ly, smem, kv, kv0, i);
        // This rank's attention features from the ranks' partials, in rank
        // order.
        // 8 lanes a feature, over the ranks.
        const int pw = 2 * H + max_cols(cv, R);
        const unsigned gmask = 0xffu << (tid & 24);
        for (int item = tid / 8; item < ns * f_cnt; item += kGroups) {
          const int s = item / f_cnt, e = item % f_cnt, hh = (f_lo + e) / dm.d_v;
          const float* ps = keyp + s * pw;
          float mx = -CUDART_INF_F;
          for (int q = tid % 8; q < R; q += 8) mx = fmaxf(mx, ps[q * S * pw + hh]);
          for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, o));
          float lsum = 0.f, o = 0.f;
          for (int q = tid % 8; q < R; q += 8) {
            const float* pq = ps + q * S * pw;
            const float f = pq[hh] == -CUDART_INF_F ? 0.f : expf(pq[hh] - mx);
            lsum += pq[H + hh] * f;
            o += pq[2 * H + e] * f;
          }
          for (int sh = 4; sh > 0; sh >>= 1) {
            lsum += __shfl_xor_sync(gmask, lsum, sh);
            o += __shfl_xor_sync(gmask, o, sh);
          }
          if (tid % 8 == 0) att[s * f_cnt + e] = o / lsum;
        }
        STAMP(10)
        product<kPartial, SB>(cx, feed, u, 1, b, sp, att, outp, C);
        // x1 = x + out proj; LayerNorm 2. The last warp (idle here while the
        // group has fewer than 8 samples) fetches the next block-step's
        // parameters and, at a position's first block, its uniforms; they
        // land by MLP 2.
        const float* out_b = sp + feed.sl[1].bias_at;
        for (int s = warp; s < ns; s += kWarps) {
          for (int c = lane; c < C; c += 32) {
            float v = out_b[c];
#pragma unroll 8
            for (int q = 0; q < R; ++q) v += outp[(q * S + s) * C + c];
            x1[s * C + c] = x[s * C + c] + v;
          }
          warp_layer_norm(x1 + s * C, sp + 2 * C, sp + 3 * C, t + s * C, C, lane);
        }
        if (warp == kWarps - 1) {
          fetch_step(k + 1, (kWarps - 1) * 32, 32);
          if (b == 0 && lane < ns)
            cp_async(uni + lane, uniforms + static_cast<int64_t>(i) * N + n0 + lane, 1);
          if (b == 0)
            for (int s = lane + 32; s < ns; s += 32)
              cp_async(uni + s, uniforms + static_cast<int64_t>(i) * N + n0 + s, 1);
        }
        cp_async_commit();
        STAMP(11)
        product<kLocal, SB>(cx, feed, u, 2, b, sp, t, hl, m_cnt);
        product<kPartial, SB>(cx, feed, u, 3, b, sp, hl, mlpp, C);
        // Block residual + the model-level extra skip: x = x + (x1 + mlp).
        const float* next = step_prm(k + 1);
        const float* mlp2_b = sp + feed.sl[3].bias_at;
        for (int s = warp; s < ns; s += kWarps) {
          float* xs = x + s * C;
          for (int c = lane; c < C; c += 32) {
            float v = mlp2_b[c];
#pragma unroll 8
            for (int q = 0; q < R; ++q) v += mlpp[(q * S + s) * C + c];
            xs[c] = xs[c] + (x1[s * C + c] + v);
          }
          if (b + 1 < NB) warp_layer_norm(xs, next, next + C, t + s * C, C, lane);
        }
        STAMP(12)
      }

      // Final LayerNorm, head, draw and merge, then the next position's
      // input, by every rank alike.
      for (int s = warp; s < ns; s += kWarps) {
        const int n = n0 + s;
        float* ts = t + s * C;
        warp_layer_norm(x + s * C, prm + 6 * C, prm + 7 * C, ts, C, lane);
        float part_logit = 0.f;
        for (int c = lane; c < C; c += 32) part_logit += ts[c] * prm[5 * C + c];
        const float logit = warp_sum(part_logit) + prm[8 * C];
        float* pix = ring + (s * 3 + (row + 1) % 3) * wp + col + 1;
        if (lane == 0 && *pix < 0.f) {
          const float prob = 1.f / (1.f + expf(-logit));
          const float drawn = uni[s] < prob ? 1.f : 0.f;
          *pix = drawn;
          if (rank == 0) canvas_out[static_cast<int64_t>((row + 1) * wp + col + 1) * N + n] = drawn;
        }
        __syncwarp();
        if (i + 1 < L) {
          if ((i + 1) % dm.w == 0) load_row(s, n, (i + 1) / dm.w + 1);
          start_position(s, i + 1, step_prm(k));
        }
      }
      STAMP(13)
    }
  }
  cp_async_wait<0>();  // the last prefetches
  cx.cluster.sync();   // no rank leaves while another may still write to it
#ifdef SAMPLE_LOOP_STAMPS
  if (blockIdx.x == 0 && tid == 0)
    for (int j = 0; j < kStamps; ++j) stamp_clocks[j] += stamp_acc[j];
#endif
}

bool vec4(const Dims& d) { return d.d_k % 4 == 0 && d.d_v % 4 == 0; }

// The kernel instance for these widths and samples a group: V-wide cache
// loads, SB samples a product thread sums at once.
using Kernel = void (*)(const float*, const float*, const float*, float*, float*, Weights, Dims,
                        Plan);
Kernel instance(const Dims& d, int samples) {
  const int sb = samples >= 3 ? 4 : samples;
  if (vec4(d))
    return sb == 1 ? sample_loop_kernel<4, 1> : sb == 2 ? sample_loop_kernel<4, 2>
                                                        : sample_loop_kernel<4, 4>;
  return sb == 1 ? sample_loop_kernel<1, 1> : sb == 2 ? sample_loop_kernel<1, 2>
                                                      : sample_loop_kernel<1, 4>;
}

cudaError_t configure(Kernel k, int smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int clusters, int cluster,
                   int smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

#ifdef SAMPLE_LOOP_STAMPS
// The stamps' clocks since the last call, then zeroes them.
extern "C" int sample_loop_stamps(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, stamp_clocks, sizeof(stamp_clocks));
  const long long zero[kStamps] = {};
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(stamp_clocks, zero, sizeof(zero));
}
#endif

// Bytes of shared memory a CTA of this plan takes.
extern "C" long long sample_loop_smem_bytes(int h, int w, int n_blocks, int C, int n_heads,
                                            int d_k, int d_v, int M, int cluster, int samples,
                                            int resident, int stage) {
  const Dims dm{0, h, w, n_blocks, C, n_heads, d_k, d_v, M};
  const Plan pl{cluster, samples, 0, resident, stage};
  return 4LL * layout(dm, pl).total;
}

// cudaOccupancyMaxActiveClusters of the kernel instance for (d_k, d_v)
// and `samples` a group at this cluster size and shared memory, and its
// registers a thread.
extern "C" int sample_loop_occupancy(int d_k, int d_v, int samples, int cluster, int smem,
                                     int* clusters, int* regs) {
  const Dims dm{0, 0, 0, 0, 0, 0, d_k, d_v, 0};
  const Kernel k = instance(dm, samples);
  cudaError_t err = configure(k, smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, 1, cluster, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, k, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k);
  *regs = fa.numRegs;
  return err;
}

// canvas0, canvas_out: (Lp, N); pos_pad: (Lp,); uniforms: (L, N); kv:
// (n_blocks, N, cluster, ceil(L / cluster), H*d_k + H*d_v) scratch. All
// float32, contiguous, on one device; the weights 16-byte aligned.
extern "C" int sample_loop_f32(
    const float* canvas0, const float* pos_pad, const float* uniforms, float* canvas_out,
    float* kv, const float* in_w4, const float* in_b, const float* head_w, const float* head_b,
    const float* ln1_w, const float* ln1_b, const float* qkv_w, const float* qkv_b,
    const float* out_w, const float* out_b, const float* ln2_w, const float* ln2_b,
    const float* mlp1_w, const float* mlp1_b, const float* mlp2_w, const float* mlp2_b,
    const float* lnf_w, const float* lnf_b, int N, int h, int w, int n_blocks, int C,
    int n_heads, int d_k, int d_v, int M, int cluster, int clusters, int samples, int groups,
    int resident, int stage, void* stream) {
  const Weights wt{in_w4, in_b, head_w, head_b, ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b,
                   ln2_w, ln2_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b, lnf_w, lnf_b};
  const Dims dm{N, h, w, n_blocks, C, n_heads, d_k, d_v, M};
  const Plan pl{cluster, samples, groups, resident, stage};
  const int smem = 4 * layout(dm, pl).total;
  const Kernel k = instance(dm, samples);
  cudaError_t err = configure(k, smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, clusters, cluster, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, k, canvas0, pos_pad, uniforms, canvas_out, kv, wt, dm, pl);
  return err != cudaSuccess ? err : cudaGetLastError();
}
