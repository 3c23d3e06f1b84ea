// The whole PixelSNAIL raster-scan sampler in one launch, float32, on
// thread-block clusters.
//
// Replaces pytorch_generative_tpu/ops/snail_decode_pallas.py::
// _snail_loop_kernel (launched by fused_snail_sample_loop). Per raster
// position i, for each sample: the 4 live taps of the masked 3x3 type-A
// input conv on the raw canvas; per block, per residual block elu(res) as
// the 2x2 conv's tap at i, mid = elu(2x2 conv over rows {row-1, row} x cols
// {col-1, col}), out = the second 2x2 conv of mid, res += out[:C] *
// sigmoid(out[C:]); q from [pos(2), res]; one-head attention over the
// cached keys < i (mask_center; at i = 0 no key is valid and the output is
// out_proj's bias); elu(conv(elu(.))) on the residual and attention
// branches, their sum, `out`, x += block_out. Then the head (two 1x1
// convs), the draw `u < sigmoid(logit)`, the inpainting merge (pixels >= 0
// are kept, sampled ones stored as exact 0.0 or 1.0) and, for every block,
// kv_proj of [pos, res_b, merged pixel] appended to that block's K/V cache
// at i: k/v read the merged pixel, so they are appended after the draw.
//
// What bounds it: the dependency chain. A position is ~1.8 MFLOP a sample,
// nothing for the card, but n_blocks blocks in order, each a chain of nine
// small products, an attention pass and five exchanges. The kernel this
// replaced ran one CTA of 256 threads a sample, read every weight (3.61 MB
// at the reproduce() config) from L2 inside the chain at every position,
// 8 dependent rounds of loads a product, and walked the cached keys one
// after another: per position 250 us at n = 16, of which the residual
// blocks' weight loads took 54% and the value pass 16% (26% near i = 783;
// tools/torch_sampler_times.py --snail, PERF.md section 5).
//
// Design: a thread-block cluster of `cluster` CTAs (ranks) serves a group
// of `samples` samples (snail_decode_cuda.snail_plan: clusters of 4 or 2 a
// sample at n = 16 and 64). Clusters never wait on one another; cluster c
// serves groups c, c + clusters, ... in turn.
//  - Weights off the chain: a first launch packs each rank's weights into
//    one stream in the order the chain takes them. The rank's thread 0
//    copies that stream chunk by chunk (one bulk copy, the TMA's, a chunk)
//    into a ring of `depth` shared-memory stages, depth - 1 chunks ahead,
//    each completing on an mbarrier; the weights do not depend on the
//    samples, so the ring never waits on the chain. The two 2x2 convs of
//    a residual block, 87% of the bytes, are split over the ranks by
//    output channel (rank r owns channels [r C/R, (r + 1) C/R) of mid and
//    res); the small products (q | kv_proj, out_proj, residual_out,
//    attention_out, out, the head) run alike on every rank, so they need
//    no exchange.
//  - Earlier positions' taps off the chain: the 2x2 conv at position p has
//    taps at p - w - 1, p - w, p - 1 and p. When a rank has a conv's input
//    at p, it multiplies it by all four taps' weights of its channels at
//    once (one product with K = C, not 4C): tap 3's share is used now; taps
//    0 and 1 go to a ring in device memory for the positions p + w + 1 and
//    p + w (copied back a block before their use), tap 2 to shared memory
//    for p + 1. So the chain waits on no cached input, and there are no
//    elu or mid caches.
//  - Products: warp w owns a slice of the columns, a group of lanes a
//    column; its lanes split the rows and meet by shuffles, so a product
//    ends without a CTA barrier, in the owning lane's epilogue. Rows lie an
//    odd number of 16-byte units apart in the ring, so the lanes of a
//    group read distinct banks.
//  - The residual block: rank r stores its mid channels into every rank's
//    shared memory (distributed shared memory), a cluster barrier, then
//    its res channels likewise, another barrier.
//  - Attention split over the ranks by key (flash-decoding): rank r owns
//    the positions l = r (mod cluster) of each block's K/V cache, laid out
//    contiguously, and only it writes or reads them. Groups of 8 lanes take
//    a sample's keys, 4 keys' k and v in flight a group (16-byte loads), with
//    a running max; the groups' partials merge in group order, every rank
//    gets each rank's (max, sum, weighted values) and merges them in rank
//    order. kv_proj's [pos, res_b] part is summed with q when block b ends;
//    after the draw the owner of position i adds the merged pixel's row.
//  - Every sum runs in a fixed order, with no atomics, and every rank holds
//    the same bits of what it computes alike, so two calls give equal bits.
// Per block and position: 5 cluster barriers (2 a residual block, 1 for
// attention) and ~11 CTA barriers, against ~26 CTA barriers and 12 rounds
// of dependent L2 loads before.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 8;  // attention: groups of 8 lanes
constexpr int kKeyBatch = 4;           // keys a group has in flight
constexpr int kMaxDepth = 8;           // ring stages
constexpr int kMaxSeg = 8;             // source segments of a ring row
constexpr int kCols = 2;               // columns a thread sums (J <= 2 * kThreads)

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

// snail_decode_cuda.snail_plan's numbers.
struct Plan {
  int cluster;  // CTAs a cluster (ranks)
  int samples;  // samples a group
  int groups;   // ceil(N / samples)
  int stage;    // floats a ring stage
  int depth;    // ring stages
};

// The streamed pieces of one block, in the order the chain takes them
// (kConv1, kConv2 once per residual block), then the head's.
enum Kind { kConv1, kConv2, kQkv, kOp, kRo, kAo, kOut, kHead, kKinds };

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// A piece's width J: the columns of its ring rows.
__host__ __device__ inline int piece_cols(const Dims& d, int R, int kind) {
  const int cnt = d.C / R;
  switch (kind) {
    case kConv1: return 4 * cnt;
    case kConv2: return 8 * cnt;
    case kQkv: return 2 * d.DK + d.DV;
    case kOp: return d.DV;
    case kRo: case kAo: case kOut: return d.C;
    default: return d.C2;
  }
}

// A piece's rows lie ld = J or J + 4 floats apart, ld / 4 odd: the lanes
// that split a column's rows then read 8 distinct banks.
__host__ __device__ inline int row_floats(int J) { return (J >> 2) & 1 ? J : J + 4; }

__host__ __device__ inline int piece_rows(const Dims& d, int kind) {
  switch (kind) {
    case kQkv: return d.C + 2;
    case kOp: case kAo: return d.DV;
    default: return d.C;
  }
}

// A block's resident parameters, in floats from the block's record: this
// rank's conv biases (NR x cnt, then NR x 2 cnt: top, gate), q_b, kv_b,
// kv_w's merged-pixel row, op_b, ro_b, ao_b, o_b.
struct BlockPrm {
  int b1, b2, qb, kvb, kvl, opb, rob, aob, ob, floats;
};

__host__ __device__ inline BlockPrm block_prm(const Dims& d, int R) {
  const int cnt = d.C / R, F = d.DK + d.DV;
  BlockPrm p;
  int at = 0;
  p.b1 = at;  at += up4(d.NR * cnt);
  p.b2 = at;  at += up4(d.NR * 2 * cnt);
  p.qb = at;  at += up4(d.DK);
  p.kvb = at; at += up4(F);
  p.kvl = at; at += up4(F);
  p.opb = at; at += up4(d.DV);
  p.rob = at; at += up4(d.C);
  p.aob = at; at += up4(d.C);
  p.ob = at;  at += up4(d.C);
  p.floats = at;
  return p;
}

// The packed weights of one rank for one position, in the order the chain
// takes them: per block, per residual block conv 1 (C x 4 cnt: taps 0-3 of
// the rank's channels) and conv 2 (C x 8 cnt: per tap its top, then its
// gate channels), then q | kv ((C + 2) x (2 DK + DV)), op, ro, ao, out; then
// the head's first conv. Each piece is K x J row-major and is taken in
// chunks of `rows` rows. `off` is a piece's offset in its block (rb 0's for
// the convs). The ranks' streams lie one after another.
struct Stream {
  int K[kKinds], J[kKinds], ld[kKinds], rows[kKinds], chunks[kKinds], off[kKinds];
  int rb_floats, block_floats, position_floats;
  int per_rb, per_block, per_position;  // chunks
};

__host__ __device__ inline Stream stream_shape(const Dims& d, int R, int stage) {
  Stream st;
  int at = 0;
  for (int k = 0; k < kKinds; ++k) {
    st.K[k] = piece_rows(d, k);
    st.J[k] = piece_cols(d, R, k);
    st.ld[k] = row_floats(st.J[k]);
    // A stage of 0 stands for one that holds every piece whole.
    st.rows[k] = stage > 0 && stage / st.ld[k] < st.K[k] ? stage / st.ld[k] : st.K[k];
    st.chunks[k] = (st.K[k] + st.rows[k] - 1) / st.rows[k];
    if (k == kQkv) at = d.NR * (st.K[kConv1] * st.ld[kConv1] + st.K[kConv2] * st.ld[kConv2]);
    st.off[k] = at;
    at += st.K[k] * st.ld[k];
  }
  st.rb_floats = st.off[kQkv] / (d.NR > 0 ? d.NR : 1);
  st.block_floats = st.off[kHead];
  st.position_floats = d.NB * st.block_floats + st.K[kHead] * st.ld[kHead];
  st.per_rb = st.chunks[kConv1] + st.chunks[kConv2];
  st.per_block = d.NR * st.per_rb;
  for (int k = kQkv; k < kHead; ++k) st.per_block += st.chunks[k];
  st.per_position = d.NB * st.per_block + st.chunks[kHead];
  return st;
}

// Shared memory, in floats from the start, every region 16-byte aligned.
// snail_loop_smem_bytes gives the total, by which snail_plan sizes a plan.
struct Layout {
  int ring, tab, prm, blk, pre, t2, cv, uni, x, res, er, mid, qin, kvp, q, att, ea, u2, apart, gp;
  int merged;
  int total;
};

__host__ __device__ inline Layout layout(const Dims& d, const Plan& p) {
  const int R = p.cluster, S = p.samples, C = d.C, F = d.DK + d.DV;
  const int cnt = C / R, wp = d.w + 2;
  Layout o;
  int at = 0;
  o.ring = at;  at += p.depth * up4(p.stage);
  o.tab = at;   at += up4(2 * stream_shape(d, R, p.stage).per_position);  // ints
  o.prm = at;   at += up4(4 * C) + up4(C) + up4(d.C2) + up4(d.C2) + 4;
  o.blk = at;   at += d.NB * block_prm(d, R).floats;
  // The convs' taps 0 and 1 of this position, copied from the device ring
  // a block ahead: (2 blocks, S, 2 taps, NR, 3 cnt): conv 1's cnt
  // channels, then conv 2's 2 cnt (top, gate). Tap 2: (NB NR, 2 positions,
  // S, 3 cnt).
  o.pre = at;   at += up4(2 * S * 2 * d.NR * 3 * cnt);
  o.t2 = at;    at += up4(d.NB * d.NR * 2 * S * 3 * cnt);
  o.cv = at;    at += up4(S * 3 * wp);  // padded canvas rows, row % 3
  o.uni = at;   at += up4(S * d.w);     // this image row's uniforms
  o.x = at;     at += up4(S * C);
  o.res = at;   at += up4(S * C);       // every rank writes its channels here
  o.er = at;    at += up4(S * C);
  o.mid = at;   at += up4(S * C);       // every rank writes its channels here
  o.qin = at;   at += up4(S * (C + 2));
  o.kvp = at;   at += up4(d.NB * S * F);
  o.q = at;     at += up4(S * d.DK);
  o.att = at;   at += up4(S * d.DV);
  o.ea = at;    at += up4(S * d.DV);
  o.u2 = at;    at += up4(S * imax(C, d.C2));
  o.apart = at; at += up4(2 * R * S * (d.DV + 2));  // every rank writes its slot
  o.gp = at;    at += up4(kGroups * (d.DV + 2));  // attention groups' m, l, sums
  o.merged = at; at += up4(S);          // this position's pixels
  o.total = at;
  return o;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One bulk copy (the TMA's, no tensor map) of `bytes` contiguous bytes, a
// multiple of 16 at 16-byte aligned ends, completing on `bar`; one thread
// issues it and arrives on `bar` expecting those bytes.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A run of `len` floats of a piece's row, taken from row k of a source
// matrix at src + b * bstride + j * jstride + k * ld (+ the rank's first
// channel for the convs).
struct Seg {
  const float* src;
  int bstride, jstride, ld, len, dst;
};

// Where each kind's pieces come from (built on the host).
struct Sources {
  Seg seg[kKinds][kMaxSeg];
  int nseg[kKinds];
};

// Packs every rank's weights into its stream (blockIdx.y = rank), 16 bytes
// a thread: the chain's copies are then one contiguous bulk copy a chunk.
__global__ void __launch_bounds__(kThreads)
snail_pack_kernel(Sources src, Stream st, Dims d, float* __restrict__ stream) {
  const int r = blockIdx.y, cnt = d.C / gridDim.y;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= st.position_floats) return;
  int b = 0, j = 0, kind = kHead, o = e - d.NB * st.block_floats;
  if (o < 0) {
    b = e / st.block_floats;
    o = e - b * st.block_floats;
    if (o < st.off[kQkv]) {
      j = o / st.rb_floats;
      o -= j * st.rb_floats;
      kind = o < st.off[kConv2] ? kConv1 : kConv2;
      o -= st.off[kind];
    } else {
      kind = kQkv;
      while (kind + 1 < kHead && o >= st.off[kind + 1]) ++kind;
      o -= st.off[kind];
    }
  }
  const int k = o / st.ld[kind], col = o - k * st.ld[kind];
  float4* to = reinterpret_cast<float4*>(stream + static_cast<int64_t>(r) * st.position_floats + e);
  if (col >= st.J[kind]) {  // a row's padding
    *to = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  int q = 0;
  while (col >= src.seg[kind][q].dst + src.seg[kind][q].len) ++q;
  const Seg& g = src.seg[kind][q];
  const float* from = g.src + static_cast<int64_t>(b) * g.bstride +
                      static_cast<int64_t>(j) * g.jstride + static_cast<int64_t>(k) * g.ld +
                      (col - g.dst) + (kind <= kConv2 ? r * cnt : 0);
  *to = *reinterpret_cast<const float4*>(from);
}

// Hands out the weight chunks in the order the chain uses them. Chunk u
// goes to ring stage u % depth and completes on that stage's barrier, at
// its (u / depth)-th phase. Taking a chunk waits for it, then (every thread
// being done with the chunk before, behind a CTA barrier) thread 0 starts
// the chunk depth - 1 ahead in the stage the one before leaves, with one
// bulk copy. A position's chunks are listed in `tab` (offset in the rank's
// stream, floats); the counters run on, so no thread divides on the chain.
struct Feed {
  Stream st;
  const float* src;  // this rank's stream
  const int* tab;    // per chunk of a position: offset, floats
  float* ring;
  uint64_t* full;
  int stage, depth;
  int left;          // chunks still to start (thread 0)
  int next_up;       // the next chunk's index in its position (thread 0)
  int next_s;        // the next chunk's stage (thread 0)

  __device__ void issue() {
    if (left == 0) return;
    --left;
    bulk_load(ring + next_s * stage, src + tab[2 * next_up],
              static_cast<unsigned>(tab[2 * next_up + 1] * 4), full + next_s);
    if (++next_up == st.per_position) next_up = 0;
    if (++next_s == depth) next_s = 0;
  }
};

// A thread's place in the ring: the stage of the next chunk it takes and
// that stage's phase parity.
struct RingPos {
  int s;
  unsigned phase;
};

// The next chunk, once it has landed for every thread.
__device__ __forceinline__ const float* acquire(Feed& feed, RingPos& rp) {
  const int s = rp.s;
  mbar_wait(feed.full + s, rp.phase);
  if (++rp.s == feed.depth) {
    rp.s = 0;
    rp.phase ^= 1u;
  }
  __syncthreads();
  if (threadIdx.x == 0) feed.issue();
  return feed.ring + s * feed.stage;
}

// out[s, j] = sum_k a[s * lda + k] W[k, j] for the group's live samples, W
// the kind's piece taken chunk by chunk from the feed. Warp w owns columns
// [w cw, (w + 1) cw), cw = ceil(J / 8); a group of LC lanes takes one of
// them (32 / LC groups a pass over the warp's columns, LC = 32 / the power
// of 2 >= cw, or 1), each lane summing rows kp, kp + LC, ... of every chunk
// for SB samples at once; the group's lanes then add their sums by
// shuffles in a fixed order, so each holds the column's sum, and the
// group's first lane hands it to epi(s, j, v, v2). With `pairs` (conv 2)
// column j = 2 pi + half stands for the piece's column t 2 cnt + half cnt +
// c (pi = t cnt + c): the top and the gate of one channel sit in adjacent
// groups, and the top's group gets the gate's sum as v2. No CTA barrier
// after the sums: the next product's barrier, or the cluster's, follows.
template <int SB, bool kPairs, class Epi>
__device__ __forceinline__ void product(Feed& feed, RingPos& rp, int kind, const float* a, int lda,
                                        int ns, int cnt, Epi epi) {
  const Stream& st = feed.st;
  const int J = st.J[kind], K = st.K[kind], ld = st.ld[kind];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = (J + kWarps - 1) / kWarps;
  const int lgc = cw <= 1 ? 0 : 32 - __clz(cw - 1);
  const int lgl = lgc >= 5 ? 0 : 5 - lgc;  // LC = 2^lgl lanes a column
  const int LC = 1 << lgl, per = 32 >> lgl, kp = lane & (LC - 1), g = lane >> lgl;
  int phys[kCols];
  bool live[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int cc = q * per + g, j = warp * cw + cc;
    live[q] = cc < cw && j < J;
    if (kPairs) {
      const int pi = j >> 1, t = pi / cnt;
      phys[q] = t * 2 * cnt + (j & 1) * cnt + pi - t * cnt;
    } else {
      phys[q] = j;
    }
  }
  float acc[kCols][SB];
#pragma unroll
  for (int q = 0; q < kCols; ++q)
#pragma unroll
    for (int s = 0; s < SB; ++s) acc[q][s] = 0.f;
  for (int c = 0; c < st.chunks[kind]; ++c) {
    const float* W = acquire(feed, rp);
    const int k0 = c * st.rows[kind], rows = min(st.rows[kind], K - k0);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (!live[q]) continue;
#pragma unroll 4
      for (int r = kp; r < rows; r += LC) {
        const float wv = W[r * ld + phys[q]];
        const float* ar = a + k0 + r;
#pragma unroll
        for (int s = 0; s < SB; ++s)
          if (s < ns) acc[q][s] += ar[s * lda] * wv;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    if (q * per >= cw) break;  // alike over the warp
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      for (int o = LC >> 1; o > 0; o >>= 1) acc[q][s] += __shfl_xor_sync(0xffffffffu, acc[q][s], o);
      const float v2 = kPairs ? __shfl_xor_sync(0xffffffffu, acc[q][s], LC) : 0.f;
      if (live[q] && kp == 0 && s < ns && (!kPairs || (g & 1) == 0))
        epi(s, warp * cw + q * per + g, acc[q][s], v2);
    }
  }
}

// The cluster barrier (a CTA barrier for a cluster of one).
__device__ __forceinline__ void cluster_barrier(int R) {
  if (R == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// This rank's share of attention for block b at position i: over its keys
// l = rank (mod R), l < i (nprev of them, rows of DK + DV floats from `kvr`
// a sample at `sstride`), for each live sample, the max score m, the sum l
// of exp(score - m) and the sums o of exp(score - m) v, stored into every
// rank's `apart` at this rank's slot.
__device__ void attention_part(cg::cluster_group& cluster, int rank, int R, const Dims& dm,
                               const float* q, const float* kvr, int64_t sstride, int nprev,
                               int ns, int S, float* gp, float* apart) {
  const int DK = dm.DK, DV = dm.DV, F = DK + DV, tid = threadIdx.x;
  const int g = tid / 8, l8 = tid % 8, warp = tid / 32, lane = tid % 32;
  const int Gs = kGroups / ns;  // groups a sample
  const int s = g / Gs, sub = g % Gs;
  const bool live = s < ns;
  const float* rows = kvr + (live ? s : 0) * sstride;
  const bool kl = l8 * 4 < DK, vl = l8 * 4 < DV;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && kl) qv = ld4(q + s * DK + l8 * 4);
  float m = -CUDART_INF_F, l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < nprev; base += Gs * kKeyBatch) {
    float4 kk[kKeyBatch], vv[kKeyBatch];
    float dot[kKeyBatch];
#pragma unroll
    for (int t = 0; t < kKeyBatch; ++t) {
      const int key = base + t * Gs + sub;
      const bool ok = live && key < nprev;
      kk[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      vv[t] = kk[t];
      if (ok && kl) kk[t] = ld4(rows + static_cast<int64_t>(key) * F + l8 * 4);
      if (ok && vl) vv[t] = ld4(rows + static_cast<int64_t>(key) * F + DK + l8 * 4);
    }
    float mb = m;
#pragma unroll
    for (int t = 0; t < kKeyBatch; ++t) {
      float v = qv.x * kk[t].x + qv.y * kk[t].y + qv.z * kk[t].z + qv.w * kk[t].w;
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      dot[t] = v;
      if (live && base + t * Gs + sub < nprev) mb = fmaxf(mb, v);
    }
    if (mb == -CUDART_INF_F) continue;  // no key of this group yet
    const float corr = expf(m - mb);    // 0 while m = -inf
    l *= corr;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] *= corr;
#pragma unroll
    for (int t = 0; t < kKeyBatch; ++t)
      if (base + t * Gs + sub < nprev) {
        const float p = expf(dot[t] - mb);
        l += p;
        o[0] += p * vv[t].x;
        o[1] += p * vv[t].y;
        o[2] += p * vv[t].z;
        o[3] += p * vv[t].w;
      }
    m = mb;
  }
  float* gt = gp + g * (DV + 2);
  if (live) {
    if (l8 == 0) {
      gt[0] = m;
      gt[1] = l;
    }
    if (vl)
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[2 + l8 * 4 + e] = o[e];
  }
  __syncthreads();
  // The groups' partials of each sample, merged in group order by one warp:
  // M = max m_k, f_k = exp(m_k - M), L = sum l_k f_k, O = sum o_k f_k; no
  // key at all gives M = -inf, L = O = 0.
  for (int ss = warp; ss < ns; ss += kWarps) {
    const float* src = gp + ss * Gs * (DV + 2);
    const float mk = lane < Gs ? src[lane * (DV + 2)] : -CUDART_INF_F;
    const float M = warp_max(mk);
    const float f = mk == -CUDART_INF_F ? 0.f : expf(mk - M);
    const float L = warp_sum(lane < Gs ? src[lane * (DV + 2) + 1] * f : 0.f);
    float O = 0.f;
#pragma unroll 8
    for (int k = 0; k < Gs; ++k) {
      const float fk = __shfl_sync(0xffffffffu, f, k);
      if (lane < DV) O += src[k * (DV + 2) + 2 + lane] * fk;
    }
    for (int r = 0; r < R; ++r) {
      float* dst = cluster.map_shared_rank(apart, r) + (rank * S + ss) * (DV + 2);
      if (lane == 0) {
        dst[0] = M;
        dst[1] = L;
      }
      if (lane < DV) dst[2 + lane] = O;
    }
  }
}

template <int SB>
__global__ void __launch_bounds__(kThreads, 1)
snail_loop_kernel(const float* __restrict__ canvas0, const float* __restrict__ uniforms,
                  const float* __restrict__ stream, float* __restrict__ canvas_out, float* kv,
                  float* taps, Weights wt, Dims dm, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Feed feed;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = pl.cluster, S = pl.samples;
  const int N = dm.N, C = dm.C, C2 = dm.C2, NB = dm.NB, NR = dm.NR, DK = dm.DK, DV = dm.DV;
  const int h = dm.h, w = dm.w, wp = w + 2, L = h * w, F = DK + DV;
  const int cnt = C / R, lo = rank * cnt, lr = (L + R - 1) / R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = rsqrtf(static_cast<float>(DK));
  const Layout ly = layout(dm, pl);
  const BlockPrm bp = block_prm(dm, R);
  float* prm = smem + ly.prm;  // in_w4 (4C), in_b, h1_b, h2_w, h2_b
  float* in_w4 = prm;
  float* in_b = in_w4 + up4(4 * C);
  float* h1_b = in_b + up4(C);
  float* h2_w = h1_b + up4(C2);
  float* h2_b = h2_w + up4(C2);
  float* blk = smem + ly.blk;
  int* tab = reinterpret_cast<int*>(smem + ly.tab);
  float* pre = smem + ly.pre;
  float* t2 = smem + ly.t2;
  float* cv = smem + ly.cv;
  float* uni = smem + ly.uni;
  float* x = smem + ly.x;
  float* res = smem + ly.res;
  float* er = smem + ly.er;
  float* mid = smem + ly.mid;
  float* qin = smem + ly.qin;
  float* kvp = smem + ly.kvp;
  float* q = smem + ly.q;
  float* att = smem + ly.att;
  float* ea = smem + ly.ea;
  float* u2 = smem + ly.u2;
  float* apart = smem + ly.apart;
  float* gp = smem + ly.gp;
  float* merged = smem + ly.merged;
  // The taps' device ring of this rank: per sample, tap (0, 1) and slot
  // (position mod w + 1), every residual block's 3 cnt partial sums (conv
  // 1's channels, conv 2's top and gate); the sums for position q are
  // written at q - w - 1 (tap 0) and q - w (tap 1) into slot q mod (w + 1),
  // read a block ahead of q's use and overwritten at q, after that read.
  const int rb3 = NR * 3 * cnt;
  auto ring_at = [&](float* ring, int s, int tap, int q, int br) {
    return ring + ((static_cast<int64_t>(s) * 2 + tap) * (w + 1) + q % (w + 1)) * NB * rb3 +
           br * 3 * cnt;
  };
  // Copies taps 0 and 1 of block b at position q, for every live sample,
  // into dst (S, 2 taps, NR, 3 cnt), 16 bytes a copy.
  auto prefetch_taps = [&](float* dst, float* ring, int q, int b, int n_live, int t) {
    for (int idx = t * 4; idx < n_live * 2 * rb3; idx += kThreads * 4) {
      const int st = idx / rb3, e = idx - st * rb3;
      cp_async16(dst + idx, ring_at(ring, st / 2, st % 2, q, b * NR) + e);
    }
  };

  __shared__ uint64_t full[kMaxDepth];
  if (tid == 0) {
    feed.st = stream_shape(dm, R, pl.stage);
    feed.src = stream + static_cast<int64_t>(rank) * feed.st.position_floats;
    feed.tab = tab;
    feed.ring = smem + ly.ring;
    feed.full = full;
    feed.stage = up4(pl.stage);
    feed.depth = pl.depth;
    feed.next_up = 0;
    feed.next_s = 0;
    const int cid = blockIdx.x / R, clusters = gridDim.x / R;
    const int my_groups = cid < pl.groups ? (pl.groups - 1 - cid) / clusters + 1 : 0;
    feed.left = feed.st.per_position * L * my_groups;
    // A position's chunks, in the chain's order.
    const Stream& st = feed.st;
    int n = 0;
    for (int b = 0; b <= NB; ++b)
      for (int j = 0; j < (b < NB ? NR + 5 : 1); ++j) {
        const int kind = b == NB ? kHead : j < NR ? kConv1 : kQkv + j - NR;
        for (int half = 0; half < (kind == kConv1 ? 2 : 1); ++half) {
          const int k = kind + half;
          const int at = b * st.block_floats + (b == NB ? 0 : st.off[k]) +
                         (j < NR && b < NB ? j * st.rb_floats : 0);
          for (int c = 0; c < st.chunks[k]; ++c) {
            const int k0 = c * st.rows[k];
            tab[2 * n] = at + k0 * st.ld[k];
            tab[2 * n + 1] = min(st.rows[k], st.K[k] - k0) * st.ld[k];
            ++n;
          }
        }
      }
    for (int k = 0; k < pl.depth; ++k) mbar_init(full + k, 1);
    mbar_fence_init();
  }
  // The resident parameters.
  for (int k = tid; k < 4 * C; k += kThreads) in_w4[k] = wt.in_w4[k];
  for (int k = tid; k < C; k += kThreads) in_b[k] = wt.in_b[k];
  for (int k = tid; k < C2; k += kThreads) {
    h1_b[k] = wt.h1_b[k];
    h2_w[k] = wt.h2_w[k];
  }
  if (tid == 0) h2_b[0] = wt.h2_b[0];
  for (int b = 0; b < NB; ++b) {
    float* p = blk + b * bp.floats;
    for (int k = tid; k < NR * cnt; k += kThreads) {
      const int j = k / cnt, c = k - j * cnt;
      p[bp.b1 + k] = wt.rb1_b[(b * NR + j) * C + lo + c];
      p[bp.b2 + j * 2 * cnt + c] = wt.rb2_b[(b * NR + j) * 2 * C + lo + c];
      p[bp.b2 + j * 2 * cnt + cnt + c] = wt.rb2_b[(b * NR + j) * 2 * C + C + lo + c];
    }
    for (int k = tid; k < DK; k += kThreads) p[bp.qb + k] = wt.q_b[b * DK + k];
    for (int k = tid; k < F; k += kThreads) {
      p[bp.kvb + k] = wt.kv_b[b * F + k];
      p[bp.kvl + k] = wt.kv_w[(static_cast<int64_t>(b) * (C + 3) + C + 2) * F + k];
    }
    for (int k = tid; k < DV; k += kThreads) p[bp.opb + k] = wt.op_b[b * DV + k];
    for (int k = tid; k < C; k += kThreads) {
      p[bp.rob + k] = wt.ro_b[b * C + k];
      p[bp.aob + k] = wt.ao_b[b * C + k];
      p[bp.ob + k] = wt.o_b[b * C + k];
    }
  }
  __syncthreads();  // the feed and its barriers
  RingPos rp{0, 0u};
  if (tid == 0)
    for (int k = 0; k < feed.depth - 1; ++k) feed.issue();
  cluster.sync();  // every rank has started: stores into its shared memory may begin

  const int cid = blockIdx.x / R, clusters = gridDim.x / R;
  const int64_t sstride = static_cast<int64_t>(NB) * R * lr * F;  // a sample's K/V
  int turn = 0;  // attention exchanges so far (apart's two halves alternate)
  for (int grp = cid; grp < pl.groups; grp += clusters) {
    const int s0 = grp * S, ns = min(S, N - s0);
    if (rank == 0)
      for (int idx = tid; idx < (h + 2) * wp * ns; idx += kThreads) {
        const int p = idx / ns, s = idx - p * ns;
        const int64_t e = static_cast<int64_t>(p) * N + s0 + s;
        canvas_out[e] = canvas0[e];
      }
    for (int idx = tid; idx < ns * wp; idx += kThreads) {
      const int s = idx / wp, c = idx - s * wp;
      cv[(s * 3 + 0) * wp + c] = canvas0[static_cast<int64_t>(c) * N + s0 + s];
    }
    // This group's slice of the taps' device ring (see ring_at).
    float* ring0 = taps + (static_cast<int64_t>(rank) * N + s0) * 2 * (w + 1) * NB * NR * 3 * cnt;
    cp_async_wait_all();
    prefetch_taps(pre, ring0, 0, 0, ns, tid);
    cp_async_commit();

    for (int i = 0; i < L; ++i) {
      const int row = i / w, col = i - row * w;
      const float pos_y = static_cast<float>(row) / static_cast<float>(h) - 0.5f;
      const float pos_x = static_cast<float>(col) / static_cast<float>(w) - 0.5f;
      if (col == 0) {  // padded row row + 1 and this row's uniforms
        const int pr = row + 1;
        for (int idx = tid; idx < ns * wp; idx += kThreads) {
          const int s = idx / wp, c = idx - s * wp;
          cv[(s * 3 + pr % 3) * wp + c] = canvas0[static_cast<int64_t>(pr * wp + c) * N + s0 + s];
        }
        for (int idx = tid; idx < ns * w; idx += kThreads) {
          const int s = idx / w, c = idx - s * w;
          uni[s * w + c] = uniforms[static_cast<int64_t>(row * w + c) * N + s0 + s];
        }
        __syncthreads();
      }
      // The masked input conv's 4 live taps, alike on every rank.
      for (int idx = tid; idx < ns * C; idx += kThreads) {
        const int s = idx / C, c = idx - s * C;
        const float* r0 = cv + (s * 3 + row % 3) * wp + col;
        const float* r1 = cv + (s * 3 + (row + 1) % 3) * wp + col;
        const float v = in_b[c] + r0[0] * in_w4[c] + r0[1] * in_w4[C + c] +
                        r0[2] * in_w4[2 * C + c] + r1[0] * in_w4[3 * C + c];
        x[idx] = v;
        res[idx] = v;
        er[idx] = elu(v);
      }

      for (int b = 0; b < NB; ++b) {
        const float* p = blk + b * bp.floats;
        // This block's taps 0 and 1 have landed (this thread's copies; the
        // product's barrier shows them to all); start the next block's.
        const int par = (i * NB + b) & 1;
        cp_async_wait_all();
        if (b + 1 < NB)
          prefetch_taps(pre + (par ^ 1) * S * 2 * NR * 3 * cnt, ring0, i, b + 1, ns, tid);
        else if (i + 1 < L)
          prefetch_taps(pre + (par ^ 1) * S * 2 * NR * 3 * cnt, ring0, i + 1, 0, ns, tid);
        cp_async_commit();
        const float* pb = pre + par * S * 2 * NR * 3 * cnt;  // (S, 2 taps, NR, 3 cnt)
        for (int j = 0; j < NR; ++j) {
          const int br = b * NR + j;
          float* t2r = t2 + (br * 2 + (i & 1)) * S * 3 * cnt;        // tap 2 for i
          float* t2w = t2 + (br * 2 + ((i + 1) & 1)) * S * 3 * cnt;  // tap 2 for i + 1
          // Conv 1 of elu(res) at i, all four taps of this rank's channels:
          // tap 3 with taps 0-2 of earlier positions into mid at i; taps 0-2
          // ahead, for the positions that take this one as that tap.
          product<SB, false>(feed, rp, kConv1, er, C, ns, cnt, [&](int s, int jj, float v, float) {
            const int t = jj / cnt, c = jj - t * cnt;
            if (t == 3) {
              const float* pr = pb + (s * 2 * NR + j) * 3 * cnt + c;
              float m = 0.f;
              if (row > 0 && col > 0) m += pr[0];
              if (row > 0) m += pr[NR * 3 * cnt];
              if (col > 0) m += t2r[s * 3 * cnt + c];
              m = elu(m + v + p[bp.b1 + j * cnt + c]);
              for (int r = 0; r < R; ++r) *cluster.map_shared_rank(mid + s * C + lo + c, r) = m;
            } else if (t == 2) {
              if (col + 1 < w) t2w[s * 3 * cnt + c] = v;
            } else if (row + 1 < h && (t == 1 || col + 1 < w)) {
              ring_at(ring0, s, t, i + w + 1 - t, br)[c] = v;
            }
          });
          cluster_barrier(R);
          // Conv 2 of mid at i, likewise; the gate updates this rank's res
          // channels on every rank.
          product<SB, true>(feed, rp, kConv2, mid, C, ns, cnt,
                            [&](int s, int jj, float vt, float vg) {
            const int pi = jj >> 1, t = pi / cnt, c = pi - t * cnt;
            if (t == 3) {
              const float* pr = pb + (s * 2 * NR + j) * 3 * cnt + cnt + c;
              const float* q2 = t2r + s * 3 * cnt + cnt + c;
              float top = 0.f, gate = 0.f;
              if (row > 0 && col > 0) {
                top += pr[0];
                gate += pr[cnt];
              }
              if (row > 0) {
                top += pr[NR * 3 * cnt];
                gate += pr[NR * 3 * cnt + cnt];
              }
              if (col > 0) {
                top += q2[0];
                gate += q2[cnt];
              }
              top += vt + p[bp.b2 + j * 2 * cnt + c];
              gate += vg + p[bp.b2 + j * 2 * cnt + cnt + c];
              const float v = res[s * C + lo + c] + top * sigmoid(gate);
              for (int r = 0; r < R; ++r) *cluster.map_shared_rank(res + s * C + lo + c, r) = v;
            } else if (t == 2) {
              if (col + 1 < w) {
                t2w[s * 3 * cnt + cnt + c] = vt;
                t2w[s * 3 * cnt + 2 * cnt + c] = vg;
              }
            } else if (row + 1 < h && (t == 1 || col + 1 < w)) {
              float* g = ring_at(ring0, s, t, i + w + 1 - t, br) + cnt + c;
              g[0] = vt;
              g[cnt] = vg;
            }
          });
          cluster_barrier(R);
          if (j + 1 < NR)
            for (int idx = tid; idx < ns * C; idx += kThreads) er[idx] = elu(res[idx]);
        }
        // q_in = [pos, res]: q, and kv_proj's part of it (the merged pixel's
        // row is added after the draw); elu(res) for residual_out.
        for (int idx = tid; idx < ns * (C + 2); idx += kThreads) {
          const int s = idx / (C + 2), k = idx - s * (C + 2);
          const float v = k == 0 ? pos_y : k == 1 ? pos_x : res[s * C + k - 2];
          qin[idx] = v;
          if (k >= 2) er[s * C + k - 2] = elu(v);
        }
        product<SB, false>(feed, rp, kQkv, qin, C + 2, ns, cnt, [&](int s, int jj, float v, float) {
          if (jj < DK)
            q[s * DK + jj] = (v + p[bp.qb + jj]) * scale;
          else
            kvp[(b * S + s) * F + jj - DK] = v + p[bp.kvb + jj - DK];
        });
        __syncthreads();
        // Attention over this rank's keys < i, then over the ranks.
        float* ap = apart + (turn & 1) * R * S * (DV + 2);
        ++turn;
        const int nprev = i > rank ? (i - 1 - rank) / R + 1 : 0;
        attention_part(cluster, rank, R, dm, q,
                       kv + (static_cast<int64_t>(s0) * NB * R + b * R + rank) * lr * F,
                       sstride, nprev, ns, S, gp, ap);
        cluster_barrier(R);
        for (int idx = tid; idx < ns * DV; idx += kThreads) {
          const int s = idx / DV, d = idx - s * DV;
          float mx = -CUDART_INF_F;
          for (int r = 0; r < R; ++r) mx = fmaxf(mx, ap[(r * S + s) * (DV + 2)]);
          float den = 0.f, num = 0.f;
          for (int r = 0; r < R; ++r) {
            const float* pr = ap + (r * S + s) * (DV + 2);
            const float f = pr[0] == -CUDART_INF_F ? 0.f : expf(pr[0] - mx);
            den += pr[1] * f;
            num += pr[2 + d] * f;
          }
          att[idx] = den > 0.f ? num / den : 0.f;
        }
        // att = elu(out_proj(att)); res2 = elu(residual_out(elu(res)));
        // att2 = elu(attention_out(att)); x += elu(out(elu(res2 + att2))).
        product<SB, false>(feed, rp, kOp, att, DV, ns, cnt, [&](int s, int d, float v, float) {
          ea[s * DV + d] = elu(v + p[bp.opb + d]);
        });
        product<SB, false>(feed, rp, kRo, er, C, ns, cnt, [&](int s, int c, float v, float) {
          u2[s * C + c] = elu(v + p[bp.rob + c]);
        });
        product<SB, false>(feed, rp, kAo, ea, DV, ns, cnt, [&](int s, int c, float v, float) {
          u2[s * C + c] = elu(u2[s * C + c] + elu(v + p[bp.aob + c]));
        });
        product<SB, false>(feed, rp, kOut, u2, C, ns, cnt, [&](int s, int c, float v, float) {
          const float xv = x[s * C + c] + elu(v + p[bp.ob + c]);
          x[s * C + c] = xv;
          res[s * C + c] = xv;
          er[s * C + c] = elu(xv);
        });
      }

      // The head, the draw and the inpainting merge, alike on every rank.
      product<SB, false>(feed, rp, kHead, x, C, ns, cnt, [&](int s, int c, float v, float) {
        u2[s * C2 + c] = v + h1_b[c];
      });
      __syncthreads();
      for (int s = warp; s < ns; s += kWarps) {
        float v = 0.f;
        for (int c = lane; c < C2; c += 32) v += u2[s * C2 + c] * h2_w[c];
        v = warp_sum(v);
        if (lane == 0) {
          const float prob = sigmoid(v + h2_b[0]);
          float* px = cv + (s * 3 + (row + 1) % 3) * wp + col + 1;
          float pix = *px;
          if (pix < 0.f) pix = uni[s * w + col] < prob ? 1.f : 0.f;
          *px = pix;
          merged[s] = pix;
          if (rank == 0)
            canvas_out[static_cast<int64_t>((row + 1) * wp + col + 1) * N + s0 + s] = pix;
        }
      }
      __syncthreads();
      // The owner of position i appends every block's k|v at i.
      if (i % R == rank) {
        const int li = i / R;
        for (int idx = tid; idx < NB * ns * F; idx += kThreads) {
          const int b = idx / (ns * F), rest = idx - b * ns * F, s = rest / F, f = rest - s * F;
          const float v = kvp[(b * S + s) * F + f] + merged[s] * blk[b * bp.floats + bp.kvl + f];
          kv[((static_cast<int64_t>(s0 + s) * NB + b) * R + rank) * lr * F +
             static_cast<int64_t>(li) * F + f] = v;
        }
      }
      // The next position's input conv reads the canvas row written above.
      __syncthreads();
    }
  }
  cluster.sync();  // no rank leaves while another may still write to it
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, float*, Weights,
                        Dims, Plan);

Kernel instance(int samples) {
  return samples <= 1 ? snail_loop_kernel<1>
       : samples <= 2 ? snail_loop_kernel<2>
       : samples <= 4 ? snail_loop_kernel<4>
                      : snail_loop_kernel<8>;
}

cudaError_t configure(Kernel k, int smem) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

// Bytes of dynamic shared memory a CTA of this plan takes.
extern "C" long long snail_loop_smem_bytes(int h, int w, int n_blocks, int n_rb, int C, int C2,
                                           int d_k, int d_v, int cluster, int samples, int stage,
                                           int depth) {
  const Dims dm{0, h, w, n_blocks, n_rb, C, C2, d_k, d_v};
  const Plan pl{cluster, samples, 0, stage, depth};
  return 4LL * layout(dm, pl).total;
}

// Bytes of static shared memory of the kernel instance for `samples` a
// group (the feed's descriptors).
extern "C" int snail_loop_static_smem_bytes(int samples, int* bytes) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, instance(samples));
  *bytes = static_cast<int>(fa.sharedSizeBytes);
  return err;
}

// cudaOccupancyMaxActiveClusters of the kernel instance for `samples` a
// group at this cluster size and shared memory, and its registers a thread.
extern "C" int snail_loop_occupancy(int samples, int cluster, int smem, int* clusters,
                                    int* regs) {
  const Kernel k = instance(samples);
  cudaError_t err = configure(k, smem);
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

// Floats of the taps' device ring of one sample (all ranks).
extern "C" long long snail_loop_taps_floats(int w, int n_blocks, int n_rb, int C) {
  return 6LL * (w + 1) * n_blocks * n_rb * C;
}

// Floats of the packed weight streams of a cluster's ranks.
extern "C" long long snail_loop_stream_floats(int h, int w, int n_blocks, int n_rb, int C,
                                              int C2, int d_k, int d_v, int cluster) {
  const Dims dm{0, h, w, n_blocks, n_rb, C, C2, d_k, d_v};
  return static_cast<long long>(cluster) * stream_shape(dm, cluster, 1 << 30).position_floats;
}

// canvas0, canvas_out: (Lp, N); uniforms: (L, N); kv: (N, n_blocks, cluster,
// ceil(L / cluster), d_k + d_v) scratch; taps: N * snail_loop_taps_floats
// scratch; packed: snail_loop_stream_floats scratch; weights as in struct
// Weights. All float32, contiguous, on one
// device; the weights the pack kernel reads 16 bytes at a time (all but
// the biases, in_w4 and h2_w) 16-byte aligned. Two launches: the pack
// kernel, then the sampler.
extern "C" int snail_loop_f32(
    const float* canvas0, const float* uniforms, float* canvas_out, float* kv, float* taps,
    float* packed,
    const float* in_w4, const float* in_b, const float* rb1_w, const float* rb1_b,
    const float* rb2_w, const float* rb2_b, const float* q_w, const float* q_b,
    const float* kv_w, const float* kv_b, const float* op_w, const float* op_b,
    const float* ro_w, const float* ro_b, const float* ao_w, const float* ao_b,
    const float* o_w, const float* o_b, const float* h1_w, const float* h1_b,
    const float* h2_w, const float* h2_b, int N, int h, int w, int n_blocks, int n_rb,
    int C, int C2, int d_k, int d_v, int cluster, int clusters, int samples, int groups,
    int stage, int depth, void* stream) {
  const Weights wt{in_w4, in_b, rb1_w, rb1_b, rb2_w, rb2_b, q_w, q_b, kv_w, kv_b, op_w,
                   op_b, ro_w, ro_b, ao_w, ao_b, o_w, o_b, h1_w, h1_b, h2_w, h2_b};
  const Dims dm{N, h, w, n_blocks, n_rb, C, C2, d_k, d_v};
  const Plan pl{cluster, samples, groups, stage, depth};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = d_k + d_v, cnt = C / cluster;
  Sources src{};
  // Conv 1: row k = [tap 0 | tap 1 | tap 2 | tap 3] of the rank's channels.
  src.nseg[kConv1] = 4;
  for (int t = 0; t < 4; ++t)
    src.seg[kConv1][t] = {rb1_w + t * C * C, n_rb * 4 * C * C, 4 * C * C, C, cnt, t * cnt};
  // Conv 2: per tap, the rank's top channels, then its gate channels.
  src.nseg[kConv2] = 8;
  for (int t = 0; t < 4; ++t)
    for (int half = 0; half < 2; ++half)
      src.seg[kConv2][2 * t + half] = {rb2_w + t * C * 2 * C + half * C, n_rb * 8 * C * C,
                                       8 * C * C, 2 * C, cnt, (2 * t + half) * cnt};
  // q | kv_proj's [pos, res] rows (the merged pixel's row stays resident).
  src.nseg[kQkv] = 2;
  src.seg[kQkv][0] = {q_w, (C + 2) * d_k, 0, d_k, d_k, 0};
  src.seg[kQkv][1] = {kv_w, (C + 3) * F, 0, F, F, d_k};
  for (int k = kOp; k < kKinds; ++k) src.nseg[k] = 1;
  src.seg[kOp][0] = {op_w, d_v * d_v, 0, d_v, d_v, 0};
  src.seg[kRo][0] = {ro_w, C * C, 0, C, C, 0};
  src.seg[kAo][0] = {ao_w, d_v * C, 0, C, C, 0};
  src.seg[kOut][0] = {o_w, C * C, 0, C, C, 0};
  src.seg[kHead][0] = {h1_w, 0, 0, C2, C2, 0};
  const Stream sh = stream_shape(dm, cluster, stage);
  const dim3 pack_grid((sh.position_floats / 4 + kThreads - 1) / kThreads, cluster);
  snail_pack_kernel<<<pack_grid, kThreads, 0, st>>>(src, sh, dm, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = 4 * layout(dm, pl).total;
  const Kernel k = instance(samples);
  err = configure(k, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, clusters, cluster, smem, st);
  err = cudaLaunchKernelEx(&cfg, k, canvas0, uniforms, static_cast<const float*>(packed),
                           canvas_out, kv, taps, wt, dm, pl);
  return err != cudaSuccess ? err : cudaGetLastError();
}
