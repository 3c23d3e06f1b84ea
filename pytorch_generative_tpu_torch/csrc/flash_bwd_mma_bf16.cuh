// PixelSNAIL's bf16 flash backward, (d_k, d_v) = (4, 32) and (4, 8), on
// bf16 tensor cores (mma.sync with f32 sums): flash_bwd_bf16's dq pass and
// dk/dv pass for those pairs (flash_bwd.cu has the contract and why there
// are two passes).
//
// Replaces, for those pairs and bf16 operands,
// pytorch_generative_tpu/ops/attention_pallas.py::_bwd_fused_kernel, at
// its rounding points for bf16 (attention_pallas.py:250-290): q2 = bf16(q
// scale log2 e) as it is staged, k unscaled; S = q2 k^T and dP = dO v^T in
// f32; P = exp2(S - lse log2 e), dS = P (dP - delta) in f32, each rounded to
// bf16 where it becomes an mma operand (dV = bf16(P)^T dO, dQ = bf16(dS) k
// scale, dK = bf16(dS)^T q2 ln 2); delta = rowsum(dO O) and lse in f32; dq,
// dk and dv rounded at their stores. mask_center shifts the diagonal by
// one; a fully masked row (lse = -inf: row 0 under mask_center) gets P = 0
// and so dq = 0.
//
// What bounds it on an H100: at d_k 4 the work per causal (query, key) pair
// is 2 (2 d_k + 3 d_v) ~ 200 operations, ~6.9 GFLOP a call at (B 128, L
// 784, H 1, d_v 32) once d_k is padded to the mma's depth (7 us at 989
// TFLOP/s), against ~10 MB of operands (3 us at 3.35 TB/s). On the tensor
// cores the products are small beside the exponentials (one exp2 a pair)
// and the latency of each tile step: the SIMT passes this replaces did all
// of it as f32 FMAs on the CUDA cores, two threads a row, at ~1% of that
// bound.
//
// Design. A CTA is 4 warps and owns 64 query rows (dq pass) or 64 keys
// (dk/dv pass), 16 a warp, one mma's M; it walks the other side's 64-row
// tiles up to (from) the diagonal, each staged into shared memory by all
// 128 threads, 16 keys (rows) at a time:
//   dq pass:    S = q2 k^T     m16n8k8, A = the warp's q2 rows (registers,
//                              d_k zero-padded to 8), B = k rows;
//               dP = dO v^T    m16n8k16 over d_v (m16n8k8 at d_v = 8), A =
//                              the warp's dO rows (registers), B = v rows;
//               dQ += dS K     m16n8k16 over the 16 keys, A = dS straight
//                              from the S / dP accumulators, B = k^T;
//   dk/dv pass: S^T = k q2^T and dP^T = v dO^T likewise with the warp's k
//               and v rows as A; dV += P^T dO and dK += dS^T q2 with A =
//               P^T and dS^T from the accumulators, B = dO^T and q2^T.
// An m16n8 accumulator (rows g and g + 8, columns 2t and 2t + 1) of two
// neighbouring 8-column blocks is, packed to bf16 pairs, the A fragment of
// an m16n8k16 product over those 16 columns, so P and dS never leave the
// registers. The tiles that are B in the transposed sense (k^T, q2^T,
// dO^T) are stored transposed as they are staged, so that every fragment
// is one 32-bit shared load; rows are padded against bank conflicts. dq,
// dk's and dv's 16-key (16-row) products go into fresh accumulators and
// are added in f32 (the tensor cores' sums round toward zero:
// flash_mma.cuh). Columns 4-7 of dQ and dK are the zero pad and are not
// stored. Every output is summed by one thread in a fixed order: two calls
// give the same bits.
//
// Operands are any view with unit feature stride (PixelSNAIL's k and v are
// column views of one (B, L, d_k + d_v) kv tensor, v 8 bytes into a
// 72-byte row, which TMA's 16-byte strides cannot take): an operand whose
// start and (batch, row) strides are 8-byte aligned is read 8 bytes (4
// values) a load, any other 2 bytes a load; the launch chooses per operand.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace smma {

using T = bf16::T;

constexpr int kBlock = 64;            // rows (keys) a CTA owns, and a streamed tile
constexpr int kWarps = 4;             // 16 rows (keys) a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;            // keys (rows) of one m16n8k16 product over them
constexpr int kDK = 4;                // d_k
constexpr int kTLd = kBlock + 8;      // row stride of a transposed tile, in values
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row stride, in 32-bit words, of a staged tile of D values a row: 20 words
// at D = 32 (rows g of a fragment load 20 g mod 32 banks apart, no
// conflict).
template <int D>
__host__ __device__ constexpr int words() {
  return D / 2 + 4;
}

// d (16 x 8) = a (16 x 8) b (8 x 8) + c, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b,
                                       const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d (16 x 8) = a (16 x 16) b (16 x 8) + c, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2], const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// A packed operand: element (b, row, h * D + d) at p[b bs + row rs + h D +
// d]; `wide` when p and both strides are 8-byte aligned.
struct Operand {
  const T* p;
  int64_t bs, rs;
  bool wide;
};

__device__ __forceinline__ uint32_t bits(T x) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&x));
}

// Values d, d + 1 (d even) of row `row`, head h, batch b, as a packed pair.
template <int D>
__device__ __forceinline__ uint32_t ld2(const Operand& o, int b, int row, int h, int d) {
  const T* x = o.p + b * o.bs + row * o.rs + h * D + d;
  if (o.wide) return __ldg(reinterpret_cast<const unsigned int*>(x));
  return bits(x[0]) | bits(x[1]) << 16;
}

// Values d .. d + 3 (d a multiple of 4) of a row, as two packed pairs.
template <int D>
__device__ __forceinline__ uint2 ld4(const Operand& o, int b, int row, int h, int d) {
  const T* x = o.p + b * o.bs + row * o.rs + h * D + d;
  if (o.wide) return __ldg(reinterpret_cast<const uint2*>(x));
  return make_uint2(bits(x[0]) | bits(x[1]) << 16, bits(x[2]) | bits(x[3]) << 16);
}

// A pair times m, rounded to bf16 again: q2's pairs from q's.
__device__ __forceinline__ uint32_t scaled(uint32_t v, float m) {
  return bf16::pack(bf16::lo(v) * m, bf16::hi(v) * m);
}

// Writes the two values of a packed pair at rows d, d + 1 of a transposed
// tile (column c).
__device__ __forceinline__ void put_t(unsigned short* t, int d, int c, uint32_t v) {
  t[d * kTLd + c] = static_cast<unsigned short>(v & 0xffffu);
  t[(d + 1) * kTLd + c] = static_cast<unsigned short>(v >> 16);
}

// Stages rows [row0, row0 + kBlock) of the d_k-wide operand o (times m and
// rounded to bf16 unless m == 1) into rows[] as stored and into tr
// ([d][row]); rows past L are zeros.
__device__ __forceinline__ void stage_dk(uint2* rows, unsigned short* tr, const Operand& o,
                                         int b, int h, int row0, int L, float m) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    uint2 v = row0 + r < L ? ld4<kDK>(o, b, row0 + r, h, 0) : make_uint2(0u, 0u);
    if (m != 1.f) v = make_uint2(scaled(v.x, m), scaled(v.y, m));
    rows[r] = v;
    put_t(tr, 0, r, v.x);
    put_t(tr, 2, r, v.y);
  }
}

// Stages rows [row0, row0 + kBlock) of the D-wide operand o into rows
// (words<D>() a row) and, with tr, transposed into tr ([d][row]).
template <int D>
__device__ __forceinline__ void stage_dv(uint32_t* rows, unsigned short* tr, const Operand& o,
                                         int b, int h, int row0, int L) {
  constexpr int kQuads = D / 4;
  for (int i = threadIdx.x; i < kBlock * kQuads; i += kThreads) {
    const int r = i / kQuads, d = 4 * (i % kQuads);
    const uint2 v = row0 + r < L ? ld4<D>(o, b, row0 + r, h, d) : make_uint2(0u, 0u);
    *reinterpret_cast<uint2*>(rows + r * words<D>() + d / 2) = v;
    if (tr != nullptr) {
      put_t(tr, d, r, v.x);
      put_t(tr, d + 2, r, v.y);
    }
  }
}

// The A fragment of a 16-row block's D-wide rows r0 (= row g) and r1 (= row
// g + 8) for the product over features [16 kb, 16 kb + 16) (m16n8k16), or
// over all 8 at D = 8 (m16n8k8: a[0], a[1]).
template <int D>
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const Operand& o, int b, int h,
                                       const int (&rows)[2], int L, int kb, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rows[i % 2], d = 16 * kb + 2 * t + 8 * (i / 2);
    a[i] = (D == 8 && i >= 2) || row >= L ? 0u : ld2<D>(o, b, row, h, d);
  }
}

// The d_k-wide rows' A fragment (m16n8k8, features 4-7 zero), times m and
// rounded to bf16 unless m == 1.
__device__ __forceinline__ void a_dk(uint32_t (&a)[2], const Operand& o, int b, int h,
                                     const int (&rows)[2], int L, int t, float m) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t v = t < 2 && rows[i] < L ? ld2<kDK>(o, b, rows[i], h, 2 * t) : 0u;
    a[i] = m != 1.f ? scaled(v, m) : v;
  }
}

// acc (16 x 8, f32) of dP or dP^T: the products over D features of the A
// fragments a and the B rows `brow` (words<D>() a row: the columns' D
// values).
template <int D>
__device__ __forceinline__ void dot_dv(float (&acc)[4], const uint32_t (&a)[D / 16 > 0 ? D / 16 : 1][4],
                                       const uint32_t* brow, int t) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (D == 8) {
    const uint32_t a8[2] = {a[0][0], a[0][1]};
    mma_k8(acc, a8, brow[t], zero);
  } else {
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
      const uint32_t bb[2] = {brow[8 * kb + t], brow[8 * kb + 4 + t]};
      if (kb == 0)
        mma_k16(acc, a[kb], bb, zero);
      else
        mma_k16(acc, a[kb], bb, acc);
    }
  }
}

// The A fragment (m16n8k16) over 16 columns from the accumulators of their
// two 8-column blocks, rounded to bf16.
__device__ __forceinline__ void a_of(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = bf16::pack(x[0][0], x[0][1]);
  a[1] = bf16::pack(x[0][2], x[0][3]);
  a[2] = bf16::pack(x[1][0], x[1][1]);
  a[3] = bf16::pack(x[1][2], x[1][3]);
}

// The B fragment (m16n8k16) of column n's 16 values from column c0 of a
// transposed tile tr ([n][c], kTLd a row); zeros where n >= n_valid.
__device__ __forceinline__ void b_t(uint32_t (&b)[2], const unsigned short* tr, int n, int c0,
                                    int t, int n_valid) {
  const uint32_t* row = reinterpret_cast<const uint32_t*>(tr + n * kTLd + c0);
  b[0] = n < n_valid ? row[t] : 0u;
  b[1] = n < n_valid ? row[4 + t] : 0u;
}

// dq pass: one CTA per (64-row q-tile, head, batch); warp w owns rows 16 w
// .. 16 w + 15 of the tile. Writes dq and the rows' delta.
template <int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Operand q, Operand k, Operand v, Operand o, Operand dout, const float* __restrict__ lse,
          T* __restrict__ dq, float* __restrict__ delta, int L, int H, float scale,
          float scale_log2, int offset) {
  constexpr int KB = DV / 16 > 0 ? DV / 16 : 1;
  __shared__ uint2 k_s[kBlock];
  __shared__ __align__(16) unsigned short kt_s[kDK * kTLd];
  __shared__ __align__(16) uint32_t v_s[kBlock * words<DV>()];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {qt * kBlock + 16 * warp + g, qt * kBlock + 16 * warp + g + 8};

  // The warp's q2 and dO rows as A fragments; delta = rowsum(dO O) of each
  // of the lane's rows (its columns 2 t + 8 i, + 1, then the row's 4 lanes).
  uint32_t aq[2], ado[KB][4];
  a_dk(aq, q, b, h, rows, L, t, scale_log2);
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) a_rows<DV>(ado[kb], dout, b, h, rows, L, kb, t);
  float dlt[2], lse2[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = 0.f;
    if (rows[i] < L) {
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const uint32_t x = ld2<DV>(dout, b, rows[i], h, 8 * c + 2 * t);
        const uint32_t y = ld2<DV>(o, b, rows[i], h, 8 * c + 2 * t);
        s += bf16::lo(x) * bf16::lo(y) + bf16::hi(x) * bf16::hi(y);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dlt[i] = s;
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + rows[i];
    lse2[i] = rows[i] < L ? lse[stat] * kLog2e : -CUDART_INF_F;
    live[i] = rows[i] < L && !isinf(lse2[i]);  // fully-masked rows: p = 0
    if (rows[i] < L && t == 0) delta[stat] = s;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // every reader of the last tile is done
    stage_dk(k_s, kt_s, k, b, h, kt * kBlock, L, 1.f);
    stage_dv<DV>(v_s, nullptr, v, b, h, kt * kBlock, L);
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < kBlock / kChunk; ++ch) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int key = kChunk * ch + 8 * nb + g;  // this lane's column of the B fragments
        const uint32_t bk = t == 0 ? k_s[key].x : t == 1 ? k_s[key].y : 0u;
        mma_k8(s[nb], aq, bk, zero);
        dot_dv<DV>(dp[nb], ado, v_s + key * words<DV>(), t);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int key = kt * kBlock + kChunk * ch + 8 * nb + 2 * t + e % 2;
          const bool ok = live[i] && key < L && key + offset <= rows[i];
          const float p = ok ? exp2f(s[nb][e] - lse2[i]) : 0.f;
          s[nb][e] = p * (dp[nb][e] - dlt[i]);  // dS
        }
      }
      uint32_t ads[4], bk[2];
      a_of(ads, s);
      b_t(bk, kt_s, g, kChunk * ch, t, kDK);
      float part[4];
      mma_k16(part, ads, bk, zero);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += part[e];
    }
  }

  if (t < 2) {  // columns 2 t, 2 t + 1 of d_k = 4
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < L) {
        T* p = dq + (static_cast<int64_t>(b) * L + rows[i]) * H * kDK + h * kDK + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = bf16::pack(acc[2 * i] * scale, acc[2 * i + 1] * scale);
      }
    }
  }
}

// dk/dv pass: one CTA per (64-key tile, head, batch); warp w owns keys 16 w
// .. 16 w + 15 of the tile.
template <int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(Operand q, Operand k, Operand v, Operand dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int H,
            float scale_log2, int offset) {
  constexpr int KB = DV / 16 > 0 ? DV / 16 : 1;
  __shared__ uint2 q_s[kBlock];
  __shared__ __align__(16) unsigned short qt_s[kDK * kTLd];
  __shared__ __align__(16) uint32_t do_s[kBlock * words<DV>()];
  __shared__ __align__(16) unsigned short dot_s[DV * kTLd];
  __shared__ float lse_s[kBlock], delta_s[kBlock];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int keys[2] = {kt * kBlock + 16 * warp + g, kt * kBlock + 16 * warp + g + 8};
  const int n_q_tiles = (L + kBlock - 1) / kBlock;

  uint32_t ak[2], av[KB][4];
  a_dk(ak, k, b, h, keys, L, t, 1.f);
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) a_rows<DV>(av[kb], v, b, h, keys, L, kb, t);
  float dk_acc[4] = {0.f, 0.f, 0.f, 0.f}, dv_acc[DV / 8][4];
#pragma unroll
  for (int nd = 0; nd < DV / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[nd][e] = 0.f;
  }
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  // q-tiles before this k-tile hold no row that sees its keys.
  for (int qt = kt; qt < n_q_tiles; ++qt) {
    __syncthreads();
    stage_dk(q_s, qt_s, q, b, h, qt * kBlock, L, scale_log2);
    stage_dv<DV>(do_s, dot_s, dout, b, h, qt * kBlock, L);
    for (int r = threadIdx.x; r < kBlock; r += kThreads) {
      const int row = qt * kBlock + r;
      const int64_t stat = (static_cast<int64_t>(b) * H + h) * L + row;
      lse_s[r] = row < L ? lse[stat] * kLog2e : -CUDART_INF_F;  // -inf: p = 0
      delta_s[r] = row < L ? delta[stat] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < kBlock / kChunk; ++ch) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int r = kChunk * ch + 8 * nb + g;  // this lane's column of the B fragments
        const uint32_t bq = t == 0 ? q_s[r].x : t == 1 ? q_s[r].y : 0u;
        mma_k8(s[nb], ak, bq, zero);
        dot_dv<DV>(dp[nb], av, do_s + r * words<DV>(), t);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int r = kChunk * ch + 8 * nb + 2 * t + e % 2;
          const float l2 = lse_s[r];
          const bool ok = keys[i] < L && !isinf(l2) && keys[i] + offset <= qt * kBlock + r;
          const float p = ok ? exp2f(s[nb][e] - l2) : 0.f;
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - delta_s[r]);  // dS
        }
      }
      uint32_t ap[4], ads[4];
      a_of(ap, s);
      a_of(ads, dp);
#pragma unroll
      for (int nd = 0; nd < DV / 8; ++nd) {
        uint32_t bo[2];
        b_t(bo, dot_s, 8 * nd + g, kChunk * ch, t, DV);
        float part[4];
        mma_k16(part, ap, bo, zero);
#pragma unroll
        for (int e = 0; e < 4; ++e) dv_acc[nd][e] += part[e];
      }
      uint32_t bq[2];
      b_t(bq, qt_s, g, kChunk * ch, t, kDK);
      float part[4];
      mma_k16(part, ads, bq, zero);
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[e] += part[e];
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= L) continue;
    const int64_t row = static_cast<int64_t>(b) * L + keys[i];
    if (t < 2)  // dS^T q2 ln 2: columns 2 t, 2 t + 1 of d_k = 4
      *reinterpret_cast<uint32_t*>(dk + row * H * kDK + h * kDK + 2 * t) =
          bf16::pack(dk_acc[2 * i] * kLn2, dk_acc[2 * i + 1] * kLn2);
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dv + row * H * DV + h * DV + 8 * nd + 2 * t) =
          bf16::pack(dv_acc[nd][2 * i], dv_acc[nd][2 * i + 1]);
  }
}

inline bool wide(const T* p, int64_t bs, int64_t rs) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0 && bs % 4 == 0 && rs % 4 == 0;
}

// Both passes on `stream` (the dk/dv pass reads the delta the dq pass
// stores), d_k = 4 and d_v = DV (32 or 8); scale_log2 as the TPU kernel
// forms it (fwg::scale_log2_of). Returns the launches' error.
template <int DV>
cudaError_t launch(const T* q, const T* k, const T* v, const T* out, const T* dout,
                   const float* lse, T* dq, T* dk, T* dv, float* delta, int B, int L, int H,
                   int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                   int64_t v_rs, int64_t o_bs, int64_t o_rs, int64_t do_bs, int64_t do_rs,
                   int mask_center, float scale_log2, cudaStream_t stream) {
  static_assert(DV == 8 || DV % 16 == 0, "d_v: one m16n8k8 or whole m16n8k16 steps");
  const Operand oq{q, q_bs, q_rs, wide(q, q_bs, q_rs)};
  const Operand ok{k, k_bs, k_rs, wide(k, k_bs, k_rs)};
  const Operand ov{v, v_bs, v_rs, wide(v, v_bs, v_rs)};
  const Operand oo{out, o_bs, o_rs, wide(out, o_bs, o_rs)};
  const Operand od{dout, do_bs, do_rs, wide(dout, do_bs, do_rs)};
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kDK)));
  const int offset = mask_center ? 1 : 0;
  dq_kernel<DV><<<grid, kThreads, 0, stream>>>(oq, ok, ov, oo, od, lse, dq, delta, L, H, scale,
                                               scale_log2, offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DV><<<grid, kThreads, 0, stream>>>(oq, ok, ov, od, lse, delta, dk, dv, L, H,
                                                 scale_log2, offset);
  return cudaGetLastError();
}

}  // namespace smma
