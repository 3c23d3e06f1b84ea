// A trial of the 3xTF32 product of csrc/gemm_tf32x3.cuh on Hopper's
// warpgroup instruction (wgmma), kept to time it against the mma.sync GEMM
// (tools/torch_gemm_variants.py); the port does not build it.
//
// out (M, N) = a (M, K) w (K, N) + bias. TF32 wgmma takes a K-major B, so
// split_t_kernel first writes w^T split into big = tf32(w) and small = w -
// big, (N, K) each, into scratch; B tiles of both reach shared memory by
// cp.async in the no-swizzle core-matrix layout (8 rows x 16 bytes a core
// matrix). A tiles land row-major as in gemm_tf32x3.cuh; each warp loads its
// 16 rows' fragments by ldmatrix and splits them in registers, and the
// warpgroup's wgmma m64nBNk8 takes A from registers. Each k-step's twelve
// products (four k-slices, three terms) go into fresh accumulators (scale-d
// 0 on the first), which are added into the running sums in f32 after
// wgmma.wait_group: each k-step is waited for before the next, or, with
// kInFlight, two fresh accumulators keep the k-step before in flight (ptxas
// serializes those wgmma all the same, C7514).

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#include "flash_mma.cuh"
#include "mma_tf32.cuh"

namespace wg3 {
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kSA = kBK + 4;
constexpr int kLBO = 128;              // bytes between core matrices adjacent in k
constexpr int kSBO = (kBK / 4) * 128;  // bytes between core matrices adjacent in n

// A no-swizzle matrix descriptor of the B tile at p.
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads of d above the wgmma wait before it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= a (64 x 8, TF32, registers) b (8 x 64, TF32, shared, K-major).
__device__ __forceinline__ void wgmma_64(float (&d)[32], const float (&a)[4], uint64_t desc_b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) (+)= a (64 x 8, TF32, registers) b (8 x 128, TF32, shared, K-major).
__device__ __forceinline__ void wgmma_128(float (&d)[64], const float (&a)[4], uint64_t desc_b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(scale_d));
}

template <int BN>
struct Mma;
template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const float (&a)[4], uint64_t b,
                                             int s) {
    wgmma_64(d, a, b, s);
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const float (&a)[4], uint64_t b,
                                             int s) {
    wgmma_128(d, a, b, s);
  }
};

// W (K, N) -> Wt big and small (N, K).
__global__ void split_t_kernel(const float* __restrict__ w, float* __restrict__ big,
                               float* __restrict__ small, int K, int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    tile[i][threadIdx.x] = k < K && n < N ? w[static_cast<int64_t>(k) * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < N && k < K) {
      const float x = tile[threadIdx.x][i], b = tf32::round(x);
      big[static_cast<int64_t>(n) * K + k] = b;
      small[static_cast<int64_t>(n) * K + k] = x - b;
    }
  }
}

template <int WGS, int BN>
struct Tiling {
  static constexpr int kBM = 64 * WGS, kThreads = 128 * WGS;
  static constexpr int kAFloats = kBM * kSA, kBFloats = BN * kBK;
  static constexpr int kStageFloats = kAFloats + 2 * kBFloats;
  static constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
};

// k-step kt's products into part: fresh sums (scale-d 0 on the first).
// With kInFlight, k-step kt - 1's part is added after waiting for all but
// the newest group, and the ring fetches one k-step less far ahead, so that
// no slot is refilled while a wgmma may still read it.
template <int WGS, int BN, bool kInFlight>
__global__ void __launch_bounds__(128 * WGS)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ bt_big,
            const float* __restrict__ bt_small, const float* __restrict__ bias,
            float* __restrict__ out, int M, int N, int K) {
  using T = Tiling<WGS, BN>;
  constexpr int NR = BN / 2;                               // accumulators a thread
  constexpr int D = kInFlight ? kStages - 2 : kStages - 1;  // k-steps fetched ahead
  extern __shared__ float smem[];
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16;  // the warp's first row
  const int n_k = (K + kBK - 1) / kBK;

  // A rows as in gemm_tf32x3.cuh; B rows n of w^T's big and small halves
  // into core matrices, (n / 8) kSBO + (k / 4) kLBO + (n % 8) 16 bytes.
  auto fetch = [&](int kt) {
    float* as = smem + (kt % kStages) * T::kStageFloats;
    float* bs = as + T::kAFloats;
    const int k0 = kt * kBK;
    for (int i = threadIdx.x; i < T::kBM * (kBK / 4); i += T::kThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      tf32::cp_async16(as + r * kSA + c,
                       ok ? a + static_cast<int64_t>(m0 + r) * K + k0 + c : a, ok);
    }
    for (int i = threadIdx.x; i < 2 * BN * (kBK / 4); i += T::kThreads) {
      const int half = i / (BN * (kBK / 4)), j = i % (BN * (kBK / 4));
      const int n = j % 8 + 8 * (j / (8 * (kBK / 4))), kc = (j / 8) % (kBK / 4);
      const bool ok = n0 + n < N && k0 + kc * 4 < K;
      const float* src = half ? bt_small : bt_big;
      tf32::cp_async16(
          bs + half * T::kBFloats + (n / 8) * (kSBO / 4) + kc * (kLBO / 4) + (n % 8) * 4,
          ok ? src + static_cast<int64_t>(n0 + n) * K + k0 + kc * 4 : src, ok);
    }
  };

  float acc[NR], part[2][NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  auto add = [&](float (&p)[NR]) {
    hold(p);
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] += p[i];
  };
  auto step = [&](int kt, float (&cur)[NR], float (&prev)[NR]) {
    tf32::cp_async_wait<D - 1>();  // k-step kt has landed
    fence_proxy();                 // for the async proxy that wgmma reads by
    __syncthreads();
    if (kt + D < n_k) fetch(kt + D);
    tf32::cp_async_commit();
    const float* as = smem + (kt % kStages) * T::kStageFloats;
    const float* bb = as + T::kAFloats;
    const float* bsm = bb + T::kBFloats;
    float a_big[kBK / 8][4], a_small[kBK / 8][4];
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      float x[4];
      tf32::ldmatrix_x4(x, as + (wrow + lane % 16) * kSA + 8 * s + (lane / 16) * 4);
      fmma::split(x, a_big[s], a_small[s]);
    }
    fence();
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {  // k columns 8s.., core-matrix columns 2s, 2s + 1
      const int off = 2 * s * (kLBO / 4);
      Mma<BN>::run(cur, a_small[s], desc(bb + off), s > 0);
      Mma<BN>::run(cur, a_big[s], desc(bsm + off), 1);
      Mma<BN>::run(cur, a_big[s], desc(bb + off), 1);
    }
    commit();
    if constexpr (kInFlight) {
      wait<1>();
      if (kt > 0) add(prev);
    } else {
      wait<0>();
      add(cur);
    }
  };
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < n_k) fetch(s);
    tf32::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; kt += 2) {  // two at a time: part's index stays static
    step(kt, part[0], part[1]);
    if (kt + 1 < n_k) step(kt + 1, part[1], part[0]);
  }
  if constexpr (kInFlight) {
    wait<0>();
    if (n_k % 2) add(part[0]);
    else add(part[1]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
    const int m = m0 + wrow + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n >= N) continue;
      const float2 bv = *reinterpret_cast<const float2*>(bias + n);
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(m) * N + n) =
          make_float2(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
    }
  }
}

// Splits w, then launches out = a w + bias on `stream`; wt is scratch of 2
// K N floats.
template <int WGS, int BN, bool kInFlight>
cudaError_t gemm(const float* a, const float* w, const float* bias, float* out, float* wt,
                 int M, int N, int K, cudaStream_t stream) {
  using T = Tiling<WGS, BN>;
  float* big = wt;
  float* small = wt + static_cast<int64_t>(N) * K;
  split_t_kernel<<<dim3((N + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, stream>>>(
      w, big, small, K, N);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<WGS, BN, kInFlight>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + T::kBM - 1) / T::kBM);
  gemm_kernel<WGS, BN, kInFlight><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      a, big, small, bias, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace wg3
