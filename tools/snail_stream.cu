// Copy-only and barrier-only kernels that measure what a PixelSNAIL
// sampler design can stream and synchronise on an H100 (built and run by
// tools/torch_sampler_times.py --stream; not part of the port).
//
// ring_kernel: every CTA (rank r of a cluster of R) copies its share,
// floats / R, of a weight buffer from device memory (L2-resident after the
// first pass) into a ring of 4 shared-memory stages with 16-byte cp.async,
// `passes` times over, each thread issuing its 16-byte pieces of a stage
// and every stage released behind a CTA barrier, as a weight ring would be
// (3 stages in flight).
// barrier_kernel: `iters` cluster barriers (mode 0), each behind a store of
// 8 floats into every rank's shared memory (mode 1), or CTA barriers
// (mode 2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ void issue(float* ring, const float* src, long long share, int stage, int depth,
                      long long u) {
  const long long chunks = (share + stage - 1) / stage;
  const long long c = u % chunks;
  const long long lo = c * stage;
  const int n = static_cast<int>(min(static_cast<long long>(stage), share - lo));
  float* dst = ring + (u % depth) * stage;
  for (int q = threadIdx.x * 4; q < n; q += kThreads * 4) cp_async16(dst + q, src + lo + q);
  commit();
}

// The ring as a sampler would run it: stage u lands while depth - 2 later
// stages are still in flight.
template <int kDepth>
__global__ void __launch_bounds__(kThreads, 1)
ring_kernel(const float* __restrict__ src, long long floats, int passes, int stage, float* sink) {
  extern __shared__ __align__(16) float ring[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long share = floats / R / 4 * 4;
  const float* mine = src + rank * share;
  const long long chunks = (share + stage - 1) / stage, total = chunks * passes;
  float acc = 0.f;
  for (long long u = 0; u < kDepth - 1; ++u) {
    if (u < total) issue(ring, mine, share, stage, kDepth, u);
    else commit();
  }
  for (long long u = 0; u < total; ++u) {
    wait_group<kDepth - 2>();
    __syncthreads();  // stage u landed for every thread; stage u - 1 is free
    if (u + kDepth - 1 < total) issue(ring, mine, share, stage, kDepth, u + kDepth - 1);
    else commit();
    acc += ring[(u % kDepth) * stage + threadIdx.x];
  }
  wait_group<0>();
  if (acc == 12345.f) sink[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int iters, int mode, float* sink) {
  __shared__ float box[8 * 16];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (mode == 1 && threadIdx.x < 8 * R) {
      const int r = threadIdx.x / 8;
      *cluster.map_shared_rank(box + rank * 8 + threadIdx.x % 8, r) = static_cast<float>(it);
    }
    if (mode == 2) {
      __syncthreads();
    } else {
      cluster.sync();
    }
    acc += box[threadIdx.x % (8 * R)];
  }
  if (acc == 12345.f) sink[blockIdx.x] = acc;
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int ctas, int cluster, int smem,
            cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ctas, 1, 1);
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

// ctas CTAs in clusters of `cluster`, each rank streaming its share of
// `floats` floats `passes` times through a ring of 4 stages of `stage`
// floats.
extern "C" int stream_copy(const float* src, long long floats, int ctas, int cluster, int passes,
                           int stage, float* sink, void* stream) {
  const int smem = 4 * 4 * stage;
  auto k = ring_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, ctas, cluster, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, k, src, floats, passes, stage, sink);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" int barrier_loop(int ctas, int cluster, int iters, int mode, float* sink,
                            void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, ctas, cluster, 0, static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaLaunchKernelEx(&cfg, barrier_kernel, iters, mode, sink);
  return err != cudaSuccess ? err : cudaGetLastError();
}
