// Clean fixture for the CUDA rules: cp.async waited and followed by a
// barrier, a cluster's mbarrier initialised, fenced and cluster-synced
// before a multicast arms and waits on it, shared memory within budget
// (a 96 KB dynamic tile behind cudaFuncSetAttribute), every launch's error
// returned. Must produce no finding. Fixture only: never built.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kDyn = 96 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"((unsigned)(uintptr_t)bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"((unsigned)(uintptr_t)bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"((unsigned)(uintptr_t)bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"((unsigned)(uintptr_t)dst), "l"(src), "r"(bytes),
      "r"((unsigned)(uintptr_t)bar), "h"(mask) : "memory");
}

__global__ void __launch_bounds__(kThreads) staged_kernel(const float* x, float* y) {
  extern __shared__ __align__(16) float tile[];
  cp_async16(&tile[threadIdx.x * 4], x + threadIdx.x * 4);
  cp_async_wait_all();
  __syncthreads();
  y[threadIdx.x] = tile[(threadIdx.x + 1) % kThreads];
}

__global__ void __launch_bounds__(kThreads) multicast_kernel(const float* x, float* y) {
  __shared__ __align__(16) float xs[kThreads];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) mbar_init(&bar);
  cg::this_cluster().sync();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, kThreads * sizeof(float));
    bulk_multicast(xs, x, kThreads * sizeof(float), &bar, 3);
  }
  mbar_wait(&bar, 0);
  y[threadIdx.x] = xs[threadIdx.x];
  cg::this_cluster().sync();
}

}  // namespace

extern "C" {

int good_launch(const float* x, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(staged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDyn);
  if (err != cudaSuccess) return (int)err;
  staged_kernel<<<1, kThreads, kDyn, s>>>(x, y);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 2;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, multicast_kernel, x, y);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
