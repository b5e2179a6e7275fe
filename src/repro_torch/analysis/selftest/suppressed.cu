// Clean fixture: a real violation carrying an inline ignore, which proves
// `// repro: ignore[rule]` suppression in CUDA sources end to end.
#include <cuda_runtime.h>

#include "shadow.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  SHADOW_CP_ASYNC(smem, 16);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  SHADOW_CP_WAIT();
}

__device__ __forceinline__ void block_sync() {
  __syncthreads();
  SHADOW_SYNC();
}

__global__ void own_copies_kernel(const float* x, float* y) {
  __shared__ __align__(16) float tile[512];
  SHADOW_BEGIN(0);
  cp_async16(&tile[threadIdx.x * 4], x);
  cp_async_wait_all();
  // each thread reads back only the four floats it copied itself
  y[threadIdx.x] = SH_RD(&tile[threadIdx.x * 4]);  // repro: ignore[async-copy-pairing]
  block_sync();
  SHADOW_END();
}

}  // namespace

extern "C" int own_launch(const float* x, float* y, void* stream) {
  own_copies_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(x, y);
  return (int)cudaGetLastError();
}
