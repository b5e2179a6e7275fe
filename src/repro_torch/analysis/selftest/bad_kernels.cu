// Seeded violations of the CUDA rules: async-copy-pairing (a cp.async
// never waited for; an mbarrier armed with expect_tx that nothing waits
// on), mbarrier-init (a barrier used before its init), smem-budget (a
// static tile past 227 KB; a 64 KB dynamic launch without the attribute),
// launch-check (a launch whose error is never read, one whose error is
// read but not returned), shadow-hooks (a helper that issues cp.async with no
// shadow hook, raw __syncthreads in kernel bodies, kernels without
// SHADOW_BEGIN / SHADOW_END). Fixture only: never built.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 256;
constexpr int kCols = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"((unsigned)(uintptr_t)bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"((unsigned)(uintptr_t)bar), "r"(bytes) : "memory");
}

__global__ void never_waited_kernel(const float* x, float* y) {
  __shared__ __align__(16) float tile[kRows * 4];
  cp_async16(&tile[threadIdx.x * 4], x + threadIdx.x * 4);   // never waited
  __syncthreads();
  y[threadIdx.x] = tile[threadIdx.x];
}

__global__ void armed_never_waited_kernel(float* y) {
  __shared__ __align__(8) uint64_t bar;
  mbar_expect_tx(&bar, 16);          // before the init, and never waited on
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  y[threadIdx.x] = 0.0f;
}

__global__ void huge_tile_kernel(float* y) {
  __shared__ float big[kRows * kCols];    // 256 KB of static shared memory
  big[threadIdx.x] = 1.0f;
  __syncthreads();
  y[threadIdx.x] = big[(threadIdx.x + 1) % kRows];
}

__global__ void dynamic_kernel(float* y) {
  extern __shared__ __align__(16) float dyn[];
  dyn[threadIdx.x] = 1.0f;
  __syncthreads();
  y[threadIdx.x] = dyn[(threadIdx.x + 1) % kRows];
}

}  // namespace

extern "C" {

int bad_launch(const float* x, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  never_waited_kernel<<<1, kRows, 0, s>>>(x, y);       // error never read
  armed_never_waited_kernel<<<1, kRows, 0, s>>>(y);
  if (cudaGetLastError() != cudaSuccess) return 1;
  huge_tile_kernel<<<1, kRows, 0, s>>>(y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dynamic_kernel<<<1, kRows, 64 * 1024, s>>>(y);      // no attribute set
  return (int)cudaGetLastError();
}

}  // extern "C"
