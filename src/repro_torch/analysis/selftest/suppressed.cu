// Clean fixture: a real violation carrying an inline ignore, which proves
// `// repro: ignore[rule]` suppression in CUDA sources end to end.
#include <cuda_runtime.h>

namespace {

__global__ void own_copies_kernel(const float* x, float* y) {
  __shared__ __align__(16) float tile[512];
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(&tile[threadIdx.x * 4]));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(x) : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // each thread reads back only the four floats it copied itself
  y[threadIdx.x] = tile[threadIdx.x * 4];  // repro: ignore[async-copy-pairing]
  __syncthreads();
}

}  // namespace

extern "C" int own_launch(const float* x, float* y, void* stream) {
  own_copies_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(x, y);
  return (int)cudaGetLastError();
}
