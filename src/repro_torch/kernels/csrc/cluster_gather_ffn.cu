// Gathered bundled FFN for Hopper (sm_90a): the port's cluster_gather_ffn
// and dense_ffn.
//
// Replaces the Pallas TPU kernels src/repro/kernels/cluster_gather_ffn.py::
// cluster_gather_ffn (body _kernel, a scalar-prefetched gather over
// caller-given cluster ids) and src/repro/kernels/dense_ffn.py::dense_ffn
// (the same body with an identity index). Over the K selected neurons
// (K = n_ids * cs clusters of cs consecutive rows, or all N rows in order
// when idx is null) of the bundled (N, R, D) weights it computes
//   y = cast_T( sum_n cast_T(act(x.Wg_n) * (x.Wu_n)) * Wd_n )
// with the gate/up dots and the down sum in fp32 (up only for R = 3; for
// R = 2 the hidden value is act(x.Wg_n)), as the reference does.
//
// What bounds it on this card: bytes at decode sizes. At D = 576, N = 1536,
// R = 3, bf16 the weights are 5.3 MB against ~2 * 3 * B * N * D operations,
// under the 295 FLOP/byte ridge for every B below ~300.
//
// Design. The TPU grid walks clusters in order and accumulates into one
// (B, D) block; here nothing carries over between blocks, so the call is
// two kernels on the caller's stream:
//   1. gate_up  H[b, n] = cast_T(act(x_b.Wg_n) * (x_b.Wu_n))
//               grid (K / 4 neuron tiles, B / 16 row tiles), one warp per
//               neuron, lanes strided over D, a fixed shuffle tree
//   2. down     y[b, d] = sum_n H[b, n] * Wd_n[d]
//               grid (D / 32 column tiles, B / 8 row tiles), block (32, 8):
//               thread (c, s) sums the neurons n = s mod 8 of its column for
//               8 rows, then slice 0 adds the 8 partial sums in order
// Any B and any N: rows and neurons are tiled and the edges masked, and no
// dimension has to divide a block size. Every sum runs in a fixed order and
// there are no atomics, so runs repeat bit for bit. H is scratch allocated
// by the caller. A simple kernel first: no tensor cores, no staging.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kGateWarps = 4;    // neurons per gate_up block
constexpr int kGateRows = 16;    // rows of x per gate_up block
constexpr int kDownCols = 32;    // output columns per down block
constexpr int kDownSlices = 8;   // neuron slices per down block
constexpr int kDownRows = 8;     // rows of x per down block

enum { ACT_SILU = 0, ACT_RELU2 = 1, ACT_GELU_TANH = 2 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == ACT_SILU) return g * (1.0f / (1.0f + expf(-g)));
  if (act == ACT_RELU2) {
    float r = fmaxf(g, 0.0f);
    return r * r;
  }
  // gelu / geglu use the tanh approximation (jax.nn.gelu(approximate=True))
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

// Bundle row of selected neuron n: cluster idx[n / cs], offset n % cs; or n.
__device__ __forceinline__ int neuron_row(const int* idx, int n, int cs) {
  return idx ? idx[n / cs] * cs + n % cs : n;
}

// 1. One warp per selected neuron, kGateRows rows of x per block.
template <typename T>
__global__ void gate_up_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               const int* __restrict__ idx, T* __restrict__ H, int B,
                               int D, int R, int K, int cs, int act) {
  const int n = blockIdx.x * kGateWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= K) return;
  const T* wg = w + (size_t)neuron_row(idx, n, cs) * R * D;
  const T* wu = wg + D;
  const bool gated = R == 3;
  const int b0 = blockIdx.y * kGateRows;
  const int b1 = min(B, b0 + kGateRows);
  for (int b = b0; b < b1; ++b) {
    const T* xb = x + (size_t)b * D;
    float ag = 0.0f, au = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float xv = to_f(xb[d]);
      ag = fmaf(xv, to_f(wg[d]), ag);
      if (gated) au = fmaf(xv, to_f(wu[d]), au);
    }
    for (int off = 16; off > 0; off >>= 1) {
      ag += __shfl_down_sync(0xffffffffu, ag, off);
      au += __shfl_down_sync(0xffffffffu, au, off);
    }
    if (lane == 0) {
      float hv = activate(ag, act);
      if (gated) hv *= au;
      H[(size_t)b * K + n] = from_f<T>(hv);
    }
  }
}

// 2. Block (kDownCols, kDownSlices) over kDownCols columns and kDownRows
// rows; slice s sums neurons s, s + 8, ... in order, then slice 0 adds the
// slices' partial sums in order 0..7 and casts to T.
template <typename T>
__global__ void down_kernel(const T* __restrict__ H, const T* __restrict__ w,
                            const int* __restrict__ idx, T* __restrict__ y, int B,
                            int D, int R, int K, int cs) {
  __shared__ float part[kDownSlices][kDownRows][kDownCols];
  const int c = threadIdx.x, s = threadIdx.y;
  const int d = blockIdx.x * kDownCols + c;
  const int b0 = blockIdx.y * kDownRows;
  const int nrows = min(kDownRows, B - b0);
  float acc[kDownRows];
#pragma unroll
  for (int q = 0; q < kDownRows; ++q) acc[q] = 0.0f;
  if (d < D) {
    for (int n = s; n < K; n += kDownSlices) {
      const size_t row = (size_t)neuron_row(idx, n, cs);
      const float wv = to_f(w[(row * R + (R - 1)) * D + d]);
#pragma unroll
      for (int q = 0; q < kDownRows; ++q)
        if (q < nrows) acc[q] = fmaf(to_f(H[(size_t)(b0 + q) * K + n]), wv, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kDownRows; ++q) part[s][q][c] = acc[q];
  __syncthreads();
  if (s == 0 && d < D) {
    for (int q = 0; q < nrows; ++q) {
      float v = part[0][q][c];
      for (int t = 1; t < kDownSlices; ++t) v += part[t][q][c];
      y[(size_t)(b0 + q) * D + d] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* idx, void* H, void* y, int B, int D,
           int R, int K, int cs, int act, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* Ht = static_cast<T*>(H);
  gate_up_kernel<T><<<dim3((K + kGateWarps - 1) / kGateWarps,
                           (B + kGateRows - 1) / kGateRows),
                      32 * kGateWarps, 0, stream>>>(xt, wt, idx, Ht, B, D, R, K, cs, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_kernel<T><<<dim3((D + kDownCols - 1) / kDownCols, (B + kDownRows - 1) / kDownRows),
                   dim3(kDownCols, kDownSlices), 0, stream>>>(
      Ht, wt, idx, static_cast<T*>(y), B, D, R, K, cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the gathered bundled FFN on `stream`; returns the first nonzero
// cudaError_t of the two launches, or 0. x (B, D) and w (N, R, D) share
// one dtype (is_bf16 = 1 for bfloat16, 0 for float32). idx holds the
// K / cs cluster ids (each in [0, N / cs)), or is null for all K = N rows
// in order (cs is then unused). The caller checks shapes, dtypes and
// contiguity and allocates H (B, K) and y (B, D) in x's dtype.
int cluster_gather_ffn_launch(const void* x, const void* w, const int* idx, void* H,
                              void* y, int B, int D, int R, int K, int cs, int act,
                              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, idx, H, y, B, D, R, K, cs, act, s);
  return launch<float>(x, w, idx, H, y, B, D, R, K, cs, act, s);
}

const char* cluster_gather_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
