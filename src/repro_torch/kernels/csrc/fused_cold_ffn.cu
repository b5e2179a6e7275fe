// Fused cold path of the hybrid FFN for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cluster_gather_ffn.py::
// fused_cold_ffn (body _fused_kernel), fp path and quant mode. Per neuron
// group g it computes predictor scores (x.A).B_g in fp32, the masked
// batch-union max over rows, the max over each cluster's cs neurons, kc
// argmax-and-knockout picks with lowest-index ties (written as (G, kc)
// int32 ids), and for each pick act(x.Wg^T) * (x.Wu^T), CATS-gated on the
// token's own score > 0, cast to x's dtype, then .Wd summed into a (B, D)
// fp32 output.
//
// Quant mode (quantized cold storage, paper §7.6): the bundles are int8
// codes q with one fp32 scale per (neuron, row) and, for int4-mixed, an
// fp16 outlier sidecar o of the codes' shape. Each weight is dequantized
// where it is read, as the reference does before its dots:
//   w = cast_T(q * sc)          int8
//   w = cast_T(q * sc + o)      int4-mixed
// with the product and the sum each rounded to fp32 (__fmul_rn,
// __fadd_rn: nvcc would contract them into one FMA and round once). The
// selection kernels read only the predictor and do not change.
//
// What bounds it on this card: bytes. At the main path's shapes (B <= 64,
// D = 576, r = 64, cs = 64, R = 3, kc = 1, bf16) one call reads ~0.5 MB
// (predictor 262 KB + one 221 KB bundle; int8 codes 111 KB, int4-mixed
// codes + sidecar 332 KB) and does ~20 MFLOP at B = 64, far under the
// 295 FLOP/byte ridge; at B = 1 launch latency dominates.
//
// Design. The TPU grid (groups,) runs in order on one core, and
// single-device plans have G = 1, so one block per group would put the
// whole cold path on one SM. Here the call is five short kernels on the
// caller's stream, each spread over many blocks:
//   1. hidden   h = x.A                     grid (B)
//   2. score    scores = h.Bp, plus the     grid (clusters, row chunks)
//               masked max of each (row chunk, cluster) tile
//   3. select   cluster max over row chunks grid (G)
//               and kc ordered picks
//   4. gate_up  H = cast(act(x.Wg)*(x.Wu)   grid (G*kc picks, neuron tiles)
//               * cats)                     one warp per neuron
//   5. down     y = H.Wd                    grid (D / 32 column tiles)
// No bundle is staged whole in shared memory (one bf16 bundle at cs = 64,
// D = 576 is 221 KB, two would exceed the 227 KB a block may hold): each
// warp streams its neuron's rows from global memory. Every sum runs in a
// fixed order (sequential loops and a fixed shuffle tree, no atomics), so
// runs repeat bit for bit. Scratch (h, scores, tile maxima, H) is
// allocated by the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kScoreRows = 8;   // rows of x per score block
constexpr int kGateWarps = 4;   // neurons per gate_up block
constexpr int kDownCols = 32;   // output columns per down block
constexpr int kDownRowGroups = 8;
constexpr int kMaxBatch = 64;   // kDownRowGroups * register accumulators
constexpr int kSelectThreads = 256;

enum { ACT_SILU = 0, ACT_RELU2 = 1, ACT_GELU_TANH = 2 };
enum { W_FP = 0, W_INT8 = 1, W_MIXED = 2 };  // weight modes

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

// The bundles a call reads: fp weights w (W_FP), or int8 codes q with
// per-(neuron, row) scales sc and, for W_MIXED, the fp16 outliers o.
template <typename T>
struct Bundles {
  const T* w;
  const int8_t* q;
  const float* sc;
  const __half* o;
};

// Weight (row, r, d) of the (N, R, D) bundles as the dots read it: the fp
// value, or the dequantized one cast to T, exactly as the reference's
// f32 multiply, f32 add and cast to x.dtype.
template <typename T, int MODE>
__device__ __forceinline__ float load_w(const Bundles<T>& b, size_t row_r, int D,
                                        int d) {
  const size_t i = row_r * D + d;
  if constexpr (MODE == W_FP) {
    return to_f(b.w[i]);
  } else {
    float v = __fmul_rn(static_cast<float>(b.q[i]), b.sc[row_r]);
    if constexpr (MODE == W_MIXED) v = __fadd_rn(v, __half2float(b.o[i]));
    return to_f(from_f<T>(v));
  }
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

// 1. h[b, j] = sum_d x[b, d] * A[d, j], fp32, d in order.
template <typename T>
__global__ void hidden_kernel(const T* __restrict__ x, const T* __restrict__ A,
                              float* __restrict__ h, int D, int r) {
  const int b = blockIdx.x;
  const T* xb = x + (size_t)b * D;
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    float acc = 0.0f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(to_f(xb[d]), to_f(A[(size_t)d * r + j]), acc);
    h[(size_t)b * r + j] = acc;
  }
}

// 2. One block per (cluster, chunk of kScoreRows rows), one thread per
// column of the cluster: scores[b, n] = sum_j h[b, j] * Bp[j, n], then the
// max over the tile's live rows and columns. A masked row counts as
// -FLT_MAX (finfo(f32).min), so an all-masked tile yields -FLT_MAX.
template <typename T>
__global__ void score_kernel(const float* __restrict__ h, const T* __restrict__ Bp,
                             int ldb, const float* __restrict__ mask,
                             float* __restrict__ scores, float* __restrict__ tile_max,
                             int B, int r, int Nc, int cs, int n_clusters) {
  extern __shared__ float smem[];
  float* hs = smem;                    // kScoreRows * r
  float* warp_max = smem + kScoreRows * r;  // blockDim.x / 32
  const int c = blockIdx.x;
  const int b0 = blockIdx.y * kScoreRows;
  const int nrows = min(kScoreRows, B - b0);
  for (int i = threadIdx.x; i < nrows * r; i += blockDim.x)
    hs[i] = h[(size_t)b0 * r + i];
  __syncthreads();

  float best = -INFINITY;              // identity for threads past cs
  if (threadIdx.x < cs) {
    const int n = c * cs + threadIdx.x;
    float acc[kScoreRows];
#pragma unroll
    for (int q = 0; q < kScoreRows; ++q) acc[q] = 0.0f;
    for (int j = 0; j < r; ++j) {
      const float bv = to_f(Bp[(size_t)j * ldb + n]);
#pragma unroll
      for (int q = 0; q < kScoreRows; ++q)
        if (q < nrows) acc[q] = fmaf(hs[q * r + j], bv, acc[q]);
    }
    best = -FLT_MAX;
#pragma unroll
    for (int q = 0; q < kScoreRows; ++q) {
      if (q < nrows) {
        scores[(size_t)(b0 + q) * Nc + n] = acc[q];
        if (mask[b0 + q] > 0.0f) best = fmaxf(best, acc[q]);
      }
    }
  }
  // max is exact, so the reduction order does not matter
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_down_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, warp_max[w]);
    tile_max[(size_t)blockIdx.y * n_clusters + c] = m;
  }
}

// Lexicographic max on (value, -index): the larger value wins, equal values
// go to the lower index. A total order, so any reduction tree agrees.
__device__ __forceinline__ void argmax_combine(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

// 3. One block per group: cluster scores = max over row chunks, then kc
// picks, each the first maximum, knocked down to -inf once taken. The
// masked value -FLT_MAX sits above -inf, so an all-masked batch picks
// [0, kc) as jax.lax.top_k does.
__global__ void select_kernel(const float* __restrict__ tile_max, int* __restrict__ idx,
                              int n_chunks, int n_clusters, int nc_g, int kc) {
  extern __shared__ float cscore[];    // nc_g
  __shared__ float wv[kSelectThreads / 32];
  __shared__ int wi[kSelectThreads / 32];
  const int g = blockIdx.x;
  for (int c = threadIdx.x; c < nc_g; c += blockDim.x) {
    float m = tile_max[g * nc_g + c];
    for (int q = 1; q < n_chunks; ++q)
      m = fmaxf(m, tile_max[(size_t)q * n_clusters + g * nc_g + c]);
    cscore[c] = m;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < kc; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < nc_g; c += blockDim.x)
      argmax_combine(bv, bi, cscore[c], c);
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      argmax_combine(bv, bi, ov, oi);
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) argmax_combine(bv, bi, wv[w], wi[w]);
      idx[g * kc + k] = bi;
      cscore[bi] = -INFINITY;
    }
    __syncthreads();
  }
}

// 4. One warp per neuron of a picked cluster: gate (and up) dots over D for
// every row, lanes strided over D and summed by a fixed shuffle tree.
// H[b, pick * cs + i] = cast_T(act(g) * u * (score > 0 under CATS)).
template <typename T, int MODE>
__global__ void gate_up_kernel(const T* __restrict__ x, const Bundles<T> w,
                               const int* __restrict__ idx,
                               const float* __restrict__ scores, T* __restrict__ H,
                               int B, int D, int R, int nc_g, int cs, int kc, int Nc,
                               int K, int act, int cats) {
  const int pick = blockIdx.x;         // g * kc + k
  const int i = blockIdx.y * kGateWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= cs) return;
  const int g = pick / kc;
  const int col = (g * nc_g + idx[pick]) * cs + i;  // cold neuron = score column
  const size_t rg = (size_t)col * R;   // (neuron, row) of the gate row
  const bool gated = R == 3;
  for (int b = 0; b < B; ++b) {
    const T* xb = x + (size_t)b * D;
    float ag = 0.0f, au = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float xv = to_f(xb[d]);
      ag = fmaf(xv, load_w<T, MODE>(w, rg, D, d), ag);
      if (gated) au = fmaf(xv, load_w<T, MODE>(w, rg + 1, D, d), au);
    }
    for (int off = 16; off > 0; off >>= 1) {
      ag += __shfl_down_sync(0xffffffffu, ag, off);
      au += __shfl_down_sync(0xffffffffu, au, off);
    }
    if (lane == 0) {
      float hv = activate(ag, act);
      if (gated) hv *= au;
      if (cats) hv *= scores[(size_t)b * Nc + col] > 0.0f ? 1.0f : 0.0f;
      H[(size_t)b * K + pick * cs + i] = from_f<T>(hv);
    }
  }
}

// 5. y[b, d] = sum_n H[b, n] * Wd[row(n), d] over the K = G*kc*cs picked
// neurons in order; a block owns kDownCols columns and every row, so each
// output is written once and no partial sums cross blocks.
template <typename T, int MODE>
__global__ void down_kernel(const T* __restrict__ H, const Bundles<T> w,
                            const int* __restrict__ idx, float* __restrict__ y,
                            int B, int D, int R, int nc_g, int cs, int kc, int K) {
  const int d = blockIdx.x * kDownCols + threadIdx.x;
  if (d >= D) return;
  const int ty = threadIdx.y;
  float acc[kMaxBatch / kDownRowGroups];
#pragma unroll
  for (int q = 0; q < kMaxBatch / kDownRowGroups; ++q) acc[q] = 0.0f;
  for (int n = 0; n < K; ++n) {
    const int pick = n / cs;
    const int i = n - pick * cs;
    const int row = ((pick / kc) * nc_g + idx[pick]) * cs + i;
    const float wv = load_w<T, MODE>(w, (size_t)row * R + (R - 1), D, d);
#pragma unroll
    for (int q = 0; q < kMaxBatch / kDownRowGroups; ++q) {
      const int b = ty + q * kDownRowGroups;
      if (b < B) acc[q] = fmaf(to_f(H[(size_t)b * K + n]), wv, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxBatch / kDownRowGroups; ++q) {
    const int b = ty + q * kDownRowGroups;
    if (b < B) y[(size_t)b * D + d] = acc[q];
  }
}

template <typename T, int MODE>
int launch(const void* x, const Bundles<T>& wt, const void* A, const void* Bp, int ldb,
           const float* mask, float* y, int* idx, float* h, float* scores,
           float* tile_max, void* H, int B, int D, int r, int G, int nc_g, int cs,
           int R, int kc, int act, int cats, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int n_clusters = G * nc_g;
  const int Nc = n_clusters * cs;
  const int K = G * kc * cs;
  const int n_chunks = (B + kScoreRows - 1) / kScoreRows;
  cudaError_t err;

  hidden_kernel<T><<<B, 64, 0, stream>>>(xt, static_cast<const T*>(A), h, D, r);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int score_threads = (cs + 31) / 32 * 32;
  const size_t score_smem = (kScoreRows * r + score_threads / 32) * sizeof(float);
  score_kernel<T><<<dim3(n_clusters, n_chunks), score_threads, score_smem, stream>>>(
      h, static_cast<const T*>(Bp), ldb, mask, scores, tile_max, B, r, Nc, cs, n_clusters);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  select_kernel<<<G, kSelectThreads, nc_g * sizeof(float), stream>>>(
      tile_max, idx, n_chunks, n_clusters, nc_g, kc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  gate_up_kernel<T, MODE><<<dim3(G * kc, (cs + kGateWarps - 1) / kGateWarps), 32 * kGateWarps, 0,
                      stream>>>(xt, wt, idx, scores, static_cast<T*>(H), B, D, R, nc_g, cs,
                                kc, Nc, K, act, cats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  down_kernel<T, MODE><<<(D + kDownCols - 1) / kDownCols, dim3(kDownCols, kDownRowGroups), 0,
                   stream>>>(static_cast<const T*>(H), wt, idx, y, B, D, R, nc_g, cs, kc, K);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* wq, const void* wsc,
             const void* wout, const void* A, const void* Bp, int ldb,
             const float* mask, float* y, int* idx, float* h, float* scores,
             float* tile_max, void* H, int B, int D, int r, int G, int nc_g, int cs,
             int R, int kc, int act, int cats, int wmode, cudaStream_t s) {
  const Bundles<T> b{static_cast<const T*>(w), static_cast<const int8_t*>(wq),
                     static_cast<const float*>(wsc), static_cast<const __half*>(wout)};
  if (wmode == W_INT8)
    return launch<T, W_INT8>(x, b, A, Bp, ldb, mask, y, idx, h, scores, tile_max, H, B,
                             D, r, G, nc_g, cs, R, kc, act, cats, s);
  if (wmode == W_MIXED)
    return launch<T, W_MIXED>(x, b, A, Bp, ldb, mask, y, idx, h, scores, tile_max, H, B,
                              D, r, G, nc_g, cs, R, kc, act, cats, s);
  return launch<T, W_FP>(x, b, A, Bp, ldb, mask, y, idx, h, scores, tile_max, H, B, D,
                         r, G, nc_g, cs, R, kc, act, cats, s);
}

}  // namespace

extern "C" {

// Launches the fused cold path on `stream`; returns the first nonzero
// cudaError_t of the five launches, or 0. The caller checks the shapes
// (B <= 64, cs <= 1024, r <= 1024, nc_g <= 12288), the dtypes and the
// contiguity, and allocates every output and scratch buffer:
//   y (B, D) f32, idx (G, kc) i32, h (B, r) f32, scores (B, G*nc_g*cs) f32,
//   tile_max (ceil(B/8), G*nc_g) f32, H (B, G*kc*cs) in x's dtype.
// x (B, D), w (G*nc_g*cs, R, D), A (D, r) and Bp (r, >= G*nc_g*cs, row
// stride ldb) share one dtype: is_bf16 = 1 for bfloat16, 0 for float32.
// wmode 0 reads w; 1 reads int8 codes wq (w's shape) and fp32 scales wsc
// (G*nc_g*cs, R) instead; 2 also adds the fp16 outliers wout (w's shape).
// Pointers a mode does not read may be null.
int fused_cold_ffn_launch(const void* x, const void* w, const void* wq,
                          const void* wsc, const void* wout, const void* A,
                          const void* Bp, int ldb, const float* mask, float* y, int* idx,
                          float* h, float* scores, float* tile_max, void* H, int B,
                          int D, int r, int G, int nc_g, int cs, int R, int kc, int act,
                          int cats, int is_bf16, int wmode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, w, wq, wsc, wout, A, Bp, ldb, mask, y, idx, h,
                                   scores, tile_max, H, B, D, r, G, nc_g, cs, R, kc, act,
                                   cats, wmode, s);
  return dispatch<float>(x, w, wq, wsc, wout, A, Bp, ldb, mask, y, idx, h, scores,
                         tile_max, H, B, D, r, G, nc_g, cs, R, kc, act, cats, wmode, s);
}

const char* fused_cold_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
