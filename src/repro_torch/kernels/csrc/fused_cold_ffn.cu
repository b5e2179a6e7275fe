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
// __fadd_rn: nvcc would contract them into one FMA and round once):
// gate_up and down read a run of 16 bytes of T through load_w_vec, which
// dequantizes element by element with those roundings. The score kernels
// and the selection read only the predictor and do not change.
//
// What bounds it on this card. By bytes, little: at the main path's
// shapes (D = 576, r = 64, cs = 64, 23 cold clusters, R = 3, kc = 1,
// bf16) one call reads ~0.5 MB (predictor 262 KB + one 221 KB bundle;
// int8 codes 111 KB, int4-mixed codes + sidecar 332 KB), 0.15 us at the
// card's memory rate, and does ~0.5 MFLOP per row of x, far under the
// 295 FLOP/byte ridge. What costs time is latency: how many global loads a
// thread waits for one after the other, and the launches. So no thread
// walks a long chain of dependent global loads: each block issues the
// loads it needs together (16-byte cp.async into shared memory, or
// 16-byte register loads), then computes from shared memory and
// registers. Tensor cores would be padding at decode batch and are not
// used.
//
// Design. The TPU grid (groups,) runs in order on one core, and
// single-device plans have G = 1, so one block per group would put the
// whole cold path on one SM. Here the call is four short kernels on the
// caller's stream, each spread over many blocks:
//   1. hidden   h partials, one per 64 rows  grid (D / 64, r / 64, B / 16)
//               of A: A's slice and x's
//               matching columns staged
//   2. score    h = sum of the partials,     grid (clusters, B / 8)
//               scores = h.Bp from a staged
//               Bp tile (r split over the
//               threads cs leaves over),
//               masked tile maxima
//   3. gate_up  each block selects its pick  grid (G*kc picks, cs neurons,
//               (cluster max over row        B / 4), one neuron a block,
//               chunks, k + 1 ordered        D split over its 4 warps
//               passes) while x's rows are
//               staged, then H = cast(act(
//               x.Wg)*(x.Wu)*cats) from
//               register weight rows
//   4. down     y = H.Wd: H and the picked   grid (D / 64, B / 4)
//               rows' offsets staged, each
//               thread 16 bytes of columns,
//               neurons split over slices
// The selection is repeated by every gate_up block, in registers and
// shared memory only: no atomics, no counter and no state across calls,
// so a CUDA graph replays a call unchanged. Any B: rows are tiled over
// the grid (row tiles past 65535 loop inside the block). Any D, row
// stride or pointer: a vector run that is not 16-byte aligned, or runs
// past the row's end, is loaded one element at a time inside the kernel.
// No bundle is staged whole in shared memory (one bf16 bundle is 221 KB at
// the main shapes). Every sum runs in a fixed order (sequential loops,
// then the D splits, score's thread groups or down's neuron slices added
// in order, a fixed shuffle tree; no atomics), so runs repeat bit for
// bit. Scratch (h partials, scores, tile maxima, H) is allocated by the
// caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <cstring>
#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;   // threads of a hidden, score or down block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;  // row tiles beyond it loop inside the block
constexpr int kHidD = 64;       // rows of A per hidden block: the D split
constexpr int kHidCols = 64;    // columns of A per hidden block
constexpr int kHidRows = 16;    // rows of x per hidden block
constexpr int kScoreRows = 8;   // rows of x per score block
constexpr int kScoreCols = 4;   // columns per score thread: cs <= 4 * kThreads
constexpr int kScoreStage = 12288;  // bytes of Bp a score block stages at once
constexpr int kGateThreads = 128;  // threads of a gate_up block: one neuron, D split
constexpr int kGateWarps = kGateThreads / 32;
constexpr int kGateRows = 4;    // rows of x per gate_up block
constexpr int kDownRows = 4;    // rows of H per down block
constexpr int kDownCols = 64;   // output columns per down block
constexpr int kDownChunk = 256; // neurons whose H columns a down block stages at once
constexpr int kDownGroup = 8;   // neurons whose weights a thread loads before it multiplies

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

// 16-byte copy from global to shared memory that completes asynchronously:
// a thread may issue many before it waits for any (cp_async_wait_all).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies a rows x cols tile of a row-major array (row stride ld elements)
// into shared memory (row stride ldd), with all the block's threads: each
// row's 16-byte-aligned middle in 16-byte cp.async copies (register
// loads where the shared row is not aligned like the source), its ragged
// head and tail in scalar loads. Every load of the tile is in flight
// before any is waited for; the caller waits (cp_async_wait_all) and
// synchronizes the block before it reads the tile.
template <typename T>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst, int ldd,
                                           const T* __restrict__ src, size_t ld, int rows,
                                           int cols) {
  constexpr int V = 16 / sizeof(T);
  const int slots = cols / V + 2;      // head, at most cols / V vectors, tail
  for (int u = threadIdx.x; u < rows * slots; u += blockDim.x) {
    const int i = u / slots, s = u - i * slots;
    const T* p = src + (size_t)i * ld;
    T* q = dst + (size_t)i * ldd;
    const int head = min(cols, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                                     sizeof(T)));
    const int nv = (cols - head) / V;
    if (s == 0) {
      for (int e = 0; e < head; ++e) q[e] = p[e];
    } else if (s <= nv) {
      const int e = head + (s - 1) * V;
      if ((reinterpret_cast<uintptr_t>(q + e) & 15) == 0) {
        cp_async16(q + e, p + e);
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(p + e);
        T t[V];
        memcpy(t, &v, sizeof(v));
#pragma unroll
        for (int k = 0; k < V; ++k) q[e + k] = t[k];
      }
    } else if (s == nv + 1) {
      for (int e = head + nv * V; e < cols; ++e) q[e] = p[e];
    }
  }
}

// 1. Block (s, jt, z) stages rows [64 s, 64 s + 64) x columns [64 jt,
// 64 jt + 64) of A and the matching columns of 16 rows of x in shared
// memory, then writes the partial products
//   part[s, b, j] = sum_{d in split s} x[b, d] * A[d, j]   (fp32, d in order)
// Thread (j, g) owns column j for every fourth row of the tile: at most 64
// sequential FMAs a row, all from shared memory. score_kernel adds the
// D / 64 partials of each h[b, j] in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hidden_kernel(const T* __restrict__ x, const T* __restrict__ A, float* __restrict__ part,
              int B, int D, int r) {
  __shared__ __align__(16) T As[kHidD * kHidCols];
  __shared__ __align__(16) T xs[kHidRows * kHidD];
  const int s = blockIdx.x;
  const int d0 = s * kHidD, dl = min(kHidD, D - d0);
  const int j0 = blockIdx.y * kHidCols, jl = min(kHidCols, r - j0);
  const int j = threadIdx.x % kHidCols, g = threadIdx.x / kHidCols;
  stage_tile(As, kHidCols, A + (size_t)d0 * r + j0, (size_t)r, dl, jl);
  for (int b0 = blockIdx.z * kHidRows; b0 < B; b0 += gridDim.z * kHidRows) {
    const int bl = min(kHidRows, B - b0);
    stage_tile(xs, kHidD, x + (size_t)b0 * D + d0, (size_t)D, bl, dl);
    cp_async_wait_all();
    __syncthreads();
    if (j < jl) {
      for (int q = g; q < bl; q += kThreads / kHidCols) {
        const T* xq = xs + q * kHidD;
        float acc = 0.0f;
        for (int d = 0; d < dl; ++d) acc = fmaf(to_f(xq[d]), to_f(As[d * kHidCols + j]), acc);
        part[((size_t)s * B + b0 + q) * r + j0 + j] = acc;
      }
    }
    __syncthreads();
  }
}

// 2. Block (c, chunk) owns cluster c's cs columns and kScoreRows rows.
// It stages Bp's (r, cs) tile in shared memory (stage_rows rows of it at
// a time) and, while the first stage is in flight, adds the hidden
// kernel's D / 64 partials of each h[b, j] in split order into shared
// memory. Thread t owns column t mod cs (and t + 256, ... when cs > 256)
// for every row; where cs leaves threads over, the n_jg = 256 / cs
// thread groups split r, group g taking j = g, g + n_jg, ... in order,
// and group 0 adds the groups' sums in group order:
//   scores[b, n] = sum_j h[b, j] * Bp[j, n]
// Then the max over the tile's live rows and columns: a masked row counts
// as -FLT_MAX (finfo(f32).min), so an all-masked tile yields -FLT_MAX.
// Chunks past the grid loop inside the block.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)  // registers for acc, not occupancy
score_kernel(const float* __restrict__ part, int n_split, const T* __restrict__ Bp, int ldb,
             const float* __restrict__ mask, float* __restrict__ scores,
             float* __restrict__ tile_max, int B, int r, int Nc, int cs, int n_clusters,
             int stage_rows) {
  extern __shared__ __align__(16) float score_smem[];
  float* hs = score_smem;                           // kScoreRows * r
  float* warp_max = hs + kScoreRows * r;            // kWarps
  T* Bs = reinterpret_cast<T*>(warp_max + kWarps);  // stage_rows * cs
  float* gsum = warp_max + kWarps;  // after the last stage: (n_jg - 1, kScoreRows, cs)
  const int c = blockIdx.x;
  const T* Bc = Bp + (size_t)c * cs;
  const int n_jg = max(1, kThreads / cs);
  const int jg = threadIdx.x / cs;               // 0 for every thread when cs > 256
  const int cbase = threadIdx.x - jg * cs;
  for (int chunk = blockIdx.y; chunk * kScoreRows < B; chunk += gridDim.y) {
    const int b0 = chunk * kScoreRows;
    const int nrows = min(kScoreRows, B - b0);
    float acc[kScoreCols][kScoreRows];
#pragma unroll
    for (int k = 0; k < kScoreCols; ++k)
#pragma unroll
      for (int q = 0; q < kScoreRows; ++q) acc[k][q] = 0.0f;
    for (int j0 = 0; j0 < r; j0 += stage_rows) {
      const int jl = min(stage_rows, r - j0);
      stage_tile(Bs, cs, Bc + (size_t)j0 * ldb, (size_t)ldb, jl, cs);
      for (int i = threadIdx.x; j0 == 0 && i < nrows * r; i += kThreads) {
        const float* p = part + (size_t)b0 * r + i;
        float v = p[0];
#pragma unroll 8
        for (int s = 1; s < n_split; ++s) v += p[(size_t)s * B * r];
        hs[i] = v;
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kScoreCols; ++k) {
        const int col = cbase + k * kThreads;
        if (jg < n_jg && col < cs) {
          for (int j = jg; j < jl; j += n_jg) {
            const float bv = to_f(Bs[j * cs + col]);
            const float* hj = hs + j0 + j;
#pragma unroll
            for (int q = 0; q < kScoreRows; ++q)
              if (q < nrows) acc[k][q] = fmaf(hj[q * r], bv, acc[k][q]);
          }
        }
      }
      __syncthreads();
    }
    if (jg > 0 && jg < n_jg) {           // then cs <= 128: one column a thread
#pragma unroll
      for (int q = 0; q < kScoreRows; ++q)
        if (q < nrows) gsum[((jg - 1) * kScoreRows + q) * cs + cbase] = acc[0][q];
    }
    __syncthreads();
    float best = -INFINITY;              // identity for threads without a column
#pragma unroll
    for (int k = 0; k < kScoreCols; ++k) {
      const int col = cbase + k * kThreads;
      if (jg == 0 && col < cs) {
        best = fmaxf(best, -FLT_MAX);
#pragma unroll
        for (int q = 0; q < kScoreRows; ++q) {
          if (q < nrows) {
            float v = acc[k][q];
            for (int g = 1; g < n_jg; ++g) v += gsum[((g - 1) * kScoreRows + q) * cs + col];
            scores[(size_t)(b0 + q) * Nc + (size_t)c * cs + col] = v;
            if (mask[b0 + q] > 0.0f) best = fmaxf(best, v);
          }
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
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
      tile_max[(size_t)chunk * n_clusters + c] = m;
    }
    __syncthreads();
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

// Pick k of group g, made by the whole block (the reference's loop,
// cluster_gather_ffn.py:178-186): group g's cluster scores, each the max of
// its tile_max entries over the row chunks, go into cscore (shared, nc_g
// floats; entry c is written and read by thread c mod blockDim.x only),
// then argmax-and-knockout passes 0..k: each takes the first maximum
// (argmax_combine, over a butterfly in each warp, then over the warps in
// order, so every thread ends with the same pair), and the thread that
// owns it knocks it down to -inf. The masked value -FLT_MAX sits above
// -inf, so an all-masked batch picks [0, kc) as jax.lax.top_k does. wv and
// wi (shared, 2 x warps) hold each pass's warp results, alternating so
// that one barrier a pass suffices. Returns pass k's cluster in every
// thread.
__device__ __forceinline__ int select_cluster(const float* __restrict__ tile_max,
                                              float* cscore, float (*wv)[kGateWarps],
                                              int (*wi)[kGateWarps], int n_chunks,
                                              int n_clusters, int g, int nc_g, int k) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int c = t; c < nc_g; c += blockDim.x) {
    const float* p = tile_max + (size_t)g * nc_g + c;
    float m = p[0];
    for (int q = 1; q < n_chunks; ++q) m = fmaxf(m, p[(size_t)q * n_clusters]);
    cscore[c] = m;
  }
  int bi = 0;
  for (int pass = 0; pass <= k; ++pass) {
    float bv = -INFINITY;
    bi = INT_MAX;
    for (int c = t; c < nc_g; c += blockDim.x) argmax_combine(bv, bi, cscore[c], c);
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      argmax_combine(bv, bi, ov, oi);
    }
    if (lane == 0) {
      wv[pass & 1][warp] = bv;
      wi[pass & 1][warp] = bi;
    }
    __syncthreads();
    bv = wv[pass & 1][0];
    bi = wi[pass & 1][0];
    for (int w = 1; w < kGateWarps; ++w) argmax_combine(bv, bi, wv[pass & 1][w], wi[pass & 1][w]);
    if (bi % (int)blockDim.x == t) cscore[bi] = -INFINITY;
  }
  return bi;
}

// A vector type of kBytes bytes, for one load of a run of elements.
template <int kBytes> struct VecOf;
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// N consecutive elements p[0, N), of which the first `valid` exist: one
// N * sizeof(E)-byte load where all exist and p is aligned to that size,
// else scalar loads of those that exist (the rest read as 0).
template <typename E, int N>
__device__ __forceinline__ void load_run(const E* p, int valid, E (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(E);
  using Vec = typename VecOf<kBytes>::type;
  if (valid >= N && (reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0) {
    const Vec v = *reinterpret_cast<const Vec*>(p);
    memcpy(out, &v, kBytes);
  } else {
    memset(out, 0, kBytes);
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < valid) out[e] = p[e];
  }
}

// The V weights (row_r, d), ..., (row_r, d + V - 1) of the (N, R, D)
// bundles as the dots read them, sc being row_r's scale in the quant
// modes: fp values, or codes (and outliers) in one load per array,
// dequantized element by element exactly as the reference's f32 multiply,
// f32 add and cast to x.dtype. Columns at or past D read as 0.
template <typename T, int MODE, int V>
__device__ __forceinline__ void load_w_vec(const Bundles<T>& b, size_t row_r, float sc,
                                           int D, int d, float (&out)[V]) {
  const size_t i = row_r * D + d;
  if constexpr (MODE == W_FP) {
    T w[V];
    load_run(b.w + i, D - d, w);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = to_f(w[e]);
  } else {
    int8_t q[V];
    __half o[V];
    load_run(b.q + i, D - d, q);
    if constexpr (MODE == W_MIXED) load_run(b.o + i, D - d, o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v = __fmul_rn(static_cast<float>(q[e]), sc);
      if constexpr (MODE == W_MIXED) v = __fadd_rn(v, __half2float(o[e]));
      out[e] = to_f(from_f<T>(v));
    }
  }
}

// A D chunk of gate_up: each of its kGateThreads threads holds S runs of
// V elements (16 bytes each) of a weight row, 8 elements in all, so a
// chunk is 1024 columns in either dtype (D = 576 is one chunk).
template <typename T> struct GateChunk {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int S = 8 / V;
  static constexpr int cols = kGateThreads * S * V;
};

// Stages rows x cols of x (row stride D) into xs (row stride ldx): each
// thread copies only its own runs, the columns [(128 s + t) V, + V) it
// later reads, with a 16-byte cp.async where the run is whole and aligned,
// else element by element with zeros past cols. So x needs no barrier:
// the thread waits for its own copies (cp_async_wait_all). stage_tile's
// loop over a block-wide slot index, with a division a slot and a
// barrier, cost 0.3-0.5 us more at B <= 4 on the H100.
template <typename T, int S>
__device__ __forceinline__ void stage_own(T* __restrict__ xs, int ldx, const T* __restrict__ x,
                                          int D, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  for (int q = 0; q < rows; ++q) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int cc = (s * kGateThreads + threadIdx.x) * V;
      if (cc < cols) {
        const T* src = x + (size_t)q * D + cc;
        T* dst = xs + q * ldx + cc;
        if (cols - cc >= V && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) dst[e] = e < cols - cc ? src[e] : from_f<T>(0.0f);
        }
      }
    }
  }
}

// 3. gate_up, with the selection. Block (pick, i, z) owns pick g * kc + k,
// neuron i of the picked cluster and rows [4 z, 4 z + 4) of x (row tiles
// past the grid loop inside the block):
//   H[b, pick * cs + i] = cast_T(act(x.Wg) * (x.Wu) * (score > 0 under CATS)).
// What bounds it: latency. Its bytes are the picked rows (2 x 64 x 576 x
// 2 B = 147 KB over the 64 neurons at the main shapes), x, the scores it
// reads and H, 0.05 us at the card's memory rate; its chain is tile_max ->
// argmax -> weight rows -> dots -> H, and at decode batch each block has a
// few hundred instructions to run one after the other. So each thread
// issues its runs of x's row tile (stage_own: cp.async into shared memory)
// first and the block selects (select_cluster) while they are in flight;
// once the pick is known each thread loads its runs of
// the neuron's gate and up rows into registers (16-byte vectors, all in
// one round, each weight read and dequantized by load_w_vec once per
// block), beside the rows' CATS scores. D is split over the block's 4
// warps: thread t holds columns [(128 s + t) V, (128 s + t) V + V), s < S,
// of each 1024-column chunk (GateChunk), so a thread does 8 columns of a
// row. Each row's two partial dots run from shared x and the register
// weights, in order over chunks, runs and elements (all 4 rows without a
// branch, so their chains interleave: at B = 1 that costs less than one row
// behind a branch), then over a fixed
// butterfly in each warp; the warps' partials are added in warp order in
// shared memory (a warp with no columns adds an exact 0), and thread q
// finishes row q. Blocks (pick, 0, 0) write idx[pick], which down reads
// in the next launch.
template <typename T, int MODE>
__global__ void __launch_bounds__(kGateThreads)
gate_up_kernel(const T* __restrict__ x, const Bundles<T> w,
               const float* __restrict__ tile_max, int* __restrict__ idx,
               const float* __restrict__ scores, T* __restrict__ H, int B, int D, int R,
               int nc_g, int cs, int kc, int Nc, int K, int n_chunks, int n_clusters,
               int act, int cats) {
  constexpr int V = GateChunk<T>::V, S = GateChunk<T>::S, DC = GateChunk<T>::cols;
  extern __shared__ __align__(16) unsigned char gate_smem[];
  T* xs = reinterpret_cast<T*>(gate_smem);                        // kGateRows x DC
  float* cscore = reinterpret_cast<float*>(xs + kGateRows * DC);  // nc_g
  __shared__ float wv[2][kGateWarps];
  __shared__ int wi[2][kGateWarps];
  __shared__ float red[kGateWarps][kGateRows][2];   // warp partials of each row's dots
  const int pick = blockIdx.x, i = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int g = pick / kc;
  const int first = blockIdx.z * kGateRows;
  const bool one_chunk = D <= DC, gated = R == 3;
  stage_own<T, S>(xs, DC, x + (size_t)first * D, D, min(kGateRows, B - first), min(DC, D));
  const int c = select_cluster(tile_max, cscore, wv, wi, n_chunks, n_clusters, g, nc_g,
                               pick - g * kc);
  if (blockIdx.y == 0 && blockIdx.z == 0 && t == 0) idx[pick] = c;
  const int col = (g * nc_g + c) * cs + i;   // cold neuron = score column
  const size_t rg = (size_t)col * R;        // (neuron, row) of the gate row
  const float sg = MODE == W_FP ? 0.0f : w.sc[rg];
  const float su = MODE == W_FP || !gated ? 0.0f : w.sc[rg + 1];
  float wg[S][V], wu[S][V];
  for (int b0 = first; b0 < B; b0 += gridDim.z * kGateRows) {
    if (b0 != first) __syncthreads();      // the last tile's red is read
    const int nrows = min(kGateRows, B - b0);
    const float sv = cats && t < nrows ? scores[(size_t)(b0 + t) * Nc + col] : 1.0f;
    float ag[kGateRows], au[kGateRows];
#pragma unroll
    for (int q = 0; q < kGateRows; ++q) ag[q] = au[q] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dl = min(DC, D - d0);
      if (b0 != first || d0 != 0) stage_own<T, S>(xs, DC, x + (size_t)b0 * D + d0, D, nrows, dl);
      if (!one_chunk || b0 == first) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int cc = (s * kGateThreads + t) * V;
          if (cc < dl) {
            load_w_vec<T, MODE, V>(w, rg, sg, D, d0 + cc, wg[s]);
            if (gated) load_w_vec<T, MODE, V>(w, rg + 1, su, D, d0 + cc, wu[s]);
          }
        }
      }
      cp_async_wait_all();  // this thread's own runs of x: it reads back only
                            // what it staged (stage_own), so no barrier
      // every row of the tile, so the rows' chains interleave; a row past
      // B re-reads the last live one and is never stored
#pragma unroll
      for (int q = 0; q < kGateRows; ++q) {
        const T* xq = xs + min(q, nrows - 1) * DC;  // repro: ignore[async-copy-pairing]
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int cc = (s * kGateThreads + t) * V;
          if (cc < dl) {
            const uint4 v = *reinterpret_cast<const uint4*>(xq + cc);
            T xt[V];
            memcpy(xt, &v, sizeof(v));
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float xv = to_f(xt[e]);
              ag[q] = fmaf(xv, wg[s][e], ag[q]);
              if (gated) au[q] = fmaf(xv, wu[s][e], au[q]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kGateRows; ++q) {
      float a = ag[q], u = au[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        if (gated) u += __shfl_xor_sync(0xffffffffu, u, off);
      }
      if (lane == 0) {
        red[warp][q][0] = a;
        red[warp][q][1] = u;
      }
    }
    __syncthreads();
    if (t < nrows) {
      float a = red[0][t][0], u = red[0][t][1];
      for (int v = 1; v < kGateWarps; ++v) {
        a += red[v][t][0];
        u += red[v][t][1];
      }
      float hv = activate(a, act);
      if (gated) hv *= u;
      if (cats) hv *= sv > 0.0f ? 1.0f : 0.0f;
      H[(size_t)(b0 + t) * K + (size_t)pick * cs + i] = from_f<T>(hv);
    }
  }
}

// 4. y[b, d] = sum_n H[b, n] * Wd[row(n), d] over the K = G*kc*cs picked
// neurons. Block (ct, z) owns 64 output columns and 4 rows of H. Its
// threads form kSlices = 256 / (64 / V) neuron slices (V = 16 bytes of T:
// 32 slices in bf16) of 64 / V threads each; thread l of slice s owns
// columns [l V, l V + V) of the tile, read as one vector per neuron, for
// the neurons n = s mod kSlices. Per chunk of 256 neurons the block
// stages their H columns and Wd row offsets in shared memory; each thread
// then loads the weights (and scales) of up to 8 of its neurons, all of
// them at K = 64, before it multiplies. The slices' partial sums are
// added in slice order in shared memory, every row behind one barrier.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
down_kernel(const T* __restrict__ H, const Bundles<T> w, const int* __restrict__ idx,
            float* __restrict__ y, int B, int D, int R, int nc_g, int cs, int kc, int K) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLanes = kDownCols / V;        // threads of a slice
  constexpr int kSlices = kThreads / kLanes;
  __shared__ __align__(16) T Hs[kDownRows * kDownChunk];
  __shared__ size_t row_r[kDownChunk];   // (neuron, row R - 1) of each neuron
  __shared__ float red[kSlices * kDownRows * kDownCols];
  const int slice = threadIdx.x / kLanes;
  const int c0 = blockIdx.x * kDownCols;
  const int d = c0 + (threadIdx.x % kLanes) * V;
  for (int b0 = blockIdx.y * kDownRows; b0 < B; b0 += gridDim.y * kDownRows) {
    const int nrows = min(kDownRows, B - b0);
    float acc[kDownRows][V];
#pragma unroll
    for (int q = 0; q < kDownRows; ++q)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[q][e] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kDownChunk) {
      const int kl = min(kDownChunk, K - k0);
      stage_tile(Hs, kDownChunk, H + (size_t)b0 * K + k0, (size_t)K, nrows, kl);
      for (int n = threadIdx.x; n < kl; n += kThreads) {
        const int pick = (k0 + n) / cs;
        const int i = k0 + n - pick * cs;
        row_r[n] = ((size_t)((pick / kc) * nc_g + idx[pick]) * cs + i) * R + (R - 1);
      }
      cp_async_wait_all();
      __syncthreads();
      if (d < D) {
        for (int n0 = slice; n0 < kl; n0 += kSlices * kDownGroup) {
          float wv[kDownGroup][V];
#pragma unroll
          for (int g = 0; g < kDownGroup; ++g) {
            const int n = n0 + g * kSlices;
            if (n < kl) {
              const size_t rr = row_r[n];
              load_w_vec<T, MODE, V>(w, rr, MODE == W_FP ? 0.0f : w.sc[rr], D, d, wv[g]);
            }
          }
#pragma unroll
          for (int g = 0; g < kDownGroup; ++g) {
            const int n = n0 + g * kSlices;
            if (n >= kl) break;
#pragma unroll
            for (int q = 0; q < kDownRows; ++q) {
              if (q < nrows) {
                const float hv = to_f(Hs[q * kDownChunk + n]);
#pragma unroll
                for (int e = 0; e < V; ++e) acc[q][e] = fmaf(hv, wv[g][e], acc[q][e]);
              }
            }
          }
        }
      }
      __syncthreads();
    }
    float* mine = red + slice * kDownRows * kDownCols + (d - c0);
#pragma unroll
    for (int q = 0; q < kDownRows; ++q)
#pragma unroll
      for (int e = 0; e < V; ++e) mine[q * kDownCols + e] = acc[q][e];
    __syncthreads();
    for (int u = threadIdx.x; u < nrows * kDownCols; u += kThreads) {
      const int q = u / kDownCols, c = u - q * kDownCols;
      if (c0 + c < D) {
        float v = red[u];
        for (int t = 1; t < kSlices; ++t) v += red[t * kDownRows * kDownCols + u];
        y[(size_t)(b0 + q) * D + c0 + c] = v;
      }
    }
    __syncthreads();
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

  const int n_split = (D + kHidD - 1) / kHidD;
  hidden_kernel<T><<<dim3(n_split, (r + kHidCols - 1) / kHidCols,
                          min((B + kHidRows - 1) / kHidRows, kMaxGridY)),
                     kThreads, 0, stream>>>(xt, static_cast<const T*>(A), h, B, D, r);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int stage_rows = min(r, max(1, kScoreStage / (cs * (int)sizeof(T))));
  const size_t stage_bytes = (size_t)stage_rows * cs * sizeof(T);
  const size_t sums_bytes = (size_t)(max(1, kThreads / cs) - 1) * kScoreRows * cs * 4;
  const size_t score_smem = (kScoreRows * r + kWarps) * sizeof(float) +
                            (stage_bytes > sums_bytes ? stage_bytes : sums_bytes);
  score_kernel<T><<<dim3(n_clusters, min(n_chunks, kMaxGridY)), kThreads, score_smem,
                    stream>>>(h, n_split, static_cast<const T*>(Bp), ldb, mask, scores,
                              tile_max, B, r, Nc, cs, n_clusters, stage_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t gate_smem = (size_t)kGateRows * GateChunk<T>::cols * sizeof(T) +
                           (size_t)nc_g * sizeof(float);
  if (gate_smem + 1024 > 48 * 1024 &&    // dynamic plus the kernel's static 192 bytes
      (err = cudaFuncSetAttribute(gate_up_kernel<T, MODE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)gate_smem)) != cudaSuccess)
    return (int)err;
  gate_up_kernel<T, MODE><<<dim3(G * kc, cs, min((B + kGateRows - 1) / kGateRows, kMaxGridY)),
                            kGateThreads, gate_smem, stream>>>(xt, wt, tile_max, idx, scores,
                                                     static_cast<T*>(H), B, D, R, nc_g, cs,
                                                     kc, Nc, K, n_chunks, n_clusters, act,
                                                     cats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  down_kernel<T, MODE><<<dim3((D + kDownCols - 1) / kDownCols,
                              min((B + kDownRows - 1) / kDownRows, kMaxGridY)),
                         kThreads, 0, stream>>>(static_cast<const T*>(H), wt, idx, y, B, D,
                                                R, nc_g, cs, kc, K);
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
// cudaError_t of the four launches, or 0. Any B >= 1 and any D. The
// caller checks the other shapes (cs <= 1024, r <= 1024, nc_g <= 12288),
// the dtypes and the contiguity, and allocates every output and scratch
// buffer:
//   y (B, D) f32, idx (G, kc) i32, h (ceil(D/64), B, r) f32 (hidden's
//   partials), scores (B, G*nc_g*cs) f32, tile_max (ceil(B/8), G*nc_g)
//   f32, H (B, G*kc*cs) in x's dtype.
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
