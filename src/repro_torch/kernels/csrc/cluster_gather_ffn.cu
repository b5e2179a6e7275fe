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
// with the gate/up dots and the down sum in fp32 (up only for R = 3;
// otherwise the hidden value is act(x.Wg_n)), as the reference does.
//
// What bounds it on this card: bytes, below B ~ 295. At D = 576, N = 1536,
// R = 3, bf16 the weights are 5.3 MB against 2 * 3 * B * N * D operations;
// at B = 300 the work reaches the bf16 ridge, where fp32 FMAs would take
// 15x longer than the tensor cores. So the design (1) reads each weight
// byte from device memory once per call: a gate_up block stages its
// neurons' gate and up rows once and loops over its row group of x (128
// rows; the groups of one neuron tile run together and share the rows in
// L2), and down stages each Wd row once per row tile; (2) keeps the card
// busy at B = 1: 384 gate_up blocks at K = 1536 (192 at K = 768), and down
// split over the neurons, with down's Wd staged while gate_up still runs
// (programmatic dependent launch); (3) runs bf16 products on the tensor
// cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate; bf16 products are
// exact in fp32, so only the order of the sums differs from the
// reference), fp32 on FMAs with the same structure (no TF32); (4) keeps x
// off the critical path: every gate_up block reads all of x, so past 16
// rows 4 neighbouring blocks form a cluster and share each stage of x by a
// TMA multicast (each row leaves L2 once per cluster).
//
// Design: two kernels on the caller's stream. The tiling comes from the
// wrapper (kernels/ops.py::gather_plan), which the CPU tests cover.
//   1. gate_up  H[b, n] = cast_T(act(x_b.Wg_n) * (x_b.Wu_n))
//               grid (K / neurons per block, row groups). A block stages
//               8 * NT weight rows (per 8-row n-tile: 4 neurons' gate and
//               up rows at R = 3, 8 gate rows otherwise) with 16-byte
//               cp.async, then takes its rows of x in stages of 16 *
//               m_tiles rows (cp.async, or the cluster's multicast). Its 4
//               warps split a stage as (m-tile, k-slice), each loading the
//               next k-step's fragments before issuing this one's mma; the
//               k-slices' fp32 sums are added in order in shared memory,
//               and the epilogue applies act, the up product and the cast.
//               D wider than one staged chunk is walked in chunks.
//   2. down     y[b, d] = cast_T(sum_n H[b, n] * Wd_n[d])
//               grid (D / 64 column tiles * splits, row tiles). A block
//               stages up to kc neurons of H and their Wd rows' 64 columns
//               at a time (Wd's fragments by ldmatrix.trans); each warp owns
//               16 columns for every m-tile. The splits of one column tile
//               (at most 8) are one thread-block cluster: each leaves its
//               fp32 tile in shared memory, and after a cluster barrier
//               every block sums its share of the tile over the blocks in
//               rank order (distributed shared memory) and writes y.
// Any B, D, N and cs: rows beyond B, neurons beyond K and columns beyond D
// are masked; the reduction dimension's padding (D to 16, a split's last
// neurons) is staged as zeros; a 16-byte run that is not aligned in device
// memory (D = 203, an odd view offset) is loaded element by element, and
// then x takes the cp.async path. Row tiles past the grid's 65535 loop in
// the block. Every sum runs in a fixed order and there are no float
// atomics, so runs repeat bit for bit. H is scratch allocated by the
// caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cstdint>
#include <cooperative_groups.h>

#include "shadow.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;    // 4 warps in every block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;  // row tiles beyond it loop inside the block
constexpr int kDownCols = 64;    // output columns per down block (16 a warp)
constexpr int kMaxSplits = 8;    // down's splits: one portable cluster
constexpr int kMaxSmem = 120 * 1024;  // dynamic shared memory cap of a block

enum { ACT_SILU = 0, ACT_RELU2 = 1, ACT_GELU_TANH = 2 };

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Shared-memory row padding: 16 bytes, so that rows 0..7 of a tile fall in
// distinct bank quads for the fragment loads (row stride = 4 mod 8 words).
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
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

// The helpers below are the only places of this file that issue cp.async
// or a bulk copy, wait for either, touch an mbarrier, synchronize the block
// or the cluster, or use programmatic dependent launch; each carries its
// shadow hook (shadow.cuh), and every shared read and write of a staged
// buffer goes through SH_RD / SH_WR (SH_RD_PEER for a peer's).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  SHADOW_CP_ASYNC(smem, 16);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  SHADOW_CP_WAIT();
}

__device__ __forceinline__ void block_sync() {
  __syncthreads();
  SHADOW_SYNC();
}

__device__ __forceinline__ void cluster_sync() {
  cg::this_cluster().sync();
  SHADOW_CLUSTER_SYNC();
}

// Stages `rows` rows of `width` elements (a multiple of 16 bytes) into dst
// (row stride ldd) with all the block's warps: row i comes from src_of(i),
// evaluated once per row; its first `cols` elements are copied, [cols,
// width) are zeros. A null row is left as it is, or zeroed with
// ZERO_MISSING (rows that pad the reduction dimension). A warp takes
// 32 / slots rows at a time when a row has at most 32 16-byte slots,
// else one row with its lanes strided over the slots. Aligned 16-byte
// runs go by cp.async, the rest element by element. The caller waits and
// synchronizes.
template <typename T, bool ZERO_MISSING, typename Src>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int ldd, int rows,
                                           int width, int cols, Src src_of) {
  constexpr int V = 16 / sizeof(T);
  const int slots = width / V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const bool packed = slots <= 32 && 32 % slots == 0;
  const int rpi = packed ? 32 / slots : 1;          // rows a warp takes at once
  const int sub = packed ? lane / slots : 0;
  const int s0 = packed ? lane % slots : lane, ds = packed ? slots : 32;
  for (int i = warp * rpi + sub; i < rows; i += nwarps * rpi) {
    const T* p = src_of(i);
    T* q = dst + (size_t)i * ldd;
    for (int sl = s0; sl < slots; sl += ds) {
      const int e = sl * V;
      if (p == nullptr) {
        if (ZERO_MISSING) SH_WR(reinterpret_cast<uint4*>(q + e)) = make_uint4(0, 0, 0, 0);
      } else if (e + V <= cols && (reinterpret_cast<uintptr_t>(p + e) & 15) == 0) {
        cp_async16(q + e, p + e);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) SH_WR(&q[e + k]) = e + k < cols ? p[e + k] : from_f<T>(0.0f);
      }
    }
  }
}

// Programmatic dependent launch: the kernel after this one in the stream
// (launched with the programmatic serialization attribute) may start, and
// griddep_wait blocks until the kernel before this one has completed and
// its writes are visible. down stages its Wd rows under gate_up's tail.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  SHADOW_GRIDDEP_LAUNCH();
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  SHADOW_GRIDDEP_WAIT();
}

// mbarrier and bulk-copy helpers for gate_up's multicast of x (a stage of
// x lands in every block of the cluster; each block's barrier counts the
// bytes that reach it).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  SHADOW_MBAR_INIT(bar);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  SHADOW_MBAR_EXPECT(bar, bytes);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// (the shadow build bounds the spin: a phase that never completes is a
// finding, never a hang)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  SHADOW_MBAR_WAIT_BEGIN(bar, parity);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done SHADOW_SPIN_ON);
  SHADOW_MBAR_WAIT_END(bar, parity, done);
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global memory to the same shared-memory offset in every block of the
// cluster named in `mask`, completing on each one's barrier `bar`.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar, uint16_t mask) {
  SHADOW_MULTICAST(dst, bytes, bar, mask);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return SH_RD(reinterpret_cast<const uint32_t*>(p));
}

// A fragment of m16n8k16 from a row-major tile (rows 0..15, columns k0..):
// lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 at columns
// k0 + 2t, +1 and k0 + 8 + 2t, +1.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = tile + (size_t)g * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// 1. gate_up. Block (nb, yb): neurons [nb * npb, nb * npb + npb) with
// npb = NT * (R == 3 ? 4 : 8), row stages yb, yb + gridDim.y, ... of
// 16 * m_tiles rows. Shared memory: the weight rows (8 * NT of chunk +
// pad), the stage of x (16 * m_tiles rows), the warps' fp32 sums (red,
// 4 warps x NT x 16 x 8). xc > 1: the block is one of a cluster of xc.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
gather_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ idx, T* __restrict__ H, int ldh, int B,
                      int D, int R, int K, int cs, int act, int m_tiles, int chunk, int xc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t xbar;  // the multicast stage's barrier
  const int ld = chunk + pad<T>();
  const int wrows = 8 * NT, srows = 16 * m_tiles;
  T* ws = reinterpret_cast<T*>(smem);
  T* xs = ws + (size_t)wrows * ld;
  float* red = reinterpret_cast<float*>(xs + (size_t)srows * ld);
  SHADOW_BEGIN(kShGatherGateUp);

  const bool gated = R == 3;
  const int npt = gated ? 4 : 8;  // neurons per n-tile
  const int npb = npt * NT;
  const int nb0 = blockIdx.x * npb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ksl = kWarps / m_tiles;  // k-slices per m-tile
  const int ms = warp / ksl, kslice = warp % ksl;
  const int n_chunks = (D + chunk - 1) / chunk;
  const int n_stages = (B + srows - 1) / srows;
  griddep_launch();  // down may stage its Wd rows meanwhile

  // xc > 1: the xc blocks of a cluster (neighbouring neuron tiles) share
  // each stage of x: block r multicasts rows r, r + xc, ... to all of them,
  // so L2 serves each row once per cluster. The rows are whole (D <= chunk,
  // aligned); the columns that pad D to 16 are zeroed once here.
  const bool mc = xc > 1;
  const int rank = mc ? (int)cg::this_cluster().block_rank() : 0;
  if (mc) {
    if (threadIdx.x == 0) mbar_init(&xbar);
    const int padc = ((D + 15) & ~15) - D;
    for (int u = threadIdx.x; u < srows * padc; u += kThreads)
      SH_WR(&xs[(size_t)(u / padc) * ld + D + u % padc]) = from_f<T>(0.0f);
    cluster_sync();
  }

  // weight row j of the block: neuron nb0 + (j / 8) * npt + j % npt, part
  // (j % 8) / 4 (gate, up) at R = 3, part 0 otherwise
  auto w_row = [&](int j, int c0) -> const T* {
    const int nt = j >> 3, jj = j & 7;
    const int n = nb0 + nt * npt + (gated ? (jj & 3) : jj);
    if (n >= K) return nullptr;
    const int part = gated ? (jj >> 2) : 0;
    return w + ((size_t)neuron_row(idx, n, cs) * R + part) * D + c0;
  };

  // this group's stages y, y + gridDim.y, ..., each block (or cluster)
  // starting at its own, so that the blocks do not all read the same rows
  // of x at once
  const int my = (n_stages - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  for (int j = 0; j < my; ++j) {
    const int st = blockIdx.y + gridDim.y * ((j + blockIdx.x / xc) % my);
    const int b0 = st * srows;
    const bool live = b0 + ms * 16 < B;  // this warp's m-tile has rows
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;

    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * chunk;
      const int cols = min(chunk, D - c0);
      const int width = (cols + 15) & ~15;
      if (n_chunks > 1 || j == 0)
        stage_rows<T, false>(ws, ld, wrows, width, cols,
                             [&](int j) { return w_row(j, c0); });
      if (mc) {
        if (j > 0) cluster_sync();  // the cluster has read the last stage
        const int rows = min(srows, B - b0);
        if (threadIdx.x == 0) mbar_expect_tx(&xbar, (unsigned)(rows * D * sizeof(T)));
        for (int i = rank + xc * (int)threadIdx.x; i < rows; i += xc * kThreads)
          bulk_multicast(xs + (size_t)i * ld, x + (size_t)(b0 + i) * D,
                         (unsigned)(D * sizeof(T)), &xbar, (uint16_t)((1u << xc) - 1));
      } else {
        stage_rows<T, false>(xs, ld, srows, width, cols, [&](int i) -> const T* {
          return b0 + i < B ? x + (size_t)(b0 + i) * D + c0 : nullptr;
        });
      }
      cp_async_wait_all();
      if (mc) mbar_wait(&xbar, j & 1);
      block_sync();
      if (live) {
        const T* xt = xs + (size_t)ms * 16 * ld;
        const int nk = width / 16;
        if constexpr (sizeof(T) == 2) {
          // the fragments of k-step kk; the next step's are loaded before
          // this step's mma is issued (two register sets, alternating)
          struct Frag {
            uint32_t a[4], b[NT][2];
          };
          auto load = [&](int kk, Frag& f) {
            const int k0 = kk * 16;
            load_a(f.a, xt, ld, k0, lane);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              const T* wp = ws + (size_t)(t * 8 + g) * ld + k0 + 2 * t4;
              f.b[t][0] = lds32(wp);
              f.b[t][1] = lds32(wp + 8);
            }
          };
          auto mma = [&](const Frag& f) {
#pragma unroll
            for (int t = 0; t < NT; ++t) mma_bf16(acc[t], f.a, f.b[t][0], f.b[t][1]);
          };
          Frag f0, f1;
          int kk = kslice;
          if (kk < nk) load(kk, f0);
          while (kk < nk) {
            if (kk + ksl < nk) load(kk + ksl, f1);
            mma(f0);
            kk += ksl;
            if (kk >= nk) break;
            if (kk + ksl < nk) load(kk + ksl, f0);
            mma(f1);
            kk += ksl;
          }
        } else {
          // fp32: the same fragment of the 16 x 8 product on FMAs, k in
          // order, 4 columns of k a load
          for (int kk = kslice; kk < nk; kk += ksl) {
#pragma unroll
            for (int k = kk * 16; k < kk * 16 + 16; k += 4) {
              const float4 xa = SH_RD(reinterpret_cast<const float4*>(xt + (size_t)g * ld + k));
              const float4 xb =
                  SH_RD(reinterpret_cast<const float4*>(xt + (size_t)(g + 8) * ld + k));
#pragma unroll
              for (int t = 0; t < NT; ++t) {
                const T* wp = ws + (size_t)(t * 8 + 2 * t4) * ld + k;
                const float4 w0 = SH_RD(reinterpret_cast<const float4*>(wp));
                const float4 w1 = SH_RD(reinterpret_cast<const float4*>(wp + ld));
                float* r = acc[t];
                r[0] = fmaf(xa.x, w0.x, r[0]); r[0] = fmaf(xa.y, w0.y, r[0]);
                r[0] = fmaf(xa.z, w0.z, r[0]); r[0] = fmaf(xa.w, w0.w, r[0]);
                r[1] = fmaf(xa.x, w1.x, r[1]); r[1] = fmaf(xa.y, w1.y, r[1]);
                r[1] = fmaf(xa.z, w1.z, r[1]); r[1] = fmaf(xa.w, w1.w, r[1]);
                r[2] = fmaf(xb.x, w0.x, r[2]); r[2] = fmaf(xb.y, w0.y, r[2]);
                r[2] = fmaf(xb.z, w0.z, r[2]); r[2] = fmaf(xb.w, w0.w, r[2]);
                r[3] = fmaf(xb.x, w1.x, r[3]); r[3] = fmaf(xb.y, w1.y, r[3]);
                r[3] = fmaf(xb.z, w1.z, r[3]); r[3] = fmaf(xb.w, w1.w, r[3]);
              }
            }
          }
        }
      }
      block_sync();  // the chunk is read before the next one is staged
    }

    // the warps' 16 x 8 sums into red[warp][t][row][col]
    if (live) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float* r = red + ((size_t)warp * NT + t) * 128;
        SH_WR(&r[g * 8 + 2 * t4]) = acc[t][0];
        SH_WR(&r[g * 8 + 2 * t4 + 1]) = acc[t][1];
        SH_WR(&r[(g + 8) * 8 + 2 * t4]) = acc[t][2];
        SH_WR(&r[(g + 8) * 8 + 2 * t4 + 1]) = acc[t][3];
      }
    }
    block_sync();
    // epilogue: row i of the stage, neuron q of the block; k-slices added
    // in order
    const int rows = min(srows, B - b0);
    for (int u = threadIdx.x; u < rows * npb; u += kThreads) {
      const int i = u / npb, q = u - i * npb;
      const int n = nb0 + q;
      if (n >= K) continue;
      const int m = i >> 4, r16 = i & 15, t = q / npt, qq = q - t * npt;
      float gs = 0.0f, us = 0.0f;
      for (int s = 0; s < ksl; ++s) {
        const float* r = red + ((size_t)(m * ksl + s) * NT + t) * 128 + r16 * 8;
        gs += SH_RD(&r[qq]);
        if (gated) us += SH_RD(&r[qq + 4]);
      }
      float hv = activate(gs, act);
      if (gated) hv *= us;
      H[(size_t)(b0 + i) * ldh + n] = from_f<T>(hv);
    }
    // the next stage writes xs only after its staging; red after a barrier
  }
  SHADOW_END();
}

// 2. down. The splits of one column tile form one thread-block cluster:
// block (ct * splits + sp, rt) sums neurons [sp * split, min(K, sp * split
// + split)) for columns [64 ct, 64 ct + 64) and row tiles rt, rt +
// gridDim.y, ... of 16 * m_tiles rows, staging kc neurons of H and of
// their Wd rows at a time. Warp w owns columns [16 w, 16 w + 16) of the
// tile (two n-tiles) for every m-tile. Each block leaves its fp32 tile in
// shared memory; after a cluster barrier, block sp sums its share of the
// tile's elements over the cluster's blocks in rank order (distributed
// shared memory), casts and writes y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_down_kernel(const T* __restrict__ H, int ldh, const T* __restrict__ w,
                   const int* __restrict__ idx, T* __restrict__ y, int B, int D, int R,
                   int K, int cs, int m_tiles, int kc, int split, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldw = kDownCols + pad<T>();
  const int ldk = kc + pad<T>();
  const int trows = 16 * m_tiles;
  T* hs = reinterpret_cast<T*>(smem);                          // trows x kc
  T* wsd = hs + (size_t)trows * ldk;                           // kc x 64
  float* red = reinterpret_cast<float*>(wsd + (size_t)kc * ldw);  // trows x 64
  cg::cluster_group cluster = cg::this_cluster();
  SHADOW_BEGIN(kShGatherDown);
  const int sp = blockIdx.x % splits, ct = blockIdx.x / splits;
  const int c0 = ct * kDownCols;
  const int nbeg = sp * split, nend = min(K, nbeg + split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int cw = warp * 16;  // the warp's first column in the tile
  const int n_row_tiles = (B + trows - 1) / trows;
  const int dcols = min(kDownCols, D - c0);

  for (int rt = blockIdx.y; rt < n_row_tiles; rt += gridDim.y) {
    const int b0 = rt * trows;
    float acc[4][2][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][t][q] = 0.0f;

    for (int n0 = nbeg; n0 < nend; n0 += kc) {
      const int nn = min(kc, nend - n0);
      const int kw = (nn + 15) & ~15;  // the k-steps' width, zero-padded
      stage_rows<T, true>(wsd, ldw, kw, kDownCols, dcols, [&](int j) -> const T* {
        return j < nn ? w + ((size_t)neuron_row(idx, n0 + j, cs) * R + (R - 1)) * D + c0
                      : nullptr;
      });
      griddep_wait();  // H is gate_up's
      stage_rows<T, false>(hs, ldk, trows, kw, nn, [&](int i) -> const T* {
        return b0 + i < B ? SH_DEP(H + (size_t)(b0 + i) * ldh + n0) : nullptr;
      });
      cp_async_wait_all();
      block_sync();
      const int live_m = min(m_tiles, (B - b0 + 15) / 16);  // m-tiles with rows
      if constexpr (sizeof(T) == 2) {
        // the fragments of one k-step (Wd's by ldmatrix.trans); the next
        // step's are loaded before this step's mma is issued
        struct Frag {
          uint32_t b[4], a[4][4];
        };
        auto load = [&](int k0, Frag& f) {
          const T* bp = wsd + (size_t)(k0 + (lane & 15)) * ldw + cw + (lane >> 4) * 8;
          SHADOW_RD_BYTES(bp, 16);
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(f.b[0]), "=r"(f.b[1]), "=r"(f.b[2]), "=r"(f.b[3])
              : "r"(smem_u32(bp)));
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m < live_m) load_a(f.a[m], hs + (size_t)m * 16 * ldk, ldk, k0, lane);
        };
        auto mma = [&](const Frag& f) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m < live_m) {
              mma_bf16(acc[m][0], f.a[m], f.b[0], f.b[1]);
              mma_bf16(acc[m][1], f.a[m], f.b[2], f.b[3]);
            }
        };
        Frag f0, f1;
        load(0, f0);
        for (int k0 = 0; k0 < kw; k0 += 32) {
          if (k0 + 16 < kw) load(k0 + 16, f1);
          mma(f0);
          if (k0 + 16 >= kw) break;
          if (k0 + 32 < kw) load(k0 + 32, f0);
          mma(f1);
        }
      } else {
        // fp32: the same fragments on FMAs, k in order
        for (int k = 0; k < kw; k += 4) {
          float2 wv[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wv[t][e] = SH_RD(reinterpret_cast<const float2*>(wsd + (size_t)(k + e) * ldw + cw +
                                                                t * 8 + 2 * t4));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (m >= live_m) break;
            const T* hp = hs + (size_t)(m * 16 + g) * ldk + k;
            const float4 ha = SH_RD(reinterpret_cast<const float4*>(hp));
            const float4 hb = SH_RD(reinterpret_cast<const float4*>(hp + 8 * ldk));
            const float av[4] = {ha.x, ha.y, ha.z, ha.w};
            const float bv[4] = {hb.x, hb.y, hb.z, hb.w};
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float* r = acc[m][t];
                r[0] = fmaf(av[e], wv[t][e].x, r[0]);
                r[1] = fmaf(av[e], wv[t][e].y, r[1]);
                r[2] = fmaf(bv[e], wv[t][e].x, r[2]);
                r[3] = fmaf(bv[e], wv[t][e].y, r[3]);
              }
          }
        }
      }
      block_sync();  // the chunk is read before the next one is staged
    }

    // this block's tile into red[row][col]: c0, c1 at row g, columns 2 t4,
    // +1; c2, c3 at row g + 8
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= m_tiles) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          SH_WR(&red[(m * 16 + g + (q >> 1) * 8) * kDownCols + cw + t * 8 + 2 * t4 +
                     (q & 1)]) = acc[m][t][q];
    }
    cluster_sync();
    for (int e = sp * kThreads + threadIdx.x; e < trows * kDownCols; e += splits * kThreads) {
      const int b = b0 + e / kDownCols, d = c0 + e % kDownCols;
      if (b >= B || d >= D) continue;
      float v = -0.0f;  // -0 + p = p: the sum starts at rank 0's bits
      for (int s0 = 0; s0 < splits; s0 += 8) {
        float pv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pv[j] = s0 + j < splits
                      ? SH_RD_PEER(cluster.map_shared_rank(red, s0 + j) + e, red + e, s0 + j)
                      : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (s0 + j < splits) v += pv[j];
      }
      y[(size_t)b * D + d] = from_f<T>(v);
    }
    cluster_sync();  // every block's tile is read before it is rewritten
  }
  SHADOW_END();
}

template <typename T>
int launch(const void* x, const void* w, const int* idx, void* H, void* y, int B, int D,
           int R, int K, int cs, int act, int ldh, int n_tiles, int m_tiles, int chunk,
           int gate_groups, int xc, int down_m_tiles, int kc, int split, int splits,
           cudaStream_t stream) {
  // shared memory: gate_up's weight rows and stage of x, then red; down's
  // H and Wd tiles, then its fp32 tile
  const size_t gate_smem =
      (size_t)(8 * n_tiles + 16 * m_tiles) * (chunk + pad<T>()) * sizeof(T) +
      (size_t)kWarps * n_tiles * 128 * sizeof(float);
  const size_t down_smem =
      ((size_t)16 * down_m_tiles * (kc + pad<T>()) + (size_t)kc * (kDownCols + pad<T>())) *
          sizeof(T) +
      (size_t)16 * down_m_tiles * kDownCols * sizeof(float);
  if ((n_tiles != 1 && n_tiles != 2) ||
      (m_tiles != 1 && m_tiles != 2 && m_tiles != 4) || chunk < 16 || chunk % 16 ||
      gate_smem > (size_t)kMaxSmem || down_m_tiles < 1 || down_m_tiles > 4 || kc < 16 ||
      kc % 16 || down_smem > (size_t)kMaxSmem || split < 16 || split % 16 || splits < 1 ||
      splits > kMaxSplits || (size_t)split * (splits - 1) >= (size_t)K || gate_groups < 1 ||
      gate_groups > kMaxGridY || (xc != 1 && xc != 2 && xc != 4))
    return (int)cudaErrorInvalidValue;
  // the multicast takes whole, 16-byte aligned rows of x
  if ((reinterpret_cast<uintptr_t>(x) & 15) || (D * sizeof(T)) % 16 || chunk < D) xc = 1;
  static bool smem_set[64] = {};  // the dynamic shared memory caps, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaError_t e = cudaSuccess;
    for (auto k : {gather_gate_up_kernel<T, 1>, gather_gate_up_kernel<T, 2>})
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gather_down_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* Ht = static_cast<T*>(H);
  const int npb = n_tiles * (R == 3 ? 4 : 8);
  const int gate_blocks = ((K + npb - 1) / npb + xc - 1) / xc * xc;  // whole clusters
  cudaLaunchAttribute gc[1];
  gc[0].id = cudaLaunchAttributeClusterDimension;
  gc[0].val.clusterDim.x = xc;
  gc[0].val.clusterDim.y = 1;
  gc[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t gcfg = {};
  gcfg.gridDim = dim3(gate_blocks, gate_groups);
  gcfg.blockDim = dim3(kThreads);
  gcfg.dynamicSmemBytes = gate_smem;
  gcfg.stream = stream;
  gcfg.attrs = gc;
  gcfg.numAttrs = 1;
  auto gate_up = n_tiles == 1 ? gather_gate_up_kernel<T, 1> : gather_gate_up_kernel<T, 2>;
  SHADOW_PREPARE(kShGatherGateUp, gate_up, gcfg.gridDim, kThreads, gate_smem);
  cudaError_t err = cudaLaunchKernelEx(&gcfg, gate_up, xt, wt, idx, Ht, ldh, B, D, R, K, cs,
                                       act, m_tiles, chunk, xc);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // down: a cluster of `splits` blocks per column tile, started early
  // (programmatic dependent launch) to stage its Wd rows under gate_up
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = splits;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const int col_tiles = (D + kDownCols - 1) / kDownCols;
  const int row_tiles = (B + 16 * down_m_tiles - 1) / (16 * down_m_tiles);
  // row tiles past the grid's cap loop inside the block (the shadow build
  // can lower the cap, to reach that loop at small B)
  cfg.gridDim = dim3(col_tiles * splits, std::min(row_tiles, SHADOW_GRID_CAP(kMaxGridY)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = down_smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  SHADOW_PREPARE(kShGatherDown, gather_down_kernel<T>, cfg.gridDim, kThreads, down_smem);
  err = cudaLaunchKernelEx(&cfg, gather_down_kernel<T>, (const T*)Ht, ldh, wt, idx,
                           static_cast<T*>(y), B, D, R, K, cs, down_m_tiles, kc, split,
                           splits);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" {

// Launches the gathered bundled FFN on `stream`; returns the first nonzero
// cudaError_t of the two launches, or 0. x (B, D) and w (N, R, D) share
// one dtype (is_bf16 = 1 for bfloat16, 0 for float32). idx holds the K /
// cs cluster ids (each in [0, N / cs)), or is null for all K = N rows in
// order (cs is then unused). The caller checks shapes, dtypes and
// contiguity, picks the tiling (kernels/ops.py::gather_plan: n_tiles,
// m_tiles, chunk, gate_groups, xc, down_m_tiles, kc, split, splits; an
// invalid one returns cudaErrorInvalidValue) and allocates H (B, ldh) and
// y (B, D) in x's dtype.
int cluster_gather_ffn_launch(const void* x, const void* w, const int* idx, void* H,
                              void* y, int B, int D, int R, int K, int cs, int act,
                              int is_bf16, int ldh, int n_tiles, int m_tiles, int chunk,
                              int gate_groups, int xc, int down_m_tiles, int kc, int split,
                              int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, idx, H, y, B, D, R, K, cs, act, ldh, n_tiles,
                                 m_tiles, chunk, gate_groups, xc, down_m_tiles, kc, split,
                                 splits, s);
  return launch<float>(x, w, idx, H, y, B, D, R, K, cs, act, ldh, n_tiles, m_tiles, chunk,
                       gate_groups, xc, down_m_tiles, kc, split, splits, s);
}

const char* cluster_gather_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// the shadow build's cluster_gather_ffn_shadow_log / _shadow_grid_cap
SHADOW_EXPORTS(cluster_gather_ffn)
