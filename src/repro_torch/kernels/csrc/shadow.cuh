// Shadow hooks of the port's CUDA kernels: the card side of the analysis
// gate's shadow tier (src/repro_torch/analysis/shadow.py), the counterpart
// of the reference's DMA race sanitizer (src/repro/analysis/
// dma_sanitizer.py), which reran the shipped Pallas kernel body with its
// copies swapped for shadow objects. Here the shadow is a second build of
// the same sources.
//
// Every synchronising or shared-memory event of the kernels goes through a
// hook of this header: the block and cluster barriers (block_sync,
// cluster_sync), cp.async and its wait, the mbarrier's init, expect_tx and
// wait, the TMA multicast, programmatic dependent launch, and each read
// and write of a staged shared buffer (SH_RD / SH_WR, SH_RD_PEER for
// distributed shared memory, SHADOW_RD_BYTES for ldmatrix). Without
// REPRO_SHADOW (the normal build, the one the serving path runs) each hook
// is empty or is the plain access it wraps, so the kernels compile to the
// code they had without this header. With -DREPRO_SHADOW (kernels/
// build.py's "shadow" variant) each hook records itself:
//
// * a table in global memory (sized by the host from each launch's grid,
//   block and shared bytes) gives every block a slot: one record per
//   thread (its barrier epoch, its cluster epoch, the cp.async copies it
//   has issued and not yet waited for, its mbarrier waits, whether it has
//   passed griddepcontrol.wait), one record of the block's mbarrier, and
//   two 64-bit words per 2-byte unit of the block's shared memory:
//   W, the unit's last write (kind: none, written, cp.async in flight, or
//   delivered by a multicast; the writing thread; its barrier and cluster
//   epochs; whether the unit held an ordered older value), and R, its
//   readers (the first in the current barrier epoch, whether another
//   thread read too, the cluster epoch of the latest read from a peer
//   block). Both are updated with 64-bit atomics: a reader updates R, then
//   checks W; a writer updates W, then checks R, each with a fence
//   between, so of two racing accesses at least one sees the other.
// * A thread's barrier epoch counts the block barriers (cluster barriers
//   included) it has passed. Two accesses of one unit by two threads of a
//   block are ordered if and only if their epochs differ. Two lanes of one
//   warp are two threads: the kernels exchange nothing through shared
//   memory within a warp without a barrier (their shuffles touch none),
//   and they call no __syncwarp, so no hook orders lanes.
// * Distributed shared memory is ordered by cluster epochs: a peer's
//   unit is read after a cluster barrier that follows its write, and is
//   rewritten after a cluster barrier that follows every peer's read. A
//   block's exit is one more such rewrite: it records that it has left
//   (its mbarrier record's `exited`), then looks for units a peer read in
//   its last cluster epoch; a peer's read or multicast that finds the
//   block gone is a finding too. The shadow then holds the cluster's
//   blocks together until every one has ended, so that a broken kernel
//   reports instead of faulting the card.
// * The multicast's bytes are counted per block: each block's mbarrier
//   record keeps the cumulative bytes expected after each expect_tx and
//   the cumulative bytes delivered; a delivered unit keeps its position in
//   that stream. A thread's k-th wait must ask for parity k & 1 and
//   entitles it to the units delivered within the first k + 1 phases'
//   expected bytes. A peer's bytes may be counted before this block's
//   expect_tx (the hardware's transaction count may go negative within a
//   phase), so delivery order is never a finding; at each cluster barrier
//   no expected byte may be missing, and at exit, when every issue is
//   done, the two counts must be equal.
//
// Rules (analysis/shadow.py names them; the reference's classes beside):
//   shadow-read-not-ready    a read of a unit whose cp.async was never
//                            waited for (dma-read-not-ready)
//   shadow-inflight-at-exit  a thread ends with a cp.async it never waited
//                            for (dma-inflight-at-exit)
//   shadow-raw-race          a read of a unit another thread wrote in the
//                            same epoch, with no ordered older value
//   shadow-war-race          a write to a unit another thread read or wrote
//                            in the same epoch, over an ordered older
//                            value, or such a read (dma-slot-overwrite)
//   shadow-restart-without-wait  a unit rewritten while its cp.async is in
//                            flight (dma-start-without-wait)
//   shadow-mbarrier          a wait on the wrong parity, a spin that ran
//                            out, a read of a multicast unit the thread's
//                            waits do not cover, expected bytes that differ
//                            from the delivered, a multicast into a block
//                            that has left (dma-double-wait)
//   shadow-dsmem-race        a peer's unit read or rewritten in the cluster
//                            epoch of its write or read (a multicast
//                            stage, over one its readers consumed), a block
//                            that leaves in the cluster epoch of a peer's
//                            read of it, a read of a block that has left
//   shadow-griddep-race      a read of the previous grid's output before
//                            griddepcontrol.wait
//   shadow-capacity          a table, list or log bound of the shadow was
//                            exceeded: the run checked less than it should
// Each finding goes into a bounded log in device memory, one record per
// (rule, kernel, source line) with a count; a full log raises its
// overflow counter, which the decoder treats as a failure.
#pragma once

#include <cstdint>

// the kernels the shadow names (analysis/shadow.py keeps the same order)
enum ShadowKernel {
  kShHidden = 0,
  kShScore = 1,
  kShGateUp = 2,
  kShDown = 3,
  kShGatherGateUp = 4,
  kShGatherDown = 5,
  kShKernels = 6
};

#ifndef REPRO_SHADOW

#define SHADOW_BEGIN(kernel) ((void)0)
#define SHADOW_END() ((void)0)
#define SHADOW_SYNC() ((void)0)
#define SHADOW_CLUSTER_SYNC() ((void)0)
#define SHADOW_CP_ASYNC(dst, bytes) ((void)0)
#define SHADOW_CP_WAIT() ((void)0)
#define SHADOW_MBAR_INIT(bar) ((void)0)
#define SHADOW_MBAR_EXPECT(bar, bytes) ((void)0)
#define SHADOW_MBAR_WAIT_BEGIN(bar, parity) ((void)0)
#define SHADOW_SPIN_ON
#define SHADOW_MBAR_WAIT_END(bar, parity, done) ((void)0)
#define SHADOW_MULTICAST(dst, bytes, bar, mask) ((void)0)
#define SHADOW_GRIDDEP_LAUNCH() ((void)0)
#define SHADOW_GRIDDEP_WAIT() ((void)0)
#define SHADOW_RD_BYTES(p, bytes) ((void)0)
#define SH_RD(p) (*(p))
#define SH_WR(p) (*(p))
#define SH_RD_PEER(remote, local, rank) (*(remote))
#define SH_DEP(p) (p)
#define SHADOW_GRID_CAP(cap) (cap)
#define SHADOW_PREPARE(kernel_id, kernel, grid, threads, dyn_smem) ((void)0)
#define SHADOW_EXPORTS(name)

#else  // REPRO_SHADOW

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace shadow {

typedef unsigned long long u64;

enum Rule : unsigned {
  kReadNotReady = 1,
  kInflightAtExit = 2,
  kRawRace = 3,
  kWarRace = 4,
  kRestart = 5,
  kMbarrier = 6,
  kDsmemRace = 7,
  kGriddepRace = 8,
  kCapacity = 9
};

constexpr int kPend = 118;       // cp.async copies a thread may have in flight
constexpr int kPhases = 64;      // mbarrier phases a block may arm
constexpr u64 kSpinNs = 200000000ull;  // an mbarrier wait gives up after 0.2 s
constexpr unsigned kEM = (1u << 20) - 1;  // barrier epochs, compared mod 2^20
constexpr unsigned kCM = (1u << 15) - 1;  // cluster epochs, compared mod 2^15
enum Kind : unsigned { kNone = 0, kWritten = 1, kPending = 2, kDelivered = 3 };

struct ThreadRec {                // 512 bytes
  unsigned epoch, cepoch, flags, npend;
  unsigned mb_waits, mb_ok;       // waits so far; the last one was right
  u64 mb_obs;                     // delivered bytes this thread's waits cover
  u64 mb_lo;                      // those its waits before the last covered
  unsigned pend[kPend];           // unit index of each 16-byte copy in flight
};
struct BarRec {                   // the block's mbarrier, and its exit
  unsigned addr, nexp, exited, pad1;  // addr: shared address + 1 (0: none)
  u64 delivered;                  // cumulative bytes delivered to it
  u64 cum[kPhases];               // cumulative bytes expected after each arm
};
struct Unit {
  u64 w, r;
};
struct Record {                   // one (rule, kernel, line) of the log
  u64 key;
  unsigned block, thread, unit, count;
};
struct Log {
  unsigned capacity, overflow, pad0, pad1;
  Record rec[1];
};
struct Block {                    // the block's view of its slot
  char* slot;
  Unit* units;
  BarRec* bar;
  u64 slot_bytes;
  unsigned nunits, kid, linear;
};

__device__ Log* g_log;
__device__ char* g_table[kShKernels];
__device__ u64 g_table_bytes[kShKernels];
__shared__ Block g_blk;

constexpr u64 kBarBytes = (sizeof(BarRec) + 255) / 256 * 256;

__host__ __device__ inline u64 slot_bytes(unsigned threads, u64 units) {
  return ((u64)threads * sizeof(ThreadRec) + kBarBytes + units * sizeof(Unit) + 255) / 256 *
         256;
}

// W: kind 0-1, thread 2-11, epoch 12-31, older 32, cepoch 33-47; a
// delivered unit keeps its stream position / 16 in bits 2-31
__device__ __forceinline__ u64 w_make(unsigned kind, unsigned t, unsigned e, unsigned older,
                                      unsigned c) {
  return (u64)kind | (u64)t << 2 | (u64)(e & kEM) << 12 | (u64)older << 32 |
         (u64)(c & kCM) << 33;
}
__device__ __forceinline__ unsigned w_kind(u64 w) { return (unsigned)(w & 3); }
__device__ __forceinline__ unsigned w_thread(u64 w) { return (unsigned)(w >> 2) & 1023; }
__device__ __forceinline__ unsigned w_epoch(u64 w) { return (unsigned)(w >> 12) & kEM; }
__device__ __forceinline__ unsigned w_older(u64 w) { return (unsigned)(w >> 32) & 1; }
__device__ __forceinline__ unsigned w_cepoch(u64 w) { return (unsigned)(w >> 33) & kCM; }
__device__ __forceinline__ u64 w_pos(u64 w) { return ((w >> 2) & 0x3fffffffull) << 4; }

// R: thread 0-9, epoch 10-29, multi 30, valid 31, cepoch 32-46, remote
// cepoch 47-61, remote valid 62, consumed 63 (a reader in this epoch read
// data of the multicast phase its right wait covered, not an older stage's)
constexpr u64 kMulti = 1ull << 30, kLocal = 1ull << 31, kRemote = 1ull << 62,
              kConsumed = 1ull << 63;
__device__ __forceinline__ unsigned r_thread(u64 r) { return (unsigned)r & 1023; }
__device__ __forceinline__ unsigned r_epoch(u64 r) { return (unsigned)(r >> 10) & kEM; }
__device__ __forceinline__ unsigned r_cepoch(u64 r) { return (unsigned)(r >> 32) & kCM; }
__device__ __forceinline__ unsigned r_rcepoch(u64 r) { return (unsigned)(r >> 47) & kCM; }

__device__ __forceinline__ u64 ld(const u64* p) { return *(const volatile u64*)p; }
__device__ __forceinline__ unsigned ld32(const unsigned* p) {
  return *(const volatile unsigned*)p;
}

// the block's own offset of a shared address: in a cluster launch the
// shared window's addresses carry the block's rank from bit 24 up
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p)) & 0xFFFFFFu;
}

// the mbarrier record of the slot whose units start at `units`
__device__ __forceinline__ BarRec* bar_of(Unit* units) {
  return reinterpret_cast<BarRec*>(reinterpret_cast<char*>(units) - kBarBytes);
}

__device__ __forceinline__ ThreadRec* me() {
  return reinterpret_cast<ThreadRec*>(g_blk.slot) + threadIdx.x;
}

__device__ __noinline__ void report(unsigned rule, int line, unsigned unit) {
  Log* L = g_log;
  if (L == nullptr) return;
  const u64 key = (u64)line << 16 | (u64)g_blk.kid << 8 | rule;
  const unsigned cap = L->capacity;
  unsigned h = (unsigned)((key * 0x9E3779B97F4A7C15ull) >> 40) % cap;
  for (unsigned probe = 0; probe < cap; ++probe, h = h + 1 == cap ? 0 : h + 1) {
    const u64 prev = atomicCAS(&L->rec[h].key, 0ull, key);
    if (prev == 0ull) {
      L->rec[h].block = g_blk.linear;
      L->rec[h].thread = threadIdx.x;
      L->rec[h].unit = unit;
    }
    if (prev == 0ull || prev == key) {
      atomicAdd(&L->rec[h].count, 1u);
      return;
    }
  }
  atomicAdd(&L->overflow, 1u);
}

__device__ __forceinline__ unsigned linear_block() {
  return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}

// The block's slot, zeroed by its threads before any hook runs.
__device__ __noinline__ void begin(unsigned kid, int line) {
  if (threadIdx.x == 0) {
    unsigned total;
    asm volatile("mov.u32 %0, %%total_smem_size;" : "=r"(total));
    const u64 units = ((u64)total + 2048) / 2;
    const u64 bytes = slot_bytes(blockDim.x, units);
    const unsigned linear = linear_block();
    g_blk.kid = kid;
    g_blk.linear = linear;
    g_blk.slot_bytes = bytes;
    g_blk.nunits = (unsigned)units;
    char* base = g_table[kid];
    if (base == nullptr || (u64)(linear + 1) * bytes > g_table_bytes[kid]) {
      g_blk.slot = nullptr;
      report(kCapacity, line, 0);
    } else {
      g_blk.slot = base + (u64)linear * bytes;
      g_blk.bar = reinterpret_cast<BarRec*>(g_blk.slot + (u64)blockDim.x * sizeof(ThreadRec));
      g_blk.units = reinterpret_cast<Unit*>(reinterpret_cast<char*>(g_blk.bar) + kBarBytes);
    }
  }
  __syncthreads();
  if (g_blk.slot != nullptr) {
    u64* p = reinterpret_cast<u64*>(g_blk.slot);
    for (u64 i = threadIdx.x; i < g_blk.slot_bytes / 8; i += blockDim.x) p[i] = 0ull;
  }
  __threadfence();
  __syncthreads();
}

__device__ __forceinline__ bool unit_range(unsigned a, unsigned bytes, int line, unsigned& u0,
                                           unsigned& u1) {
  u0 = a >> 1;
  u1 = (a + bytes + 1) >> 1;
  if (u1 > g_blk.nunits) {
    report(kCapacity, line, u0);
    return false;
  }
  return true;
}

// does W hold a value ordered before thread t's accesses in epoch e?
__device__ __forceinline__ unsigned ordered_value(u64 w, unsigned t, unsigned e) {
  const unsigned k = w_kind(w);
  if (k == kDelivered) return 1;
  if (k == kWritten && (w_thread(w) == t || w_epoch(w) != e)) return 1;
  return k == kNone ? 0 : w_older(w);
}

__device__ __forceinline__ void note_read(Unit* s, unsigned t, unsigned e, unsigned c) {
  u64 r = ld(&s->r);
  for (;;) {
    const bool cur = (r & kLocal) && r_epoch(r) == e;
    if (cur && (r_thread(r) == t || (r & kMulti))) return;
    const u64 nr = cur ? (r | kMulti)
                       : ((r & (kRemote | (u64)kCM << 47)) | kLocal | (u64)t |
                          (u64)(e & kEM) << 10 | (u64)(c & kCM) << 32);
    const u64 prev = atomicCAS(&s->r, r, nr);
    if (prev == r) return;
    r = prev;
  }
}

__device__ __noinline__ void on_read(const void* p, unsigned bytes, int line) {
  if (g_blk.slot == nullptr) return;
  unsigned u0, u1;
  if (!unit_range(smem_addr(p), bytes, line, u0, u1)) return;
  ThreadRec* m = me();
  const unsigned t = threadIdx.x, e = m->epoch & kEM, c = m->cepoch & kCM;
  for (unsigned u = u0; u < u1; ++u) note_read(g_blk.units + u, t, e, c);
  __threadfence();
  for (unsigned u = u0; u < u1; ++u) {
    const u64 w = ld(&g_blk.units[u].w);
    const unsigned k = w_kind(w);
    const bool race = (k == kWritten || k == kPending) && w_thread(w) != t && w_epoch(w) == e;
    if (race)
      report(w_older(w) ? kWarRace : kRawRace, line, u);
    else if (k == kPending)
      report(kReadNotReady, line, u);
    else if (k == kDelivered && w_pos(w) > m->mb_obs)
      report(kMbarrier, line, u);
    else if (k == kDelivered && m->mb_ok && w_pos(w) > m->mb_lo &&
             !(ld(&g_blk.units[u].r) & kConsumed))
      atomicOr(&g_blk.units[u].r, kConsumed);   // this phase's own data
  }
}

// a plain store (kind kWritten) or a cp.async issue (kind kPending)
__device__ __noinline__ void on_write(const void* p, unsigned bytes, unsigned kind, int line) {
  if (g_blk.slot == nullptr) return;
  unsigned u0, u1;
  if (!unit_range(smem_addr(p), bytes, line, u0, u1)) return;
  ThreadRec* m = me();
  const unsigned t = threadIdx.x, e = m->epoch & kEM, c = m->cepoch & kCM;
  unsigned older[8];
  for (unsigned u = u0; u < u1 && u - u0 < 8; ++u) {
    u64* w = &g_blk.units[u].w;
    u64 old = ld(w), prev;
    for (;;) {
      older[u - u0] = ordered_value(old, t, e);
      prev = atomicCAS(w, old, w_make(kind, t, e, older[u - u0], c));
      if (prev == old) break;
      old = prev;
    }
    const unsigned k = w_kind(old);
    if (k == kPending) {
      report(w_thread(old) != t && w_epoch(old) == e ? kWarRace : kRestart, line, u);
    } else if (k == kWritten && w_thread(old) != t && w_epoch(old) == e) {
      report(kWarRace, line, u);
    } else if (k == kDelivered && w_cepoch(old) == c) {
      report(kDsmemRace, line, u);
    }
  }
  if (u1 - u0 > 8) report(kCapacity, line, u0);
  __threadfence();
  for (unsigned u = u0; u < u1 && u - u0 < 8; ++u) {
    const u64 r = ld(&g_blk.units[u].r);
    if ((r & kLocal) && r_epoch(r) == e && (r_thread(r) != t || (r & kMulti)))
      report(older[u - u0] ? kWarRace : kRawRace, line, u);
    if ((r & kRemote) && r_rcepoch(r) == c) report(kDsmemRace, line, u);
  }
  if (kind == kPending) {
    if (m->npend < kPend)
      m->pend[m->npend++] = u0;
    else
      report(kCapacity, line, u0);
  }
}

// cp.async.wait_all: this thread's copies land at its current epoch
__device__ __noinline__ void on_cp_wait() {
  if (g_blk.slot == nullptr) return;
  ThreadRec* m = me();
  const unsigned t = threadIdx.x, e = m->epoch & kEM;
  for (unsigned i = 0; i < m->npend; ++i)
    for (unsigned u = m->pend[i]; u < m->pend[i] + 8; ++u) {
      u64* w = &g_blk.units[u].w;
      u64 old = ld(w);
      while (w_kind(old) == kPending && w_thread(old) == t) {
        const u64 nw = w_make(kWritten, t, e, w_older(old), w_cepoch(old));
        const u64 prev = atomicCAS(w, old, nw);
        if (prev == old) break;
        old = prev;
      }
    }
  m->npend = 0;
  __threadfence();
}

// The block's expected and delivered multicast bytes: at a cluster
// barrier every byte the armed phases expect has been delivered (a fast
// peer may already deliver the next stage's), at exit exactly those.
__device__ __noinline__ void check_bar(bool at_exit, int line) {
  BarRec* b = g_blk.bar;
  const unsigned n = ld32(&b->nexp);
  if (b->addr == 0 || n == 0) return;
  const u64 got = ld(&b->delivered), want = ld(&b->cum[n - 1]);
  if (got < want || (at_exit && got != want)) report(kMbarrier, line, b->addr - 1);
}

__device__ __noinline__ void on_sync(bool cluster, int line) {
  if (g_blk.slot == nullptr) return;
  ThreadRec* m = me();
  m->epoch += 1;
  if (cluster) {
    m->cepoch += 1;
    if (threadIdx.x == 0) check_bar(false, line);
  }
}

__device__ __noinline__ void end(int line) {
  const bool cluster = cooperative_groups::this_cluster().num_blocks() > 1;
  if (cluster && g_blk.slot != nullptr) {
    // the block leaves once all its threads are here: marked first, then
    // every unit a peer read in this cluster epoch is a read that no
    // cluster barrier orders before the exit (a peer that reads later
    // finds the mark: of the two, at least one sees the other)
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicExch(&g_blk.bar->exited, 1u);
      __threadfence();
    }
    __syncthreads();
    const unsigned c = me()->cepoch & kCM;
    for (unsigned u = threadIdx.x; u < g_blk.nunits; u += blockDim.x) {
      const u64 r = ld(&g_blk.units[u].r);
      if ((r & kRemote) && r_rcepoch(r) == c) report(kDsmemRace, line, u);
    }
  }
  // a cluster's blocks leave together, after every multicast into them
  // has landed, so that a mutant that breaks the kernel's own ordering
  // (a block that stops waiting early, or leaves while a peer reads it)
  // cannot fault the card
  if (cluster) {
    cooperative_groups::this_cluster().sync();
    if (threadIdx.x == 0)
      for (int i = 0; i < 100; ++i) __nanosleep(1000);
    __syncthreads();
  }
  if (g_blk.slot == nullptr) return;
  ThreadRec* m = me();
  const unsigned t = threadIdx.x;
  for (unsigned i = 0; i < m->npend; ++i) {
    const u64 w = ld(&g_blk.units[m->pend[i]].w);
    if (w_kind(w) == kPending && w_thread(w) == t) {
      report(kInflightAtExit, line, m->pend[i]);
      break;
    }
  }
  if (t == 0) check_bar(true, line);
}

__device__ __noinline__ void on_mbar_init(const void* bar, int line) {
  if (g_blk.slot == nullptr) return;
  BarRec* b = g_blk.bar;
  const unsigned a = smem_addr(bar) + 1;
  if (b->addr == a) report(kMbarrier, line, a - 1);
  else if (b->addr != 0) report(kCapacity, line, a - 1);
  else b->addr = a;
  __threadfence();
}

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the real barrier's phase of parity `parity` completes within kSpinNs
__device__ __forceinline__ bool real_wait(unsigned raw, unsigned parity) {
  const u64 t0 = globaltimer();
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(raw), "r"(parity)
        : "memory");
  } while (!done && globaltimer() - t0 < kSpinNs);
  return done;
}

__device__ __noinline__ void on_mbar_expect(const void* bar, unsigned bytes, int line) {
  if (g_blk.slot == nullptr) return;
  // Before arming phase k the real barrier must have left phase k - 1: an
  // arrive on a phase whose arrival is spent is undefined and faults the
  // card. Where it never completed (expected and delivered bytes differ:
  // a finding) the barrier starts afresh, so that a broken kernel reports
  // instead of faulting.
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const unsigned k0 = g_blk.bar->nexp;
  if (k0 > 0 && !real_wait(raw, (k0 - 1) & 1)) {
    report(kMbarrier, line, smem_addr(bar));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(raw) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  BarRec* b = g_blk.bar;
  if (b->addr != smem_addr(bar) + 1) {
    report(kMbarrier, line, smem_addr(bar));
    return;
  }
  const unsigned k = b->nexp;
  if (k >= kPhases) {
    report(kCapacity, line, 0);
    return;
  }
  b->cum[k] = (k ? b->cum[k - 1] : 0ull) + bytes;
  __threadfence();
  b->nexp = k + 1;
  __threadfence();
}

__device__ __noinline__ void on_mbar_wait_begin(unsigned parity, int line) {
  if (g_blk.slot == nullptr) return;
  if ((parity & 1) != (me()->mb_waits & 1)) report(kMbarrier, line, 0);
}

__device__ __noinline__ void on_mbar_wait_end(const void* bar, unsigned parity, unsigned done,
                                              int line) {
  if (g_blk.slot == nullptr) return;
  ThreadRec* m = me();
  BarRec* b = g_blk.bar;
  if (!done) report(kMbarrier, line, smem_addr(bar));
  const unsigned w = m->mb_waits;
  const unsigned n = ld32(&b->nexp);
  // the phase this wait saw complete: its own on the right parity, else
  // the one before
  const bool right = done && (parity & 1) == (w & 1);
  int ph = right ? (int)w : (int)w - 1;
  if (ph >= (int)n) ph = (int)n - 1;
  m->mb_obs = ph >= 0 ? ld(&b->cum[ph]) : 0ull;
  m->mb_lo = ph >= 1 ? ld(&b->cum[ph - 1]) : 0ull;
  m->mb_ok = right && ph == (int)w;
  m->mb_waits = w + 1;
}

__device__ __forceinline__ Unit* peer_units(unsigned rank, unsigned own) {
  return reinterpret_cast<Unit*>(reinterpret_cast<char*>(g_blk.units) +
                                 ((long long)rank - (long long)own) *
                                     (long long)g_blk.slot_bytes);
}

__device__ __noinline__ void on_multicast(const void* dst, unsigned bytes, const void* bar,
                                          unsigned mask, int line) {
  if (g_blk.slot == nullptr) return;
  namespace cg = cooperative_groups;
  const unsigned own = cg::this_cluster().block_rank();
  const unsigned c = me()->cepoch & kCM;
  const unsigned a = smem_addr(dst), ba = smem_addr(bar) + 1;
  unsigned u0, u1;
  if (!unit_range(a, bytes, line, u0, u1)) return;
  for (unsigned rank = 0; rank < 16; ++rank) {
    if (!(mask >> rank & 1)) continue;
    Unit* units = peer_units(rank, own);
    BarRec* b = bar_of(units);
    if (ld32(&b->addr) != ba) {
      report(kMbarrier, line, ba - 1);
      continue;
    }
    // (the hook runs before the copy is issued, so a block that waits for
    // these bytes cannot have left yet)
    if (ld32(&b->exited)) report(kMbarrier, line, ba - 1);
    const u64 pos = atomicAdd(&b->delivered, (u64)bytes) + bytes;
    const u64 nw = (u64)kDelivered | ((pos >> 4) & 0x3fffffffull) << 2 | (u64)c << 33;
    for (unsigned u = u0; u < u1; ++u) {
      // over a stage its readers consumed in this cluster epoch
      const u64 r = ld(&units[u].r);
      if ((r & kLocal) && (r & kConsumed) && r_cepoch(r) == c)
        report(kDsmemRace, line, u);
      atomicExch(&units[u].w, nw);
    }
  }
  __threadfence();
}

// distributed shared memory: `local`'s offset in cluster rank `rank` (the
// block's own rank too: its unit is ordered the same way, but is no
// peer's read at its exit)
__device__ __noinline__ void on_read_peer(const void* local, unsigned bytes, unsigned rank,
                                          int line) {
  if (g_blk.slot == nullptr) return;
  namespace cg = cooperative_groups;
  const unsigned own = cg::this_cluster().block_rank();
  const unsigned c = me()->cepoch & kCM;
  unsigned u0, u1;
  if (!unit_range(smem_addr(local), bytes, line, u0, u1)) return;
  Unit* units = peer_units(rank, own);
  for (unsigned u = u0; u < u1 && rank != own; ++u) {
    u64 r = ld(&units[u].r);
    while (!((r & kRemote) && r_rcepoch(r) == c)) {
      const u64 nr = (r & ~((u64)kCM << 47)) | kRemote | (u64)c << 47;
      const u64 prev = atomicCAS(&units[u].r, r, nr);
      if (prev == r) break;
      r = prev;
    }
  }
  __threadfence();
  if (rank != own && ld32(&bar_of(units)->exited)) report(kDsmemRace, line, u0);
  for (unsigned u = u0; u < u1; ++u) {
    const u64 w = ld(&units[u].w);
    const unsigned d = (c - w_cepoch(w)) & kCM;
    if (w_kind(w) != kWritten || d == 0 || d > kCM / 2) report(kDsmemRace, line, u);
  }
}

__device__ __noinline__ void on_griddep(unsigned flag) {
  if (g_blk.slot != nullptr) me()->flags |= flag;
}

__device__ __noinline__ void on_dep_read(int line) {
  if (g_blk.slot != nullptr && !(me()->flags & 1)) report(kGriddepRace, line, 0);
}

template <typename P>
__device__ __forceinline__ P* rd(P* p, int line) {
  on_read(p, sizeof(P), line);
  return p;
}
template <typename P>
__device__ __forceinline__ P* wr(P* p, int line) {
  on_write(p, sizeof(P), kWritten, line);
  return p;
}
template <typename P, typename Q>
__device__ __forceinline__ P* rd_peer(P* remote, Q* local, unsigned rank, int line) {
  on_read_peer(local, sizeof(Q), rank, line);
  return remote;
}
template <typename P>
__device__ __forceinline__ P* dep(P* p, int line) {
  on_dep_read(line);
  return p;
}

// ---- host side: the tables, the log and the row-tile cap ----

struct HostTables {
  void* ptr[kShKernels];
  size_t cap[kShKernels];
};
static HostTables g_host = {};
static int g_grid_cap = 1 << 30;

inline int grid_cap(int cap) { return cap < g_grid_cap ? cap : g_grid_cap; }

// Makes kernel `kid`'s table hold `grid` blocks of `threads` threads with
// `dyn` dynamic shared bytes (a larger table is allocated, after the
// device is idle, when it does not).
template <typename K>
cudaError_t prepare(int kid, K kernel, dim3 grid, int threads, size_t dyn) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const u64 units = ((u64)attr.sharedSizeBytes + dyn + 4096) / 2;
  const size_t need = (size_t)slot_bytes(threads, units) * grid.x * grid.y * grid.z;
  if (need <= g_host.cap[kid]) return cudaSuccess;
  if ((e = cudaDeviceSynchronize()) != cudaSuccess) return e;
  if (g_host.ptr[kid] != nullptr && (e = cudaFree(g_host.ptr[kid])) != cudaSuccess) return e;
  g_host.ptr[kid] = nullptr;
  g_host.cap[kid] = 0;
  const size_t bytes = need + need / 2;
  if ((e = cudaMalloc(&g_host.ptr[kid], bytes)) != cudaSuccess) return e;
  g_host.cap[kid] = bytes;
  const u64 b = bytes;
  if ((e = cudaMemcpyToSymbol(g_table, &g_host.ptr[kid], sizeof(void*), kid * sizeof(void*))) !=
      cudaSuccess)
    return e;
  return cudaMemcpyToSymbol(g_table_bytes, &b, sizeof(b), kid * sizeof(u64));
}

inline int set_log(void* log) {
  return (int)cudaMemcpyToSymbol(g_log, &log, sizeof(void*));
}

inline int set_grid_cap(int cap) {
  g_grid_cap = cap > 0 ? cap : 1 << 30;
  return 0;
}

}  // namespace shadow

#define SHADOW_BEGIN(kernel) ::shadow::begin((kernel), __LINE__)
#define SHADOW_END() ::shadow::end(__LINE__)
#define SHADOW_SYNC() ::shadow::on_sync(false, __LINE__)
#define SHADOW_CLUSTER_SYNC() ::shadow::on_sync(true, __LINE__)
#define SHADOW_CP_ASYNC(dst, bytes) \
  ::shadow::on_write((dst), (bytes), ::shadow::kPending, __LINE__)
#define SHADOW_CP_WAIT() ::shadow::on_cp_wait()
#define SHADOW_MBAR_INIT(bar) ::shadow::on_mbar_init((bar), __LINE__)
#define SHADOW_MBAR_EXPECT(bar, bytes) ::shadow::on_mbar_expect((bar), (bytes), __LINE__)
#define SHADOW_MBAR_WAIT_BEGIN(bar, parity)            \
  ::shadow::on_mbar_wait_begin((parity), __LINE__); \
  const ::shadow::u64 shadow_t0 = ::shadow::globaltimer()
#define SHADOW_SPIN_ON &&::shadow::globaltimer() - shadow_t0 < ::shadow::kSpinNs
#define SHADOW_MBAR_WAIT_END(bar, parity, done) \
  ::shadow::on_mbar_wait_end((bar), (parity), (done), __LINE__)
#define SHADOW_MULTICAST(dst, bytes, bar, mask) \
  ::shadow::on_multicast((dst), (bytes), (bar), (mask), __LINE__)
#define SHADOW_GRIDDEP_LAUNCH() ::shadow::on_griddep(2u)
#define SHADOW_GRIDDEP_WAIT() ::shadow::on_griddep(1u)
#define SHADOW_RD_BYTES(p, bytes) ::shadow::on_read((p), (bytes), __LINE__)
#define SH_RD(p) (*::shadow::rd((p), __LINE__))
#define SH_WR(p) (*::shadow::wr((p), __LINE__))
#define SH_RD_PEER(remote, local, rank) (*::shadow::rd_peer((remote), (local), (rank), __LINE__))
#define SH_DEP(p) (::shadow::dep((p), __LINE__))
#define SHADOW_GRID_CAP(cap) (::shadow::grid_cap(cap))
#define SHADOW_PREPARE(kernel_id, kernel, grid, threads, dyn_smem)                          \
  do {                                                                                       \
    const cudaError_t shadow_err =                                                           \
        ::shadow::prepare((kernel_id), (kernel), (grid), (threads), (size_t)(dyn_smem));     \
    if (shadow_err != cudaSuccess) return (int)shadow_err;                                   \
  } while (0)
#define SHADOW_EXPORTS(name)                                                                 \
  extern "C" int name##_shadow_log(void* log) { return ::shadow::set_log(log); }            \
  extern "C" int name##_shadow_grid_cap(int cap) { return ::shadow::set_grid_cap(cap); }

#endif  // REPRO_SHADOW
