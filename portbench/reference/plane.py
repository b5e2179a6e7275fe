"""The storage plane's pricing, replayed over the recorded steps.

An independent, plain implementation of what PowerInfer-2's storage
plane charges one decode step on the modeled phone (dense family, one
device, the PowerInfer-2 system: predictor, bundled two-phase reads, a
neuron cache with a pinned hot prefix, the cluster pipeline, hybrid
engines), fed the step's cluster-id trace, its batch and its mean
context. It keeps its own LRU state from the plane's creation, so it is
replayed over every step the engine ran, warm-up included.

Pricing, as the paper models it:
* compute: hot neurons on the dense engine and picked cold neurons on
  the sparse one, overlapped (the slower sets the time), plus attention
  on the dense engine;
* cache: the cold neurons of the picked clusters are looked up in one
  LRU over (layer, neuron) holding `(1 - offload) * N / 2`-ish neurons a
  layer, pre-warmed with the most frequent cold neurons; misses are
  admitted;
* I/O: each layer's misses read as bundles in one random read of the
  UFS 4.0 curve, two-phase (the gate third always, up and down for the
  80% whose gate fires, drawn from a generator seeded by the layer);
* pipeline: per layer, as many cluster tasks as picked clusters, the
  first `misses // cs` of them waiting for their share of the layer's
  I/O, which one I/O queue serves in layer order; four compute workers
  take the ready task of the lowest (layer, cluster).
"""
from __future__ import annotations

import numpy as np

from portbench.reference.plan import BucketPlan

# UFS 4.0 random-read throughput (bytes per read -> MB/s), paper §2.3.2
UFS40_RANDOM = ((4096, 1000.0), (8192, 1100.0), (24576, 1900.0),
                (65536, 2400.0), (524288, 3500.0))
GATE_FIRES = 0.8          # two-phase loading: share of gates that fire
WORKERS = 4               # compute workers of the cluster pipeline
FIELDS = ("compute_s", "io_s", "effective_s", "cache_hit_rate", "n_miss",
          "batch")


def _interp(points, x):
    xs = [p[0] for p in points]
    if x <= xs[0]:
        return points[0][1]
    if x >= xs[-1]:
        return points[-1][1]
    i = int(np.searchsorted(xs, x))
    (x0, y0), (x1, y1) = points[i - 1], points[i]
    return y0 + (x - x0) / (x1 - x0) * (y1 - y0)


def random_read_s(nbytes: int, block: int) -> float:
    if nbytes <= 0:
        return 0.0
    return nbytes / (_interp(UFS40_RANDOM, block) * 1e6)


def makespan(tasks) -> float:
    """List schedule of (layer, cluster, compute_s, ready_s) tasks on
    WORKERS workers: the earliest free worker takes the ready task of the
    lowest (layer, cluster), or waits for the task that is ready first."""
    pending = sorted(tasks, key=lambda t: (t[0], t[1]))
    free = [0.0] * WORKERS
    last = 0.0
    while pending:
        w = int(np.argmin(free))
        now = free[w]
        ready = [t for t in pending if t[3] <= now]
        if ready:
            task, start = ready[0], now
        else:
            task = min(pending, key=lambda t: (t[3], t[0], t[1]))
            start = task[3]
        pending.remove(task)
        free[w] = start + task[2]
        last = max(last, free[w])
    return last


class PlaneReplay:
    """The plane's state and pricing. `m` is the configuration's model,
    `rows` the bundle's rows, `plan1` the batch-1 bucket's plan (it sizes
    the pinned prefix and the cache's warm set), `hw` the phone."""

    def __init__(self, m: dict, rows: int, plan1: BucketPlan, hw: dict,
                 offload_ratio: float):
        self.m, self.hw, self.rows = m, hw, rows
        L, N, D = m["num_layers"], m["d_ff"], m["d_model"]
        self.L, self.N, self.cs = L, N, plan1.cs
        self.bundle = rows * D * 2        # fp16 cold bundles on storage
        resident = int(N * (1.0 - offload_ratio))
        hot_cap = (resident // 2) // self.cs * self.cs
        n_pinned = min(plan1.n_hot, max(hot_cap, self.cs))
        per_layer = min(max(resident - n_pinned, self.cs),
                        max(N - n_pinned, self.cs))
        self.capacity = max(per_layer * L, self.cs)
        # LRU over (layer, neuron): each entry's last use (-1: absent),
        # and the log of uses in order, which eviction walks from its
        # oldest end, skipping uses a later one superseded
        self.clock = self.live = 0
        self.stamp = np.full(L * N, -1, np.int64)
        self.log, self.head, self.off = [], 0, 0
        warm = per_layer * L // L
        for l in range(L):
            self._use(l, np.arange(n_pinned, min(n_pinned + warm, N)))
        self._evict()

    def _use(self, l, ids):
        keys = l * self.N + np.asarray(ids, np.int64)
        self.live += int((self.stamp[keys] < 0).sum())
        self.stamp[keys] = np.arange(self.clock, self.clock + len(keys))
        self.log.append((keys, self.clock))
        self.clock += len(keys)

    def _evict(self):
        over = self.live - self.capacity
        while over > 0:
            keys, start = self.log[self.head]
            seg = keys[self.off:]
            valid = np.flatnonzero(
                self.stamp[seg] == start + self.off + np.arange(len(seg)))
            take = valid[:over]
            self.stamp[seg[take]] = -1
            over -= len(take)
            self.live -= len(take)
            if over > 0:
                self.log[self.head] = None
                self.head, self.off = self.head + 1, 0
            else:
                self.off += int(take[-1]) + 1

    def _compute_s(self, p: BucketPlan, batch: int, ctx: float) -> float:
        m, hw = self.m, self.hw
        D, H, KV, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], \
            m["d_head"]
        per_neuron = 2 * self.rows * D
        hot = p.n_hot * 1.0 * per_neuron
        cold = p.kc * p.cs * p.groups * 1.0 * per_neuron
        attn = (4 * H * dh * ctx + 4 * D * (H + 2 * KV) * dh) * self.L \
            * batch * 1.0
        t_ffn = max(hot / hw["dense_flops"],
                    cold / hw["sparse_flops"]) * self.L * batch
        return t_ffn + attn / hw["dense_flops"]

    def step(self, trace, p: BucketPlan, batch: int, ctx: float) -> dict:
        """TokenStats fields of one step; trace (L, G, kc) cluster ids."""
        L, N, cs = self.L, self.N, self.cs
        comp = self._compute_s(p, batch, ctx)
        hits = misses_total = 0
        tasks, t_io, io_raw = [], 0.0, 0.0
        nc_g = max((N - p.n_hot) // cs // p.groups, 1)
        for l in range(L):
            tr = np.asarray(trace[l]).reshape(p.groups, -1)
            clusters = np.unique(tr + np.arange(p.groups)[:, None] * nc_g)
            ids = (p.n_hot + clusters[:, None] * cs
                   + np.arange(cs)[None]).reshape(-1)
            ids = ids[ids < N]
            hit = self.stamp[l * N + ids] >= 0
            miss = ids[~hit]
            hits += int(hit.sum())
            misses_total += len(miss)
            # hits are touched first, in id order, then misses admitted
            self._use(l, ids[hit])
            self._use(l, miss)
            self._evict()
            io = 0.0
            if len(miss):
                fires = np.random.default_rng(l).random(len(miss)) \
                    < GATE_FIRES
                nbytes = int(self.bundle / self.rows * len(miss)
                             + self.bundle * (self.rows - 1) / self.rows
                             * fires.sum() * 1.0)
                io = random_read_s(nbytes, min(24576, self.bundle)) * 1.0
            io_raw += io
            n_miss_c = len(miss) // cs
            n_c = max(len(ids) // cs, 1)
            comp_c = comp / L / n_c
            io_c = io / max(n_miss_c, 1) if io else 0.0
            for c in range(n_c):
                if c < n_miss_c and io_c > 0:
                    t_io += io_c
                    ready = t_io
                else:
                    ready = 0.0
                tasks.append((l, c, comp_c, ready))
        seen = hits + misses_total
        return dict(compute_s=comp, io_s=io_raw, effective_s=makespan(tasks),
                    cache_hit_rate=1.0 if seen == 0 else hits / seen,
                    n_miss=misses_total, batch=batch)
