"""Neuron-cluster-level pipeline (paper §4.3, Fig 6).

Two parts:

1. A deterministic discrete-event simulator comparing the two pipeline
   policies of Fig 6 — `matrix` (barrier between matrices: compute may
   only run clusters of the lowest incomplete matrix) and `cluster`
   (PowerInfer-2: no barrier; compute immediately moves to any ready
   cluster of any matrix). Driven by measured compute times + the
   StorageModel's I/O times; reproduces the paper's bubble-elimination
   claim and Table 4's compute/I-O split.

2. A real async prefetch executor: ONE I/O thread (the paper pins a
   single I/O core because UFS has a single command queue; the host-DMA
   analogue keeps one stream) overlapping host->device fetches with
   compute in the serving engine.
"""
from __future__ import annotations

import heapq
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass


# ------------------------------------------------- discrete-event sim ----

@dataclass(frozen=True)
class ClusterTask:
    matrix: int           # which matrix (Gate/Up/Down of layer l, ...)
    cluster: int          # index within the matrix
    comp_time: float      # seconds of compute
    io_time: float = 0.0  # seconds of I/O (0 = already in memory)


@dataclass
class PipelineResult:
    makespan: float
    compute_busy: float       # summed busy seconds across workers
    io_busy: float
    n_workers: int
    policy: str

    @property
    def compute_util(self) -> float:
        return self.compute_busy / (self.makespan * self.n_workers)

    @property
    def io_fraction(self) -> float:
        """Fraction of the critical path attributable to I/O stalls
        (Table 2/4 style: 1 - compute share of wall time)."""
        per_worker = self.compute_busy / self.n_workers
        return max(0.0, 1.0 - per_worker / self.makespan)


def _greedy_compute(tasks, ready, workers, floor=0.0):
    """List-schedule tasks on workers; each task starts at
    max(ready[task], worker_free, floor). Returns (busy, completion).

    Each round picks the task minimizing (start, matrix, cluster) with
    start = max(ready, earliest-free worker, floor) and assigns it to
    that worker. Two heaps — tasks keyed by ready time and workers
    keyed by free time — make each pick O(log n) instead of the naive
    rescan of all pending tasks (O(n^2 * W) overall); the schedule, and
    therefore the makespan, is identical.
    """
    busy = 0.0
    last = floor
    future = []            # (ready_time, matrix, cluster, task)
    for t in tasks:
        r = max(ready[(t.matrix, t.cluster)], floor)
        future.append((r, t.matrix, t.cluster, t))
    heapq.heapify(future)
    avail = []             # ready now: (matrix, cluster, task)
    wheap = list(workers)
    heapq.heapify(wheap)
    while future or avail:
        wfree = heapq.heappop(wheap)
        now = max(wfree, floor)
        while future and future[0][0] <= now:
            _, m, c, t = heapq.heappop(future)
            heapq.heappush(avail, (m, c, t))
        if avail:
            _, _, task = heapq.heappop(avail)
            start = now
        else:                       # idle until the next task is ready
            start, _, _, task = heapq.heappop(future)
        end = start + task.comp_time
        heapq.heappush(wheap, end)
        busy += task.comp_time
        last = max(last, end)
    workers[:] = wheap              # free-time multiset for the caller
    return busy, last


def simulate_pipeline(tasks, n_compute: int = 4,
                      policy: str = "cluster") -> PipelineResult:
    """Simulate compute workers + ONE I/O worker (single UFS queue).

    policy='matrix'  — Fig 6(a): isolated matrix units. I/O for matrix
                       m's missing clusters only *starts* once matrix
                       m-1 has fully computed, and compute may only run
                       the current matrix's clusters.
    policy='cluster' — Fig 6(b): PowerInfer-2. The I/O thread streams
                       misses ahead in matrix order; compute takes any
                       ready cluster from any matrix (no barrier).
    """
    assert policy in ("matrix", "cluster")
    tasks = sorted(tasks, key=lambda t: (t.matrix, t.cluster))
    n_matrices = max(t.matrix for t in tasks) + 1 if tasks else 0
    io_busy = sum(t.io_time for t in tasks)
    workers = [0.0] * n_compute

    if policy == "cluster":
        # I/O issued serially ahead of compute, in matrix order
        ready = {}
        t_io = 0.0
        for t in tasks:
            if t.io_time > 0:
                t_io += t.io_time
                ready[(t.matrix, t.cluster)] = t_io
            else:
                ready[(t.matrix, t.cluster)] = 0.0
        busy, makespan = _greedy_compute(tasks, ready, workers)
        return PipelineResult(makespan=makespan, compute_busy=busy,
                              io_busy=io_busy, n_workers=n_compute,
                              policy=policy)

    # matrix policy: strict per-matrix units for both I/O and compute
    compute_busy = 0.0
    t_prev = 0.0       # completion time of the previous matrix
    io_free = 0.0
    for m in range(n_matrices):
        unit = [t for t in tasks if t.matrix == m]
        ready = {}
        io_free = max(io_free, t_prev)
        for t in unit:
            if t.io_time > 0:
                io_free += t.io_time
                ready[(t.matrix, t.cluster)] = io_free
            else:
                ready[(t.matrix, t.cluster)] = t_prev
        busy, t_prev = _greedy_compute(unit, ready, workers, floor=t_prev)
        compute_busy += busy
    return PipelineResult(makespan=t_prev, compute_busy=compute_busy,
                          io_busy=io_busy, n_workers=n_compute,
                          policy="matrix")


def make_decode_tasks(n_matrices: int, clusters_per_matrix: int,
                      in_memory_fraction: float, comp_time: float,
                      io_time: float, seed: int = 0):
    """Build a Fig-6-style workload: a fraction of clusters is cached,
    the rest need random I/O."""
    import random
    rng = random.Random(seed)
    tasks = []
    for m in range(n_matrices):
        for c in range(clusters_per_matrix):
            cached = rng.random() < in_memory_fraction
            tasks.append(ClusterTask(m, c, comp_time,
                                     0.0 if cached else io_time))
    return tasks


# ------------------------------------------------ async prefetcher ----

class PrefetchExecutor:
    """Single I/O thread overlapping cold-store fetches with compute.

    submit() returns a Future; the serving engine submits layer l+1's
    predicted-miss fetches before computing layer l (the cluster-level
    pipeline: compute of one matrix overlaps I/O of the next).
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="neuron-io")

    def submit(self, fn, *args, **kwargs):
        return self._pool.submit(fn, *args, **kwargs)

    def shutdown(self):
        self._pool.shutdown(wait=True)
