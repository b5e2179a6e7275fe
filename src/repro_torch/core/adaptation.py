"""Dynamic CPU/NPU-ratio adaptation (paper §4.1.3).

PowerInfer-2 pre-builds one NPU graph per (batch size, hot ratio) and
swaps them as the live batch changes; the reference keeps one jitted
decode executable per batch bucket. Here a bucket's entry is its decode
step bound to that bucket's plan and, on a CUDA card, that step captured
once in a `torch.cuda.CUDAGraph` (`GraphedStep`): one replay launches the
whole step (embed, every layer, logits, the cluster-id trace), where the
eager step pays the host's launch work for each of its thousands of
kernels. The graph reads static buffers (the engine's token and mask
buffers and the KV arena's views, which never move) and writes static
outputs that the caller copies out before the next replay. On the CPU,
or with graphs turned off, the entry is the eager step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from repro_torch import obs
from repro_torch.core.clusters import HybridPlan
from repro_torch.core.planner import ExecutionPlan
from repro_torch.kernels import ops

# the serving bucket ladder
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def bucket_for(batch: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if batch <= b:
            return b
    return buckets[-1]


def stepped_plan(plan_source: ExecutionPlan, batch: int, buckets,
                 backend: str = None) -> HybridPlan:
    """The plan a step of `batch` live rows runs: its bucket's, with the
    cold-path backend overridden when `backend` is given."""
    plan = plan_source.plan_for_batch(bucket_for(batch, buckets))
    if backend and plan.backend != backend:
        plan = dataclasses.replace(plan, backend=backend)
    return plan


def _minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


class GraphedStep:
    """One bucket's decode step, captured in a CUDA graph at first use.

    `capture` first runs the step once eagerly on a side stream over
    scratch copies of the cache: the first use builds the kernel library
    and sets up cuBLAS there, outside the capture, and no live request's
    KV state advances. It then captures the step on the given buffers,
    on the same stream, into the decoder's shared memory pool. Neither
    pass is a decode step, so the kernel wrappers' `launches` counts are
    put back as they were (`warmup_launches` keeps the warm-up's, by
    wrapper name); each replay adds the launches the capture recorded.
    A call replays on the buffers of the capture and raises if given
    others (a rebuilt arena needs `reset` and a new capture). A failed
    capture or replay raises: nothing falls back to the eager step."""

    def __init__(self, step: Callable, pool: Callable[[], tuple]):
        self.step = step
        self._pool = pool
        self.captures = 0
        self.reset()

    def reset(self):
        self.graph = None
        self.logits = self.cidx = self._bound = None
        self.launches = self.warmup_launches = {}

    @staticmethod
    def _buffers(tokens, cache, mask):
        return tuple((t.data_ptr(), tuple(t.shape))
                     for t in (tokens, mask, *cache.values()))

    def capture(self, model, tokens, cache, mask):
        if tokens.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA buffers, not "
                             f"{tokens.device}")
        with obs.always("decoder.capture"):
            counts = ops.launch_counts()
            current = torch.cuda.current_stream(tokens.device)
            side = torch.cuda.Stream(tokens.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                scratch = {k: v.clone() for k, v in cache.items()}
                self.step(model, tokens, scratch, mask)
            current.wait_stream(side)
            del scratch
            warm = ops.launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool(), stream=side):
                logits, _, cidx = self.step(model, tokens, cache, mask)
            self.warmup_launches = _minus(warm, counts)
            self.launches = _minus(ops.launch_counts(), warm)
            ops.set_launch_counts(counts)
            self.graph, self.logits, self.cidx = graph, logits, cidx
            self._bound = self._buffers(tokens, cache, mask)
            self.captures += 1

    def __call__(self, model, tokens, cache, mask):
        if self.graph is None:
            self.capture(model, tokens, cache, mask)
        elif self._buffers(tokens, cache, mask) != self._bound:
            raise RuntimeError("the step's buffers moved since its CUDA "
                               "graph was captured; reset it first")
        self.graph.replay()
        ops.set_launch_counts({k: n + self.launches[k]
                               for k, n in ops.launch_counts().items()})
        return self.logits, cache, self.cidx


@dataclass
class BucketedDecoder:
    """Decode steps per batch bucket.

    make_step(plan) returns a decode callable (model, tokens, cache,
    active_mask) -> (logits, cache, trace) specialized to the plan; it
    is built once per bucket and cached (the paper's pre-generated NPU
    graph table, §5 Batch-Adaptive Planning). With `graphs`, each
    bucket's entry is a `GraphedStep`, captured at the bucket's first
    use; every bucket captures into one memory pool, which is safe
    because buckets replay one at a time and the caller copies the
    outputs out before the next replay. `inputs(b)` gives the static
    inputs (model, tokens, cache, active_mask) of bucket b, for
    `prewarm`.

    `backend` ('jnp' | 'pallas' | None) overrides each bucket plan's
    cold-path backend: every entry in the table runs the chosen path,
    whatever backend the offline planner wrote into the plans.
    """
    plan_source: ExecutionPlan
    make_step: Callable[[HybridPlan], Callable]
    buckets: tuple = DEFAULT_BUCKETS
    backend: str = None
    graphs: bool = False
    inputs: Optional[Callable[[int], tuple]] = None
    _cache: Dict[int, tuple] = field(default_factory=dict)
    switches: int = 0
    _last_key: Optional[int] = None
    _pool: Optional[tuple] = None

    def graph_pool(self) -> tuple:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def prewarm(self):
        """Build every bucket's entry; with graphs, capture each one on
        `inputs(b)`."""
        for b in self.buckets:
            _, fn = self.executable_for(b)
            if self.graphs and fn.graph is None:
                if self.inputs is None:
                    raise RuntimeError("prewarm captures on the engine's "
                                       "buffers: none are bound yet")
                fn.capture(*self.inputs(b))

    def executable_for(self, batch: int):
        b = bucket_for(batch, self.buckets)
        if b not in self._cache:
            plan = stepped_plan(self.plan_source, b, self.buckets,
                                self.backend)
            step = self.make_step(plan)
            if self.graphs:
                step = GraphedStep(step, self.graph_pool)
            self._cache[b] = (plan, step)
        if b != self._last_key:
            self.switches += 1
            self._last_key = b
        return self._cache[b]

    def drop_graphs(self):
        """Forget every captured graph (the buffers they read are gone);
        each bucket captures again at its next use, into a new pool."""
        for _, fn in self._cache.values():
            if isinstance(fn, GraphedStep):
                fn.reset()
        self._pool = None

    def live_plans(self):
        return {b: p for b, (p, _) in self._cache.items()}


@dataclass
class BatchTracker:
    """Tracks live decoding sequences (Best-of-N / continuous batching):
    the *effective* batch size falls as sequences hit EOS (paper Fig 13)."""
    active: int = 0
    history: list = field(default_factory=list)

    def start(self, n: int = 1):
        self.active += n
        self.history.append(self.active)

    def finish(self, n: int = 1):
        self.active = max(0, self.active - n)
        self.history.append(self.active)
