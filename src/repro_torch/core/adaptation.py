"""Dynamic CPU/NPU-ratio adaptation (paper §4.1.3).

PowerInfer-2 pre-builds one NPU graph per (batch size, hot ratio) and
swaps them as the live batch changes. The reference keeps one jitted
decode executable per batch bucket; PyTorch runs eagerly, so here the
table holds one decode callable per bucket, bound to that bucket's plan.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict

from repro_torch.core.clusters import HybridPlan
from repro_torch.core.planner import ExecutionPlan

# the serving bucket ladder
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def bucket_for(batch: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if batch <= b:
            return b
    return buckets[-1]


@dataclass
class BucketedDecoder:
    """Decode callables per batch bucket.

    make_step(plan) returns a decode callable specialized to the plan;
    it is built once per bucket and cached (the paper's pre-generated
    NPU graph table, §5 Batch-Adaptive Planning).

    `backend` ('jnp' | 'pallas' | None) overrides each bucket plan's
    cold-path backend: every callable in the table runs the chosen path,
    whatever backend the offline planner wrote into the plans.
    """
    plan_source: ExecutionPlan
    make_step: Callable[[HybridPlan], Callable]
    buckets: tuple = DEFAULT_BUCKETS
    backend: str = None
    _cache: Dict[int, tuple] = field(default_factory=dict)

    def executable_for(self, batch: int):
        b = bucket_for(batch, self.buckets)
        if b not in self._cache:
            plan = self.plan_source.plan_for_batch(b)
            if self.backend and plan.backend != self.backend:
                plan = dataclasses.replace(plan, backend=self.backend)
            self._cache[b] = (plan, self.make_step(plan))
        return self._cache[b]

    def live_plans(self):
        return {b: p for b, (p, _) in self._cache.items()}
