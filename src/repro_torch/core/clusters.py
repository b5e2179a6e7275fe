"""Neuron-cluster math (PowerInfer-2 §3.1).

A *neuron* is one FFN row-bundle (gate/up rows + down column — the
paper's §4.4 Gate-Up-Down bundle). A *neuron cluster* is `cluster_size`
consecutive neurons after the planner's frequency permutation; cluster
size is set by the config (64 for smollm-135m; reduced in smoke tests).

The hot/cold split is a static prefix split over the permuted neuron
dim: [0, n_hot) = hot clusters (dense engine), [n_hot, N) = cold
clusters (predictor-gated gathered engine).
"""
from __future__ import annotations

from dataclasses import dataclass


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def round_down(n: int, m: int) -> int:
    return (n // m) * m


@dataclass(frozen=True)
class HybridPlan:
    """Static decode-path plan for one (batch-size bucket, layer kind).

    The paper swaps pre-built NPU graphs per batch bucket; we swap
    decode callables keyed by this plan (core/adaptation.py).
    Cold selection/gather is *cluster*-granular: `k_cold` neurons =
    (k_cold // cluster_size) clusters per group.
    """
    n_hot: int             # dense hot prefix (neurons)
    k_cold: int            # gathered cold budget per group (neurons)
    groups: int = 1        # neuron-dim shards (mesh model-axis size)
    backend: str = "jnp"   # 'jnp' | 'pallas'
    cluster_size: int = 128
    # Two-level MoE sparsity (intra-expert hot/cold, DESIGN.md §9):
    # per-expert hot prefix rows (0 = whole-expert MoE or dense plan)
    # and the pinned resident prefix when it differs from the per-step
    # hot compute — every routed expert's hot prefix stays resident
    # while only the activated experts compute theirs, so
    # n_hot = shared + n_act*n_expert_hot prices compute and
    # n_pinned = shared + E*n_expert_hot sizes residency.
    n_expert_hot: int = 0
    n_pinned: int = 0
    # On-storage dtype of the *cold* bundles (§7.6 hybrid quantization):
    # 'fp16' | 'int8' | 'int4-mixed'. The hot/pinned prefix always stays
    # fp (the paper keeps dense-activation weights high-precision on the
    # NPU); the storage plane prices cold I/O and residency at this
    # dtype and prepare_params quantizes the cold rows to match.
    storage_dtype: str = "fp16"

    @property
    def total_cold(self) -> int:
        return self.k_cold * self.groups

    @property
    def clusters_per_group(self) -> int:
        return self.k_cold // self.cluster_size

    @property
    def resident_hot(self) -> int:
        """Pinned resident hot prefix (neurons): n_pinned for two-level
        MoE plans, otherwise the computed hot prefix itself."""
        return self.n_pinned or self.n_hot


def make_plan(n_neurons: int, hot_ratio: float, cold_active_ratio: float,
              cluster_size: int, groups: int = 1,
              backend: str = "jnp",
              storage_dtype: str = "fp16") -> HybridPlan:
    """Build a hybrid plan with cluster- and group-aligned sizes.

    The cold suffix (n_neurons - n_hot) must be a multiple of
    groups*cluster_size so each mesh shard owns whole clusters; any
    remainder is absorbed into the hot prefix (dense is always safe).
    """
    align = cluster_size * groups
    n_cold = round_down(int(n_neurons * (1.0 - hot_ratio)), align)
    n_hot = n_neurons - n_cold
    k_total = round_down(int(n_cold * cold_active_ratio), align)
    k_total = max(k_total, align) if n_cold >= align else 0
    return HybridPlan(n_hot=n_hot, k_cold=k_total // groups,
                      groups=groups, backend=backend,
                      cluster_size=cluster_size,
                      storage_dtype=storage_dtype)


def scale_plan_for_batch(base: HybridPlan, n_neurons: int, batch: int,
                         cluster_size: int) -> HybridPlan:
    """Sparsity-aware adaptation (§4.1.3): larger effective batch ->
    denser activation union -> larger hot share, smaller cold budget.

    Mirrors the paper's measurement (Fig 2): hot share grows from the
    base ratio at batch 1 toward ~70% at batch >= 32; beyond that the
    union saturates and everything moves to the dense engine.
    """
    import math
    base_ratio = base.n_hot / max(n_neurons, 1)
    # log-linear ramp from base_ratio (b=1) to 0.7 (b=32), capped.
    t = min(math.log2(max(batch, 1)) / 5.0, 1.0)
    hot_ratio = base_ratio + (0.7 - base_ratio) * t
    cold_ratio = (base.total_cold / max(n_neurons - base.n_hot, 1)) * (1.0 + t)
    return make_plan(n_neurons, hot_ratio, min(cold_ratio, 1.0),
                     cluster_size, base.groups, base.backend,
                     storage_dtype=base.storage_dtype)
