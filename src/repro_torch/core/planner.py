"""Offline execution planner (paper §5), numpy part.

Counterpart of `repro/core/planner.py` for the classify -> plan half:
`classify_neurons` sorts neurons by activation frequency into a
hot-first permutation and sizes the hot prefix per batch-size bucket
(the batch-b activation probability of a neuron with per-token
frequency f is 1-(1-f)^b, the Fig 2 union effect), capped by I/O-aware
sizing; `build_plan` emits an ExecutionPlan. Plans save and load in the
reference's JSON, so a plan the JAX package saved loads here.

Activation profiling and predictor calibration are a later slice; until
then plans come from `synthetic_frequencies` or from a saved plan.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, asdict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusters import HybridPlan, make_plan


@dataclass(frozen=True)
class HardwareProfile:
    """Target-device characteristics consumed by the planner. No
    defaults: every profile names its device."""
    name: str
    seq_bw: float                  # bytes/s sequential (slow-tier read)
    rand_bw: float                 # bytes/s random
    attn_time_s: float             # per-layer attention time (prefetch window)
    dense_engine_flops: float      # dense (NPU) engine
    sparse_engine_flops: float     # gathered (CPU) path effective


# The paper's device (OnePlus 12, Snapdragon 8 Gen 3 + UFS 4.0).
# NPU ~11 TFLOP/s effective (§2.3.1: 770 tok/s prefill on a 7B ~ 2*7G*770);
# 6 CPU cores ~60 GFLOP/s fp16 NEON (12 tok/s in-memory decode on ~3B
# active params).
PHONE = HardwareProfile(
    name="snapdragon-8gen3",
    seq_bw=4e9, rand_bw=1e9, attn_time_s=2e-3,
    dense_engine_flops=11e12, sparse_engine_flops=60e9)


@dataclass
class ExecutionPlan:
    arch: str
    n_neurons: int
    cluster_size: int
    # hot-first neuron permutation per layer, (L, N) int32
    neuron_order: np.ndarray
    # per-token activation frequency per layer, (L, N) float32 (permuted)
    frequencies: np.ndarray
    # batch-bucket -> HybridPlan
    plans: dict
    hardware: HardwareProfile

    def plan_for_batch(self, batch: int) -> HybridPlan:
        buckets = sorted(self.plans)
        for b in buckets:
            if batch <= b:
                return self.plans[b]
        return self.plans[buckets[-1]]

    def save(self, path):
        obj = {
            "arch": self.arch, "n_neurons": self.n_neurons,
            "cluster_size": self.cluster_size,
            "neuron_order": self.neuron_order.tolist(),
            "frequencies": self.frequencies.tolist(),
            "plans": {str(b): asdict(p) for b, p in self.plans.items()},
            "hardware": asdict(self.hardware),
        }
        with open(path, "w") as f:
            json.dump(obj, f)

    @staticmethod
    def load(path) -> "ExecutionPlan":
        with open(path) as f:
            obj = json.load(f)
        return ExecutionPlan(
            arch=obj["arch"], n_neurons=obj["n_neurons"],
            cluster_size=obj["cluster_size"],
            neuron_order=np.asarray(obj["neuron_order"], np.int32),
            frequencies=np.asarray(obj["frequencies"], np.float32),
            plans={int(b): HybridPlan(**p) for b, p in obj["plans"].items()},
            hardware=HardwareProfile(**obj["hardware"]),
        )


def synthetic_frequencies(cfg: ModelConfig, seed: int = 0,
                          zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-shaped activation frequencies (the paper's Fig 2 skew: <1% of
    neurons are hot at batch 1, hot spots dominate)."""
    rng = np.random.default_rng(seed)
    L, N = cfg.num_layers, max(cfg.d_ff, 1)
    rank = np.arange(1, N + 1, dtype=np.float64)
    base = 1.0 / rank ** zipf_a
    base = base / base.max() * 0.95
    freqs = np.stack([rng.permutation(base) for _ in range(L)])
    return freqs.astype(np.float32)


def classify_neurons(freqs: np.ndarray, cfg: ModelConfig,
                     hw: HardwareProfile,
                     batch_buckets=(1, 2, 4, 8, 16, 32),
                     groups: int = 1, backend: str = "jnp",
                     storage_dtype: str = "fp16"):
    """freqs (L, N) per-token activation frequency -> (order, plans).

    Hot threshold: union activation probability at the bucket's batch
    size exceeds 0.5. I/O cap: the hot prefix must be prefetchable
    within one attention block at sequential bandwidth.
    """
    L, N = freqs.shape
    # numpy's default (unstable) argsort, as the reference: the same
    # routine gives the same neuron_order, ties included
    order = np.argsort(-freqs, axis=1).astype(np.int32)     # hot-first
    sorted_f = np.take_along_axis(freqs, order, axis=1)
    mean_f = sorted_f.mean(axis=0)                          # (N,) layer-avg

    sc = cfg.sparse_ffn
    io_cap = hot_io_cap(cfg, hw, storage_dtype)

    plans = {}
    for b in batch_buckets:
        union = 1.0 - (1.0 - mean_f) ** b
        n_hot = int((union > 0.5).sum())
        n_hot = min(n_hot, io_cap, N)
        hot_ratio = n_hot / N
        # cold budget: expected active cold fraction at this batch size
        cold_union = union[n_hot:] if n_hot < N else np.array([0.0])
        cold_ratio = float(np.clip(cold_union.mean() * 2.0, 0.02, 1.0))
        plans[b] = make_plan(N, hot_ratio, cold_ratio, sc.cluster_size,
                             groups=groups, backend=backend,
                             storage_dtype=storage_dtype)
    return order, np.ascontiguousarray(sorted_f), plans


def _bundle_bytes(cfg: ModelConfig, storage_dtype: str = "fp16") -> int:
    from repro_torch.core.sparse_ffn import ffn_rows
    from repro_torch.quant.quantize import bundle_nbytes
    R = ffn_rows(cfg.activation)
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return bundle_nbytes(cfg.d_model, storage_dtype, rows=R,
                         itemsize=itemsize)


def hot_io_cap(cfg: ModelConfig, hw: HardwareProfile,
               storage_dtype: str = "fp16") -> int:
    """I/O-aware hot-prefix cap (§5 "carefully balances"): the pinned
    hot region must be prefetchable within one attention block at
    sequential bandwidth."""
    return int(hw.seq_bw * hw.attn_time_s
               / max(_bundle_bytes(cfg, storage_dtype), 1))


@torch.no_grad()
def permute_ffn_params(model, order: np.ndarray):
    """Reorder each layer's FFN bundle rows (and predictor columns)
    hot-first, matching the plan. Updates `model`'s parameters in place
    (no second copy of the FFN weights) and returns the model."""
    for l, layer in enumerate(model.layers):
        ffn = layer.ffn
        idx = torch.from_numpy(np.asarray(order[l], np.int64)).to(
            ffn.w.device)
        ffn.w.copy_(ffn.w.index_select(0, idx))
        if ffn.pred_B is not None:
            ffn.pred_B.copy_(ffn.pred_B.index_select(1, idx))
    return model


def build_plan(cfg: ModelConfig, freqs: np.ndarray = None, *,
               hw: HardwareProfile, groups: int = 1,
               backend: str = "jnp",
               storage_dtype: str = "fp16") -> ExecutionPlan:
    if freqs is None:
        freqs = synthetic_frequencies(cfg)
    order, sorted_f, plans = classify_neurons(freqs, cfg, hw,
                                              groups=groups, backend=backend,
                                              storage_dtype=storage_dtype)
    return ExecutionPlan(
        arch=cfg.name, n_neurons=freqs.shape[1],
        cluster_size=cfg.sparse_ffn.cluster_size,
        neuron_order=order, frequencies=sorted_f, plans=plans, hardware=hw)
