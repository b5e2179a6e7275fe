"""The dense family's execution plan worked out again, from the same
synthetic frequencies, in numpy: the hot-first neuron order per layer
and, per batch bucket, the hot prefix and the cold clusters kept per
group. A frozen copy of the planner's arithmetic (Zipf frequencies,
union-probability hot sizing, the I/O cap of the hot prefix, cluster
alignment), so that a plan the port computed differently shows as a
trace that does not fit.

Also the phone profile and storage curves the storage plane prices
with (PowerInfer-2's OnePlus 12 with UFS 4.0)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the paper's device: sequential / random read bytes/s, the attention
# block's prefetch window, dense (NPU) and sparse (CPU) FLOP/s
PHONE = dict(seq_bw=4e9, rand_bw=1e9, attn_time_s=2e-3,
             dense_flops=11e12, sparse_flops=60e9)
HARDWARE = {"PHONE": PHONE}
BUCKETS = (1, 2, 4, 8, 16, 32)


@dataclass(frozen=True)
class BucketPlan:
    n_hot: int          # dense hot prefix (neurons, hot-first order)
    kc: int             # cold clusters kept per group
    cs: int             # cluster size
    groups: int


def synthetic_frequencies(L: int, N: int, seed: int = 0,
                          zipf_a: float = 1.2) -> np.ndarray:
    """Per-layer Zipf activation frequencies, each layer's in its own
    random order (numpy's generator from `seed`)."""
    rng = np.random.default_rng(seed)
    rank = np.arange(1, N + 1, dtype=np.float64)
    base = 1.0 / rank ** zipf_a
    base = base / base.max() * 0.95
    return np.stack([rng.permutation(base)
                     for _ in range(L)]).astype(np.float32)


def bundle_bytes(m: dict, rows: int) -> int:
    """fp16 storage: rows * d_model * itemsize."""
    itemsize = 2 if m["param_dtype"] == "bfloat16" else 4
    return rows * m["d_model"] * itemsize


def dense_plan(m: dict, rows: int, hw: dict = PHONE, groups: int = 1,
               buckets=BUCKETS):
    """(order (L, N) int32, {bucket: BucketPlan})."""
    L, N = m["num_layers"], m["d_ff"]
    cs = m["sparse_ffn"]["cluster_size"]
    freqs = synthetic_frequencies(L, N)
    order = np.argsort(-freqs, axis=1).astype(np.int32)
    mean_f = np.take_along_axis(freqs, order, axis=1).mean(axis=0)
    io_cap = int(hw["seq_bw"] * hw["attn_time_s"] / bundle_bytes(m, rows))
    plans = {}
    for b in buckets:
        union = 1.0 - (1.0 - mean_f) ** b
        n_hot = min(int((union > 0.5).sum()), io_cap, N)
        cold_union = union[n_hot:] if n_hot < N else np.array([0.0])
        cold_ratio = float(np.clip(cold_union.mean() * 2.0, 0.02, 1.0))
        # cluster- and group-aligned sizes; a remainder joins the hot
        # prefix
        align = cs * groups
        n_cold = (int(N * (1.0 - n_hot / N)) // align) * align
        k_total = (int(n_cold * cold_ratio) // align) * align
        k_total = max(k_total, align) if n_cold >= align else 0
        plans[b] = BucketPlan(n_hot=N - n_cold, kc=k_total // groups // cs,
                              cs=cs, groups=groups)
    return order, plans


def bucket_of(batch: int, buckets=BUCKETS) -> int:
    for b in buckets:
        if batch <= b:
            return b
    return buckets[-1]
