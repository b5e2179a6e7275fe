"""Segmented in-memory neuron cache (paper §4.2).

Three regions with different granularity and policy:
  * fixed  — attention weights + KV cache; preloaded, never evicted.
  * hot    — dense matrices for the NPU/MXU path; LRU at *cluster*
             granularity (a cluster = `cluster_size` bundled neurons).
  * cold   — individually managed neurons for the sparse path; LRU at
             *neuron* granularity (co-activation after removing hot
             neurons is <20%, so bundling whole groups wastes I/O).

Evictions are discards (weights are read-only; no write-back).
`rebalance(batch_size)` grows the hot region for larger batches and
shrinks it back when sequences complete (paper Fig 2 dynamics).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_loaded: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0

    def reset(self):
        self.hits = self.misses = self.evictions = self.bytes_loaded = 0


class LRUSet:
    """LRU over integer keys with capacity in item count."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()

    def __contains__(self, k):
        return k in self._d

    def __len__(self):
        return len(self._d)

    def touch(self, k) -> bool:
        """Mark k used. Returns True if it was present (hit)."""
        if k in self._d:
            self._d.move_to_end(k)
            return True
        return False

    def admit(self, k) -> list:
        """Insert k; returns list of evicted keys."""
        evicted = []
        if k in self._d:
            self._d.move_to_end(k)
            return evicted
        while len(self._d) >= max(self.capacity, 1):
            old, _ = self._d.popitem(last=False)
            evicted.append(old)
        self._d[k] = True
        return evicted

    def resize(self, capacity: int) -> list:
        self.capacity = capacity
        evicted = []
        while len(self._d) > max(capacity, 0):
            old, _ = self._d.popitem(last=False)
            evicted.append(old)
        return evicted

    def keys(self):
        return list(self._d.keys())


class NeuronCache:
    """Per-layer segmented neuron cache.

    Keys: (layer, neuron_id) for cold entries; (layer, cluster_id) for
    hot entries. Capacities are in *neurons* (bytes_per_neuron converts).
    """

    def __init__(self, n_layers: int, neurons_per_layer: int,
                 cluster_size: int, capacity_neurons: int,
                 hot_fraction: float = 0.5, bytes_per_neuron: int = 0):
        self.n_layers = n_layers
        self.N = neurons_per_layer
        self.cluster_size = cluster_size
        self.capacity = capacity_neurons
        self.bytes_per_neuron = bytes_per_neuron
        n_hot = int(capacity_neurons * hot_fraction)
        self.hot = LRUSet(max(n_hot // cluster_size, 1))
        self.cold = LRUSet(max(capacity_neurons - n_hot, 1))
        self.stats = CacheStats()

    # -- hot region: cluster granularity ------------------------------
    def lookup_hot_cluster(self, layer: int, cluster_id: int) -> bool:
        hit = self.hot.touch((layer, cluster_id))
        self.stats.hits += self.cluster_size if hit else 0
        self.stats.misses += 0 if hit else self.cluster_size
        return hit

    def admit_hot_cluster(self, layer: int, cluster_id: int):
        ev = self.hot.admit((layer, cluster_id))
        self.stats.evictions += len(ev) * self.cluster_size
        self.stats.bytes_loaded += self.cluster_size * self.bytes_per_neuron

    # -- cold region: neuron granularity ------------------------------
    def lookup_cold(self, layer: int, neuron_ids) -> tuple:
        """Returns (hit_ids, miss_ids)."""
        hits, misses = [], []
        for nid in neuron_ids:
            (hits if self.cold.touch((layer, int(nid))) else misses).append(int(nid))
        self.stats.hits += len(hits)
        self.stats.misses += len(misses)
        return hits, misses

    def admit_cold(self, layer: int, neuron_ids):
        for nid in neuron_ids:
            ev = self.cold.admit((layer, int(nid)))
            self.stats.evictions += len(ev)
        self.stats.bytes_loaded += len(neuron_ids) * self.bytes_per_neuron

    # -- dynamic rebalancing (paper §4.2 last para) --------------------
    def rebalance(self, batch_size: int):
        """Grow hot region with batch size (more dense NPU work), shrink
        cold; and vice versa. Ratio ramps 0.5 -> 0.8 from batch 1 to 32."""
        import math
        t = min(math.log2(max(batch_size, 1)) / 5.0, 1.0)
        hot_frac = 0.5 + 0.3 * t
        n_hot = int(self.capacity * hot_frac)
        ev_h = self.hot.resize(max(n_hot // self.cluster_size, 1))
        ev_c = self.cold.resize(max(self.capacity - n_hot, 1))
        self.stats.evictions += len(ev_h) * self.cluster_size + len(ev_c)

    @property
    def resident_neurons(self) -> int:
        return len(self.hot) * self.cluster_size + len(self.cold)
