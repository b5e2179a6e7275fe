"""Host-DRAM cold store with the paper's bundled neuron layout (§4.4).

Weights live position-major: record i = (gate row i, up row i, down
column i) — one contiguous fetch brings a whole neuron bundle (the
paper measured 80% Gate/Up/Down co-activation). The store also models
the paper's two I/O refinements:

  * two-phase loading (4-bit models): fetch Gate first; fetch Up/Down
    only if the Gate activation is non-zero (saves ~20% of bundle bytes
    on non-co-activated neurons);
  * block-size-aware reads: bundle fetches are split into the block
    size that maximizes the storage model's bandwidth.

Here the "flash" is host DRAM: fetch() returns real numpy rows and
a *modeled* I/O time from the configured StorageModel, so the serving
engine and the pipeline benchmarks get both data and timing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.io_model import StorageModel, UFS40


@dataclass
class FetchResult:
    rows: np.ndarray          # (k, R, D) bundle rows
    nbytes: int
    io_time: float            # modeled seconds
    n_ops: int


class ColdStore:
    """Per-layer bundled neuron store backed by host memory."""

    def __init__(self, bundles_per_layer, storage: StorageModel = UFS40,
                 two_phase: bool = False, block_size: int = 24576,
                 bundle_bytes_override: int = None,
                 count_scale: float = 1.0):
        """bundles_per_layer: list of np arrays (N, R, D) — one per layer,
        already permuted hot-first by the planner.

        bundle_bytes_override / count_scale let a reduced model's store
        price I/O at deployment-size constants (serving.TimingProfile).
        """
        self.layers = [np.asarray(b) for b in bundles_per_layer]
        self.storage = storage
        self.two_phase = two_phase
        self.block_size = block_size
        self.bundle_bytes_override = bundle_bytes_override
        self.count_scale = count_scale
        self.total_fetches = 0
        self.total_bytes = 0
        self.total_io_time = 0.0

    def bundle_bytes(self, layer: int = 0) -> int:
        if self.bundle_bytes_override:
            return int(self.bundle_bytes_override)
        b = self.layers[layer]
        return int(b[0].nbytes)

    def fetch(self, layer: int, neuron_ids, gate_active=None) -> FetchResult:
        """Random-read the given neuron bundles.

        gate_active: optional bool per id (two-phase loading §4.4) —
        inactive gates skip the Up/Down half of the bundle.
        """
        ids = np.asarray(neuron_ids, dtype=np.int64)
        rows = self.layers[layer][ids]
        per_bundle = self.bundle_bytes(layer)
        n_eff = len(ids) * self.count_scale
        if self.two_phase and gate_active is not None:
            act = np.asarray(gate_active, dtype=bool)
            # gate = 1/R of the bundle; up/down only when active
            R = rows.shape[1]
            nbytes = int(per_bundle / R * n_eff
                         + per_bundle * (R - 1) / R * act.sum()
                         * self.count_scale)
            n_ops = int(n_eff) + int(act.sum() * self.count_scale)
        else:
            nbytes = int(per_bundle * n_eff)
            n_ops = int(n_eff)
        t = self.storage.read_time(nbytes, min(self.block_size, per_bundle),
                                   random=True)
        self.total_fetches += n_ops
        self.total_bytes += nbytes
        self.total_io_time += t
        return FetchResult(rows=rows, nbytes=nbytes, io_time=t, n_ops=n_ops)

    def fetch_sequential(self, layer: int) -> FetchResult:
        """Stream a whole layer (prefill / hot-region preload, §4.1.1)."""
        rows = self.layers[layer]
        nbytes = int(rows.nbytes)
        t = self.storage.read_time(nbytes, 524288, random=False)
        self.total_bytes += nbytes
        self.total_io_time += t
        return FetchResult(rows=rows, nbytes=nbytes, io_time=t, n_ops=1)

    def reset_stats(self):
        self.total_fetches = 0
        self.total_bytes = 0
        self.total_io_time = 0.0
