"""Storage-tier performance models (paper §2.3.2) and the kernel
calibration.

A copy of `repro/core/io_model.py`: the `StorageModel` interface, the
paper's UFS 4.0 and UFS 3.1, the host-DMA tier, the core and
command-queue derates, and `KernelCalibration`, which turns measured
kernel rates into the `HardwareProfile` the storage plane prices
compute with. Its JSON block and row keys are the reference's, so a
calibration either package wrote loads in the other; `hardware(base)`
requires its base profile (the port's `HardwareProfile` has no default
device).

Numbers for `UFS40` come straight from the paper:
  * sequential: 450 MB/s @4KB -> 4 GB/s @512KB
  * random:     1 GB/s @4KB/128MB range, 3.5 GB/s @512KB
  * core dependence: big 1076 / mid 1008 / little 762 MB/s
  * single command queue: concurrency degrades up to 40%
"""
from __future__ import annotations

from dataclasses import dataclass, replace
import bisect


def _interp(points, x):
    """Piecewise-linear interpolation on sorted (x, y) points."""
    xs = [p[0] for p in points]
    if x <= xs[0]:
        return points[0][1]
    if x >= xs[-1]:
        return points[-1][1]
    i = bisect.bisect_left(xs, x)
    (x0, y0), (x1, y1) = points[i - 1], points[i]
    t = (x - x0) / (x1 - x0)
    return y0 + t * (y1 - y0)


@dataclass(frozen=True)
class StorageModel:
    """Bandwidth model: read time for (bytes, block_size, access kind)."""
    name: str
    # (block_size_bytes, MB/s) curves
    seq_curve: tuple = ()
    rand_curve: tuple = ()
    base_latency_us: float = 100.0
    range_derate: float = 1.0      # multiplier for large scattered ranges
    core_derate: float = 1.0       # paper Table 1: which core runs I/O
    queue_derate: float = 1.0      # >1 issuing core contention

    def bandwidth(self, block_size: int, random: bool) -> float:
        """Bytes/second for the given access pattern."""
        curve = self.rand_curve if random else self.seq_curve
        mbps = _interp(curve, block_size)
        return mbps * 1e6 * self.range_derate * self.core_derate \
            * self.queue_derate

    def read_time(self, nbytes: int, block_size: int, random: bool) -> float:
        """Seconds to read `nbytes` in `block_size` chunks.

        The bandwidth curves are *measured throughput at that block
        size* (paper §2.3.2), so per-op latency is already amortized
        into them — no separate latency term.
        """
        if nbytes <= 0:
            return 0.0
        bw = self.bandwidth(block_size, random)
        return nbytes / bw


UFS40 = StorageModel(
    name="ufs4.0",
    seq_curve=((4096, 450.0), (65536, 1800.0), (262144, 3200.0),
               (524288, 4000.0)),
    rand_curve=((4096, 1000.0), (8192, 1100.0), (24576, 1900.0),
                (65536, 2400.0), (524288, 3500.0)),
    base_latency_us=80.0,
)

UFS31 = StorageModel(
    name="ufs3.1",
    seq_curve=((4096, 300.0), (65536, 1100.0), (524288, 2100.0)),
    rand_curve=((4096, 550.0), (24576, 1000.0), (524288, 1800.0)),
    base_latency_us=110.0,
)

# a slow tier of host DRAM behind PCIe-class DMA: sequential and random
# converge for large blocks; latency dominates small transfers
HOST_DMA = StorageModel(
    name="host-dma",
    seq_curve=((4096, 4000.0), (65536, 20000.0), (524288, 50000.0)),
    rand_curve=((4096, 2000.0), (65536, 15000.0), (524288, 45000.0)),
    base_latency_us=20.0,
)


# ------------------------------------------------ kernel calibration ----

@dataclass(frozen=True)
class KernelCalibration:
    """Measured kernel throughput -> planner / storage-plane constants.

    Closes the loop between `HardwareProfile.dense_engine_flops` /
    `sparse_engine_flops` and the executed kernels: per serving bucket,
    time the dense FFN and the cold path (`ffn_hybrid` with n_hot = 0,
    the fused kernel on the card), aggregate the measured rates here,
    and `hardware(base)` gives the profile the storage plane prices
    with. `source` names where the rates were measured (the card and
    its power limit)."""
    dense_flops_per_s: float       # measured dense (hot-prefix) engine
    sparse_flops_per_s: float      # measured fused gathered cold path
    gather_bytes_per_s: float      # weight bytes/s the cold path moved
    source: str = "uncalibrated"

    @staticmethod
    def from_rows(rows) -> "KernelCalibration":
        """Aggregate per-bucket rows (dicts carrying dense_flops /
        t_dense_s, cold_flops / t_pallas_cold_s and gather_bytes) into
        one calibration: total work over total measured time, so big
        buckets weigh proportionally."""
        dense_t = sum(r["t_dense_s"] for r in rows)
        cold_t = sum(r["t_pallas_cold_s"] for r in rows)
        return KernelCalibration(
            dense_flops_per_s=sum(r["dense_flops"] for r in rows)
            / max(dense_t, 1e-12),
            sparse_flops_per_s=sum(r["cold_flops"] for r in rows)
            / max(cold_t, 1e-12),
            gather_bytes_per_s=sum(r["gather_bytes"] for r in rows)
            / max(cold_t, 1e-12),
            source=rows[0].get("source", "uncalibrated") if rows
            else "uncalibrated")

    @staticmethod
    def from_bench_json(path) -> "KernelCalibration":
        """Load the "calibration" block of a kernel bench's JSON."""
        import json
        with open(path) as f:
            obj = json.load(f)
        return KernelCalibration(**obj["calibration"])

    def hardware(self, base):
        """`base` with the measured engine rates (its storage bandwidths
        and attention window stay: they are storage-tier numbers, not
        kernel ones). `base` is required: there is no default device."""
        if base is None:
            raise TypeError("KernelCalibration.hardware needs a base "
                            "HardwareProfile; the port has no default "
                            "device")
        return replace(base,
                       name=f"{base.name}+kernels[{self.source}]",
                       dense_engine_flops=self.dense_flops_per_s,
                       sparse_engine_flops=self.sparse_flops_per_s)


def with_core(model: StorageModel, core: str) -> StorageModel:
    """Paper Table 1: I/O throughput depends on the issuing core."""
    derate = {"big": 1.0, "mid": 0.94, "little": 0.71}[core]
    return replace(model, core_derate=derate)


def with_queue_contention(model: StorageModel, n_issuers: int) -> StorageModel:
    """Paper §2.3.2: UFS has a single command queue; multiple issuing
    cores degrade throughput by up to 40%."""
    derate = 1.0 if n_issuers <= 1 else max(0.6, 1.0 - 0.1 * (n_issuers - 1))
    return replace(model, queue_derate=derate)
