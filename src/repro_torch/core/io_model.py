"""Storage-tier performance model (paper §2.3.2).

A copy of `repro/core/io_model.py` cut to what the serving path prices
with: the `StorageModel` interface and the paper's measured UFS 4.0.

Numbers for `UFS40` come straight from the paper:
  * sequential: 450 MB/s @4KB -> 4 GB/s @512KB
  * random:     1 GB/s @4KB/128MB range, 3.5 GB/s @512KB
"""
from __future__ import annotations

from dataclasses import dataclass
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
