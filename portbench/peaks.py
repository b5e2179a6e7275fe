"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense tensor-core rates, no sparsity, at the full power limit).
A card missing from the table has no roofline or mfu: its readers
return nothing."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,         # dense tensor-core bf16
        "fp32_flops": 67e12,          # outside the tensor cores
        "hbm_bytes": 3.35e12,         # HBM3, bytes/s
        "memory_bytes": 80 * 10 ** 9,
    },
}


def peaks_of(kind: str):
    """The peak table of the card named `kind` (torch's device name), or
    None."""
    return PEAKS.get(kind)
