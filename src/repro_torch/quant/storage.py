"""Plan storage dtype (counterpart of `plan_storage_dtype` in
`repro/quant/storage.py`). The port serves fp16 cold bundles only."""
from __future__ import annotations

STORAGE_DTYPES = ("fp16", "int8", "int4-mixed")


def plan_storage_dtype(plan) -> str:
    """The single storage dtype an ExecutionPlan declares (every batch
    bucket must agree — the stored bytes don't change per batch)."""
    sds = {getattr(p, "storage_dtype", "fp16")
           for p in plan.plans.values()}
    if len(sds) != 1:
        raise ValueError(
            f"batch buckets disagree on storage_dtype: {sorted(sds)}")
    sd = sds.pop()
    if sd not in STORAGE_DTYPES:
        raise ValueError(f"unknown storage dtype {sd!r}; expected one of "
                         f"{STORAGE_DTYPES}")
    if sd != "fp16":
        raise NotImplementedError(
            f"storage dtype {sd!r} belongs to the quantized-storage "
            f"slice, which the port has not reached")
    return sd
