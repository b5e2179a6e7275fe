"""Bundle byte accounting (counterpart of `bundle_nbytes` in
`repro/quant/quantize.py`). The port stores cold bundles in fp16 only."""
from __future__ import annotations


def bundle_nbytes(d_model: int, storage_dtype: str, rows: int = 3,
                  itemsize: int = 2) -> int:
    """Bytes of one neuron bundle (`rows` x d_model weights) as stored at
    `storage_dtype`: fp16 is rows * d_model * itemsize, unpadded, as in
    the reference. Quantized dtypes raise until their slice lands."""
    if storage_dtype in (None, "fp16"):
        return rows * d_model * itemsize
    if storage_dtype in ("int8", "int4-mixed"):
        raise NotImplementedError(
            f"storage dtype {storage_dtype!r} belongs to the "
            f"quantized-storage slice, which the port has not reached")
    raise ValueError(
        f"unknown storage dtype {storage_dtype!r}; expected one of "
        f"'fp16', 'int8', 'int4-mixed'")
