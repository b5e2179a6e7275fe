"""Bundle byte accounting and the exact top-k mask (counterparts of
`bundle_nbytes`, `bundle_nbytes_int4` and `exact_topk_mask` in
`repro/quant/quantize.py`). The quantizers of the serving plane are in
`quant/storage.py`."""
from __future__ import annotations

import torch

# Smallest priced read block of the modeled storage tier (UFS 4.0 data
# unit, io_model.UFS40's first curve point). Quantized bundle sizes are
# padded to this granularity.
BUNDLE_ALIGN = 4096


def exact_topk_mask(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask selecting exactly the k largest entries of `mag`, ties
    broken by lowest flat index (`lax.top_k`'s order). torch.topk
    promises no tie order; a stable descending sort keeps equal values in
    index order."""
    flat = mag.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:k]
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=mag.device)
    mask[idx] = True
    return mask.reshape(mag.shape)


def bundle_nbytes_int4(d_model: int, gated: bool = True,
                       align: int = BUNDLE_ALIGN,
                       outlier_frac: float = 0.0) -> int:
    """Paper §4.4: a 4-bit Gate-Up-Down bundle (int4 weights + fp16 group
    scales per matrix, plus `outlier_frac` of fp16 outliers) padded to
    the storage read granularity `align`; `align=0` returns the raw
    size."""
    R = 3 if gated else 2
    per_matrix = d_model // 2 + d_model // 32 * 2   # int4 + fp16 group scales
    raw = R * per_matrix + int(round(outlier_frac * R * d_model)) * 2
    if not align:
        return raw
    return ((raw + align - 1) // align) * align


def bundle_nbytes(d_model: int, storage_dtype: str, rows: int = 3,
                  itemsize: int = 2, align: int = BUNDLE_ALIGN,
                  outlier_frac: float = 0.01) -> int:
    """Bytes of one neuron bundle (`rows` x d_model weights) as stored at
    `storage_dtype`, the one accounting the storage plane prices with:

      fp16       rows * d_model * itemsize, unpadded
      int8       per-channel int8 + one fp16 scale per row, padded
      int4-mixed per-channel int4 + group scales + fp16 outlier sidecar
                 (§7.6), padded: `bundle_nbytes_int4`
    """
    if storage_dtype in (None, "fp16"):
        return rows * d_model * itemsize
    if storage_dtype == "int8":
        raw = rows * (d_model + 2)
        return ((raw + align - 1) // align) * align if align else raw
    if storage_dtype == "int4-mixed":
        return bundle_nbytes_int4(d_model, gated=rows == 3, align=align,
                                  outlier_frac=outlier_frac)
    raise ValueError(
        f"unknown storage dtype {storage_dtype!r}; expected one of "
        f"'fp16', 'int8', 'int4-mixed'")
