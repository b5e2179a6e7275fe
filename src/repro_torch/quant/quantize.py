"""Quantization (paper §7.6), counterpart of `repro/quant/quantize.py`:
INT4 group-wise, per-channel and mixed-precision outliers, the int8 KV
helpers, bundle byte accounting and the exact top-k mask.

The paper's accuracy result hinges on its hybrid scheme: NPUs only do
per-channel INT4 (QNN's accuracy collapses on GSM8K, Table 7);
PowerInfer-2 keeps outlier weights in FP16 and per-channel-INT4
quantizes the rest (AWQ-inspired), matching llama.cpp's group-32
accuracy at NPU speed. All three schemes are simulated quantization
(codes stored as int8), plain torch with the reference's roundings: an
fp32 copy first, round half to even, clip, a 1e-8 scale floor, so the
codes are bit-identical to the reference's for fp32, bf16 and fp16
inputs. No serving path calls them; the quantizers of the serving plane
are in `quant/storage.py`.
"""
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


def quantize_groupwise_int4(w: torch.Tensor, group: int = 32) -> dict:
    """llama.cpp-style: one scale per `group` consecutive weights.

    w (..., D) with D % group == 0 -> {'q': int8 in [-8, 7], 'scales'
    (..., D // group) fp32, 'group'}."""
    shape = w.shape
    if shape[-1] % group:
        raise ValueError(
            f"groupwise int4 needs the channel dim to be a multiple of "
            f"group={group}; got D={shape[-1]}")
    wg = w.reshape(*shape[:-1], shape[-1] // group, group).float()
    scale = (wg.abs().amax(dim=-1, keepdim=True) / 7.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8)
    return {"q": q.reshape(shape), "scales": scale.squeeze(-1),
            "group": group}


def dequantize_groupwise_int4(qw: dict) -> torch.Tensor:
    q, scale, group = qw["q"], qw["scales"], qw["group"]
    shape = q.shape
    qg = q.reshape(*shape[:-1], shape[-1] // group, group).float()
    return (qg * scale[..., None]).reshape(shape)


def quantize_per_channel_int4(w: torch.Tensor) -> dict:
    """QNN-style: one scale per output channel (row, the last dim
    reduced) -> {'q': int8 in [-8, 7], 'scales' (...,) fp32}."""
    w32 = w.float()
    scale = (w32.abs().amax(dim=-1, keepdim=True) / 7.0).clamp_min(1e-8)
    # round the fp32 copy: bf16/fp16 inputs must yield the same codes
    q = torch.clamp(torch.round(w32 / scale), -8, 7).to(torch.int8)
    return {"q": q, "scales": scale.squeeze(-1)}


def dequantize_per_channel_int4(qw: dict) -> torch.Tensor:
    return qw["q"].float() * qw["scales"][..., None]


def quantize_mixed(w: torch.Tensor, outlier_frac: float = 0.01) -> dict:
    """PowerInfer-2's scheme (AWQ-inspired, §7.6): the top-|w| outliers
    (exactly k = max(1, int(size * outlier_frac)), ties to the lowest
    flat index) are kept in FP16, the rest is per-channel INT4."""
    w32 = w.float()
    k = max(1, int(w32.numel() * outlier_frac))
    outlier_mask = exact_topk_mask(w32.abs(), k)
    zero = torch.zeros((), dtype=w32.dtype, device=w32.device)
    q4 = quantize_per_channel_int4(torch.where(outlier_mask, zero, w32))
    o_f16 = torch.where(outlier_mask, w32, zero).half()
    return {"q4": q4, "outlier_mask": outlier_mask, "o_f16": o_f16}


def dequantize_mixed(qw: dict) -> torch.Tensor:
    base = dequantize_per_channel_int4(qw["q4"])
    return torch.where(qw["outlier_mask"], qw["o_f16"].float(), base)


def _rel_error(deq: torch.Tensor, w32: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(deq - w32)
                 / (torch.linalg.vector_norm(w32) + 1e-9))


def quant_error(w, scheme: str = "mixed", **kw) -> float:
    """Relative Frobenius error of a scheme, the Table 7 proxy metric.
    scheme: 'group32', 'per_channel' or 'mixed'."""
    w32 = torch.as_tensor(w).float()
    if scheme == "group32":
        deq = dequantize_groupwise_int4(quantize_groupwise_int4(w32, **kw))
    elif scheme == "per_channel":
        deq = dequantize_per_channel_int4(quantize_per_channel_int4(w32))
    elif scheme == "mixed":
        deq = dequantize_mixed(quantize_mixed(w32, **kw))
    else:
        raise ValueError(scheme)
    return _rel_error(deq, w32)


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


# ------------------------------------------------------- int8 KV cache ----
#
# Beyond the paper: K/V stored in int8 with per-(token, head) scales,
# half the cache traffic. No serving path of either package uses it.

def quantize_kv(kv: torch.Tensor) -> dict:
    """kv (..., T, KV, dh) -> {'q': int8 in [-127, 127], 'scale': fp32
    (..., T, KV, 1)}."""
    kv32 = kv.float()
    scale = (kv32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(kv32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_kv(qkv: dict) -> torch.Tensor:
    return qkv["q"].float() * qkv["scale"]


def kv_quant_error(kv) -> float:
    """Relative error of the int8 KV roundtrip."""
    kv = torch.as_tensor(kv)
    return _rel_error(dequantize_kv(quantize_kv(kv)), kv.float())
