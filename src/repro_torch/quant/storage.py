"""Storage-dtype bundle quantization for the serving plane (counterpart
of `repro/quant/storage.py`, paper §7.6 + §4.4).

`HybridPlan.storage_dtype` declares how *cold* neuron bundles live on
the slow tier: 'fp16', 'int8' (per-channel int8 + one scale per row) or
'int4-mixed' (per-channel INT4 with the top-|w| outliers kept in an
fp16 sidecar). `quantize_plan_params` quantizes a permuted model in
place:

* each layer's `ffn.w` keeps full precision for the hot prefix and holds
  the *dequantized roundtrip* in its cold rows, so prefill and every
  bucket's hot compute read what the storage holds;
* `ffn.wq` (int8 codes), `ffn.wsc` (fp32 per-row scales) and, for
  int4-mixed, `ffn.wout` (fp16 outlier sidecar) are the stored form the
  cold paths gather from, dequantizing at the gather boundary with the
  one formula `q * sc (+ out)` in fp32, so both backends decode the same
  tokens.

The containers are full size (all N rows), so `[n_hot:]` slices stay
aligned with `w` for every batch bucket; rows below the quantization
boundary are never read from them.

MoE plans quantize the routed experts' cold rows in place (simulated
quantization: the moe cold path is expert dispatch, not a cluster
gather, so no containers), leaving the shared experts fp.
"""
from __future__ import annotations

import torch

STORAGE_DTYPES = ("fp16", "int8", "int4-mixed")
OUTLIER_FRAC = 0.01       # §7.6: ~1% of weights preserved in FP16


def check_storage_dtype(storage_dtype: str) -> str:
    if storage_dtype not in STORAGE_DTYPES:
        raise ValueError(
            f"unknown storage dtype {storage_dtype!r}; expected one of "
            f"{STORAGE_DTYPES}")
    return storage_dtype


def plan_storage_dtype(plan) -> str:
    """The single storage dtype an ExecutionPlan declares (every batch
    bucket must agree — the stored bytes don't change per batch)."""
    sds = {getattr(p, "storage_dtype", "fp16")
           for p in plan.plans.values()}
    if len(sds) != 1:
        raise ValueError(
            f"batch buckets disagree on storage_dtype: {sorted(sds)}")
    return check_storage_dtype(sds.pop())


def _topk_mask_batched(mag: torch.Tensor, k: int) -> torch.Tensor:
    """(M, S) magnitudes -> bool (M, S) with exactly k True per row, ties
    broken by lowest index (the contract of `lax.top_k`, which a stable
    descending sort keeps and torch.topk does not promise)."""
    idx = torch.sort(mag, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    return mask.scatter_(-1, idx[:, :k], True)


def _per_channel(w32: torch.Tensor, qmax: int, qmin: int):
    """Codes and scales with one scale per row of the last dim; the
    division stays in fp32 and torch.round rounds half to even, as
    jnp.round does."""
    scale = w32.abs().amax(dim=-1, keepdim=True) / float(qmax)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), qmin, qmax).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_bundles(w: torch.Tensor, storage_dtype: str,
                     outlier_frac: float = OUTLIER_FRAC,
                     batch_dims: int = 0) -> dict:
    """Quantize bundle weights w (..., D) per channel (scale over the last
    dim) -> {'wq' int8, 'wsc' f32 (...,), ['wout' f16 (..., D)]}.

    int4-mixed keeps exactly k = round(outlier_frac * size) top-|w|
    outliers per weight tensor in the fp16 sidecar; each of the
    `batch_dims` leading dims gets its own budget (1 for a stacked
    (L, N, R, D) tensor: per-layer budgets). Outlier positions carry a
    zero code, so the sidecar add is exact.
    """
    check_storage_dtype(storage_dtype)
    if storage_dtype == "fp16":
        raise ValueError("fp16 is the identity: nothing to quantize")
    w32 = w.float()
    if storage_dtype == "int8":
        q, scale = _per_channel(w32, 127, -127)
        return {"wq": q, "wsc": scale}
    lead = 1
    for d in w32.shape[:batch_dims]:
        lead *= d
    flat = w32.abs().reshape(lead, -1)
    k = max(1, int(round(flat.shape[1] * outlier_frac)))
    mask = _topk_mask_batched(flat, k).reshape(w32.shape)
    base = torch.where(mask, torch.zeros_like(w32), w32)
    q, scale = _per_channel(base, 7, -8)
    wout = torch.where(mask, w32, torch.zeros_like(w32)).to(torch.float16)
    return {"wq": q, "wsc": scale, "wout": wout}


def dequantize_bundles(qd: dict) -> torch.Tensor:
    """fp32 values of a `quantize_bundles` result: the formula both cold
    paths apply at their gather boundary (a product, then a sum, each
    rounded to fp32)."""
    deq = qd["wq"].float() * qd["wsc"][..., None]
    if qd.get("wout") is not None:
        deq = deq + qd["wout"].float()
    return deq


def quant_boundary(plan) -> int:
    """First quantized neuron row: the smallest bucket's hot prefix.
    Every bucket's cold region [n_hot, N) lies inside [boundary, N), so
    one stored representation serves all buckets."""
    return min(p.n_hot for p in plan.plans.values())


@torch.no_grad()
def _quantize_ffn(model, plan, storage_dtype):
    """Dense: attach full-size wq/wsc(/wout) containers to each layer's
    FFN and write the dequantized roundtrip into w's cold rows. One layer
    at a time is the reference's per-layer outlier budget on the stacked
    (L, N, R, D) tensor."""
    n_q = quant_boundary(plan)
    for layer in model.layers:
        ffn = layer.ffn
        qd = quantize_bundles(ffn.w, storage_dtype)
        ffn.w[n_q:] = dequantize_bundles(qd)[n_q:].to(ffn.w.dtype)
        ffn.wq, ffn.wsc = qd["wq"], qd["wsc"]
        ffn.wout = qd.get("wout")
    return model


@torch.no_grad()
def _quantize_moe(model, plan, storage_dtype):
    """MoE: write the quantize-dequantize roundtrip into the routed
    experts' cold rows (whole-expert plans: every row; two-level plans:
    rows past the smallest bucket's per-expert hot prefix), one layer at
    a time with one outlier budget per expert, the reference's per
    (layer, expert) budget. Shared experts stay fp."""
    n_q_e = min(getattr(p, "n_expert_hot", 0) for p in plan.plans.values())
    for layer in model.layers:
        ex = layer.moe.experts                         # (E, f, R, D)
        qd = quantize_bundles(ex[:, n_q_e:], storage_dtype, batch_dims=1)
        ex[:, n_q_e:] = dequantize_bundles(qd).to(ex.dtype)
    return model


def quantize_plan_params(model, plan):
    """Quantize cold FFN bundles to the plan's declared storage dtype
    (identity for fp16). Called on the *permuted* model: the hot-first
    order decides which rows are cold."""
    sd = plan_storage_dtype(plan)
    if sd == "fp16":
        return model
    if getattr(model.cfg, "num_experts", 0):
        return _quantize_moe(model, plan, sd)
    return _quantize_ffn(model, plan, sd)
