"""Hybrid hot/cold FFN — the paper's technique, in PyTorch, on one rank
or over a group of ranks (one body: a group of one is the single device).

Counterpart of `repro/core/sparse_ffn.py`. Weight layout (paper §4.4):
one bundled tensor `w` of shape (N, R, D), neuron-major, so neuron i's
Gate row, Up row and Down column are contiguous (R=3 for gated FFNs,
R=2 for ungated: [fc1, fc2]).

Paths:
  * ffn_dense  — full dense FFN (prefill) and the hot prefix of decode,
                 plain `torch.matmul`, as the reference leaves them to XLA.
  * ffn_hybrid — decode: dense hot prefix + predictor-gated gathered cold
                 clusters. `plan.backend == "pallas"` runs the cold path
                 through the hand-written fused kernel
                 (`kernels.ops.fused_cold_ffn`); "jnp" runs the plain
                 chain below. The backend names stay the reference's, so
                 its saved plans load unchanged. Under int8 / int4-mixed
                 storage both gather the stored codes and dequantize at
                 the gather boundary.
"""
from __future__ import annotations

import torch

from repro_torch.core.clusters import HybridPlan
from repro_torch.core.predictor import predict_scores
from repro_torch.models.modules import activation_fn
from repro_torch.parallel import LOCAL, cold_range, cold_split, hot_range


def ffn_rows(activation: str) -> int:
    return 2 if activation == "gelu" else 3


def _apply_bundle(w, x, activation: str):
    """Dense FFN over a (n, R, D) bundle slice. x (..., D) -> (..., D)."""
    act = activation_fn(activation)
    g = x @ w[:, 0].T
    if w.shape[1] == 3:
        h = act(g) * (x @ w[:, 1].T)
    else:
        h = act(g)
    return h @ w[:, -1]


def ffn_dense(w, x, activation: str, shard=None, rows=None):
    """Full dense FFN (the prefill path; paper §4.1.1).

    Over a ShardGroup (`repro_torch.parallel`; default one rank) each
    rank runs its slice of the neurons (`rows.dense`, or its n-th of w's
    rows when w holds them all): x enters through `copy_in` and one fp32
    all-reduce (`reduce_out`) sums the slices, so the backward is right
    over ranks too; a group of one runs all of w and makes no
    collective."""
    shard = shard or LOCAL
    if rows is None:
        N, s, n = w.shape[0], shard.rank, shard.size
        parts = [slice(s * N // n, (s + 1) * N // n)]
    else:
        parts = [rows.local(lo, hi) for lo, hi in rows.dense]
    xs = shard.copy_in(x)
    y = None
    for sl in parts:
        part = _apply_bundle(w[sl], xs, activation).float()
        y = part if y is None else y + part
    if y is None:
        y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return shard.reduce_out(y).to(x.dtype)


def _top_k_ids(cscore: torch.Tensor, kc: int) -> torch.Tensor:
    """(G, nc_g) -> (G, kc) int32: the ids jax.lax.top_k returns, largest
    first with ties to the lowest index. torch.topk promises no tie order;
    a stable descending sort does (equal scores keep index order), which
    also makes an all -inf row pick [0, kc)."""
    order = torch.sort(cscore, dim=-1, descending=True, stable=True).indices
    return order[:, :kc].to(torch.int32)


def _gather_quant(wq, wsc, wout, cidx):
    """Gather selected cold clusters from the stored quantized form and
    dequantize at the gather boundary (§7.6): int8 codes * per-row scale
    (+ fp16 outlier sidecar for int4-mixed), in fp32 — the formula the
    fused kernel applies, so the backends stay token-identical.

    wq (G, nc_g, cs, R, D) int8; wsc (G, nc_g, cs, R) f32; wout like wq
    or None; cidx (G, kc) -> (G, kc, cs, R, D) fp32.
    """
    groups = torch.arange(wq.shape[0], device=wq.device)[:, None]
    c = cidx.long()
    deq = wq[groups, c].float() * wsc[groups, c][..., None]
    if wout is not None:
        deq = deq + wout[groups, c].float()
    return deq


def _quant_operands(quant, rows: slice, shape) -> dict:
    """The stored quantized containers' cold rows `rows`, shaped for the
    fused kernel ((G, nc_g, cs, R, D) codes and sidecar, (G, nc_g, cs, R)
    scales); empty for fp16 storage."""
    if quant is None:
        return {}
    wq, wsc, wout = quant
    ops = {"wq": wq[rows].reshape(shape),
           "wsc": wsc[rows].reshape(shape[:-1])}
    if wout is not None:
        ops["wout"] = wout[rows].reshape(shape)
    return ops


def _cold_path(w, pred, x, rows: slice, G: int, activation: str,
               mode: str, plan: HybridPlan, active_mask, quant):
    """Predictor scores -> batch union -> per-group top-k clusters ->
    gathered FFN over the G groups of cold rows `rows` of w (and of B's
    columns). Returns (y (B, D) fp32, ids (G, kc) int32)."""
    _, R, D = w.shape
    B = x.shape[0]
    cs, kc = plan.cluster_size, plan.clusters_per_group
    A, Bm = pred
    wc = w[rows]
    nc_g = wc.shape[0] // G // cs                     # cold clusters per group
    shape = (G, nc_g, cs, R, D)
    wc = wc.reshape(shape)
    if plan.backend == "pallas":
        # the fused kernel does scoring, batch-union top-k, gather, FFN
        # and CATS gating itself; selection matches the chain below
        from repro_torch.kernels import ops as kops
        y_cold, cidx = kops.fused_cold_ffn(
            x, wc, A, Bm[:, rows], activation=activation, mode=mode, kc=kc,
            active_mask=active_mask,
            **_quant_operands(quant, rows, shape))
        return y_cold.float(), cidx
    scores = predict_scores(A, Bm, x)[:, rows]                 # (B, Nc) fp32
    # Batch union (paper fn.1: a neuron is active if any token in the
    # batch triggers it), then *cluster*-granular selection
    if active_mask is not None:
        union = torch.where(active_mask[:, None], scores,
                            torch.full_like(scores, float("-inf")))
        union = union.amax(dim=0)                              # (Nc,)
    else:
        union = scores.amax(dim=0)
    cscore = union.reshape(G, nc_g, cs).amax(dim=-1)           # (G, nc_g)
    cidx = _top_k_ids(cscore, kc)                              # (G, kc)
    groups = torch.arange(G, device=x.device)[:, None]
    if quant is not None:
        # gather the stored codes and dequantize at the gather boundary,
        # cast back to w's dtype as the roundtrip in w
        q = _quant_operands(quant, rows, shape)
        gath = _gather_quant(q["wq"], q["wsc"], q.get("wout"),
                             cidx).to(w.dtype)
    else:
        gath = wc[groups, cidx.long()]
    gath = gath.reshape(G, kc * cs, R, D)
    act = activation_fn(activation)
    g = torch.einsum("bd,gkd->bgk", x, gath[:, :, 0])
    if R == 3:
        h = act(g) * torch.einsum("bd,gkd->bgk", x, gath[:, :, 1])
    else:
        h = act(g)
    if mode == "cats":
        # CATS-style (§7.2.5): gate each token's contribution by its own
        # predicted activation for the selected neurons
        tok = scores.reshape(B, G, nc_g, cs)[:, groups, cidx.long()]
        h = h * (tok.reshape(B, G, kc * cs) > 0.0).to(h.dtype)
    y_cold = torch.einsum("bgk,gkd->bd", h.to(w.dtype), gath[:, :, -1])
    return y_cold.float(), cidx


def ffn_hybrid(w, pred, x, activation: str, mode: str, plan: HybridPlan,
               return_indices: bool = False, active_mask=None, quant=None,
               shard=None, rows=None):
    """Decode-phase hybrid FFN (paper §4.1.2). x: (B, D).

    w (N, R, D) bundled weights; pred (A (D, r), B (r, N)) the activation
    predictor, or None; quant (wq, wsc, wout) the stored cold bundles of
    int8 / int4-mixed storage, or None for fp16. hot prefix -> dense
    matmul; cold suffix -> predictor scores -> batch union -> per-group
    top-k clusters -> gathered FFN.

    active_mask (B,) bool, optional: rows excluded from the batch-union
    selection (the serving engine's free KV-arena slots). Masked rows
    still produce an output but never steer which clusters activate.

    shard: a ShardGroup (`repro_torch.parallel`) of n ranks, default
    one (`LOCAL`, which makes no collective). Each rank runs its hot
    slice and, when the plan's groups divide n > 1, its G/n whole cold
    groups (the fused kernel over them under 'pallas'), its ids gathered
    in rank order to (G, kc); otherwise every rank runs the whole cold
    path and rank 0's output enters the sum. One fp32 all-reduce
    (`reduce_out`, after x entered through `copy_in`) joins the partial
    outputs. `rows` (a NeuronRows) maps the
    global neuron ids to the rows w, B and the quantized containers hold
    on this rank; None when they hold all N.
    """
    shard = shard or LOCAL
    s, n = shard.rank, shard.size
    N = w.shape[0] if rows is None else rows.n_neurons
    local = (lambda lo, hi: slice(lo, hi)) if rows is None else rows.local
    n_hot, G = plan.n_hot, plan.groups
    x = shard.copy_in(x)
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    lo, hi = hot_range(n_hot, s, n)
    if hi > lo:
        y += _apply_bundle(w[local(lo, hi)], x, activation).float()
    kc = plan.clusters_per_group                      # active clusters/group
    cidx = torch.zeros((G, max(kc, 1)), dtype=torch.int32, device=x.device)
    if N - n_hot > 0 and kc > 0 and pred is not None:
        sl = local(*cold_range(plan, N, s, n))
        if cold_split(plan, n):
            y_cold, idx = _cold_path(w, pred, x, sl, G // n, activation, mode,
                                     plan, active_mask, quant)
            cidx = shard.all_gather_ids(idx)
            y += y_cold
        else:
            # one rank, or groups that do not divide the ranks: the cold
            # path runs whole on every rank (the same ids), its y counted
            # once
            y_cold, cidx = _cold_path(w, pred, x, sl, G, activation, mode, plan,
                                      active_mask, quant)
            if s == 0:
                y += y_cold
    y = shard.reduce_out(y).to(x.dtype)
    if return_indices:
        return y, cidx       # (G, kc) selected cold cluster ids per group
    return y


def ffn_apply(w, pred, x, activation: str, sparse_cfg,
              plan: HybridPlan | None, return_indices: bool = False,
              active_mask=None, quant=None, shard=None, rows=None):
    """Uniform entry: dense when plan is None (prefill) else hybrid."""
    if plan is None or not sparse_cfg.enabled:
        y = ffn_dense(w, x, activation, shard, rows)
        return (y, None) if return_indices else y
    squeeze = x.dim() == 3
    xx = x.reshape(-1, x.shape[-1]) if squeeze else x
    out = ffn_hybrid(w, pred, xx, activation, sparse_cfg.mode, plan,
                     return_indices=return_indices, active_mask=active_mask,
                     quant=quant, shard=shard, rows=rows)
    if return_indices:
        y, cidx = out
        return (y.reshape(x.shape) if squeeze else y), cidx
    return out.reshape(x.shape) if squeeze else out
