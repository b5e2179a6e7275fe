"""Hybrid hot/cold FFN — the paper's technique, single-device PyTorch.

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
                 its saved plans load unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core.clusters import HybridPlan
from repro_torch.core.predictor import predict_scores
from repro_torch.models.modules import activation_fn


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


def ffn_dense(w, x, activation: str):
    """Full dense FFN (the prefill path; paper §4.1.1)."""
    return _apply_bundle(w, x, activation)


def _top_k_ids(cscore: torch.Tensor, kc: int) -> torch.Tensor:
    """(G, nc_g) -> (G, kc) int32: the ids jax.lax.top_k returns, largest
    first with ties to the lowest index. torch.topk promises no tie order;
    a stable descending sort does (equal scores keep index order), which
    also makes an all -inf row pick [0, kc)."""
    order = torch.sort(cscore, dim=-1, descending=True, stable=True).indices
    return order[:, :kc].to(torch.int32)


def ffn_hybrid(w, pred, x, activation: str, mode: str, plan: HybridPlan,
               return_indices: bool = False, active_mask=None):
    """Decode-phase hybrid FFN (paper §4.1.2). x: (B, D).

    w (N, R, D) bundled weights; pred (A (D, r), B (r, N)) the activation
    predictor, or None. hot prefix -> dense matmul; cold suffix ->
    predictor scores -> batch union -> per-group top-k clusters ->
    gathered FFN.

    active_mask (B,) bool, optional: rows excluded from the batch-union
    selection (the serving engine's free KV-arena slots). Masked rows
    still produce an output but never steer which clusters activate.
    """
    N, R, D = w.shape
    B = x.shape[0]
    n_hot, G = plan.n_hot, plan.groups
    y = torch.zeros((B, D), dtype=torch.float32, device=x.device)

    if n_hot > 0:
        y += _apply_bundle(w[:n_hot], x, activation).float()

    n_cold = N - n_hot
    cs = plan.cluster_size
    kc = plan.clusters_per_group                      # active clusters/group
    cidx = torch.zeros((G, max(kc, 1)), dtype=torch.int32, device=x.device)
    if n_cold > 0 and kc > 0 and pred is not None:
        A, Bm = pred
        nc_g = n_cold // G // cs                      # cold clusters per group
        wc = w[n_hot:].reshape(G, nc_g, cs, R, D)
        if plan.backend == "pallas":
            # the fused kernel does scoring, batch-union top-k, gather, FFN
            # and CATS gating itself; selection matches the chain below
            from repro_torch.kernels import ops as kops
            y_cold, cidx = kops.fused_cold_ffn(
                x, wc, A, Bm[:, n_hot:], activation=activation, mode=mode,
                kc=kc, active_mask=active_mask)
        else:
            scores = predict_scores(A, Bm, x)[:, n_hot:]       # (B, Nc) fp32
            # Batch union (paper fn.1: a neuron is active if any token in
            # the batch triggers it), then *cluster*-granular selection
            if active_mask is not None:
                union = torch.where(active_mask[:, None], scores,
                                    torch.full_like(scores, float("-inf")))
                union = union.amax(dim=0)                      # (Nc,)
            else:
                union = scores.amax(dim=0)
            cscore = union.reshape(G, nc_g, cs).amax(dim=-1)   # (G, nc_g)
            cidx = _top_k_ids(cscore, kc)                      # (G, kc)
            groups = torch.arange(G, device=x.device)[:, None]
            gath = wc[groups, cidx.long()].reshape(G, kc * cs, R, D)
            act = activation_fn(activation)
            g = torch.einsum("bd,gkd->bgk", x, gath[:, :, 0])
            if R == 3:
                h = act(g) * torch.einsum("bd,gkd->bgk", x, gath[:, :, 1])
            else:
                h = act(g)
            if mode == "cats":
                # CATS-style (§7.2.5): gate each token's contribution by
                # its own predicted activation for the selected neurons
                tok = scores.reshape(B, G, nc_g, cs)[:, groups, cidx.long()]
                h = h * (tok.reshape(B, G, kc * cs) > 0.0).to(h.dtype)
            y_cold = torch.einsum("bgk,gkd->bd", h.to(w.dtype),
                                  gath[:, :, -1])
        y += y_cold.float()

    y = y.to(x.dtype)
    if return_indices:
        return y, cidx       # (G, kc) selected cold cluster ids per group
    return y


def ffn_apply(w, pred, x, activation: str, sparse_cfg,
              plan: HybridPlan | None, return_indices: bool = False,
              active_mask=None):
    """Uniform entry: dense when plan is None (prefill) else hybrid."""
    if plan is None or not sparse_cfg.enabled:
        y = ffn_dense(w, x, activation)
        return (y, None) if return_indices else y
    squeeze = x.dim() == 3
    xx = x.reshape(-1, x.shape[-1]) if squeeze else x
    out = ffn_hybrid(w, pred, xx, activation, sparse_cfg.mode, plan,
                     return_indices=return_indices, active_mask=active_mask)
    if return_indices:
        y, cidx = out
        return (y.reshape(x.shape) if squeeze else y), cidx
    return out.reshape(x.shape) if squeeze else out
