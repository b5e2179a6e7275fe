"""Plain PyTorch versions of the port's kernels.

The wrappers in `kernels/ops.py` run these for tensors on the CPU; the
CUDA kernels are held against them on the card. They repeat the kernels'
arithmetic step by step and are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.models.modules import activation_fn

# A masked row loses every batch-union max without poisoning the
# all-masked case: finfo.min sits below any finite score yet above the
# -inf a picked cluster is knocked down to, so an all-masked batch picks
# the distinct ids [0, kc), as jax.lax.top_k does.
NEG = torch.finfo(torch.float32).min


def select_clusters(cscore: torch.Tensor, kc: int) -> torch.Tensor:
    """(G, nc_g) cluster scores -> (G, kc) int32 ids: kc picks of the
    first maximum (torch.argmax returns the lowest index among ties), each
    knocked down to -inf once taken. Same ids as jax.lax.top_k."""
    sc = cscore.clone()
    picks = []
    for _ in range(kc):
        c = sc.argmax(dim=-1, keepdim=True)
        picks.append(c)
        sc.scatter_(-1, c, float("-inf"))
    return torch.cat(picks, dim=-1).to(torch.int32)


def fused_cold_ffn_ref(x, wc, A, Bp, mask, *, activation: str, cats: bool,
                       kc: int):
    """x (B, D); wc (G, nc_g, cs, R, D); A (D, r); Bp (r, G*nc_g*cs);
    mask (B,) float, > 0 = the row votes in the batch union.
    Returns (y (B, D) fp32, idx (G, kc) int32)."""
    G, nc_g, cs, R, D = wc.shape
    B = x.shape[0]
    xf = x.float()
    scores = (xf @ A.float()) @ Bp.float()                  # (B, Nc) fp32
    union = torch.where(mask.reshape(B, 1) > 0.0, scores,
                        torch.full_like(scores, NEG)).amax(dim=0)
    idx = select_clusters(union.reshape(G, nc_g, cs).amax(dim=-1), kc)
    groups = torch.arange(G, device=x.device)[:, None]
    wsel = wc[groups, idx.long()].reshape(G * kc * cs, R, D)
    act = activation_fn(activation)
    h = act(xf @ wsel[:, 0].float().T)                      # (B, K) fp32
    if R == 3:
        h = h * (xf @ wsel[:, 1].float().T)
    if cats:
        # CATS: each token keeps only the picked neurons its OWN score
        # marks positive
        tok = scores.reshape(B, G, nc_g, cs)[:, groups, idx.long()]
        h = h * (tok.reshape(B, -1) > 0.0).to(h.dtype)
    wd = wsel[:, -1]
    y = h.to(wd.dtype).float() @ wd.float()
    return y, idx


def pick_disagreements(idx_a, idx_b, x, wc, A, Bp, mask, rel: float = 1e-5):
    """Compare two (G, kc) selections made from the same inputs by two
    fp32 implementations whose sums run in different orders. Returns
    (near_ties, real): positions (g, k, id_a, id_b) where the ids differ,
    split by whether the two clusters' scores, recomputed in fp64, tie
    within `rel` (fp32 rounding can then order them either way)."""
    G, nc_g, cs = wc.shape[:3]
    B = x.shape[0]
    s64 = (x.double() @ A.double()) @ Bp.double()[:, :G * nc_g * cs]
    s64 = torch.where(mask.reshape(B, 1) > 0.0, s64,
                      torch.full_like(s64, NEG)).amax(dim=0)
    c64 = s64.reshape(G, nc_g, cs).amax(dim=-1).cpu()
    a, b = idx_a.cpu(), idx_b.cpu()
    near, real = [], []
    for g, k in (a != b).nonzero().tolist():
        va, vb = float(c64[g, a[g, k]]), float(c64[g, b[g, k]])
        tie = abs(va - vb) <= rel * max(abs(va), abs(vb), 1e-30)
        (near if tie else real).append((g, k, int(a[g, k]), int(b[g, k])))
    return near, real
