"""Plain PyTorch versions of the port's kernels.

The wrappers in `kernels/ops.py` run these for tensors on the CPU; the
CUDA kernels are held against them on the card. They repeat the kernels'
arithmetic step by step and are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_ffn import _gather_quant
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
                       kc: int, wq=None, wsc=None, wout=None):
    """x (B, D); wc (G, nc_g, cs, R, D); A (D, r); Bp (r, G*nc_g*cs);
    mask (B,) float, > 0 = the row votes in the batch union.
    Quant mode: wq (G, nc_g, cs, R, D) int8 codes, wsc (G, nc_g, cs, R)
    fp32 scales and, for int4-mixed, wout (G, nc_g, cs, R, D) fp16
    outliers; the picked bundles are dequantized as q * sc (+ out) in fp32
    and cast to x's dtype before the dots, and wc is not read.
    Returns (y (B, D) fp32, idx (G, kc) int32)."""
    G, nc_g, cs, R, D = wc.shape
    B = x.shape[0]
    xf = x.float()
    scores = (xf @ A.float()) @ Bp.float()                  # (B, Nc) fp32
    union = torch.where(mask.reshape(B, 1) > 0.0, scores,
                        torch.full_like(scores, NEG)).amax(dim=0)
    idx = select_clusters(union.reshape(G, nc_g, cs).amax(dim=-1), kc)
    h, wd = picked_ffn(x, wc, idx, activation=activation, wq=wq, wsc=wsc,
                       wout=wout)
    if cats:
        # CATS: each token keeps only the picked neurons its OWN score
        # marks positive
        groups = torch.arange(G, device=x.device)[:, None]
        tok = scores.reshape(B, G, nc_g, cs)[:, groups, idx.long()]
        h = h * (tok.reshape(B, -1) > 0.0).to(h.dtype)
    y = h.to(wd.dtype).float() @ wd.float()
    return y, idx


def picked_ffn(x, wc, idx, *, activation: str, wq=None, wsc=None,
               wout=None):
    """The picked clusters' FFN before the CATS gate, as fused_cold_ffn_ref
    computes it: (h (B, K) fp32, the picked Wd rows (K, D) in x's dtype),
    K = G * kc * cs in (group, pick, neuron) order."""
    G, nc_g, cs, R, D = wc.shape
    kc = idx.shape[1]
    groups = torch.arange(G, device=x.device)[:, None]
    if wq is None:
        wsel = wc[groups, idx.long()]
    else:
        wsel = _gather_quant(wq, wsc, wout, idx).to(x.dtype)
    wsel = wsel.reshape(G * kc * cs, R, D)
    xf = x.float()
    h = activation_fn(activation)(xf @ wsel[:, 0].float().T)
    if R == 3:
        h = h * (xf @ wsel[:, 1].float().T)
    return h, wsel[:, -1]


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


# fp32 rounding of a CATS score, relative to the sum of the magnitudes of
# its products: 16 units of fp32's epsilon (2**-23), well past the
# difference two fp32 summation orders of the score make
GATE_REL = 16 * 2.0 ** -23


def cats_zero_gates(idx, x, wc, A, Bp, rel: float = GATE_REL):
    """The (row, picked neuron) pairs whose CATS gate two fp32
    implementations may set differently: the token's own score of the
    picked neuron, s = sum_j (sum_i x_i A_ij) Bp_jk recomputed in fp64,
    lies within `rel` * sum_ij |x_i A_ij Bp_jk| of 0 (the rounding is scaled
    by the products' magnitudes, not by the result, which may be exactly
    0). idx (G, kc) are the picks; neuron k of a row counts in (group,
    pick, neuron) order, as picked_ffn's columns. Returns (P, 2) int64 on
    the CPU."""
    G, nc_g, cs = wc.shape[:3]
    kc = idx.shape[1]
    ids = idx.long().cpu() + torch.arange(G)[:, None] * nc_g
    cols = (ids[:, :, None] * cs + torch.arange(cs)).reshape(G * kc * cs)
    bp = Bp[:, cols.to(Bp.device)].double()
    xd, ad = x.double(), A.double()
    score = (xd @ ad) @ bp
    scale = (xd.abs() @ ad.abs()) @ bp.abs()
    return (score.abs() <= rel * scale).nonzero().cpu()


def near_threshold(x, w, activation: str, mode: str, dx: float = 0.0):
    """(T, N) bool: the (token, neuron) pairs whose activation test
    |h| > _act_threshold(mode) (`core/planner.py`'s profile) two
    computations may decide differently. x (..., D) is one computation's
    FFN input, recomputed in fp64; the other's x may differ by up to `dx`
    per entry and sums in another order, so the gate g = x.w_g lies
    within GATE_REL*sum|x w_g| + dx*sum|w_g| of the fp64 value (the up
    projection u alike). A pair is flagged when |h| over that box reaches
    both sides of the threshold, as `cats_zero_gates` flags a gate within
    rounding of 0."""
    from repro_torch.core.planner import _act_threshold
    act = activation_fn(activation)
    xd, wd = x.double().reshape(-1, x.shape[-1]), w.double()

    def box(j):
        v = xd @ wd[:, j].T
        e = GATE_REL * (xd.abs() @ wd[:, j].abs().T) \
            + dx * wd[:, j].abs().sum(-1)
        return v - e, v + e
    g = box(0)
    a = torch.stack([act(g[0]), act(g[1])])
    u = torch.stack(box(1)) if w.shape[1] == 3 else torch.ones_like(a)
    prods = (a[:, None] * u[None, :]).abs()
    hi = prods.amax(dim=(0, 1))
    lo = prods.amin(dim=(0, 1))
    lo = torch.where((a[0] * a[1] <= 0) | (u[0] * u[1] <= 0), 0.0, lo)
    tau = _act_threshold(mode)
    return (lo <= tau) & (hi > tau)


def _apply_bundle(x, wsel, activation: str):
    """x (B, D), wsel (K, R, D) -> (B, D) fp32: gate/up dots in fp32, the
    activation, h cast to the weight dtype, the down dot in fp32."""
    act = activation_fn(activation)
    xf = x.float()
    h = act(xf @ wsel[:, 0].float().T)
    if wsel.shape[1] == 3:
        h = h * (xf @ wsel[:, 1].float().T)
    return h.to(wsel.dtype).float() @ wsel[:, -1].float()


def cluster_gather_ffn_ref(x, w, cluster_idx, *, activation: str,
                           cluster_size: int):
    """x (B, D); w (N, R, D) bundled neuron weights; cluster_idx (K,) ids
    of clusters of `cluster_size` consecutive neurons. Returns the sum of
    the bundled FFN over those clusters, (B, D) in x's dtype."""
    N = w.shape[0]
    wc = w.reshape(N // cluster_size, cluster_size, *w.shape[1:])
    wsel = wc[cluster_idx.long()].reshape(-1, *w.shape[1:])
    return _apply_bundle(x, wsel, activation).to(x.dtype)


def dense_ffn_ref(x, w, *, activation: str):
    """Dense bundled FFN. x (B, D), w (N, R, D) -> (B, D) in x's dtype."""
    return _apply_bundle(x, w, activation).to(x.dtype)


def cluster_gather_ffn_grouped_ref(x, wc, cidx, *, activation: str):
    """Plain version of `cluster_gather_ffn_grouped`: wc (G, nc_g, cs, R,
    D) and cidx (G, kc), group g's ids offset by g * nc_g into the
    flattened clusters."""
    G, nc_g, cs, R, D = wc.shape
    gidx = cidx + torch.arange(G, dtype=cidx.dtype,
                               device=cidx.device)[:, None] * nc_g
    return cluster_gather_ffn_ref(x, wc.reshape(G * nc_g * cs, R, D),
                                  gidx.reshape(-1), activation=activation,
                                  cluster_size=cs)
