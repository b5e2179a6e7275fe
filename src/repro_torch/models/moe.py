"""Mixture-of-Experts FFN and the MoE decoder model (deepseek-moe,
grok-1, turbosparse-mixtral), single device.

Counterpart of `repro/models/moe.py` without the mesh. The paper's
neuron clusters map onto MoE at two levels: shared experts are hot
clusters (always dense), routed experts are cold clusters gated by the
router (the predictor's role); with `cfg.moe_intra_expert` the hybrid
hot/cold split also applies inside each expert (the TurboSparse-Mixtral
case).

Dispatch is sort-based and capacity-dropped: tokens -> top-k experts ->
rank within the expert by a stable sort -> (E, C, D) dispatch buffer ->
batched expert GEMMs -> weighted combine. Every shape is fixed by the
token count and the config, and nothing reads a tensor's value on the
host, so a decode step captures in a CUDA graph. The expert GEMMs run
densely over the whole capacity buffer, as the reference's einsums do.

Serving: the model is the dense model with MoE layers (`MoEModel`), so
`dense.prefill` and `dense.decode_step` run it; with collect_indices
the decode step returns the per-layer kept-dispatch counts (L, E), or
with a two-level plan (one whose `n_expert_hot` > 0) the (L, E, 1+ncc)
trace whose columns past the first count the real activations of each
intra-expert cold cluster, thresholded off the unchanged dense expert
activations, so decode stays token-identical to whole-expert decode.

Over a group of n ranks (`_moe_split`): routing, capacity and slots run
whole on every rank, so each rank picks exactly the single-device
experts. With `moe_shard_mode == "ep"` and E % n == 0
(`_moe_ep_shard_map`'s scheme) rank s holds experts [s*E/n, (s+1)*E/n)
and runs only their slots, in one dispatch group; with "tp" (grok-1,
whose 8 experts do not cover the ranks: the reference's `experts` spec
P(None, 'model')) rank s holds rows [s*f/n, (s+1)*f/n) of every expert
and runs every expert's GEMMs over them, in the config's dispatch
groups. Either way the rank also holds a share of the shared experts'
rows (`parallel.hot_range`), combines a partial (T, D) output, and one
fp32 all-reduce joins the partials. The rows enter through `copy_in`
(and so do the routing weights of the combine), so the backward sums
the partial gradients of x and of the router. The two-level trace's
(E/n, 1+ncc) blocks are gathered in expert order under ep; under tp
each rank counts the clusters of its rows and the counts are gathered
in rank order. When E % n != 0 under ep every rank holds and runs every
expert.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusters import HybridPlan
from repro_torch.core.planner import _act_threshold
from repro_torch.core.sparse_ffn import ffn_dense, ffn_rows
from repro_torch.models import blocks, dense
from repro_torch.models.modules import activation_fn, dense_init
from repro_torch.parallel import expert_parallel, neuron_parallel


# ------------------------------------------------------------- MoE FFN ----

class MoEFFN(nn.Module):
    """router (D, E), routed experts (E, f, R, D) and, when the config
    has shared experts, their bundled weights `shared` (n_sh*f, R, D)
    (the reference's `shared.w`). With a layout, `experts` holds the
    rank's experts (ep) or every expert's rows `expert_rows` (tp), and
    `shared` its shared rows; the router is whole."""

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__()
        E, f, D = cfg.num_experts, cfg.d_ff, cfg.d_model
        R = ffn_rows(cfg.activation)
        S = cfg.num_shared_experts * f
        self.whole = (E, f, R, D, S)
        self.expert_range = (0, E) if layout is None else layout.experts
        self.expert_rows = (0, f) if layout is None else layout.expert_rows
        self.shared_rows = (0, S) if layout is None else layout.shared
        e_loc = self.expert_range[1]
        f_loc = self.expert_rows[1] - self.expert_rows[0]
        n_sh = self.shared_rows[1] - self.shared_rows[0]
        self.router = blocks._param((D, E), dtype, device)
        self.experts = blocks._param((e_loc, f_loc, R, D), dtype, device)
        self.shared = blocks._param((n_sh, R, D), dtype, device) \
            if cfg.num_shared_experts else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The reference's rules: truncated normal at 1/sqrt(fan_in),
        fan_in the last-but-one dim (D for the router, R for the bundled
        experts). One expert at a time, to bound the fp32 temporaries;
        a slice draws every leaf (every expert) whole and keeps its
        part."""
        E, f, R, D, S = self.whole
        dev = self.router.device
        self.router.copy_(dense_init((D, E), self.router.dtype, generator,
                                     dev))
        if self.shared is not None:
            self.shared.copy_(dense_init((S, R, D), self.shared.dtype,
                                         generator, dev,
                                         index=slice(*self.shared_rows)))
        e0, ne = self.expert_range
        rows = slice(*self.expert_rows)
        for e in range(E):
            held = e0 <= e < e0 + ne
            ex = dense_init((f, R, D), self.experts.dtype, generator, dev,
                            index=rows if held else slice(0, 0))
            if held:
                self.experts[e - e0].copy_(ex)


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int(T * k / E * factor)
    return max(8, ((c + 7) // 8) * 8)


def _top_k(gates, k: int):
    """jax.lax.top_k's (values, ids (int32)): largest first, ties to the
    lowest id. torch.topk promises no tie order; a stable descending
    sort does."""
    ids = torch.sort(gates, dim=-1, descending=True, stable=True).indices
    ids = ids[..., :k]
    return gates.gather(-1, ids), ids.to(torch.int32)


def moe_dispatch(gates, k: int, capacity: int, active=None):
    """gates (T, E) router probabilities -> (tope (T, k) int32 expert
    ids, topv (T, k) renormalized weights, slot (T, k) int32 into a flat
    (E*C) buffer, keep (T, k) bool).

    active (T,) bool, optional: inactive rows route to a sentinel bucket
    E that sorts after every real expert, so they never occupy a
    capacity slot and the live rows' ranking is that of a dispatch over
    the live rows alone."""
    T, E = gates.shape
    topv, tope = _top_k(gates, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = tope.reshape(-1).long()                        # (T*k,)
    if active is not None:
        live = active.reshape(T, 1).expand(T, k).reshape(-1)
        flat_e = torch.where(live, flat_e, E)
    order = torch.sort(flat_e, stable=True).indices
    n = torch.arange(T * k, device=gates.device)
    ranks = torch.empty_like(n).scatter_(0, order, n)
    counts = torch.zeros(E + 1, dtype=torch.long, device=gates.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(0) - counts                     # exclusive
    pos_in_e = ranks - offsets[flat_e]
    keep = (pos_in_e < capacity) & (flat_e < E)
    slot = torch.where(keep, flat_e * capacity + pos_in_e, 0)
    return (tope, topv, slot.reshape(T, k).to(torch.int32),
            keep.reshape(T, k))


def _expert_counts(tope, keep, E: int):
    """Kept dispatch entries per expert, (E,) int32: the activation
    trace of whole-expert mode (an expert with count > 0 fired)."""
    flat = torch.where(keep.reshape(-1), tope.reshape(-1).long(), E)
    counts = torch.zeros(E + 1, dtype=torch.long, device=tope.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts[:E].to(torch.int32)


def _dispatch_group(xt, router, cfg: ModelConfig, C: int, active=None,
                    xs=None):
    """One dispatch group: xt (T, D) -> (buf (E, C, D), (slot, keep,
    topv), aux loss, per-expert kept counts). The softmax and the aux
    loss are fp32. Each (token, expert) entry is scatter-added at its
    slot with weight keep; a dropped entry adds 0*x to slot 0. `xs`
    (default xt): the same rows as they enter a split region, which fill
    the buffer while xt routes."""
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    tope, topv, slot, keep = moe_dispatch(gates, k, C, active)
    xs = xt if xs is None else xs
    xk = xs[:, None].expand(T, k, D).reshape(T * k, D)
    wgt = keep.reshape(-1).to(xt.dtype)
    buf = torch.zeros((E * C, D), dtype=xs.dtype, device=xt.device)
    buf.index_add_(0, slot.reshape(-1).long(), xk * wgt[:, None])
    # router load-balance aux loss (Switch-style)
    me = gates.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device)
    ce.scatter_add_(0, tope.reshape(-1).long(),
                    torch.full((T * k,), 1.0 / (T * k),
                               dtype=torch.float32, device=xt.device))
    aux = E * torch.sum(me * ce)
    counts = _expert_counts(tope, keep, E)
    return buf.reshape(E, C, D), (slot, keep, topv), aux, counts


def _two_level_trace(cfg: ModelConfig, plan) -> bool:
    """True when the trace is the two-level (E, 1+ncc) form:
    intra-expert sparsity on and the stepped plan carries a per-expert
    hot prefix."""
    return (cfg.moe_intra_expert and plan is not None
            and getattr(plan, "n_expert_hot", 0) > 0)


def _cold_cluster_counts(h, cfg: ModelConfig, n_hot_e: int, cs: int):
    """h (..., E, C, f) real expert activations -> (E, ncc) int32
    active-(slot, neuron) counts per intra-expert cold cluster (rows
    are hot-first, so the cold suffix starts at n_hot_e). Empty slots
    and dropped entries hold exact zeros and never mark a cluster."""
    tau = _act_threshold(cfg.sparse_ffn.mode)
    f = h.shape[-1]
    active = (h.abs() > tau).to(torch.int32)
    na = active.reshape((-1,) + tuple(h.shape[-3:])).sum(dim=(0, 2))
    ncc = (f - n_hot_e) // cs
    return na[:, n_hot_e:].reshape(-1, ncc, cs).sum(dim=-1).to(torch.int32)


def _combine_group(yb, slot, keep, topv):
    """yb (E*C, D) expert outputs -> (T, D) weighted combine."""
    T, k = slot.shape
    yk = yb.index_select(0, slot.reshape(-1).long()).reshape(T, k, -1)
    yk = yk * (topv * keep).to(yk.dtype)[..., None]
    return yk.sum(dim=1)


def _expert_gemm(a, w):
    """a (G, E, C, m) @ w (E, m, n) -> (G, E, C, n): one batched GEMM per
    expert over every group's slots. `w` may be a strided view of the
    bundled experts (cuBLAS takes its leading dimension as given)."""
    G, E, C, m = a.shape
    y = torch.bmm(a.transpose(0, 1).reshape(E, G * C, m), w)
    return y.reshape(E, G, C, -1).transpose(0, 1)


def _experts_ffn(buf, w, activation: str):
    """The experts' gated FFN over their dispatch buffers: buf (G, E, C,
    D), w (E, f, R, D) -> (activations h (G, E, C, f), outputs (G, E, C,
    D))."""
    act = activation_fn(activation)
    g = _expert_gemm(buf, w[:, :, 0].transpose(1, 2))
    if w.shape[2] == 3:
        h = act(g) * _expert_gemm(buf, w[:, :, 1].transpose(1, 2))
    else:
        h = act(g)
    return h, _expert_gemm(h, w[:, :, -1])


def _moe_split(moe: MoEFFN, xt, cfg: ModelConfig, G: int, C: int, mask,
               plan, collect_trace: bool, shard):
    """The MoE FFN over `shard`'s n ranks (module docstring): routing,
    capacity and slots replicated, the rank's share of the expert
    compute (its experts under ep, every expert's rows under tp) on the
    rows entered through `copy_in`, a partial combine with the routing
    weights entered the same way, the rank's shared rows, and one fp32
    `reduce_out`. Returns ((T, D) output, aux, trace or None)."""
    T, D = xt.shape
    E = cfg.num_experts
    n, r = shard.size, shard.rank
    e0, ne = moe.expert_range
    if expert_parallel(cfg, n) and (ne != E // n or e0 != r * ne):
        raise ValueError(f"expert parallel over {n} ranks: the layer "
                         f"holds experts [{e0}, {e0 + ne}), not rank "
                         f"{r}'s {E // n}")
    if neuron_parallel(cfg, n) and (ne != E or moe.experts.shape[1]
                                    * n != cfg.d_ff):
        raise ValueError(f"neuron parallel over {n} ranks: the layer "
                         f"holds {ne} experts of {moe.experts.shape[1]} "
                         f"rows, not {E} of {cfg.d_ff // n}")
    Tg = T // G
    xs = shard.copy_in(xt)
    groups = [_dispatch_group(xt[g * Tg:(g + 1) * Tg], moe.router, cfg, C,
                              mask[g * Tg:(g + 1) * Tg],
                              xs=xs[g * Tg:(g + 1) * Tg]) for g in range(G)]
    buf = torch.stack([q[0] for q in groups])               # (G, E, C, D)
    h, yl = _experts_ffn(buf[:, e0:e0 + ne], moe.experts, cfg.activation)
    if ne < E:                   # the other ranks' experts' outputs are 0
        yb = torch.zeros_like(buf)
        yb[:, e0:e0 + ne] = yl
    else:
        yb = yl
    y = torch.cat([_combine_group(yb[i].reshape(E * C, D), slot, keep,
                                  shard.copy_in(topv))
                   for i, (_, (slot, keep, topv), _, _) in enumerate(groups)]
                  ).float()
    if moe.shared is not None and moe.shared.shape[0]:   # its shared rows
        y = y + ffn_dense(moe.shared, xs, cfg.activation).float()
    y = shard.reduce_out(y).to(xt.dtype)
    aux = torch.stack([q[2] for q in groups]).mean()
    if not collect_trace:
        return y, aux, None
    counts = torch.stack([q[3] for q in groups]).sum(dim=0).to(torch.int32)
    if not _two_level_trace(cfg, plan):
        return y, aux, counts
    cs, n_hot_e = plan.cluster_size, plan.n_expert_hot
    if ne < E:
        # ep: this rank's (E/n, 1+ncc) block, gathered in expert order
        cold = _cold_cluster_counts(h, cfg, n_hot_e, cs)
        blk = torch.cat([counts[e0:e0 + ne, None], cold], dim=1)
        return y, aux, shard.all_gather_ids(blk)
    # tp: each rank counts its rows' clusters, gathered in rank order
    # (its rows are whole clusters: `parallel.shard_layout` checks)
    chunks = _cold_cluster_counts(h, cfg, 0, cs)            # (E, f/n/cs)
    whole = shard.all_gather_ids(chunks.T.contiguous()).T   # (E, f/cs)
    return y, aux, torch.cat([counts[:, None], whole[:, n_hot_e // cs:]],
                             dim=1)


def apply_moe_ffn(moe: MoEFFN, x, cfg: ModelConfig,
                  plan: Optional[HybridPlan] = None,
                  active_mask=None, collect_trace: bool = False,
                  shard=None):
    """x (..., D) -> ((..., D), aux[, trace]), over T = x.numel() / D
    tokens.

    Tokens route within `cfg.moe_dispatch_groups` groups of equal size
    (one group when G does not divide T), each with its own capacity
    C = _capacity(T/G, ...). active_mask (T,) bool: rows excluded from
    dispatch (freed KV-arena lanes); they neither consume capacity nor
    appear in the trace. collect_trace=True also returns the per-expert
    kept counts (E,) int32, or with a two-level plan the (E, 1+ncc)
    form. The expert compute never depends on the plan.

    shard: the rank's group; expert parallel over it when
    `expert_parallel(cfg, n)` (one dispatch group only), neuron parallel
    when `neuron_parallel(cfg, n)`; otherwise (E % n != 0 under ep)
    every rank runs every expert and makes no collective."""
    shape = x.shape
    D = shape[-1]
    xt = x.reshape(-1, D)                                   # (T, D)
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    G = cfg.moe_dispatch_groups \
        if cfg.moe_dispatch_groups > 0 and T % cfg.moe_dispatch_groups == 0 \
        else 1
    Tg = T // G
    C = _capacity(Tg, k, E, cfg.moe_capacity_factor)
    mask = torch.ones(T, dtype=torch.bool, device=x.device) \
        if active_mask is None else active_mask.reshape(-1)
    n = 1 if shard is None else shard.size
    if expert_parallel(cfg, n) or neuron_parallel(cfg, n):
        if G != 1 and expert_parallel(cfg, n):
            raise ValueError(f"expert parallel dispatch runs one group, "
                             f"not moe_dispatch_groups={G}")
        y, aux, trace = _moe_split(moe, xt, cfg, G, C, mask, plan,
                                   collect_trace, shard)
        y = y.reshape(shape)
        return (y, aux, trace) if collect_trace else (y, aux)
    groups = [_dispatch_group(xt[g * Tg:(g + 1) * Tg], moe.router, cfg, C,
                              mask[g * Tg:(g + 1) * Tg]) for g in range(G)]
    buf = torch.stack([r[0] for r in groups])               # (G, E, C, D)

    h, yb = _experts_ffn(buf, moe.experts, cfg.activation)  # (G, E, C, D)
    y = torch.cat([_combine_group(yb[i].reshape(E * C, D), *r[1])
                   for i, r in enumerate(groups)])
    aux = torch.stack([r[2] for r in groups]).mean()

    if moe.shared is not None:                              # hot clusters
        y = y + ffn_dense(moe.shared, xt, cfg.activation)
    y = y.reshape(shape)
    if not collect_trace:
        return y, aux
    counts = torch.stack([r[3] for r in groups]).sum(dim=0)  # (E,)
    if _two_level_trace(cfg, plan):
        cold = _cold_cluster_counts(h, cfg, plan.n_expert_hot,
                                    plan.cluster_size)
        return y, aux, torch.cat([counts[:, None].to(torch.int32), cold],
                                 dim=1)
    return y, aux, counts.to(torch.int32)


# --------------------------------------------------------------- model ----

class MoELayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__()
        self.ln1 = blocks._param((cfg.d_model,), dtype, device)
        self.attn = blocks.Attention(cfg, dtype, device, layout)
        self.ln2 = blocks._param((cfg.d_model,), dtype, device)
        self.moe = MoEFFN(cfg, dtype, device, layout)

    def init_weights(self, generator: torch.Generator):
        self.attn.init_weights(generator)
        self.moe.init_weights(generator)

    def ffn_block(self, x, cfg: ModelConfig, plan, return_indices=False,
                  active_mask=None, shard=None):
        """apply_moe_ffn without the aux loss; the plan only shapes the
        trace."""
        out = apply_moe_ffn(self.moe, x, cfg, plan=plan,
                            active_mask=active_mask,
                            collect_trace=return_indices, shard=shard)
        return (out[0], out[2]) if return_indices else out[0]


class MoEModel(dense.DenseModel):
    """The dense model's embed, out_norm, optional lm_head and attention,
    with an MoE FFN in every layer (`MoELayer.moe`)."""
    layer_type = MoELayer


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0,
               layout=None):
    """The MoE model on `device` (default `cuda`; raises without a card),
    with random weights from a `torch.Generator` seeded by `seed`, or
    zero weights to be filled when `seed` is None."""
    return dense.make_model(cfg, device, seed, model_type=MoEModel,
                            layout=layout)


# forward (full-sequence logits, every layer's MoE over the B*S tokens in
# the config's dispatch groups; differentiable, the training forward, whose
# router aux loss is dropped as the reference's is), prefill and decode are
# the dense model's layer walk, which reaches each layer's MoE through
# MoELayer.ffn_block; the decode trace is (L, E) or (L, E, 1+ncc)
forward = dense.forward
prefill = dense.prefill
make_decode_step = dense.make_decode_step

