"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427), the hybrid family.

Counterpart of `repro/models/rglru.py`. The block pattern ('rec', 'rec',
'attn') repeats: two RG-LRU recurrent blocks per local-attention (MQA,
window `cfg.local_window`) block, and every temporal block is followed
by a GeGLU MLP that carries the PowerInfer-2 hybrid FFN (under a
"pallas" plan, the `fused_cold_ffn` kernel). 38 layers = 12 groups of
the pattern + 2 remainder rec layers.

RG-LRU: r_t = σ(x_t·w_r + b_r), i_t = σ(x_t·w_i + b_i),
        a_t = exp(-c · softplus(Λ) · r_t),
        h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t);
gates and log-decay in fp32. The full sequence runs as a log-depth
(Hillis-Steele) scan over the reference's `combine`, ceil(log2 S)
steps of a few launches each; decode is the O(1) update.

The layers are one list in model order (group g's block i is layer
g * period + i, then the remainder); the reference stacks them by group
(`groups.b0..b{period-1}`, `rem0..`), which `bridge` maps. The caches
hold one entry per rec (or attn) layer in that order, which is the
reference's group-major order. The local attention keeps a ring of
`local_window` slots (`kv_cache.init_ring_cache`).

Over ranks (`parallel.shard_layout`) a rec block splits by channels of
the LRU width: the gates, the conv and the scan are per channel, so the
only join is the fp32 all-reduce after `w_out`. Attention splits by
heads when both head counts divide the ranks (recurrentgemma-9b's one kv
head keeps it whole), and every MLP runs the hybrid FFN on its rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, dense
from repro_torch.models.attention import rope_angles
from repro_torch.models.kv_cache import (
    init_ring_cache, prefill_slots, write_pos, write_prefill)
from repro_torch.models.modules import (
    dense_init, dtype_of, embed_init, resolve_device, rms_norm)
from repro_torch.models.ssm import causal_conv
from repro_torch.parallel import cut_shape, placements, places_under


# ------------------------------------------------------------- RG-LRU ----

class LRU(nn.Module):
    """The RG-LRU's per-channel gates (dr,): w_r, b_r, w_i, b_i, and
    lam (fp32); with `place` ({leaf: index}), the channels a rank
    holds."""

    def __init__(self, dr: int, dtype, device, place=None):
        super().__init__()
        self.dr, self.place = dr, place or {}
        for name in ("w_r", "b_r", "w_i", "b_i", "lam"):
            setattr(self, name, blocks._param(
                cut_shape((dr,), self.place.get((name,))),
                torch.float32 if name == "lam" else dtype, device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for name in ("w_r", "w_i"):
            w = getattr(self, name)
            w.copy_(dense_init((self.dr,), w.dtype, generator, w.device,
                               scale=1.0, index=self.place.get((name,))))
        self.lam.fill_(0.7)


def _gates(p: LRU, x, c: float):
    """(a, b) of the update h' = a h + b, fp32."""
    r = torch.sigmoid(x * p.w_r + p.b_r).float()
    i = torch.sigmoid(x * p.w_i + p.b_i)
    log_a = -c * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * x).float()
    return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over dim 1,
    by doubling: after the step of offset d, (a_t, b_t) compose the
    elements (t - 2d, t]. Returns (A, H): A_t the product of a up to t,
    H_t the state at t."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def rglru_full(p: LRU, x, cfg, init_h=None):
    """x (B, S, dr) -> (y, h_final), both in x's dtype."""
    a, b = _gates(p, x, cfg.rglru_c)
    A, H = linear_scan(a, b)
    if init_h is not None:
        H = H + A * init_h[:, None].float()
    return H.to(x.dtype), H[:, -1].to(x.dtype)


def rglru_step(p: LRU, x, cfg, h):
    """x (B, dr), h (B, dr) -> (y, h'), both in x's dtype."""
    a, b = _gates(p, x, cfg.rglru_c)
    h = a * h.float() + b
    return h.to(x.dtype), h.to(x.dtype)


# ------------------------------------------------------------- blocks ----

class RecBlock(nn.Module):
    """ln, w_in / w_gate (d, dr), conv_w (W, dr), conv_b, the LRU, w_out
    (dr, d), then ln2 and the FFN. With `layout` and `place` (one
    block's `parallel.placements`) a rank's slice: its LRU channels of
    w_in / w_gate / the conv / the gates and w_out's rows, its FFN
    rows."""
    kind = "rec"

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None,
                 place=None):
        super().__init__()
        d = dr = cfg.d_model
        self.place = place or {}
        self.whole = {"w_in": (d, dr), "w_gate": (d, dr),
                      "conv_w": (cfg.rglru_conv_width, dr), "conv_b": (dr,),
                      "w_out": (dr, d)}
        p = blocks._param
        cut = lambda k: cut_shape(self.whole[k], self.place.get((k,)))
        self.ln = p((d,), dtype, device)
        self.w_in = p(cut("w_in"), dtype, device)
        self.w_gate = p(cut("w_gate"), dtype, device)
        self.conv_w = p(cut("conv_w"), dtype, device)
        self.conv_b = p(cut("conv_b"), dtype, device)
        self.lru = LRU(dr, dtype, device, places_under(self.place, ("lru",)))
        self.w_out = p(cut("w_out"), dtype, device)
        self.ln2 = p((d,), dtype, device)
        self.ffn = blocks.FFN(cfg, dtype, device, layout)

    @property
    def split(self) -> bool:
        """True when this block holds a share of the LRU channels."""
        return self.w_in.shape[1] < self.whole["w_in"][1]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for name, scale in (("w_in", None), ("w_gate", None),
                            ("conv_w", 0.5), ("w_out", None)):
            w = getattr(self, name)
            w.copy_(dense_init(self.whole[name], w.dtype, generator,
                               w.device, scale=scale,
                               index=self.place.get((name,))))
        self.ffn.init_weights(generator)
        self.lru.init_weights(generator)


class AttnBlock(nn.Module):
    """ln, local attention, ln2 and the FFN (a rank's heads and FFN rows
    with `layout`)."""
    kind = "attn"

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None,
                 place=None):
        super().__init__()
        self.ln = blocks._param((cfg.d_model,), dtype, device)
        self.attn = blocks.Attention(cfg, dtype, device, layout)
        self.ln2 = blocks._param((cfg.d_model,), dtype, device)
        self.ffn = blocks.FFN(cfg, dtype, device, layout)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        self.attn.init_weights(generator)
        self.ffn.init_weights(generator)


def _apply_mlp(lp, x, cfg, plan, shard=None, return_indices=False):
    """x + the block's MLP (the hybrid FFN under `plan`, per rank over
    `shard`); with return_indices, (x, the cold cluster ids or None)."""
    f = blocks.apply_ffn_block(lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps),
                               cfg, plan, return_indices=return_indices,
                               shard=shard)
    if return_indices:
        return x + f[0], f[1]
    return x + f


def _split(lp: RecBlock, shard) -> bool:
    return shard is not None and lp.split


def _rec_in(lp: RecBlock, x, cfg, tail, shard=None):
    """(gelu gate, conv output, new tail) of a rec block's input, on the
    channels lp holds (x entering the split through `copy_in`)."""
    xi = rms_norm(x, lp.ln, cfg.norm_eps)
    if _split(lp, shard):
        xi = shard.copy_in(xi)
    gate = F.gelu(xi @ lp.w_gate, approximate="tanh")
    u, tail = causal_conv(xi @ lp.w_in, lp.conv_w, lp.conv_b, tail)
    return gate, u, tail


def _rec_out(lp: RecBlock, y, gate, shard=None):
    """(y * gate) @ w_out, the channels' partial sums joined in fp32 over
    ranks (the recurrence is per channel: nothing to join before)."""
    out = (y * gate) @ lp.w_out
    return shard.reduce_out(out) if _split(lp, shard) else out


def rec_full(lp: RecBlock, x, cfg, plan=None, shard=None):
    """Full-sequence recurrent block + MLP from a zero state: (x,
    (h_final, conv_tail))."""
    gate, u, tail = _rec_in(lp, x, cfg, None, shard)
    y, h = rglru_full(lp.lru, u, cfg)
    x = x + _rec_out(lp, y, gate, shard)
    return _apply_mlp(lp, x, cfg, plan, shard), (h, tail)


def rec_step(lp: RecBlock, x, cfg, h, tail, plan=None, shard=None,
             return_indices=False):
    """One-token recurrent block + MLP. x (B, 1, D). With
    return_indices, (x, the MLP's cluster ids, (h, tail))."""
    gate, u, tail = _rec_in(lp, x, cfg, tail, shard)
    y, h = rglru_step(lp.lru, u[:, 0], cfg, h)
    x = x + _rec_out(lp, y[:, None], gate, shard)
    if return_indices:
        x, cidx = _apply_mlp(lp, x, cfg, plan, shard, True)
        return x, cidx, (h, tail)
    return _apply_mlp(lp, x, cfg, plan, shard), (h, tail)


def attn_full_block(lp: AttnBlock, x, cfg, angles, plan=None, shard=None):
    a, kv = blocks.attn_full(lp.attn, rms_norm(x, lp.ln, cfg.norm_eps), cfg,
                             angles, causal=True, window=cfg.local_window,
                             shard=shard)
    return _apply_mlp(lp, x + a, cfg, plan, shard), kv


def attn_step_block(lp: AttnBlock, x, cfg, angles, kc, vc, kv_pos, pos,
                    plan=None, shard=None, return_indices=False):
    """One-token local attention block + MLP: (x, (k, v)), or with
    return_indices (x, the MLP's cluster ids, (k, v))."""
    a, kc, vc = blocks.attn_decode(lp.attn, rms_norm(x, lp.ln, cfg.norm_eps),
                                   cfg, angles, kc, vc, kv_pos, pos,
                                   window=cfg.local_window, shard=shard)
    if return_indices:
        x, cidx = _apply_mlp(lp, x + a, cfg, plan, shard, True)
        return x, cidx, (kc, vc)
    return _apply_mlp(lp, x + a, cfg, plan, shard), (kc, vc)


# ------------------------------------------------------------- model ----

def layout(cfg: ModelConfig):
    """(n_groups, remainder kinds) of the repeating block pattern."""
    period = len(cfg.block_pattern)
    n_groups = cfg.num_layers // period
    return n_groups, cfg.block_pattern[: cfg.num_layers - n_groups * period]


def layer_kinds(cfg: ModelConfig):
    """The kind of every layer in model order."""
    n_groups, rem = layout(cfg)
    return tuple(cfg.block_pattern) * n_groups + tuple(rem)


def layer_paths(cfg: ModelConfig):
    """The reference tree's path of every layer in model order: group g's
    block i at ("groups", f"b{i}") (row g of the stacked leaves), the
    remainder's block j at (f"rem{j}",)."""
    n_groups, rem = layout(cfg)
    P = len(cfg.block_pattern)
    return [("groups", f"b{i}") for _ in range(n_groups) for i in range(P)] \
        + [(f"rem{j}",) for j in range(len(rem))]


class HybridModel(nn.Module):
    """embed, out_norm and the blocks in model order; the head is the
    tied embedding (the reference's hybrid has no lm_head). With
    `layout` (a `parallel.ShardLayout`) one rank's slice: its vocab rows,
    each rec block's LRU channels, each attention block's heads (when
    both head counts divide the ranks) and every MLP's rows."""

    def __init__(self, cfg: ModelConfig, device, layout=None):
        super().__init__()
        if not cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: the hybrid family ties its head")
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        self.places = {} if layout is None else placements(cfg, layout)
        self.vocab = (0, cfg.vocab_padded) if layout is None else \
            layout.vocab
        self.embed = blocks._param((self.vocab[1] - self.vocab[0],
                                    cfg.d_model), dtype, device)
        self.out_norm = blocks._param((cfg.d_model,), dtype, device)
        kinds = {"rec": RecBlock, "attn": AttnBlock}
        self.layers = nn.ModuleList(
            kinds[k](cfg, dtype, device, layout,
                     places_under(self.places, path))
            for k, path in zip(layer_kinds(cfg), layer_paths(cfg)))
        self.lm_head = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        cfg = self.cfg
        self.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model,
                                    self.embed.dtype, generator, self.device,
                                    index=self.places.get(("embed",))))
        for layer in self.layers:
            layer.init_weights(generator)
        return self

    def init_cache(self, batch: int, seq_len: int = 0):
        """rec_h (n_rec, B, dr), rec_conv (n_rec, B, W-1, dr), the local
        ring attn_k / attn_v (n_attn, B, local_window, KV, dh) with its
        kv_pos (B, local_window), length (B,), of the channels and kv
        heads this model holds; `seq_len` does not size it."""
        cfg = self.cfg
        kinds = layer_kinds(cfg)
        n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
        dt, dev = dtype_of(cfg.param_dtype), self.device
        rec = [l for l in self.layers if l.kind == "rec"]
        attn = [l for l in self.layers if l.kind == "attn"]
        dr = rec[0].w_in.shape[1] if rec else cfg.d_model
        kv = attn[0].attn.wk.shape[1] // cfg.d_head if attn else \
            cfg.num_kv_heads
        ring = init_ring_cache(n_attn, batch, None, cfg.local_window, kv,
                               cfg.d_head, dt, dev)
        return {"rec_h": torch.zeros((n_rec, batch, dr), dtype=dt,
                                     device=dev),
                "rec_conv": torch.zeros((n_rec, batch,
                                         cfg.rglru_conv_width - 1, dr),
                                        dtype=dt, device=dev),
                "attn_k": ring["k"], "attn_v": ring["v"],
                "kv_pos": ring["kv_pos"], "length": ring["length"]}


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0,
               layout=None):
    """The hybrid model on `device` (default `cuda`; raises without a
    card), random weights from a `torch.Generator` seeded by `seed`, or
    zero weights to be filled when `seed` is None; with `layout`, only
    that rank's slices."""
    device = resolve_device(device)
    model = HybridModel(cfg, device, layout)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _angles(cfg, positions):
    return rope_angles(positions, cfg.d_head // 2, cfg.rope_theta)


def _full_layer(lp, x, cfg, angles, plan, shard=None):
    """One block over the full sequence: (x, its state)."""
    if lp.kind == "rec":
        return rec_full(lp, x, cfg, plan, shard)
    return attn_full_block(lp, x, cfg, angles, plan, shard)


def forward(model: HybridModel, tokens, plan=None, shard=None):
    """Full-sequence logits (B, S, V); differentiable when grad is
    enabled and the parameters require it. `shard`: the rank's group
    when the model is one rank's slice."""
    cfg = model.cfg
    x = dense.embed_tokens(model, tokens, shard)
    angles = _angles(cfg, torch.arange(x.shape[1], device=x.device))
    for lp in model.layers:
        x, _ = blocks.run_layer(_full_layer, lp, x, cfg, angles, plan, shard,
                                remat=cfg.remat)
    return dense.lm_logits(model, x, shard)


@torch.no_grad()
def prefill(model: HybridModel, tokens, max_len: Optional[int] = None,
            shard=None):
    """Prefill of tokens (B, S) with the dense FFN: (logits (B, 1, V) of
    the last position, the cache). The local ring keeps the last
    `local_window` tokens, so S must be a multiple of the window or
    shorter than it (token p in slot p % window); it raises otherwise.
    `max_len` does not size the cache."""
    cfg = model.cfg
    B, S = tokens.shape
    _, n = prefill_slots(S, cfg.local_window, cfg.local_window)
    x = dense.embed_tokens(model, tokens, shard)
    angles = _angles(cfg, torch.arange(S, device=x.device))
    cache = model.init_cache(B)
    ri, kvs = 0, []
    for lp in model.layers:
        x, st = _full_layer(lp, x, cfg, angles, None, shard)
        if lp.kind == "rec":
            cache["rec_h"][ri], cache["rec_conv"][ri] = st
            ri += 1
        else:
            kvs.append(st)
    write_prefill(cache, kvs, S, n, ("attn_k", "attn_v"))
    return dense.lm_logits(model, x[:, -1:], shard), cache


@torch.no_grad()
def decode_step(model: HybridModel, tokens, cache, plan=None, shard=None,
                collect_indices: bool = False):
    """tokens (B, 1) -> (logits (B, 1, V), cache[, cluster_ids]), the
    cache updated in place and returned; every block's MLP runs the
    hybrid FFN under `plan` (per rank over `shard`). collect_indices
    also returns every MLP's selected cold cluster ids (L, G, kc),
    gathered over the ranks, or None on the dense path."""
    cfg = model.cfg
    pos = cache["length"]
    x = dense.embed_tokens(model, tokens, shard)
    angles = _angles(cfg, pos[:, None])
    kv_pos = write_pos(cache["kv_pos"], pos)
    ri = ai = 0
    cidxs = []
    for lp in model.layers:
        if lp.kind == "rec":
            x, *c, (h, tail) = rec_step(lp, x, cfg, cache["rec_h"][ri],
                                        cache["rec_conv"][ri], plan, shard,
                                        collect_indices)
            cache["rec_h"][ri], cache["rec_conv"][ri] = h, tail
            ri += 1
        else:
            x, *c, _ = attn_step_block(lp, x, cfg, angles,
                                       cache["attn_k"][ai],
                                       cache["attn_v"][ai], kv_pos, pos,
                                       plan, shard, collect_indices)
            ai += 1
        cidxs += c
    cache["length"].add_(1)      # pos is this tensor: every use came first
    logits = dense.lm_logits(model, x, shard)
    if collect_indices:
        trace = torch.stack(cidxs) if cidxs[0] is not None else None
        return logits, cache, trace
    return logits, cache
