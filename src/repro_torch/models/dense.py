"""Dense decoder-only transformer (llama family), the model of the
serving path.

Counterpart of `repro/models/dense.py`. The model is an `nn.Module`
holding the parameters; forward (the training forward), prefill and
decode are plain functions over it, and the reference's layer `scan` is
a Python loop. Prefill and decode run under `torch.no_grad()` (a decode
step is captured in a CUDA graph); forward records autograd when asked.

Tensor parallel: a model built with a `ShardLayout` holds one rank's
slice (`bridge.params_from_numpy(..., shard=...)`, or `make_model(...,
layout=)` drawing the whole model's random weights leaf by leaf), and
forward, prefill and decode take that rank's group as `shard`. The
embedding holds the rank's vocab rows and the head its vocab columns
(tied or not) when the ranks divide the padded vocabulary: the lookup
is local and masked, joined by one fp32 all-reduce, and the logits'
columns are gathered in rank order, so every rank gets the whole
logits, and the same loss or token, as one rank.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusters import HybridPlan
from repro_torch.models import blocks
from repro_torch.models.attention import rope_angles
from repro_torch.models.kv_cache import (
    init_full_cache, init_ring_cache, prefill_slots, write_pos,
    write_prefill)
from repro_torch.models.modules import (
    dense_init, dtype_of, embed_init, resolve_device, rms_norm)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__()
        self.ln1 = blocks._param((cfg.d_model,), dtype, device)
        self.attn = blocks.Attention(cfg, dtype, device, layout)
        self.ln2 = blocks._param((cfg.d_model,), dtype, device)
        self.ffn = blocks.FFN(cfg, dtype, device, layout)

    def init_weights(self, generator: torch.Generator):
        self.attn.init_weights(generator)
        self.ffn.init_weights(generator)

    def ffn_block(self, x, cfg: ModelConfig, plan, return_indices=False,
                  active_mask=None, shard=None):
        """The layer's FFN on its normed input: the hybrid FFN under a
        plan, dense without one. With return_indices, (y, trace)."""
        return blocks.apply_ffn_block(self.ffn, x, cfg, plan,
                                      return_indices=return_indices,
                                      active_mask=active_mask, shard=shard)


class DenseModel(nn.Module):
    """Parameters of the dense model, in the reference's layouts: embed
    (V_padded, D), out_norm (D,), per layer ln1/ln2 (D,), attention
    wq/wk/wv/wo, the bundled FFN w (N, R, D) and its predictor.

    The layer walk below (prefill, decode) reaches the FFN only through
    `layer.ffn_block`, so a subclass with another `layer_type` (the MoE
    model, `models/moe.py`) serves through the same functions.

    `layout` (a `parallel.ShardLayout`) sizes the layers at one rank's
    slice; None holds the whole model."""

    layer_type = Layer

    def __init__(self, cfg: ModelConfig, device, layout=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        # the vocab rows of embed (columns of lm_head) held: [lo, hi)
        self.vocab = (0, cfg.vocab_padded) if layout is None else \
            layout.vocab
        n_vocab = self.vocab[1] - self.vocab[0]
        self.embed = blocks._param((n_vocab, cfg.d_model), dtype, device)
        self.out_norm = blocks._param((cfg.d_model,), dtype, device)
        self.layers = nn.ModuleList(self.layer_type(cfg, dtype, device,
                                                    layout)
                                    for _ in range(cfg.num_layers))
        self.lm_head = None if cfg.tie_embeddings else blocks._param(
            (cfg.d_model, n_vocab), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def kv_heads(self) -> int:
        """The kv heads this model's caches hold (a rank's share when
        attention is head-sharded)."""
        return self.layers[0].attn.wk.shape[1] // self.cfg.d_head

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights from `generator`: truncated normal at
        1/sqrt(fan_in), embeddings N(0, 0.02), norm weights zero (the
        (1 + w) scale makes that the identity) — the reference's rules.
        A slice draws each leaf whole and keeps its part, so it holds the
        whole model's weights for the same generator."""
        cfg = self.cfg
        lo, hi = self.vocab
        self.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model,
                                    self.embed.dtype, generator,
                                    self.device, index=slice(lo, hi)))
        for layer in self.layers:
            layer.init_weights(generator)
        if self.lm_head is not None:
            self.lm_head.copy_(dense_init(
                (cfg.d_model, cfg.vocab_padded), self.lm_head.dtype,
                generator, self.device, index=(slice(None), slice(lo, hi))))
        return self

    def init_cache(self, batch: int, seq_len: int):
        """The cache of `seq_len` positions: a ring of
        `cfg.sliding_window` slots when the window is shorter, else a
        full cache of `seq_len` slots."""
        cfg = self.cfg
        return init_ring_cache(cfg.num_layers, batch, seq_len,
                               cfg.sliding_window, self.kv_heads, cfg.d_head,
                               dtype_of(cfg.param_dtype), self.device)


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0,
               model_type=DenseModel, layout=None):
    """The dense model (or `model_type`) on `device` (default `cuda`;
    raises without a card), with random weights from a `torch.Generator`
    seeded by `seed` on that device, or zero weights to be filled when
    `seed` is None; with `layout` (a `parallel.ShardLayout`), only that
    rank's slices."""
    device = resolve_device(device)
    model = model_type(cfg, device, layout=layout)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


# -------------------------------------------------------------- forward ----

def vocab_of(model) -> tuple:
    """The vocab rows [lo, hi) a model's embedding holds (every family's
    model; only the dense and moe models split it)."""
    return getattr(model, "vocab", (0, model.cfg.vocab_padded))


def embed_tokens(model: DenseModel, tokens, shard=None):
    """Embedding rows of `tokens`, with `jnp.take`'s rules for ids out of
    range: an id in [-V, 0) wraps, any id >= V or < -V gives a NaN row
    (V = the padded vocabulary). A model holding a share of the vocab
    looks up the ids in its rows, zeros elsewhere (rank 0 also writes
    the NaN rows, so each enters the sum once), and the ranks' rows are
    summed in fp32 (`shard.reduce_out`)."""
    V = model.cfg.vocab_padded
    t = tokens.long()
    ok = (t >= -V) & (t < V)
    t = torch.where(t < 0, t + V, t)                 # negative ids wrap
    lo, hi = vocab_of(model)
    if hi - lo == V:
        x = model.embed[torch.where(ok, t, 0)]
        x = torch.where(ok[..., None], x, torch.full_like(x, float("nan")))
        return x.to(dtype_of(model.cfg.compute_dtype))
    mine = ok & (t >= lo) & (t < hi)
    x = model.embed[torch.where(mine, t - lo, 0)]
    fill = float("nan") if shard.rank == 0 else 0.0
    x = torch.where(mine[..., None], x,
                    torch.where(ok[..., None], torch.zeros_like(x),
                                torch.full_like(x, fill)))
    return shard.reduce_out(x).to(dtype_of(model.cfg.compute_dtype))


def lm_logits(model: DenseModel, x, shard=None):
    """Logits (..., V_padded) of the final hidden states, the padding
    classes masked to -1e30 (out of place: autograd keeps the product).
    A model holding a share of the vocab computes its columns from x
    entered through `shard.copy_in` and gathers the ranks' columns."""
    cfg = model.cfg
    x = rms_norm(x, model.out_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    lo, hi = vocab_of(model)
    split = hi - lo < cfg.vocab_padded
    if split:
        x = shard.copy_in(x)
    logits = x @ head.to(x.dtype)
    if cfg.vocab_size < hi:
        # mask the padding classes (vocab padded for shardability)
        cols = torch.arange(lo, hi, device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab_size, -1e30)
    return shard.gather_vocab(logits) if split else logits


def _layer_full(layer, x, cfg: ModelConfig, angles, plan, shard):
    """One layer over the full sequence: (x', (k, v))."""
    a, kv = blocks.attn_full(layer.attn, rms_norm(x, layer.ln1, cfg.norm_eps),
                             cfg, angles, causal=True,
                             window=cfg.sliding_window, shard=shard)
    x = x + a
    x = x + layer.ffn_block(rms_norm(x, layer.ln2, cfg.norm_eps), cfg, plan,
                            shard=shard)
    return x, kv


def forward_from_embeds(model: DenseModel, x, angles, *, plan=None,
                        collect_kv=False, shard=None):
    """Run the layer stack over full-sequence embeddings. While autograd
    records (grad enabled), `cfg.remat` recomputes each layer in the
    backward pass instead of keeping its activations (the reference's
    `jax.checkpoint` of the scanned layer)."""
    cfg = model.cfg
    kvs = []
    for layer in model.layers:
        x, kv = blocks.run_layer(_layer_full, layer, x, cfg, angles, plan,
                                 shard, remat=cfg.remat)
        if collect_kv:
            kvs.append(kv)
    return x, kvs


def forward(model: DenseModel, tokens, plan: Optional[HybridPlan] = None,
            shard=None):
    """Full-sequence logits (B, S, V) of tokens (B, S) under 1-D RoPE;
    differentiable (the training forward) when grad is enabled and the
    parameters require it. `shard`: the rank's group when the model is
    one rank's slice."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, shard)
    pos = torch.arange(x.shape[1], device=x.device)
    angles = rope_angles(pos, cfg.d_head // 2, cfg.rope_theta)
    x, _ = forward_from_embeds(model, x, angles, plan=plan, shard=shard)
    return lm_logits(model, x, shard)


# -------------------------------------------------------- prefill/decode ----

@torch.no_grad()
def prefill_from_embeds(model: DenseModel, x, angles,
                        max_len: Optional[int] = None, shard=None):
    """Dense prefill of embeddings x (B, S, D) under RoPE `angles`.
    Returns (logits (B, 1, V) of the last position, cache padded to
    `max_len` slots with kv_pos = -1 in the padding). With a sliding
    window W < S the cache is the ring of the last W tokens (then S must
    be a multiple of W, so that token p sits in slot p % W; it raises
    otherwise). `shard`: the rank's group when the model is one rank's
    slice."""
    cfg = model.cfg
    B, S = x.shape[:2]
    # the padded full cache also past a window that the prompt does not
    # fill, as the reference's
    T, n = prefill_slots(S, cfg.sliding_window, max_len)
    x, kvs = forward_from_embeds(model, x, angles, collect_kv=True,
                                 shard=shard)
    cache = init_full_cache(cfg.num_layers, B, T, model.kv_heads,
                            cfg.d_head, dtype_of(cfg.param_dtype), x.device)
    return lm_logits(model, x[:, -1:], shard), write_prefill(cache, kvs, S,
                                                             n)


@torch.no_grad()
def prefill(model: DenseModel, tokens, max_len: Optional[int] = None,
            shard=None):
    """Dense prefill of tokens (B, S); see `prefill_from_embeds`."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, shard)
    pos = torch.arange(x.shape[1], device=x.device)
    angles = rope_angles(pos, cfg.d_head // 2, cfg.rope_theta)
    return prefill_from_embeds(model, x, angles, max_len, shard)


@torch.no_grad()
def decode_step(model: DenseModel, tokens, cache,
                plan: Optional[HybridPlan] = None, active_mask=None,
                collect_indices: bool = False, angles_fn=None, shard=None):
    """tokens (B, 1) -> (logits (B, 1, V), cache[, cluster_ids]).

    The cache is updated in place, every tensor keeping its storage (a
    CUDA graph of the step replays on the same buffers), and returned.
    active_mask (B,) bool:
    live rows for the sparse-FFN batch-union selection; None = all rows
    live. collect_indices=True also returns the per-layer trace the
    storage plane prices: the selected cold cluster ids (L, G, kc) of
    dense layers, the MoE layers' (L, E) kept-dispatch counts or their
    two-level (L, E, 1+ncc) form.
    angles_fn(pos) gives the RoPE angles (B, 1, dh/2) of the positions
    pos (B,) (the vlm's M-RoPE); default plain 1-D RoPE. shard: the
    rank's group when the model is one rank's slice (the trace is then
    the whole group's, gathered)."""
    cfg = model.cfg
    pos = cache["length"]                              # (B,)
    x = embed_tokens(model, tokens, shard)
    angles = angles_fn(pos) if angles_fn else rope_angles(
        pos[:, None], cfg.d_head // 2, cfg.rope_theta)
    kv_pos = write_pos(cache["kv_pos"], pos)
    cidxs = []
    for l, layer in enumerate(model.layers):
        a, _, _ = blocks.attn_decode(
            layer.attn, rms_norm(x, layer.ln1, cfg.norm_eps), cfg, angles,
            cache["k"][l], cache["v"][l], kv_pos, pos,
            window=cfg.sliding_window, shard=shard)
        x = x + a
        f = layer.ffn_block(rms_norm(x, layer.ln2, cfg.norm_eps), cfg, plan,
                            return_indices=collect_indices,
                            active_mask=active_mask, shard=shard)
        if collect_indices:
            f, cidx = f
            cidxs.append(cidx)
        x = x + f
    cache["length"].add_(1)      # pos is this tensor: every use came first
    logits = lm_logits(model, x, shard)
    if collect_indices:
        # the dense path (no plan, or sparse FFN off) selects nothing
        trace = torch.stack(cidxs) if cidxs[0] is not None else None
        return logits, cache, trace
    return logits, cache


def make_decode_step(cfg: ModelConfig, collect_indices: bool = False,
                     angles_fn=None, shard=None):
    """The serving decode callable (model, tokens, cache, plan,
    active_mask) -> (logits, cache[, trace]), over `shard`'s ranks when
    given."""
    def step(model, tokens, cache, plan=None, active_mask=None):
        return decode_step(model, tokens, cache, plan, active_mask,
                           collect_indices=collect_indices,
                           angles_fn=angles_fn, shard=shard)
    return step
