"""Dense decoder-only transformer (llama family), the model of the
serving path.

Counterpart of `repro/models/dense.py`. The model is an `nn.Module`
holding the parameters; prefill and decode are plain functions over it,
and the reference's layer `scan` is a Python loop.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusters import HybridPlan
from repro_torch.models import blocks
from repro_torch.models.attention import rope_angles
from repro_torch.models.kv_cache import init_full_cache, write_pos
from repro_torch.models.modules import (
    dense_init, dtype_of, embed_init, resolve_device, rms_norm)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = blocks._param((cfg.d_model,), dtype, device)
        self.attn = blocks.Attention(cfg, dtype, device)
        self.ln2 = blocks._param((cfg.d_model,), dtype, device)
        self.ffn = blocks.FFN(cfg, dtype, device)


class DenseModel(nn.Module):
    """Parameters of the dense model, in the reference's layouts: embed
    (V_padded, D), out_norm (D,), per layer ln1/ln2 (D,), attention
    wq/wk/wv/wo, the bundled FFN w (N, R, D) and its predictor."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: sliding-window (ring) caches are not ported")
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        self.embed = blocks._param((cfg.vocab_padded, cfg.d_model), dtype,
                                   device)
        self.out_norm = blocks._param((cfg.d_model,), dtype, device)
        self.layers = nn.ModuleList(Layer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.lm_head = None if cfg.tie_embeddings else blocks._param(
            (cfg.d_model, cfg.vocab_padded), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights from `generator`: truncated normal at
        1/sqrt(fan_in), embeddings N(0, 0.02), norm weights zero (the
        (1 + w) scale makes that the identity) — the reference's rules."""
        cfg = self.cfg
        self.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model,
                                    self.embed.dtype, generator, self.device))
        for layer in self.layers:
            layer.attn.init_weights(generator)
            layer.ffn.init_weights(generator)
        if self.lm_head is not None:
            self.lm_head.copy_(dense_init(tuple(self.lm_head.shape),
                                          self.lm_head.dtype, generator,
                                          self.device))
        return self

    def init_cache(self, batch: int, seq_len: int):
        cfg = self.cfg
        return init_full_cache(cfg.num_layers, batch, seq_len,
                               cfg.num_kv_heads, cfg.d_head,
                               dtype_of(cfg.param_dtype), self.device)


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0):
    """The dense model on `device` (default `cuda`; raises without a
    card), with random weights from a `torch.Generator` seeded by `seed`
    on that device, or zero weights to be filled when `seed` is None."""
    device = resolve_device(device)
    model = DenseModel(cfg, device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


# -------------------------------------------------------------- forward ----

def embed_tokens(model: DenseModel, tokens):
    x = model.embed[tokens.long()]
    return x.to(dtype_of(model.cfg.compute_dtype))


def lm_logits(model: DenseModel, x):
    cfg = model.cfg
    x = rms_norm(x, model.out_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = x @ head.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        # mask the padding classes (vocab padded for shardability)
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def forward_from_embeds(model: DenseModel, x, angles, *, plan=None,
                        collect_kv=False):
    """Run the layer stack over full-sequence embeddings."""
    cfg = model.cfg
    kvs = []
    for layer in model.layers:
        a, kv = blocks.attn_full(layer.attn,
                                 rms_norm(x, layer.ln1, cfg.norm_eps), cfg,
                                 angles, causal=True)
        x = x + a
        x = x + blocks.apply_ffn_block(
            layer.ffn, rms_norm(x, layer.ln2, cfg.norm_eps), cfg, plan)
        if collect_kv:
            kvs.append(kv)
    return x, kvs


# -------------------------------------------------------- prefill/decode ----

@torch.no_grad()
def prefill(model: DenseModel, tokens, max_len: Optional[int] = None):
    """Dense prefill of tokens (B, S). Returns (logits (B, 1, V) of the
    last position, cache padded to `max_len` slots with kv_pos = -1 in the
    padding)."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = embed_tokens(model, tokens)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    angles = rope_angles(pos, cfg.d_head // 2, cfg.rope_theta)
    x, kvs = forward_from_embeds(model, x, angles, collect_kv=True)
    T = max_len or S
    cache = model.init_cache(B, T)
    for l, (k, v) in enumerate(kvs):
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
    cache["kv_pos"][:, :S] = pos.to(torch.int32)
    cache["length"].fill_(S)
    return lm_logits(model, x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: DenseModel, tokens, cache,
                plan: Optional[HybridPlan] = None, active_mask=None,
                collect_indices: bool = False):
    """tokens (B, 1) -> (logits (B, 1, V), cache[, cluster_ids]).

    The cache is updated in place and returned. active_mask (B,) bool:
    live rows for the sparse-FFN batch-union selection; None = all rows
    live. collect_indices=True also returns the per-layer selected cold
    cluster ids (L, G, kc), the trace the storage plane prices."""
    cfg = model.cfg
    pos = cache["length"]                              # (B,)
    x = embed_tokens(model, tokens)
    angles = rope_angles(pos[:, None], cfg.d_head // 2, cfg.rope_theta)
    kv_pos = write_pos(cache["kv_pos"], pos)
    cidxs = []
    for l, layer in enumerate(model.layers):
        a, _, _ = blocks.attn_decode(
            layer.attn, rms_norm(x, layer.ln1, cfg.norm_eps), cfg, angles,
            cache["k"][l], cache["v"][l], kv_pos, pos)
        x = x + a
        f = blocks.apply_ffn_block(
            layer.ffn, rms_norm(x, layer.ln2, cfg.norm_eps), cfg, plan,
            return_indices=collect_indices, active_mask=active_mask)
        if collect_indices:
            f, cidx = f
            cidxs.append(cidx)
        x = x + f
    cache["length"] = pos + 1
    logits = lm_logits(model, x)
    if collect_indices:
        # the dense path (no plan, or sparse FFN off) selects nothing
        trace = torch.stack(cidxs) if cidxs[0] is not None else None
        return logits, cache, trace
    return logits, cache


def make_decode_step(cfg: ModelConfig, collect_indices: bool = False):
    """The serving decode callable (model, tokens, cache, plan,
    active_mask) -> (logits, cache[, trace])."""
    def step(model, tokens, cache, plan=None, active_mask=None):
        return decode_step(model, tokens, cache, plan, active_mask,
                           collect_indices=collect_indices)
    return step
