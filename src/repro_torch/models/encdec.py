"""Encoder-decoder audio backbone (SeamlessM4T-v2, arXiv:2308.11596), the
encdec family.

Counterpart of `repro/models/encdec.py`. Transformer backbone only: the
mel-spectrogram and conformer frontend is a stub, so callers hand in
frame embeddings (B, num_frames, d_model). RoPE stands in for
Seamless's learned positions, as in the reference.

The encoder runs non-causal self attention and a dense FFN. Each decoder
layer runs causal self attention (cached at decode; a ring of
`cfg.sliding_window` slots when the window is set and shorter than the
prompt), cross attention to the encoder memory (its K/V computed once
at prefill and kept in the cache as mem_k / mem_v), then the FFN that
carries the PowerInfer-2 hybrid FFN (under a "pallas" plan, the
`fused_cold_ffn` kernel).

Over ranks (`parallel.shard_layout`) the self and cross attention split
by heads when both head counts divide the ranks (the memory's K/V then
held for the rank's heads only), the encoder FFNs by the prefill's rows
and the decoder FFNs by a decode step's, the embedding by vocab rows and
the untied head by vocab columns.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, dense
from repro_torch.models.attention import rope_angles
from repro_torch.models.kv_cache import (
    init_full_cache, init_ring_cache, prefill_slots, write_pos, write_prefill)
from repro_torch.models.modules import (
    dense_init, dtype_of, embed_init, resolve_device, rms_norm)
from repro_torch.parallel import placements


class EncLayer(nn.Module):
    """ln1, self attention, ln2, the (dense) FFN; with `layout` a rank's
    heads and FFN rows."""

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__()
        self.ln1 = blocks._param((cfg.d_model,), dtype, device)
        self.attn = blocks.Attention(cfg, dtype, device, layout)
        self.ln2 = blocks._param((cfg.d_model,), dtype, device)
        self.ffn = blocks.FFN(cfg, dtype, device, layout)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        self.attn.init_weights(generator)
        self.ffn.init_weights(generator)


class DecLayer(EncLayer):
    """An encoder layer's weights plus lnx and the cross attention
    xattn."""

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__(cfg, dtype, device, layout)
        self.lnx = blocks._param((cfg.d_model,), dtype, device)
        self.xattn = blocks.Attention(cfg, dtype, device, layout)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        self.xattn.init_weights(generator)


class EncDecModel(nn.Module):
    """embed, enc_norm, out_norm, the encoder and decoder layers and
    lm_head (D, V_padded). With `layout` (a `parallel.ShardLayout`) one
    rank's slice: its vocab rows of embed and columns of lm_head, the
    heads of every self and cross attention (when both head counts
    divide the ranks), the encoder FFNs' prefill rows (`enc_ffn`) and
    the decoder FFNs' decode rows."""

    def __init__(self, cfg: ModelConfig, device, layout=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        p = blocks._param
        self.places = {} if layout is None else placements(cfg, layout)
        self.vocab = (0, cfg.vocab_padded) if layout is None else \
            layout.vocab
        nv = self.vocab[1] - self.vocab[0]
        self.embed = p((nv, cfg.d_model), dtype, device)
        self.enc_norm = p((cfg.d_model,), dtype, device)
        self.out_norm = p((cfg.d_model,), dtype, device)
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, dtype, device, None if layout is None
                     else layout.enc)
            for _ in range(cfg.num_encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, device, layout)
                                        for _ in range(cfg.num_layers))
        # the reference always holds lm_head; a tied config leaves it
        # unused (dense.lm_logits reads the embedding)
        self.lm_head = p((cfg.d_model, nv), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        cfg = self.cfg
        self.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model,
                                    self.embed.dtype, generator, self.device,
                                    index=self.places.get(("embed",))))
        for layer in (*self.enc_layers, *self.dec_layers):
            layer.init_weights(generator)
        self.lm_head.copy_(dense_init((cfg.d_model, cfg.vocab_padded),
                                      self.lm_head.dtype, generator,
                                      self.device,
                                      index=self.places.get(("lm_head",))))
        return self

    @property
    def kv_heads(self) -> int:
        """The kv heads this model's caches hold (a rank's share when
        attention is head-sharded)."""
        return self.dec_layers[0].attn.wk.shape[1] // self.cfg.d_head

    def init_cache(self, batch: int, seq_len: int):
        """Self-attention k / v (L, B, T, KV, dh), T = min(window,
        seq_len) with a sliding window, else seq_len; cross memory mem_k
        / mem_v (L, B, num_frames, KV, dh); kv_pos (B, T); length."""
        cfg = self.cfg
        mem = self._self_cache(batch, cfg.num_frames)
        return dict(init_ring_cache(cfg.num_layers, batch, seq_len,
                                    cfg.sliding_window, self.kv_heads,
                                    cfg.d_head, dtype_of(cfg.param_dtype),
                                    self.device),
                    mem_k=mem["k"], mem_v=mem["v"])

    def _self_cache(self, batch: int, T: int):
        """k / v (L, B, T, KV, dh), kv_pos (B, T) and length (B,)."""
        cfg = self.cfg
        return init_full_cache(cfg.num_layers, batch, T, self.kv_heads,
                               cfg.d_head, dtype_of(cfg.param_dtype),
                               self.device)


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0,
               layout=None):
    """The encdec model on `device` (default `cuda`; raises without a
    card), random weights from a `torch.Generator` seeded by `seed`, or
    zero weights to be filled when `seed` is None; with `layout`, only
    that rank's slices."""
    device = resolve_device(device)
    model = EncDecModel(cfg, device, layout)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _angles(cfg, n, device):
    return rope_angles(torch.arange(n, device=device), cfg.d_head // 2,
                       cfg.rope_theta)


def _enc_layer(lp: EncLayer, h, cfg, angles, shard=None):
    a, _ = blocks.attn_full(lp.attn, rms_norm(h, lp.ln1, cfg.norm_eps), cfg,
                            angles, causal=False, shard=shard)
    h = h + a
    return h + blocks.apply_ffn_block(
        lp.ffn, rms_norm(h, lp.ln2, cfg.norm_eps), cfg, None, shard=shard)


def encode(model: EncDecModel, frames, shard=None):
    """frames (B, F, D) stub embeddings -> encoder memory (B, F, D)."""
    cfg = model.cfg
    x = frames.to(device=model.device, dtype=dtype_of(cfg.compute_dtype))
    angles = _angles(cfg, x.shape[1], x.device)
    for lp in model.enc_layers:
        x = blocks.run_layer(_enc_layer, lp, x, cfg, angles, shard,
                             remat=cfg.remat)
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


def cross_memory(model: EncDecModel, memory, shard=None):
    """Every decoder layer's cross K/V of the encoder memory: (mem_k,
    mem_v), each (L, B, F, KV, dh), of the kv heads each layer holds
    (over ranks the memory enters each split through `copy_in`)."""
    B, F, _ = memory.shape
    dh = model.cfg.d_head
    mk, mv = [], []
    for lp in model.dec_layers:
        m = shard.copy_in(memory) if shard is not None and lp.xattn.split \
            else memory
        mk.append((m @ lp.xattn.wk).reshape(B, F, -1, dh))
        mv.append((m @ lp.xattn.wv).reshape(B, F, -1, dh))
    return torch.stack(mk), torch.stack(mv)


def _dec_layer_full(lp: DecLayer, x, cfg, angles, mem_k, mem_v, plan,
                    shard=None):
    a, kv = blocks.attn_full(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg,
                             angles, causal=True, window=cfg.sliding_window,
                             shard=shard)
    x = x + a
    x = x + blocks.cross_attn(lp.xattn, rms_norm(x, lp.lnx, cfg.norm_eps),
                              mem_k, mem_v, cfg, shard)
    x = x + blocks.apply_ffn_block(lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps),
                                   cfg, plan, shard=shard)
    return x, kv


def _decoder(model, tokens, frames, plan, collect_kv, shard=None):
    """(x after the decoder layers, their k/v, mem_k, mem_v)."""
    cfg = model.cfg
    mk, mv = cross_memory(model, encode(model, frames, shard), shard)
    x = dense.embed_tokens(model, tokens, shard)
    angles = _angles(cfg, x.shape[1], x.device)
    kvs = []
    for l, lp in enumerate(model.dec_layers):
        x, kv = blocks.run_layer(_dec_layer_full, lp, x, cfg, angles, mk[l],
                                 mv[l], plan, shard, remat=cfg.remat)
        if collect_kv:
            kvs.append(kv)
    return x, kvs, mk, mv


def forward(model: EncDecModel, tokens, frames, plan=None, shard=None):
    """Full-sequence logits (B, S, V) of the decoder over `tokens` (B, S)
    given the frames (B, F, D); differentiable when grad is enabled and
    the parameters require it. `shard`: the rank's group when the model
    is one rank's slice."""
    x, _, _, _ = _decoder(model, tokens, frames, plan, False, shard)
    return dense.lm_logits(model, x, shard)


@torch.no_grad()
def prefill(model: EncDecModel, tokens, frames,
            max_len: Optional[int] = None, shard=None):
    """Encode the frames, then prefill tokens (B, S) with the dense FFN:
    (logits (B, 1, V) of the last position, the cache padded to
    `max_len` slots). With a sliding window W < S the self-attention
    cache is the ring of the last W tokens (S must then be a multiple of
    W; it raises otherwise)."""
    B, S = tokens.shape
    T, n = prefill_slots(S, model.cfg.sliding_window, max_len)
    x, kvs, mk, mv = _decoder(model, tokens, frames, None, True, shard)
    cache = dict(model._self_cache(B, T), mem_k=mk, mem_v=mv)
    return dense.lm_logits(model, x[:, -1:], shard), write_prefill(
        cache, kvs, S, n)


@torch.no_grad()
def decode_step(model: EncDecModel, tokens, cache, plan=None, shard=None,
                collect_indices: bool = False):
    """tokens (B, 1) -> (logits (B, 1, V), cache[, cluster_ids]), the
    cache updated in place and returned; every decoder FFN runs the
    hybrid FFN under `plan` (per rank over `shard`). collect_indices
    also returns every decoder FFN's selected cold cluster ids (L, G,
    kc), gathered over the ranks, or None on the dense path."""
    cfg = model.cfg
    pos = cache["length"]
    x = dense.embed_tokens(model, tokens, shard)
    angles = rope_angles(pos[:, None], cfg.d_head // 2, cfg.rope_theta)
    kv_pos = write_pos(cache["kv_pos"], pos)
    cidxs = []
    for l, lp in enumerate(model.dec_layers):
        a, _, _ = blocks.attn_decode(
            lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, angles,
            cache["k"][l], cache["v"][l], kv_pos, pos,
            window=cfg.sliding_window, shard=shard)
        x = x + a
        x = x + blocks.cross_attn(lp.xattn, rms_norm(x, lp.lnx, cfg.norm_eps),
                                  cache["mem_k"][l], cache["mem_v"][l], cfg,
                                  shard)
        f = blocks.apply_ffn_block(
            lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps), cfg, plan,
            return_indices=collect_indices, shard=shard)
        if collect_indices:
            f, cidx = f
            cidxs.append(cidx)
        x = x + f
    cache["length"].add_(1)      # pos is this tensor: every use came first
    logits = dense.lm_logits(model, x, shard)
    if collect_indices:
        trace = torch.stack(cidxs) if cidxs[0] is not None else None
        return logits, cache, trace
    return logits, cache
