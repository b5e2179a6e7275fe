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


class EncLayer(nn.Module):
    """ln1, self attention, ln2, the (dense) FFN."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = blocks._param((cfg.d_model,), dtype, device)
        self.attn = blocks.Attention(cfg, dtype, device)
        self.ln2 = blocks._param((cfg.d_model,), dtype, device)
        self.ffn = blocks.FFN(cfg, dtype, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        self.attn.init_weights(generator)
        self.ffn.init_weights(generator)


class DecLayer(EncLayer):
    """An encoder layer's weights plus lnx and the cross attention
    xattn."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        self.lnx = blocks._param((cfg.d_model,), dtype, device)
        self.xattn = blocks.Attention(cfg, dtype, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        super().init_weights(generator)
        self.xattn.init_weights(generator)


class EncDecModel(nn.Module):
    """embed, enc_norm, out_norm, the encoder and decoder layers and
    lm_head (D, V_padded)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        p = blocks._param
        self.embed = p((cfg.vocab_padded, cfg.d_model), dtype, device)
        self.enc_norm = p((cfg.d_model,), dtype, device)
        self.out_norm = p((cfg.d_model,), dtype, device)
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, dtype, device)
            for _ in range(cfg.num_encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, device)
                                        for _ in range(cfg.num_layers))
        # the reference always holds lm_head; a tied config leaves it
        # unused (dense.lm_logits reads the embedding)
        self.lm_head = p((cfg.d_model, cfg.vocab_padded), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        cfg = self.cfg
        self.embed.copy_(embed_init(cfg.vocab_padded, cfg.d_model,
                                    self.embed.dtype, generator, self.device))
        for layer in (*self.enc_layers, *self.dec_layers):
            layer.init_weights(generator)
        self.lm_head.copy_(dense_init(tuple(self.lm_head.shape),
                                      self.lm_head.dtype, generator,
                                      self.device))
        return self

    def init_cache(self, batch: int, seq_len: int):
        """Self-attention k / v (L, B, T, KV, dh), T = min(window,
        seq_len) with a sliding window, else seq_len; cross memory mem_k
        / mem_v (L, B, num_frames, KV, dh); kv_pos (B, T); length."""
        cfg = self.cfg
        mem = self._self_cache(batch, cfg.num_frames)
        return dict(init_ring_cache(cfg.num_layers, batch, seq_len,
                                    cfg.sliding_window, cfg.num_kv_heads,
                                    cfg.d_head, dtype_of(cfg.param_dtype),
                                    self.device),
                    mem_k=mem["k"], mem_v=mem["v"])

    def _self_cache(self, batch: int, T: int):
        """k / v (L, B, T, KV, dh), kv_pos (B, T) and length (B,)."""
        cfg = self.cfg
        return init_full_cache(cfg.num_layers, batch, T, cfg.num_kv_heads,
                               cfg.d_head, dtype_of(cfg.param_dtype),
                               self.device)


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0):
    """The encdec model on `device` (default `cuda`; raises without a
    card), random weights from a `torch.Generator` seeded by `seed`, or
    zero weights to be filled when `seed` is None."""
    device = resolve_device(device)
    model = EncDecModel(cfg, device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _angles(cfg, n, device):
    return rope_angles(torch.arange(n, device=device), cfg.d_head // 2,
                       cfg.rope_theta)


def _enc_layer(lp: EncLayer, h, cfg, angles):
    a, _ = blocks.attn_full(lp.attn, rms_norm(h, lp.ln1, cfg.norm_eps), cfg,
                            angles, causal=False)
    h = h + a
    return h + blocks.apply_ffn_block(
        lp.ffn, rms_norm(h, lp.ln2, cfg.norm_eps), cfg, None)


def encode(model: EncDecModel, frames):
    """frames (B, F, D) stub embeddings -> encoder memory (B, F, D)."""
    cfg = model.cfg
    x = frames.to(device=model.device, dtype=dtype_of(cfg.compute_dtype))
    angles = _angles(cfg, x.shape[1], x.device)
    for lp in model.enc_layers:
        x = blocks.run_layer(_enc_layer, lp, x, cfg, angles,
                             remat=cfg.remat)
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


def cross_memory(model: EncDecModel, memory):
    """Every decoder layer's cross K/V of the encoder memory: (mem_k,
    mem_v), each (L, B, F, KV, dh)."""
    B, F, _ = memory.shape
    kv, dh = model.cfg.num_kv_heads, model.cfg.d_head
    mk = torch.stack([(memory @ lp.xattn.wk).reshape(B, F, kv, dh)
                      for lp in model.dec_layers])
    mv = torch.stack([(memory @ lp.xattn.wv).reshape(B, F, kv, dh)
                      for lp in model.dec_layers])
    return mk, mv


def _dec_layer_full(lp: DecLayer, x, cfg, angles, mem_k, mem_v, plan):
    a, kv = blocks.attn_full(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg,
                             angles, causal=True, window=cfg.sliding_window)
    x = x + a
    x = x + blocks.cross_attn(lp.xattn, rms_norm(x, lp.lnx, cfg.norm_eps),
                              mem_k, mem_v, cfg)
    x = x + blocks.apply_ffn_block(lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps),
                                   cfg, plan)
    return x, kv


def _decoder(model, tokens, frames, plan, collect_kv):
    """(x after the decoder layers, their k/v, mem_k, mem_v)."""
    cfg = model.cfg
    mk, mv = cross_memory(model, encode(model, frames))
    x = dense.embed_tokens(model, tokens)
    angles = _angles(cfg, x.shape[1], x.device)
    kvs = []
    for l, lp in enumerate(model.dec_layers):
        x, kv = blocks.run_layer(_dec_layer_full, lp, x, cfg, angles, mk[l],
                                 mv[l], plan, remat=cfg.remat)
        if collect_kv:
            kvs.append(kv)
    return x, kvs, mk, mv


def forward(model: EncDecModel, tokens, frames, plan=None):
    """Full-sequence logits (B, S, V) of the decoder over `tokens` (B, S)
    given the frames (B, F, D); differentiable when grad is enabled and
    the parameters require it."""
    x, _, _, _ = _decoder(model, tokens, frames, plan, False)
    return dense.lm_logits(model, x)


@torch.no_grad()
def prefill(model: EncDecModel, tokens, frames,
            max_len: Optional[int] = None):
    """Encode the frames, then prefill tokens (B, S) with the dense FFN:
    (logits (B, 1, V) of the last position, the cache padded to
    `max_len` slots). With a sliding window W < S the self-attention
    cache is the ring of the last W tokens (S must then be a multiple of
    W; it raises otherwise)."""
    B, S = tokens.shape
    T, n = prefill_slots(S, model.cfg.sliding_window, max_len)
    x, kvs, mk, mv = _decoder(model, tokens, frames, None, True)
    cache = dict(model._self_cache(B, T), mem_k=mk, mem_v=mv)
    return dense.lm_logits(model, x[:, -1:]), write_prefill(cache, kvs, S,
                                                            n)


@torch.no_grad()
def decode_step(model: EncDecModel, tokens, cache, plan=None):
    """tokens (B, 1) -> (logits (B, 1, V), cache), the cache updated in
    place and returned; every decoder FFN runs the hybrid FFN under
    `plan`."""
    cfg = model.cfg
    pos = cache["length"]
    x = dense.embed_tokens(model, tokens)
    angles = rope_angles(pos[:, None], cfg.d_head // 2, cfg.rope_theta)
    kv_pos = write_pos(cache["kv_pos"], pos)
    for l, lp in enumerate(model.dec_layers):
        a, _, _ = blocks.attn_decode(
            lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, angles,
            cache["k"][l], cache["v"][l], kv_pos, pos,
            window=cfg.sliding_window)
        x = x + a
        x = x + blocks.cross_attn(lp.xattn, rms_norm(x, lp.lnx, cfg.norm_eps),
                                  cache["mem_k"][l], cache["mem_v"][l], cfg)
        x = x + blocks.apply_ffn_block(
            lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps), cfg, plan)
    cache["length"].add_(1)      # pos is this tensor: every use came first
    return dense.lm_logits(model, x), cache
