"""Transformer building blocks: the attention block (full + decode) and
the FFN block (dense or PowerInfer-2 hybrid).

Counterpart of `repro/models/blocks.py`. Parameters keep the reference's
layouts (wq (d, H*dh), ffn w (N, R, D), predictor A (D, r) / B (r, N)) so
its weights load unchanged; they are frozen (`requires_grad=False`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_ffn import ffn_apply, ffn_rows
from repro_torch.models.attention import (
    apply_rotary, decode_attention, flash_attention)
from repro_torch.models.kv_cache import write_kv
from repro_torch.models.modules import dense_init


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ------------------------------------------------------------ attention ----

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        if cfg.qk_norm:
            raise NotImplementedError(
                f"{cfg.name}: qk-norm attention is not ported yet")
        h, dh, kv, d = cfg.num_heads, cfg.d_head, cfg.num_kv_heads, cfg.d_model
        self.wq = _param((d, h * dh), dtype, device)
        self.wk = _param((d, kv * dh), dtype, device)
        self.wv = _param((d, kv * dh), dtype, device)
        self.wo = _param((h * dh, d), dtype, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for p in (self.wq, self.wk, self.wv, self.wo):
            p.copy_(dense_init(tuple(p.shape), p.dtype, generator, p.device))


def _qkv(p: Attention, x, cfg: ModelConfig, angles):
    """Project + rope. x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KV,dh)."""
    B, S, _ = x.shape
    h, dh = cfg.num_heads, cfg.d_head
    kv = p.wk.shape[1] // dh
    q = (x @ p.wq).reshape(B, S, h, dh)
    k = (x @ p.wk).reshape(B, S, kv, dh)
    v = (x @ p.wv).reshape(B, S, kv, dh)
    if angles is not None:
        q = apply_rotary(q, angles)
        k = apply_rotary(k, angles)
    return q, k, v


def attn_full(p: Attention, x, cfg: ModelConfig, angles, *, causal=True,
              window=0):
    """Full-sequence self attention. Returns (out, (k, v)) for caching."""
    q, k, v = _qkv(p, x, cfg, angles)
    o = flash_attention(q, k, v, causal=causal, window=window)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p.wo, (k, v)


def attn_decode(p: Attention, x, cfg: ModelConfig, angles, k_cache, v_cache,
                kv_pos, pos, *, window=0):
    """One-token self attention vs cache. x (B,1,D); pos (B,) absolute.

    Writes the new token's k/v (RoPE pre-applied) into its slot in place,
    then attends over the updated cache. `kv_pos` must already include
    the current position. Returns (out, k_cache, v_cache).
    """
    q, k_new, v_new = _qkv(p, x, cfg, angles)
    k_cache, v_cache = write_kv(k_cache, v_cache, k_new, v_new, pos)
    o = decode_attention(q, k_cache, v_cache, kv_pos, pos, window=window)
    return o.reshape(*x.shape[:2], -1) @ p.wo, k_cache, v_cache


# ------------------------------------------------------------------ FFN ----

class FFN(nn.Module):
    """Bundled FFN weights w (N, R, D) and, when the config enables the
    sparse FFN, the activation predictor A (D, r) / B (r, N)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        N, R, D = cfg.d_ff, ffn_rows(cfg.activation), cfg.d_model
        self.w = _param((N, R, D), dtype, device)
        rank = cfg.sparse_ffn.predictor_rank if cfg.sparse_ffn.enabled else 0
        self.pred_A = _param((D, rank), dtype, device) if rank else None
        self.pred_B = _param((rank, N), dtype, device) if rank else None

    @property
    def pred(self):
        return None if self.pred_A is None else (self.pred_A, self.pred_B)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for p in (self.w, self.pred_A, self.pred_B):
            if p is not None:
                p.copy_(dense_init(tuple(p.shape), p.dtype, generator,
                                   p.device))


def apply_ffn_block(p: FFN, x, cfg: ModelConfig, plan, return_indices=False,
                    active_mask=None):
    return ffn_apply(p.w, p.pred, x, cfg.activation, cfg.sparse_ffn, plan,
                     return_indices=return_indices, active_mask=active_mask)
