"""Transformer building blocks: the attention block (full + decode) and
the FFN block (dense or PowerInfer-2 hybrid).

Counterpart of `repro/models/blocks.py`, and `run_layer`, the layer
call with the reference's `jax.checkpoint` of scanned layers (remat).
Parameters keep the reference's
layouts (wq (d, H*dh), ffn w (N, R, D), predictor A (D, r) / B (r, N)) so
its weights load unchanged. They are built frozen (`requires_grad=False`),
as serving wants them; the train step (`train/steps.py`) makes them
require grad only while it differentiates the loss.

Over a group of ranks (`repro_torch.parallel`) a module is built at its
rank's slice (`ShardLayout`): attention holds its heads (`wq`/`wk`/`wv`
by columns, `wo` by rows, `attn_spec`'s split) when both head counts
divide the ranks, and all of them otherwise; the FFN holds its rows
(`FFN.rows`). The functions below take the group as `shard`: a split
region is entered through `shard.copy_in` and left through
`shard.reduce_out`, the one fp32 all-reduce each split needs forward,
and the one its input's gradient needs backward. A module built at a
slice draws its random weights leaf by leaf at the whole shape, from the
same generator stream as the whole model, and keeps its slice.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.predictor import init_predictor
from repro_torch.core.sparse_ffn import ffn_apply, ffn_rows
from repro_torch.models.attention import (
    apply_rotary, decode_attention, flash_attention, maybe_qk_norm)
from repro_torch.models.kv_cache import write_kv
from repro_torch.models.modules import dense_init


def run_layer(fn, *args, remat: bool = False):
    """fn(*args); with `remat` while autograd records, the layer's
    activations are recomputed in the backward pass instead of kept."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ------------------------------------------------------------ attention ----

class Attention(nn.Module):
    """q, k, v and output projections of the heads this rank holds (all
    of them without a layout)."""

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__()
        h, dh, kv, d = cfg.num_heads, cfg.d_head, cfg.num_kv_heads, cfg.d_model
        # (first q head, q heads, first kv head, kv heads) held
        self.heads = (0, h, 0, kv) if layout is None else layout.heads
        self.whole = (h, kv)
        self.d_head = dh
        h, kv = self.heads[1], self.heads[3]
        self.wq = _param((d, h * dh), dtype, device)
        self.wk = _param((d, kv * dh), dtype, device)
        self.wv = _param((d, kv * dh), dtype, device)
        self.wo = _param((h * dh, d), dtype, device)
        # qk-norm (Qwen3): per-head (dh,) norm weights, zero at init as
        # the reference's (the (1 + w) scale makes that the identity)
        self.q_norm = _param((dh,), dtype, device) if cfg.qk_norm else None
        self.k_norm = _param((dh,), dtype, device) if cfg.qk_norm else None

    @property
    def split(self) -> bool:
        """True when this module holds a share of the heads."""
        return self.heads[1] < self.whole[0]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        q0, nq, k0, nk = self.heads
        dh, d = self.d_head, self.wq.shape[0]
        H, KV = self.whole
        for p, shape, sl in (
                (self.wq, (d, H * dh), (slice(None), slice(q0 * dh,
                                                           (q0 + nq) * dh))),
                (self.wk, (d, KV * dh), (slice(None), slice(k0 * dh,
                                                            (k0 + nk) * dh))),
                (self.wv, (d, KV * dh), (slice(None), slice(k0 * dh,
                                                            (k0 + nk) * dh))),
                (self.wo, (H * dh, d), (slice(q0 * dh, (q0 + nq) * dh),))):
            p.copy_(dense_init(shape, p.dtype, generator, p.device,
                               index=sl))


def _qkv(p: Attention, x, cfg: ModelConfig, angles, shard=None):
    """Project + rope. x (B,S,D) -> q (B,S,H,dh), k/v (B,S,KV,dh) of the
    heads p holds (x enters the split through `copy_in` when p holds a
    share of them)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    h, kv = p.wq.shape[1] // dh, p.wk.shape[1] // dh
    if shard is not None and p.split:
        x = shard.copy_in(x)
    q = (x @ p.wq).reshape(B, S, h, dh)
    k = (x @ p.wk).reshape(B, S, kv, dh)
    v = (x @ p.wv).reshape(B, S, kv, dh)
    q, k = maybe_qk_norm(q, k, p.q_norm, p.k_norm, cfg.norm_eps)
    if angles is not None:
        q = apply_rotary(q, angles)
        k = apply_rotary(k, angles)
    return q, k, v


def _out(p: Attention, o, cfg: ModelConfig, shard):
    """o @ wo; the heads' partial sums joined in fp32 when this rank
    holds a share of the heads."""
    y = o @ p.wo
    if shard is not None and p.split:
        y = shard.reduce_out(y)
    return y


def attn_full(p: Attention, x, cfg: ModelConfig, angles, *, causal=True,
              window=0, shard=None):
    """Full-sequence self attention. Returns (out, (k, v)) for caching
    (k, v of this rank's kv heads)."""
    q, k, v = _qkv(p, x, cfg, angles, shard)
    o = flash_attention(q, k, v, causal=causal, window=window)
    B, S = x.shape[:2]
    return _out(p, o.reshape(B, S, -1), cfg, shard), (k, v)


def attn_decode(p: Attention, x, cfg: ModelConfig, angles, k_cache, v_cache,
                kv_pos, pos, *, window=0, shard=None):
    """One-token self attention vs cache. x (B,1,D); pos (B,) absolute.

    Writes the new token's k/v (RoPE pre-applied) into its slot in place,
    then attends over the updated cache. `kv_pos` must already include
    the current position. Returns (out, k_cache, v_cache).
    """
    q, k_new, v_new = _qkv(p, x, cfg, angles, shard)
    k_cache, v_cache = write_kv(k_cache, v_cache, k_new, v_new, pos)
    o = decode_attention(q, k_cache, v_cache, kv_pos, pos, window=window)
    return _out(p, o.reshape(*x.shape[:2], -1), cfg, shard), k_cache, \
        v_cache


def cross_attn(p: Attention, x, mem_k, mem_v, cfg: ModelConfig,
               shard=None):
    """Attention of x (B, S, D) to precomputed encoder memory mem_k /
    mem_v (B, F, KV, dh) of the kv heads p holds: no RoPE, no mask. Over
    ranks x enters the split through `copy_in` and the heads' partial
    outputs are joined after `wo`."""
    B, S, _ = x.shape
    if shard is not None and p.split:
        x = shard.copy_in(x)
    q = (x @ p.wq).reshape(B, S, -1, cfg.d_head)
    o = flash_attention(q, mem_k, mem_v, causal=False)
    return _out(p, o.reshape(B, S, -1), cfg, shard)


# ------------------------------------------------------------------ FFN ----

class FFN(nn.Module):
    """Bundled FFN weights w (N, R, D) and, when the config enables the
    sparse FFN, the activation predictor A (D, r) / B (r, N).

    Quantized cold storage (`quant.storage.quantize_plan_params`) adds
    the buffers wq (N, R, D) int8 codes, wsc (N, R) fp32 per-row scales
    and, for int4-mixed, wout (N, R, D) fp16 outliers; they stay None for
    fp16 storage. (Attention's wq is the query projection; these live on
    the FFN module.)

    With a layout, every N-sized dim holds this rank's rows only and
    `rows` (a NeuronRows) maps global neuron ids to them; A is whole."""

    def __init__(self, cfg: ModelConfig, dtype, device, layout=None):
        super().__init__()
        self.rows = None if layout is None else layout.ffn
        N, R, D = cfg.d_ff, ffn_rows(cfg.activation), cfg.d_model
        if self.rows is not None:
            N = len(self.rows.ids)
        self.w = _param((N, R, D), dtype, device)
        rank = cfg.sparse_ffn.predictor_rank if cfg.sparse_ffn.enabled else 0
        self.pred_A = _param((D, rank), dtype, device) if rank else None
        self.pred_B = _param((rank, N), dtype, device) if rank else None
        for name in ("wq", "wsc", "wout"):
            self.register_buffer(name, None)

    @property
    def pred(self):
        return None if self.pred_A is None else (self.pred_A, self.pred_B)

    @property
    def quant(self):
        """(wq, wsc, wout) of quantized cold storage, or None (fp16)."""
        return None if self.wq is None else (self.wq, self.wsc, self.wout)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        ids = slice(None) if self.rows is None else \
            torch.from_numpy(self.rows.ids).to(self.w.device)
        N = self.w.shape[0] if self.rows is None else self.rows.n_neurons
        _, R, D = self.w.shape
        self.w.copy_(dense_init((N, R, D), self.w.dtype, generator,
                                self.w.device, index=ids))
        if self.pred_A is not None:
            r = self.pred_A.shape[1]
            A, B = init_predictor(D, N, r, self.w.dtype, generator,
                                  self.w.device)
            self.pred_A.copy_(A)
            self.pred_B.copy_(B[:, ids])


def apply_ffn_block(p: FFN, x, cfg: ModelConfig, plan, return_indices=False,
                    active_mask=None, shard=None):
    return ffn_apply(p.w, p.pred, x, cfg.activation, cfg.sparse_ffn, plan,
                     return_indices=return_indices, active_mask=active_mask,
                     quant=p.quant, shard=shard, rows=p.rows)
