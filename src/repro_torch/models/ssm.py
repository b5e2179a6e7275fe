"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060), the ssm family.

Counterpart of `repro/models/ssm.py`. Attention-free and FFN-free
(d_ff = 0), so the PowerInfer-2 hot/cold FFN does not apply and no hand
kernel runs here. Forward and prefill use the chunked SSD algorithm
(block-diagonal intra-chunk term plus a low-rank inter-chunk
recurrence); decode is the O(1) recurrent update h' = exp(dt*A) h +
dt*B x, y = C h + D x.

Over ranks each layer splits by whole heads (`parallel.ssm_range`): the
SSD scan of a head needs no other head, the gated norm sums the ranks'
squares (`ShardGroup.reduce_stat`) and the output projection's partial
sums are joined after `wo`.

The reference's einsums promote mixed bf16/fp32 operands to fp32; the
port casts to fp32 where they do. The decay cumsums run in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, dense
from repro_torch.models.modules import (
    dense_init, dtype_of, embed_init, resolve_device, rms_norm)
from repro_torch.parallel import cut_shape, placements, places_under


# ------------------------------------------------------------ SSD core ----

def segsum(x):
    """x (..., l) -> lower-triangular pairwise segment sums (..., l, l):
    out[i, j] = x[j+1] + ... + x[i] for j <= i, -inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return ss.masked_fill(~mask, float("-inf"))


def ssd_chunked(X, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan.

    X: (b, s, h, p) inputs (already dt-scaled); A: (b, s, h) log-decay
    per step (dt * A); B, C: (b, s, n) shared across heads. s must be a
    multiple of `chunk`. Returns (Y (b, s, h, p), final_state (b, h, p,
    n)) in X's dtype; the sums run in fp32."""
    b, s, h, p = X.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    Xc = X.reshape(b, c, chunk, h, p).float()
    Ac = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2).float()   # (b,h,c,l)
    Bc = B.reshape(b, c, chunk, n).float()
    Cc = C.reshape(b, c, chunk, n).float()
    A_cum = torch.cumsum(Ac, dim=-1)

    # 1. intra-chunk (block-diagonal) term
    L = torch.exp(segsum(Ac))                                   # (b,h,c,l,l)
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, Xc)

    # 2. per-chunk end states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)           # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, Xc)

    # 3. inter-chunk recurrence (the initial state as chunk -1)
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=X.dtype,
                                 device=X.device)
    states = torch.cat([init_state[:, None].float(), states], dim=1)
    chunk_decay = F.pad(A_cum[..., -1], (1, 0))                 # (b,h,c+1)
    dec = torch.exp(segsum(chunk_decay))                        # (b,h,c+1,c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dec, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output within each chunk
    state_decay = torch.exp(A_cum)                              # (b,h,c,l)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    Y = (Y_diag + Y_off).reshape(b, s, h, p).to(X.dtype)
    return Y, final_state.to(X.dtype)


def ssd_step(state, x, dA, dt, B, C):
    """One recurrent step. state (b,h,p,n); x (b,h,p); dA (b,h) = dt*A;
    dt (b,h); B, C (b,n). Returns (state', y (b,h,p))."""
    decay = torch.exp(dA)[..., None, None]
    dBx = dt[:, :, None, None] * x[..., None] * B[:, None, None, :]
    state = state * decay + dBx
    y = torch.einsum("bhpn,bn->bhp", state, C)
    return state, y


# --------------------------------------------------------- conv helper ----

def causal_conv(x, w, b, tail=None):
    """Depthwise causal conv with silu. x (B, S, C), w (W, C), b (C,);
    tail (B, W-1, C) carries the last inputs across calls. Returns
    (silu(conv + b), new_tail)."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(W):            # the reference's sum, in its order
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y + b), xp[:, -(W - 1):]


# ----------------------------------------------------------- the model ----

# leaves stored in fp32 whatever the model's dtype
_FP32 = ("A_log", "D", "dt_bias")


def leaf_shapes(cfg: ModelConfig) -> dict:
    """{leaf: whole shape} of a mamba2 layer, in the reference's order."""
    d, di, n, h = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                   cfg.ssm_heads)
    W = cfg.ssm_conv_width
    return {"ln": (d,), "wz": (d, di), "wx": (d, di), "wB": (d, n),
            "wC": (d, n), "wdt": (d, h), "conv_w": (W, di + 2 * n),
            "conv_b": (di + 2 * n,), "A_log": (h,), "D": (h,),
            "dt_bias": (h,), "gn": (di,), "wo": (di, d)}


class SSMLayer(nn.Module):
    """One mamba2 block in the reference's layout: ln (d), wz / wx (d,
    d_inner), wB / wC (d, n), wdt (d, h), conv_w (W, d_inner + 2n),
    conv_b, A_log / D / dt_bias (h,) in fp32, gn (d_inner), wo (d_inner,
    d).

    `place` ({leaf: index}, `parallel.placements` of one layer) gives the
    part of each leaf a rank holds: over ranks its heads' d_inner
    columns of wz / wx / gn / wo's rows, its heads of wdt / A_log / D /
    dt_bias; wB, wC and the conv stay whole."""

    def __init__(self, cfg: ModelConfig, dtype, device, place=None):
        super().__init__()
        self.whole = leaf_shapes(cfg)
        self.place = place or {}
        for name, shape in self.whole.items():
            setattr(self, name, blocks._param(
                cut_shape(shape, self.place.get((name,))),
                torch.float32 if name in _FP32 else dtype, device))
        # the d_inner columns [lo, hi) of the heads held
        cols = self.place.get(("wz",), (None, slice(None)))[1]
        self.inner = cols.indices(cfg.ssm_d_inner)[:2]

    @property
    def split(self) -> bool:
        """True when this layer holds a share of the heads."""
        return self.wz.shape[1] < self.whole["wz"][1]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The reference's `init_layer`: zero norms and conv bias, A_log
        0, D 1, dt_bias -2 (softplus ~ 0.12), the rest truncated normal
        at 1/sqrt(fan_in), conv_w at 0.5; a slice draws each leaf whole
        and keeps its part."""
        for name, scale in (("wz", None), ("wx", None), ("wB", None),
                            ("wC", None), ("wdt", None), ("conv_w", 0.5),
                            ("wo", None)):
            w = getattr(self, name)
            w.copy_(dense_init(self.whole[name], w.dtype, generator,
                               w.device, scale=scale,
                               index=self.place.get((name,))))
        self.D.fill_(1.0)
        self.dt_bias.fill_(-2.0)


class SSMModel(nn.Module):
    """embed (V_padded, D), out_norm, the layers; the head is the tied
    embedding. With `layout` (a `parallel.ShardLayout`) one rank's
    slice: its vocab rows and each layer's heads (`SSMLayer`)."""

    def __init__(self, cfg: ModelConfig, device, layout=None):
        super().__init__()
        if not cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: the ssm family ties its head")
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        self.places = {} if layout is None else placements(cfg, layout)
        self.vocab = (0, cfg.vocab_padded) if layout is None else \
            layout.vocab
        self.embed = blocks._param((self.vocab[1] - self.vocab[0],
                                    cfg.d_model), dtype, device)
        self.out_norm = blocks._param((cfg.d_model,), dtype, device)
        layer = places_under(self.places, ("layers",))
        self.layers = nn.ModuleList(SSMLayer(cfg, dtype, device, layer)
                                    for _ in range(cfg.num_layers))
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
        """Recurrent state: ssm (L, B, h, p, n), conv tails (L, B, W-1,
        d_inner + 2n), length (B,), of the heads (and their conv
        channels) this model holds; `seq_len` does not size it."""
        cfg = self.cfg
        h, p, n = self.layers[0].wdt.shape[1], cfg.ssm_head_dim, \
            cfg.ssm_state
        L, W = cfg.num_layers, cfg.ssm_conv_width
        dt, dev = dtype_of(cfg.param_dtype), self.device
        return {"ssm": torch.zeros((L, batch, h, p, n), dtype=dt, device=dev),
                "conv": torch.zeros((L, batch, W - 1, h * p + 2 * n),
                                    dtype=dt, device=dev),
                "length": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0,
               layout=None):
    """The ssm model on `device` (default `cuda`; raises without a
    card), random weights from a `torch.Generator` seeded by `seed`, or
    zero weights to be filled when `seed` is None; with `layout`, only
    that rank's slices."""
    device = resolve_device(device)
    model = SSMModel(cfg, device, layout)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _split(lp: SSMLayer, shard) -> bool:
    return shard is not None and lp.split


def _proj(lp: SSMLayer, x, shard=None):
    """x (B,S,D) -> z, xin, B, C, dt (pre-conv) of the heads lp holds; dt
    in fp32. Over ranks x enters the split through `copy_in`, and so do
    the whole wB and wC, whose gradient then sums every rank's heads'
    part."""
    wB, wC = lp.wB, lp.wC
    if _split(lp, shard):
        x, wB, wC = shard.copy_in(x), shard.copy_in(wB), shard.copy_in(wC)
    dt = F.softplus((x @ lp.wdt).float() + lp.dt_bias)
    return x @ lp.wz, x @ lp.wx, x @ wB, x @ wC, dt


def _conv_split(lp: SSMLayer, cfg: ModelConfig, xin, Bm, Cm, tail,
                shard=None):
    """The causal conv over [xin, B, C], split back: (xin, B, C, tail).
    A layer holding a share of the heads convolves its xin channels and
    the B and C channels, the whole conv entering through `copy_in`."""
    cw, cb = lp.conv_w, lp.conv_b
    if _split(lp, shard):
        cw, cb = shard.copy_in(cw), shard.copy_in(cb)
        (lo, hi), di = lp.inner, cfg.ssm_d_inner
        cw = torch.cat([cw[:, lo:hi], cw[:, di:]], dim=1)
        cb = torch.cat([cb[lo:hi], cb[di:]])
    out, tail = causal_conv(torch.cat([xin, Bm, Cm], dim=-1), cw, cb, tail)
    di, n = xin.shape[-1], cfg.ssm_state
    return out[..., :di], out[..., di:di + n], out[..., di + n:], tail


def gated_norm(lp: SSMLayer, y, cfg: ModelConfig, shard=None):
    """rms_norm(y, gn) over the whole d_inner: a layer holding a share of
    the heads sums its columns' squares with the other ranks'
    (`reduce_stat`) before the rsqrt."""
    if not _split(lp, shard):
        return rms_norm(y, lp.gn, cfg.norm_eps)
    yf = y.float()
    ss = shard.reduce_stat(yf.square().sum(dim=-1, keepdim=True))
    out = yf * torch.rsqrt(ss / cfg.ssm_d_inner + cfg.norm_eps)
    return (out * (1.0 + lp.gn.float())).to(y.dtype)


def _out(lp: SSMLayer, y, shard):
    """y @ wo, the heads' partial sums joined in fp32 over ranks."""
    out = y @ lp.wo
    return shard.reduce_out(out) if _split(lp, shard) else out


def _layer_full(lp: SSMLayer, x, cfg: ModelConfig, init_state=None,
                shard=None):
    """Full-sequence mamba2 block. Returns (out, (final_state, conv_tail))."""
    b, s, _ = x.shape
    h, p = lp.wdt.shape[1], cfg.ssm_head_dim
    xi = rms_norm(x, lp.ln, cfg.norm_eps)
    z, xin, Bm, Cm, dt = _proj(lp, xi, shard)
    xin, Bm, Cm, tail = _conv_split(lp, cfg, xin, Bm, Cm, None, shard)
    A = -torch.exp(lp.A_log)                                    # (h,)
    Xh = xin.reshape(b, s, h, p) * dt[..., None].to(xin.dtype)
    Ah = (dt * A).to(xin.dtype)
    Y, fstate = ssd_chunked(Xh, Ah, Bm, Cm, min(cfg.ssm_chunk, s),
                            init_state)
    Y = Y + lp.D.to(Y.dtype)[None, None, :, None] * xin.reshape(b, s, h, p)
    y = Y.reshape(b, s, h * p) * F.silu(z)
    y = gated_norm(lp, y, cfg, shard)
    return x + _out(lp, y, shard), (fstate, tail)


def _layer_step(lp: SSMLayer, x, cfg: ModelConfig, state, tail, shard=None):
    """One-token mamba2 step. x (B,1,D); state in fp32 inside."""
    b = x.shape[0]
    h, p = lp.wdt.shape[1], cfg.ssm_head_dim
    xi = rms_norm(x, lp.ln, cfg.norm_eps)
    z, xin, Bm, Cm, dt = _proj(lp, xi, shard)
    xin, Bm, Cm, tail = _conv_split(lp, cfg, xin, Bm, Cm, tail, shard)
    A = -torch.exp(lp.A_log)
    dt1 = dt[:, 0]                                              # (b,h)
    x1 = xin[:, 0].reshape(b, h, p).float()
    new, yh = ssd_step(state.float(), x1, dt1 * A, dt1, Bm[:, 0].float(),
                       Cm[:, 0].float())
    yh = yh + lp.D[None, :, None] * x1
    y = yh.reshape(b, 1, h * p).to(x.dtype) * F.silu(z)
    y = gated_norm(lp, y, cfg, shard)
    return (x + _out(lp, y, shard)).to(x.dtype), (new.to(state.dtype), tail)


def forward(model: SSMModel, tokens, plan=None, shard=None):
    """Full-sequence logits (B, S, V); differentiable when grad is
    enabled and the parameters require it. No FFN, so no plan applies.
    `shard`: the rank's group when the model is one rank's slice."""
    cfg = model.cfg
    x = dense.embed_tokens(model, tokens, shard)
    for lp in model.layers:
        x, _ = blocks.run_layer(_layer_full, lp, x, cfg, None, shard,
                                remat=cfg.remat)
    return dense.lm_logits(model, x, shard)


@torch.no_grad()
def prefill(model: SSMModel, tokens, max_len: Optional[int] = None,
            shard=None):
    """Prefill of tokens (B, S) (S a multiple of the chunk, or at most
    one chunk): (logits (B, 1, V) of the last position, the recurrent
    cache). `max_len` does not size the cache."""
    cfg = model.cfg
    B, S = tokens.shape
    x = dense.embed_tokens(model, tokens, shard)
    cache = model.init_cache(B)
    for l, lp in enumerate(model.layers):
        x, (state, tail) = _layer_full(lp, x, cfg, shard=shard)
        cache["ssm"][l] = state
        cache["conv"][l] = tail
    cache["length"].fill_(S)
    return dense.lm_logits(model, x[:, -1:], shard), cache


@torch.no_grad()
def decode_step(model: SSMModel, tokens, cache, plan=None, shard=None):
    """tokens (B, 1) -> (logits (B, 1, V), cache), the cache updated in
    place and returned."""
    cfg = model.cfg
    x = dense.embed_tokens(model, tokens, shard)
    for l, lp in enumerate(model.layers):
        x, (state, tail) = _layer_step(lp, x, cfg, cache["ssm"][l],
                                       cache["conv"][l], shard)
        cache["ssm"][l] = state
        cache["conv"][l] = tail
    cache["length"].add_(1)
    return dense.lm_logits(model, x, shard), cache
