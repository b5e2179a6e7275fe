"""Attention: RoPE, GQA prefill attention and decode-step attention.

Counterpart of `repro/models/attention.py`, plain PyTorch as the
reference is plain jnp. Shapes: q (B, Sq, H, dh); k/v (B, Skv, KV, dh);
GQA groups G = H // KV. RoPE is applied *before* caching, so cached K
carries absolute positions.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------- RoPE ----

def rope_angles(positions: torch.Tensor, d_half: int, theta: float):
    """positions (..., S) -> angles (..., S, d_half), fp32."""
    exps = torch.arange(d_half, dtype=torch.float32,
                        device=positions.device) / d_half
    inv = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv


def apply_rotary(x: torch.Tensor, angles: torch.Tensor):
    """Half-split rotation. x (B, S, H, dh), angles (B, S, dh//2) or
    (S, dh//2)."""
    dt = x.dtype
    d_half = x.shape[-1] // 2
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]                  # (B, S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :d_half].float(), x[..., d_half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


# ------------------------------------------------------ prefill attention ----

def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_block=1024):
    """Prefill attention with `repro.models.attention.flash_attention`'s
    numerics: fp32 scores, a -1e30 mask, and an online softmax over kv
    chunks of `kv_block` carrying (m, l, acc) in fp32. The reference also
    chunks q; rows are independent, so all of q runs at once here."""
    B, Sq, H, dh = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    kb = min(kv_block, Skv)
    if Skv % kb:
        raise ValueError(f"kv length {Skv} must be a multiple of the kv "
                         f"block {kb}")
    scale = dh ** -0.5
    qf = q.reshape(B, Sq, KV, G, dh).float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, dh), dtype=torch.float32,
                      device=q.device)
    for j in range(Skv // kb):
        kc = k[:, j * kb:(j + 1) * kb].float()
        vc = v[:, j * kb:(j + 1) * kb].float()
        kpos = j * kb + torch.arange(kb, device=q.device)
        s = torch.einsum("bqkgd,btkd->bkgqt", qf, kc) * scale
        mask = torch.ones((Sq, kb), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,G,Sq,dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


# ------------------------------------------------------ decode (Sq=1) ----

def decode_attention(q, k_cache, v_cache, kv_pos, pos, *, window=0):
    """One-token attention against a cache.

    q: (B, 1, H, dh) (RoPE already applied at `pos`).
    k_cache/v_cache: (B, T, KV, dh).
    kv_pos: (B, T) absolute position of each slot, -1 = empty.
    pos: (B,) current absolute position of the query token.
    """
    B, _, H, dh = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qr = q.reshape(B, KV, G, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qr, k_cache.float()) * scale
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window:
        valid &= (pos[:, None] - kv_pos) < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # PV in the cache dtype with fp32 accumulation, as the reference:
    # p is cast *down* to the cache dtype first
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, dh).to(q.dtype)
