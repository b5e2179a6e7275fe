"""VLM backbone (Qwen2-VL, arXiv:2409.12191): M-RoPE + GQA decoder.

Counterpart of `repro/models/vlm.py`, the model that the reference's
`build_model(cfg)` gives for family "vlm". LM backbone only: the vision
tower and projector are a stub, so callers hand in patch embeddings
(B, P, d_model), which go ahead of the text tokens. M-RoPE gives the
image patches 3D (t, h, w) rotary positions on a sqrt(P) grid; text
tokens take equal (t, h, w) positions continuing after the image.

The weights are the dense model's (`dense.DenseModel`). The serving
engine does not reach this module: it serves the vlm family's backbone
through the dense plane on token streams with plain 1-D RoPE, as the
reference's does. Decode here runs the same hybrid FFN (and, given a
plan with backend "pallas", the same `fused_cold_ffn` kernel) under the
M-RoPE positions of the text.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusters import HybridPlan
from repro_torch.models import dense
from repro_torch.models.attention import mrope_angles
from repro_torch.models.modules import dtype_of


def _grid(n_img: int) -> int:
    return max(int(n_img ** 0.5), 1)


def build_positions(cfg: ModelConfig, batch_size: int, n_img: int,
                    n_text: int, device=None) -> torch.Tensor:
    """(3, B, S) int32 M-RoPE position streams of the [image ; text]
    layout."""
    grid = _grid(n_img)
    idx = torch.arange(n_img, dtype=torch.int32, device=device)
    t_txt = grid + torch.arange(n_text, dtype=torch.int32, device=device)
    pos = torch.stack([
        torch.cat([torch.zeros_like(idx), t_txt]),
        torch.cat([idx // grid, t_txt]),
        torch.cat([idx % grid, t_txt]),
    ])                                                     # (3, S)
    return pos[:, None].expand(3, batch_size, pos.shape[1])


def make_model(cfg: ModelConfig, device=None, seed: Optional[int] = 0,
               layout=None):
    """The backbone's weights, as `dense.make_model` gives them."""
    if sum(cfg.mrope_sections) != cfg.d_head // 2:
        raise ValueError(f"{cfg.name}: M-RoPE sections {cfg.mrope_sections} "
                         f"do not split d_head // 2 = {cfg.d_head // 2}")
    return dense.make_model(cfg, device=device, seed=seed, layout=layout)


def _embed(model: dense.DenseModel, tokens, patch_embeds, shard=None):
    tok = dense.embed_tokens(model, tokens, shard)
    img = patch_embeds.to(device=tok.device,
                          dtype=dtype_of(model.cfg.compute_dtype))
    return torch.cat([img, tok], dim=1)


def _prefill_angles(cfg: ModelConfig, B: int, S: int, device):
    P = cfg.num_image_tokens
    return mrope_angles(build_positions(cfg, B, P, S - P, device),
                        cfg.mrope_sections, cfg.rope_theta)


def decode_angles(cfg: ModelConfig, pos):
    """M-RoPE angles (B, 1, dh/2) of the text token at cache index `pos`
    (B,), which counts the image slots: its position is grid + its text
    index, as `build_positions` gives it."""
    P = cfg.num_image_tokens
    p = pos - P + _grid(P)
    return mrope_angles(p[None, :, None].expand(3, -1, 1),
                        cfg.mrope_sections, cfg.rope_theta)


def forward(model: dense.DenseModel, tokens, patch_embeds,
            plan: Optional[HybridPlan] = None, shard=None):
    """Logits (B, P + S_text, V) of the whole [image ; text] sequence;
    differentiable (the training forward) when grad is enabled and the
    parameters require it. `shard` as in dense.forward."""
    x = _embed(model, tokens, patch_embeds, shard)
    B, S = x.shape[:2]
    x, _ = dense.forward_from_embeds(
        model, x, _prefill_angles(model.cfg, B, S, x.device), plan=plan,
        shard=shard)
    return dense.lm_logits(model, x, shard)


@torch.no_grad()
def prefill(model: dense.DenseModel, tokens, patch_embeds,
            max_len: Optional[int] = None, shard=None):
    """Prefill of patch_embeds (B, P, D) then tokens (B, S_text), with
    M-RoPE. Returns (logits (B, 1, V) of the last position, cache of
    `max_len` slots, default P + S_text). `shard` as in dense.prefill."""
    x = _embed(model, tokens, patch_embeds, shard)
    B, S = x.shape[:2]
    return dense.prefill_from_embeds(
        model, x, _prefill_angles(model.cfg, B, S, x.device), max_len,
        shard)


def make_decode_step(cfg: ModelConfig, collect_indices: bool = False,
                     shard=None):
    """The decode callable (model, tokens, cache, plan, active_mask) ->
    (logits, cache[, trace]) under M-RoPE positions."""
    return dense.make_decode_step(
        cfg, collect_indices=collect_indices,
        angles_fn=lambda pos: decode_angles(cfg, pos), shard=shard)
