"""Token sampling: greedy, temperature and top-k.

Counterpart of `repro/serving/sampler.py`. Randomness comes from an
explicit `torch.Generator`; no torch generator reproduces `jax.random`,
so the two packages agree token for token only at temperature 0.
"""
from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, generator: torch.Generator = None):
    """logits (B, V) -> (B,) int32. Greedy (first maximum) at
    temperature <= 0; otherwise a categorical draw from `generator`."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
