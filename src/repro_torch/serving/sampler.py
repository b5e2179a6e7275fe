"""Token sampling: greedy, temperature and top-k, plus Best-of-N scoring.

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


def sequence_logprob(logits_seq: torch.Tensor,
                     tokens_seq: torch.Tensor) -> torch.Tensor:
    """Mean token log-prob of tokens_seq (B, S) under logits_seq (B, S,
    V), in fp32: the Best-of-N ranking score (the paper's Fig 1b)."""
    logp = torch.log_softmax(logits_seq.float(), dim=-1)
    ll = logp.gather(-1, tokens_seq.long()[..., None])[..., 0]
    return ll.mean(dim=-1)
