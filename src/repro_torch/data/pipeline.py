"""Deterministic synthetic token pipeline (counterpart of
`repro/data/pipeline.py`).

Zipf-distributed token streams with short-range Markov structure
(repeated n-grams): the offline planner's profiling corpus, non-uniform
enough to give the activation profiler skewed neuron statistics. Numpy
with the reference's calls in the reference's order, so one `DataConfig`
gives bit-identical batches in both packages. Fully offline and seeded.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_repeat: float = 0.3     # prob. of copying a recent token


class SyntheticTokens:
    """Iterator of {'tokens': (B,S), 'labels': (B,S)} int32 numpy
    batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # Zipf over the vocab, renormalized
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.p = p / p.sum()

    def _sequence(self, length):
        out = np.empty(length + 1, np.int32)
        base = self.rng.choice(self.cfg.vocab_size, size=length + 1, p=self.p)
        out[:] = base
        # inject n-gram copies for learnable structure
        copy = self.rng.random(length + 1) < self.cfg.ngram_repeat
        lag = self.rng.integers(1, 8, size=length + 1)
        for i in np.nonzero(copy)[0]:
            if i >= lag[i]:
                out[i] = out[i - lag[i]]
        return out

    def batch(self):
        cfg = self.cfg
        seqs = np.stack([self._sequence(cfg.seq_len)
                         for _ in range(cfg.batch_size)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def __iter__(self):
        while True:
            yield self.batch()


def shard_batch(batch, device=None, replica: int = 0, dp: int = 1):
    """Host batch -> tensors on `device` (default `cuda`; raises on a
    host without a card). With dp > 1 data-parallel replicas, replica
    `replica`'s rows [r*B/dp, (r+1)*B/dp) of every array (the reference's
    P("data", None) placement); dp must divide the batch."""
    from repro_torch.models.modules import resolve_device
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % dp:
            raise ValueError(f"{k}: a batch of {B} rows does not split "
                             f"over dp={dp} replicas")
        rows = v[replica * B // dp:(replica + 1) * B // dp]
        out[k] = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    return out
