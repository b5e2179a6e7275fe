"""The one traffic generator: a mix's parameters (`traffic/<mix>.json`)
and a seed give the request stream a closed loop of clients consumes.

Every seed serves the same set of sizes in another order. Sizes come in
blocks of `block` requests; each block holds the mix's distribution at
`block` fixed quantiles, for prompts and for outputs, each in its own
order drawn from the seed. Whatever span of the stream a run consumes,
its sizes differ from another seed's only at the span's two ends. The
token ids are uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The distribution `dist` at the n midpoint quantiles (i + 0.5) / n,
    rounded to whole tokens and clipped to [min, max]."""
    p = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "uniform":
        v = lo + p * (hi - lo)
    elif dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(q) for q in p])
        v = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def seed_seq(seed: int) -> int:
    """A seed as numpy and torch take it: any whole number, folded to
    63 bits."""
    return int(seed) % (2 ** 63)


@dataclass
class Request:
    """One request of the stream and what the harness saw of it (host
    clock, seconds)."""
    index: int                     # position in the stream
    prompt: np.ndarray             # (S,) int32
    max_new: int
    due: float = None              # when its client sent it
    uid: int = None                # the engine's uid
    tokens: list = field(default_factory=list)
    token_times: list = field(default_factory=list)
    token_steps: list = field(default_factory=list)
    done: float = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


class Stream:
    """The mix's requests in stream order, made as they are consumed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.block = int(mix["block"])
        self._p = quantiles(mix["prompt"], self.block)
        self._o = quantiles(mix["output"], self.block)
        self._rng = np.random.default_rng(seed_seq(seed))
        self._sizes = []
        self.issued = 0

    def _next_sizes(self):
        if not self._sizes:
            sp = self._rng.permutation(self._p)
            so = self._rng.permutation(self._o)
            self._sizes = list(zip(sp.tolist(), so.tolist()))[::-1]
        return self._sizes.pop()

    def next(self) -> Request:
        s, o = self._next_sizes()
        prompt = self._rng.integers(0, self.vocab, s).astype(np.int32)
        req = Request(index=self.issued, prompt=prompt, max_new=int(o))
        self.issued += 1
        return req

    @property
    def longest(self) -> int:
        """The most KV positions a request of the mix can take."""
        return int(self._p.max() + self._o.max())
