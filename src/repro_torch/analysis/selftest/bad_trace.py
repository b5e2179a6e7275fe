"""Seeded violations: wall-clock, py-random, host-sync. Fixture only:
never imported or executed."""
import random
import time

import numpy as np
import torch


def decode_step(x, cache):
    y = torch.tanh(x)
    if y.sum() > 0:                  # a branch on a tensor: a host read
        y = y + 1.0
    cache["n"] = helper(y)
    return y


def helper(y):
    return y.max().item()            # reached from decode_step


def sample_delay():
    t0 = time.perf_counter()         # wall clock in serving code
    jitter = random.random()         # stdlib global RNG
    noise = np.random.rand(3)        # numpy global RNG
    w = torch.randn(4)               # torch's global generator
    w.normal_()                      # torch's global generator, in place
    return t0 + jitter + noise.sum() + float(w.sum())
