"""Online activation predictor (PowerInfer-2 §3.2).

A low-rank two-matrix MLP per FFN layer scores each neuron's activation
for the current hidden state:

    score(x) = x @ A @ B          A: (d_model, r)   B: (r, n_neurons)

The predictor gates the *cold* path: only top-scored cold clusters are
gathered and computed.
"""
from __future__ import annotations

import torch


def predict_scores(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor):
    """x (..., d_model) -> neuron scores (..., n_neurons), fp32."""
    return (x.float() @ A.float()) @ B.float()
