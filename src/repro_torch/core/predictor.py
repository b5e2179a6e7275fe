"""Online activation predictor (PowerInfer-2 §3.2).

A low-rank two-matrix MLP per FFN layer scores each neuron's activation
for the current hidden state:

    score(x) = x @ A @ B          A: (d_model, r)   B: (r, n_neurons)

The predictor gates the *cold* path: only top-scored cold clusters are
gathered and computed. The offline planner (`core/planner.py`)
calibrates it against observed activations.
"""
from __future__ import annotations

import torch

from repro_torch.models.modules import dense_init


def init_predictor(d_model: int, n_neurons: int, rank: int, dtype,
                   generator: torch.Generator, device):
    """Random (A (d_model, rank), B (rank, n_neurons)) from `generator`,
    A drawn first: truncated normal at 1/sqrt(fan_in), the reference's
    rule."""
    A = dense_init((d_model, rank), dtype, generator, device)
    B = dense_init((rank, n_neurons), dtype, generator, device)
    return A, B


def predict_scores(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor):
    """x (..., d_model) -> neuron scores (..., n_neurons), fp32."""
    return (x.float() @ A.float()) @ B.float()


def predict_proba(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor):
    """Activation probability of each neuron, sigmoid of the score."""
    return torch.sigmoid(predict_scores(A, B, x))
