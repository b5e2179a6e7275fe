"""PyTorch/CUDA port of the PowerInfer-2 reproduction.

A sibling of the JAX package `repro`, held against it by parity tests.
It imports torch and never jax, and nothing of `repro`.
"""
