"""Numerics leaves and parameter init helpers (PyTorch).

Counterpart of `repro/models/modules.py`. Random init draws from an
explicit `torch.Generator`; torch's numbers differ from `jax.random`'s
for the same seed, so parity tests hand both packages the same numpy
weights (see `repro_torch.bridge`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Asking for CUDA on a host without a card raises; there is
    no fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


def trunc_normal(shape, generator: torch.Generator, device, std: float = 1.0,
                 bound: float = 2.0) -> torch.Tensor:
    """fp32 normal truncated to [-bound, bound] standard deviations, by
    inverting the normal CDF on a uniform draw from `generator`."""
    lo = 0.5 * (1.0 + math.erf(-bound / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(bound / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    z = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return z.clamp_(-bound, bound) * std


def dense_init(shape, dtype, generator, device, scale: float | None = None):
    """Truncated-normal init with 1/sqrt(fan_in) scale (last-but-one dim),
    the reference's rule."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return trunc_normal(shape, generator, device, std=scale).to(dtype)


def embed_init(vocab: int, dim: int, dtype, generator, device):
    return (torch.randn((vocab, dim), generator=generator, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMS norm in fp32 with the (1 + w) scale, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dt)


def _relu2(x):
    return torch.relu(x).square()


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "relu2":
        return _relu2
    if name in ("gelu", "geglu"):
        return _gelu_tanh
    raise ValueError(f"unknown activation {name!r}")
