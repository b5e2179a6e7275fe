"""Numerics leaves and parameter init helpers (PyTorch).

Counterpart of `repro/models/modules.py`. Random init draws from an
explicit `torch.Generator`; torch's numbers differ from `jax.random`'s
for the same seed, so parity tests hand both packages the same numpy
weights (see `repro_torch.bridge`).
"""
from __future__ import annotations

import math

import numpy as np
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


def torch_index(index, device):
    """An index as `parallel.placements` gives it (slices and numpy id
    arrays) with its id arrays as tensors on `device`; None stays
    None."""
    if index is None:
        return None
    if not isinstance(index, tuple):
        index = (index,)
    return tuple(torch.from_numpy(i).to(device) if isinstance(i, np.ndarray)
                 else i for i in index)


def trunc_normal(shape, generator: torch.Generator, device, std: float = 1.0,
                 bound: float = 2.0, index=None) -> torch.Tensor:
    """fp32 normal truncated to [-bound, bound] standard deviations, by
    inverting the normal CDF on a uniform draw from `generator`. With
    `index`, the part [index] of that draw: the whole shape is drawn (the
    generator advances as for the whole) and only the part transformed,
    which is elementwise, so it equals the whole's part bit for bit."""
    lo = 0.5 * (1.0 + math.erf(-bound / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(bound / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    if index is not None:
        u = u[torch_index(index, device)]
    z = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return z.clamp_(-bound, bound) * std


def dense_init(shape, dtype, generator, device, scale: float | None = None,
               index=None):
    """Truncated-normal init with 1/sqrt(fan_in) scale (last-but-one dim),
    the reference's rule; with `index`, that part of it (`trunc_normal`)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return trunc_normal(shape, generator, device, std=scale,
                        index=index).to(dtype)


def embed_init(vocab: int, dim: int, dtype, generator, device, index=None):
    """N(0, 0.02) embedding rows; with `index`, that part of them."""
    z = torch.randn((vocab, dim), generator=generator, device=device,
                    dtype=torch.float32)
    return ((z if index is None else z[torch_index(index, device)]) * 0.02
            ).to(dtype)


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
