"""Public wrappers of the port's hand-written CUDA kernels.

A wrapper runs its kernel's plain version (`kernels/ref.py`) when the
tensors lie on the CPU. For CUDA tensors it checks devices, dtypes,
shapes and strides, allocates outputs and scratch with `torch.empty`,
launches on the current stream and raises if the launch fails: it never
falls back to the plain version. Each wrapper keeps a plain integer
`launches` count, raised by one per call that launches its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import fused_cold_ffn_ref

_ACT_CODES = {"silu": 0, "relu2": 1, "gelu": 2, "geglu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 64


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def fused_cold_ffn(x, wc, A, Bp, *, activation: str, mode: str = "relu",
                   kc: int, active_mask=None, wq=None, wsc=None, wout=None):
    """Fused cold path: predictor score -> batch-union top-k -> cluster
    gather -> gated FFN (replaces `repro.kernels.ops.fused_cold_ffn`).

    x (B, D); wc (G, nc_g, cs, R, D) cold clusters per group; A (D, r)
    and Bp (r, G*nc_g*cs) the predictor's cold slice (Bp may be a column
    slice: its rows need only unit stride); kc clusters kept per group.
    `mode == "cats"` gates each token by its own score; `active_mask` (B,)
    bool keeps dead KV-arena lanes out of the batch union. Returns
    (y (B, D) fp32, idx (G, kc) int32).
    """
    if wq is not None or wsc is not None or wout is not None:
        raise NotImplementedError(
            "quantized cold bundles (wq/wsc/wout) belong to the "
            "quantized-storage slice, which the port has not reached")
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if mode not in ("relu", "cats"):
        raise ValueError(f"unknown sparse mode {mode!r}")
    G, nc_g, cs, R, D = wc.shape
    B = x.shape[0]
    if active_mask is None:
        mask = torch.ones((B,), dtype=torch.float32, device=x.device)
    else:
        mask = active_mask.to(device=x.device, dtype=torch.float32).reshape(B)
    cats = mode == "cats"
    if x.device.type == "cpu":
        return fused_cold_ffn_ref(x, wc, A, Bp, mask, activation=activation,
                                  cats=cats, kc=kc)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cold_ffn runs on cpu or cuda, not "
                         f"{x.device}")
    r = A.shape[1]
    Nc = G * nc_g * cs
    for name, t in (("wc", wc), ("A", A), ("Bp", Bp)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: the "
                            f"kernel takes one dtype for all four")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_cold_ffn takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[1] != D or A.shape != (D, r) \
            or Bp.dim() != 2 or Bp.shape[0] != r or Bp.shape[1] < Nc:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, wc "
                         f"{tuple(wc.shape)}, A {tuple(A.shape)}, Bp "
                         f"{tuple(Bp.shape)}")
    if not (1 <= B <= MAX_BATCH and R in (2, 3) and 1 <= kc <= nc_g
            and cs <= 1024 and 1 <= r <= 1024 and nc_g <= 12288):
        raise ValueError(f"unsupported shape: B={B} (1..{MAX_BATCH}), "
                         f"R={R} (2|3), kc={kc} (1..nc_g={nc_g}), cs={cs} "
                         f"(<=1024), r={r} (<=1024), nc_g <= 12288")
    if not (x.is_contiguous() and wc.is_contiguous() and A.is_contiguous()
            and Bp.stride(1) == 1):
        raise ValueError("x, wc and A must be contiguous and Bp's rows "
                         "unit-stride")
    from repro_torch.kernels.build import library   # builds at first use
    lib = library("fused_cold_ffn")
    dev = x.device
    f32 = torch.float32
    y = torch.empty((B, D), dtype=f32, device=dev)
    idx = torch.empty((G, kc), dtype=torch.int32, device=dev)
    h = torch.empty((B, r), dtype=f32, device=dev)
    scores = torch.empty((B, Nc), dtype=f32, device=dev)
    tile_max = torch.empty(((B + 7) // 8, G * nc_g), dtype=f32, device=dev)
    H = torch.empty((B, G * kc * cs), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_cold_ffn_launch(
            _ptr(x), _ptr(wc), _ptr(A), _ptr(Bp), Bp.stride(0), _ptr(mask),
            _ptr(y), _ptr(idx), _ptr(h), _ptr(scores), _ptr(tile_max),
            _ptr(H), B, D, r, G, nc_g, cs, R, kc, _ACT_CODES[activation],
            int(cats), _DTYPE_CODES[x.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_cold_ffn launch failed: CUDA error {rc} "
                           f"({lib.fused_cold_ffn_error_string(rc).decode()})")
    fused_cold_ffn.launches += 1
    return y, idx


fused_cold_ffn.launches = 0

__all__ = ["fused_cold_ffn"]
