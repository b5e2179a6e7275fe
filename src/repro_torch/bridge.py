"""Weights from the reference's parameter layout.

`params_from_numpy(tree, cfg)` builds the port's model (`DenseModel`,
or `MoEModel` for the moe family) from the JAX package's parameter
pytree with every leaf given as a numpy array (`load_checkpoint` reads
that tree from a checkpoint the reference saved):
{"embed", "out_norm", ["lm_head"], "layers": {"ln1", "ln2", "attn":
{"wq", "wk", "wv", "wo", ["qk": {"q_norm", "k_norm"}]}, "ffn": {"w",
["pred": {"A", "B"}], ["wq", "wsc", ["wout"]]}}}, layer leaves stacked
(L, ...); the qk-norm weights are there when the config sets qk_norm,
and the FFN's wq/wsc/wout are the stored cold bundles of int8 /
int4-mixed storage. A moe tree has "moe": {"router", "experts",
["shared": {"w"}]} in place of "ffn". It reads numpy alone. bfloat16 leaves cross over bit for bit through a uint16 view:
numpy holds them as ml_dtypes' extension type, or, read back from a
`.npy` without it, as bare 2-byte voids or their uint16 bits, so a
leaf's declared dtype (`dtypes`, from a checkpoint's manifest) wins over
the array's own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import SEP, restore_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.models.dense import DenseModel
from repro_torch.models.moe import MoEModel
from repro_torch.models.modules import resolve_device


def _tensor(a, dtype: str = None) -> torch.Tensor:
    """A CPU tensor of the numpy array `a`; `dtype` is the leaf's
    declared dtype name (default: a's own)."""
    a = np.array(a)                 # a writable, contiguous copy
    name = dtype or a.dtype.name
    if name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a {a.dtype} array holds no bfloat16")
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name != name:
        raise TypeError(f"array is {a.dtype}, declared {name}")
    return torch.from_numpy(a)


def _leaf(tree, dtypes, *keys):
    """(array, declared dtype) of the leaf at `keys`; KeyError names the
    leaf as a checkpoint does."""
    t, d = tree, dtypes
    for k in keys:
        if k not in t:
            raise KeyError(f"missing leaf {SEP.join(keys)!r}")
        t, d = t[k], (d or {}).get(k)
    return t, d


@torch.no_grad()
def _load(param: torch.nn.Parameter, a, name: str, dtype: str = None):
    t = _tensor(a, dtype)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"the port's {tuple(param.shape)}")
    param.copy_(t.to(param.dtype))


def params_from_numpy(tree, cfg: ModelConfig, device=None,
                      dtypes=None) -> DenseModel:
    """The port's model on `device` (default `cuda`) holding `tree`'s
    weights; `dtypes` (the same nesting) declares leaves' dtypes."""
    model_type = MoEModel if cfg.family == "moe" else DenseModel
    model = model_type(cfg, resolve_device(device))

    def load(param, *keys, layer=None):
        a, dt = _leaf(tree, dtypes, *keys)
        name = ".".join(keys)
        if layer is not None:
            a, name = a[layer], f"{name}[{layer}]"
        _load(param, a, name, dt)

    load(model.embed, "embed")
    load(model.out_norm, "out_norm")
    if model.lm_head is not None:
        load(model.lm_head, "lm_head")
    for l, layer in enumerate(model.layers):
        load(layer.ln1, "layers", "ln1", layer=l)
        load(layer.ln2, "layers", "ln2", layer=l)
        for k in ("wq", "wk", "wv", "wo"):
            load(getattr(layer.attn, k), "layers", "attn", k, layer=l)
        if cfg.qk_norm:
            for k in ("q_norm", "k_norm"):
                load(getattr(layer.attn, k), "layers", "attn", "qk", k,
                     layer=l)
        if model_type is MoEModel:
            _load_moe(layer.moe, load, l)
        else:
            _load_ffn(layer.ffn, tree, dtypes, load, l, model.device)
    return model


def _load_ffn(ffn, tree, dtypes, load, l, device):
    load(ffn.w, "layers", "ffn", "w", layer=l)
    stored = _leaf(tree, dtypes, "layers", "ffn")[0]
    N, R, D = ffn.w.shape
    for k, shape in (("wq", (N, R, D)), ("wsc", (N, R)),
                     ("wout", (N, R, D))):
        if k in stored:
            a, dt = _leaf(tree, dtypes, "layers", "ffn", k)
            t = _tensor(a[l], dt)
            if tuple(t.shape) != shape:
                raise ValueError(f"layers.ffn.{k}[{l}]: shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            setattr(ffn, k, t.to(device))
    if ffn.pred_A is not None:
        load(ffn.pred_A, "layers", "ffn", "pred", "A", layer=l)
        load(ffn.pred_B, "layers", "ffn", "pred", "B", layer=l)


def _load_moe(moe, load, l):
    load(moe.router, "layers", "moe", "router", layer=l)
    load(moe.experts, "layers", "moe", "experts", layer=l)
    if moe.shared is not None:
        load(moe.shared, "layers", "moe", "shared", "w", layer=l)


def load_checkpoint(path: str, cfg: ModelConfig, device=None) -> DenseModel:
    """The port's model on `device` (default `cuda`) from a checkpoint the
    reference's `save_checkpoint` wrote (a parameter tree already
    permuted, and for int8 / int4-mixed storage quantized, to match the
    plan it is served with)."""
    ckpt = restore_numpy(path)
    return params_from_numpy(ckpt.tree, cfg, device, dtypes=ckpt.dtypes)
