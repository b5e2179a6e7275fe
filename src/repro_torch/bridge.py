"""Weights from the reference's parameter layout.

`params_from_numpy(tree, cfg)` builds the port's `DenseModel` from the
JAX package's parameter pytree with every leaf given as a numpy array:
{"embed", "out_norm", ["lm_head"], "layers": {"ln1", "ln2", "attn":
{"wq", "wk", "wv", "wo"}, "ffn": {"w", ["pred": {"A", "B"}], ["wq",
"wsc", ["wout"]]}}}, layer leaves stacked (L, ...); the FFN's wq/wsc/wout
are the stored cold bundles of int8 / int4-mixed storage. It reads numpy
alone; bfloat16 leaves (numpy's ml_dtypes extension type) cross over bit
for bit through a uint16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dense import DenseModel
from repro_torch.models.modules import resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def _load(param: torch.nn.Parameter, a, name: str):
    t = _tensor(a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"the port's {tuple(param.shape)}")
    param.copy_(t.to(param.dtype))


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> DenseModel:
    """The port's model on `device` (default `cuda`) holding `tree`'s
    weights."""
    model = DenseModel(cfg, resolve_device(device))
    _load(model.embed, tree["embed"], "embed")
    _load(model.out_norm, tree["out_norm"], "out_norm")
    if model.lm_head is not None:
        _load(model.lm_head, tree["lm_head"], "lm_head")
    lt = tree["layers"]
    for l, layer in enumerate(model.layers):
        _load(layer.ln1, lt["ln1"][l], f"layers.ln1[{l}]")
        _load(layer.ln2, lt["ln2"][l], f"layers.ln2[{l}]")
        for k in ("wq", "wk", "wv", "wo"):
            _load(getattr(layer.attn, k), lt["attn"][k][l],
                  f"layers.attn.{k}[{l}]")
        _load(layer.ffn.w, lt["ffn"]["w"][l], f"layers.ffn.w[{l}]")
        for k in ("wq", "wsc", "wout"):
            if k in lt["ffn"]:
                setattr(layer.ffn, k,
                        _tensor(lt["ffn"][k][l]).to(model.device))
        if layer.ffn.pred_A is not None:
            _load(layer.ffn.pred_A, lt["ffn"]["pred"]["A"][l],
                  f"layers.ffn.pred.A[{l}]")
            _load(layer.ffn.pred_B, lt["ffn"]["pred"]["B"][l],
                  f"layers.ffn.pred.B[{l}]")
    return model
