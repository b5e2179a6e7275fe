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

Over a group of ranks, `shard_params` cuts the tree to one rank's slices
(the counterpart of the reference engine's `_shard_params` and
`_QUANT_FFN_SPECS`), and `params_from_numpy(..., shard=, plan=)` builds
that rank's model from them; `shard_model` does the same from a whole
port model.

`params_to_numpy(model)` is the inverse of `params_from_numpy`: the
reference-layout tree of a whole model, layer leaves stacked (L, ...),
which `checkpoint.ckpt.save_checkpoint` writes as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import SEP, Tree, restore_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.models.dense import DenseModel
from repro_torch.models.moe import MoEModel
from repro_torch.models.modules import resolve_device
from repro_torch.parallel import ShardLayout, shard_layout


def _tensor(a, dtype: str = None) -> torch.Tensor:
    """A CPU tensor of the numpy array `a` (a tensor passes as it is);
    `dtype` is the leaf's declared dtype name (default: a's own)."""
    if isinstance(a, torch.Tensor):
        return a
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


def _take(a, axis: int, idx):
    """a's entries `idx` along per-layer axis `axis`: a is stacked (L,
    ...) or a sequence of per-layer arrays or tensors."""
    if isinstance(a, (list, tuple)):
        return [_take(t, axis - 1, idx) for t in a]
    if isinstance(a, torch.Tensor) and not isinstance(idx, slice):
        idx = torch.from_numpy(idx).to(a.device)
    return a[(slice(None),) * (axis + 1) + (idx,)]


def _shard_tree(tree, cfg: ModelConfig, layout: ShardLayout):
    """The leaves of `tree` (the reference's layout, layer leaves stacked
    or per layer) that `layout`'s rank holds; the rest stay whole."""
    q0, nq, k0, nk = layout.heads
    dh = cfg.d_head
    layers = dict(tree["layers"])
    attn = dict(layers["attn"])
    for k, (lo, n) in (("wq", (q0, nq)), ("wk", (k0, nk)),
                       ("wv", (k0, nk))):
        attn[k] = _take(attn[k], 1, slice(lo * dh, (lo + n) * dh))
    attn["wo"] = _take(attn["wo"], 0, slice(q0 * dh, (q0 + nq) * dh))
    layers["attn"] = attn
    if "moe" in layers:
        moe = dict(layers["moe"])
        e0, ne = layout.experts
        moe["experts"] = _take(moe["experts"], 0, slice(e0, e0 + ne))
        if "shared" in moe:
            moe["shared"] = {"w": _take(moe["shared"]["w"], 0,
                                        slice(*layout.shared))}
        layers["moe"] = moe
    else:
        ids = layout.ffn.ids
        ffn = {k: _take(v, 0, ids) for k, v in layers["ffn"].items()
               if k in ("w", "wq", "wsc", "wout")}
        if "pred" in layers["ffn"]:
            pred = layers["ffn"]["pred"]
            ffn["pred"] = {"A": pred["A"], "B": _take(pred["B"], 1, ids)}
        layers["ffn"] = ffn
    return dict(tree, layers=layers)


def shard_params(tree, cfg: ModelConfig, plan, rank: int, n: int):
    """The slices of `tree` that rank `rank` of `n` holds
    (`parallel.shard_layout`): heads when both head counts divide n, the
    FFN rows (`w`, the predictor's B columns and the quantized
    containers wq / wsc / wout) every bucket of `plan` computes on the
    rank, whole experts and shared rows for moe. Layer leaves may be
    stacked (L, ...) arrays or per-layer sequences."""
    return _shard_tree(tree, cfg, shard_layout(cfg, plan, rank, n))


def params_from_numpy(tree, cfg: ModelConfig, device=None,
                      dtypes=None, shard=None, plan=None) -> DenseModel:
    """The port's model on `device` (default `cuda`) holding `tree`'s
    weights; `dtypes` (the same nesting) declares leaves' dtypes. With
    `shard`, a ShardGroup of n > 1 ranks, the model holds only its
    rank's slices for serving `plan` (an ExecutionPlan; moe needs
    none)."""
    model_type = MoEModel if cfg.family == "moe" else DenseModel
    layout = None
    if shard is not None and shard.size > 1:
        if plan is None and not cfg.num_experts:
            raise ValueError("a dense model's slice follows the plan's "
                             "buckets: pass plan=")
        layout = shard_layout(cfg, plan, shard.rank, shard.size)
        tree = _shard_tree(tree, cfg, layout)
    model = model_type(cfg, resolve_device(device), layout=layout)

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


def load_checkpoint(path: str, cfg: ModelConfig, device=None, shard=None,
                    plan=None) -> DenseModel:
    """The port's model on `device` (default `cuda`) from a checkpoint the
    reference's `save_checkpoint` wrote (a parameter tree already
    permuted, and for int8 / int4-mixed storage quantized, to match the
    plan it is served with); with `shard`, the rank's slices only (see
    `params_from_numpy`)."""
    ckpt = restore_numpy(path)
    return params_from_numpy(ckpt.tree, cfg, device, dtypes=ckpt.dtypes,
                             shard=shard, plan=plan)


def model_tree(model: DenseModel) -> dict:
    """The reference-layout tree of a whole port model, its layer leaves
    as per-layer lists of the model's own tensors (no copy)."""
    layers = model.layers
    attn = {k: [getattr(l.attn, k) for l in layers]
            for k in ("wq", "wk", "wv", "wo")}
    if model.cfg.qk_norm:
        attn["qk"] = {k: [getattr(l.attn, k) for l in layers]
                      for k in ("q_norm", "k_norm")}
    out = {"embed": model.embed, "out_norm": model.out_norm,
           "layers": {"ln1": [l.ln1 for l in layers],
                      "ln2": [l.ln2 for l in layers], "attn": attn}}
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head
    if isinstance(model, MoEModel):
        moe = {"router": [l.moe.router for l in layers],
               "experts": [l.moe.experts for l in layers]}
        if layers[0].moe.shared is not None:
            moe["shared"] = {"w": [l.moe.shared for l in layers]}
        out["layers"]["moe"] = moe
        return out
    ffn = {"w": [l.ffn.w for l in layers]}
    for k in ("wq", "wsc", "wout"):
        if getattr(layers[0].ffn, k) is not None:
            ffn[k] = [getattr(l.ffn, k) for l in layers]
    if layers[0].ffn.pred_A is not None:
        ffn["pred"] = {"A": [l.ffn.pred_A for l in layers],
                       "B": [l.ffn.pred_B for l in layers]}
    out["layers"]["ffn"] = ffn
    return out


def _numpy(t: torch.Tensor):
    """(numpy array, dtype name) of a tensor; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def params_to_numpy(model: DenseModel, values: dict = None) -> Tree:
    """The reference-layout tree of a whole port model as numpy (the
    inverse of `params_from_numpy`): `model_tree`'s per-layer lists
    stacked into (L, ...) leaves, each on the host, bf16 leaves as their
    uint16 bits with "bfloat16" in the returned dtypes. With `values`
    (tensors keyed by the model's parameter names, such as gradients or
    AdamW moments) the same tree of those tensors instead, a None value
    giving zeros."""
    names = {id(p): n for n, p in model.named_parameters()}

    def pick(t):
        if values is None:
            return t
        v = values[names[id(t)]]
        return torch.zeros_like(t) if v is None else v

    def convert(node):
        if isinstance(node, dict):
            out = {k: convert(v) for k, v in node.items()}
            return ({k: a for k, (a, _) in out.items()},
                    {k: d for k, (_, d) in out.items()})
        if isinstance(node, list):
            return _numpy(torch.stack([pick(t).detach() for t in node]))
        return _numpy(pick(node))

    return Tree(*convert(model_tree(model)))


def shard_model(model: DenseModel, plan, shard, device=None) -> DenseModel:
    """Rank `shard.rank`'s slice of a whole port model (weights already
    prepared for `plan`), on `device` (default the model's); the model
    itself when the group has one rank."""
    if shard is None or shard.size == 1:
        return model
    return params_from_numpy(model_tree(model), model.cfg,
                             device or model.device, shard=shard, plan=plan)
