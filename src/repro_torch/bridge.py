"""Weights from the reference's parameter layout.

`params_from_numpy(tree, cfg)` builds the port's model of cfg's family
(`models.model.family`) from the JAX package's parameter pytree with
every leaf given as a numpy array (`load_checkpoint` reads that tree
from a checkpoint the reference saved). `model_tree` is the one
description of that layout, which loading, `params_to_numpy` and
`shard_model` all walk. The dense and vlm tree:
{"embed", "out_norm", ["lm_head"], "layers": {"ln1", "ln2", "attn":
{"wq", "wk", "wv", "wo", ["qk": {"q_norm", "k_norm"}]}, "ffn": {"w",
["pred": {"A", "B"}], ["wq", "wsc", ["wout"]]}}}, layer leaves stacked
(L, ...); the qk-norm weights are there when the config sets qk_norm,
and the FFN's wq/wsc/wout are the stored cold bundles of int8 /
int4-mixed storage. A moe tree has "moe": {"router", "experts",
["shared": {"w"}]} in place of "ffn". The ssm tree stacks mamba's
layers (`wz`, `wx`, `wB`, `wC`, `wdt`, the conv, `A_log`, `D`, the
norms); the hybrid tree stacks its blocks by group (`groups.b{i}`) with
the remainder blocks `rem{j}`; the encdec tree has `enc_layers`,
`dec_layers` (with `lnx`, `xattn`) and `enc_norm`. It reads numpy
alone. bfloat16 leaves cross over bit for bit through a uint16 view:
numpy holds them as ml_dtypes' extension type, or, read back from a
`.npy` without it, as bare 2-byte voids or their uint16 bits, so a
leaf's declared dtype (`dtypes`, from a checkpoint's manifest) wins over
the array's own.

Over a group of ranks, `placements` (`parallel.placements`) says which
slice of each leaf a rank holds (`parallel.shard_layout`: heads, vocab
rows and columns, FFN rows, experts or each expert's rows, mamba2's
heads, the RG-LRU's channels), `shard_params` cuts the tree to
one rank's slices (the counterpart of the reference's param specs and of
its engine's `_shard_params` and `_QUANT_FFN_SPECS`), and
`params_from_numpy(..., shard=, plan=)` builds that rank's model from
them (a serving layout for `plan`, the training layout without one);
`shard_model` does the same from a whole port model.

`params_to_numpy(model)` is the inverse of `params_from_numpy`: the
reference-layout tree of a whole model, layer leaves stacked (L, ...),
which `checkpoint.ckpt.save_checkpoint` writes as the reference does;
`gather_params(model, shard)` gives the same tree from the slices the
ranks of a group hold.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.ckpt import SEP, Tree, restore_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, rglru
from repro_torch.models.dense import DenseModel
from repro_torch.models.moe import MoEModel
from repro_torch.models.model import family
from repro_torch.models.modules import resolve_device
from repro_torch.parallel import (ShardLayout, placements, shard_layout,
                                  stacked)


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


def _index(a, idx):
    """a[idx] of a numpy array or tensor; numpy ids in idx index a tensor
    on its device."""
    if isinstance(a, torch.Tensor):
        idx = tuple(torch.from_numpy(i).to(a.device)
                    if isinstance(i, np.ndarray) else i for i in idx)
    return a[idx]


def _shard_tree(tree, cfg: ModelConfig, layout: ShardLayout):
    """The leaves of `tree` (the reference's layout, layer leaves stacked
    (L, ...) or per-layer sequences) that `layout`'s rank holds; the rest
    stay whole."""
    places = placements(cfg, layout)

    def cut(node, keys):
        if isinstance(node, dict):
            return {k: cut(v, keys + (k,)) for k, v in node.items()}
        idx = places.get(keys)
        if idx is None:
            return node
        if not stacked(keys):
            return _index(node, idx)
        if isinstance(node, (list, tuple)):
            return [_index(t, idx) for t in node]
        return _index(node, (slice(None),) + idx)
    return cut(tree, ())


def shard_params(tree, cfg: ModelConfig, plan, rank: int, n: int):
    """The slices of `tree` that rank `rank` of `n` holds
    (`parallel.shard_layout`, `parallel.placements`): heads when both
    head counts divide n, the embedding's vocab rows and the head's
    vocab columns when n divides the padded vocabulary, the FFN rows
    (`w`, the predictor's B columns and the quantized containers wq /
    wsc / wout) every bucket of `plan` computes on the rank (its n-th of
    them when `plan` is None, for training), whole experts (ep) or every
    expert's rows (tp) and shared rows for moe, mamba2's heads and the
    RG-LRU's channels. Layer leaves may be stacked (L, ...) arrays or
    per-layer sequences."""
    return _shard_tree(tree, cfg, shard_layout(cfg, plan, rank, n))


def params_from_numpy(tree, cfg: ModelConfig, device=None,
                      dtypes=None, shard=None, plan=None) -> nn.Module:
    """The port's model of cfg's family on `device` (default `cuda`)
    holding `tree`'s weights: every leaf of `model_tree` read from the
    same place in `tree` (a per-layer list from the stacked leaf's rows),
    and the stored cold bundles wq / wsc / wout where the tree has them.
    `dtypes` (the same nesting) declares leaves' dtypes. With `shard`, a
    ShardGroup of n > 1 ranks, the model of any family holds only its
    rank's slices for serving `plan` (an ExecutionPlan, or a HybridPlan
    used at every batch), or for training when `plan` is None."""
    kw = {}
    if shard is not None and shard.size > 1:
        kw["layout"] = shard_layout(cfg, plan, shard.rank, shard.size)
        tree = _shard_tree(tree, cfg, kw["layout"])
    model = family(cfg)[0](cfg, resolve_device(device), seed=None, **kw)
    loaded = set()

    def load(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                load(v, keys + (k,))
            return
        a, dt = _leaf(tree, dtypes, *keys)
        name = ".".join(keys)
        for i, p in (enumerate(node) if isinstance(node, list) else
                     [(None, node)]):
            _load(p, a if i is None else a[i],
                  name if i is None else f"{name}[{i}]", dt)
            loaded.add(id(p))
    load(model_tree(model), ())
    missed = [n for n, p in model.named_parameters() if id(p) not in loaded]
    if missed:
        raise AssertionError(f"model_tree misses {missed}")
    stored = tree.get("layers", {}).get("ffn", {})
    dts = ((dtypes or {}).get("layers") or {}).get("ffn") or {}
    for k in ("wq", "wsc", "wout"):
        for l, layer in enumerate(model.layers if k in stored else ()):
            _load_stored(layer.ffn, k, stored[k][l], dts.get(k), l)
    return model


def _load_stored(ffn, k, a, dtype, l):
    """Layer l's stored cold bundle `k` (int8 / int4-mixed storage), a
    plain tensor of the FFN: wq (N, R, D), wsc (N, R) or wout (N, R,
    D)."""
    N, R, D = ffn.w.shape
    t = _tensor(a, dtype)
    shape = (N, R) if k == "wsc" else (N, R, D)
    if tuple(t.shape) != shape:
        raise ValueError(f"layers.ffn.{k}[{l}]: shape {tuple(t.shape)}, "
                         f"expected {shape}")
    setattr(ffn, k, t.to(ffn.w.device))


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


def _stack(trees: list) -> dict:
    """Per-layer trees of one layout -> one tree of per-layer lists (the
    reference's stacked layers)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return list(trees)


def _attn_leaves(attn) -> dict:
    out = {k: getattr(attn, k) for k in ("wq", "wk", "wv", "wo")}
    if attn.q_norm is not None:
        out["qk"] = {"q_norm": attn.q_norm, "k_norm": attn.k_norm}
    return out


def _ffn_leaves(ffn) -> dict:
    out = {"w": ffn.w}
    for k in ("wq", "wsc", "wout"):
        if getattr(ffn, k) is not None:
            out[k] = getattr(ffn, k)
    if ffn.pred_A is not None:
        out["pred"] = {"A": ffn.pred_A, "B": ffn.pred_B}
    return out


def _dense_layer(layer) -> dict:
    out = {"ln1": layer.ln1, "ln2": layer.ln2,
           "attn": _attn_leaves(layer.attn)}
    if isinstance(layer, MoEModel.layer_type):
        moe = {"router": layer.moe.router, "experts": layer.moe.experts}
        if layer.moe.shared is not None:
            moe["shared"] = {"w": layer.moe.shared}
        out["moe"] = moe
    else:
        out["ffn"] = _ffn_leaves(layer.ffn)
    return out


def _ssm_layer(layer) -> dict:
    return dict(layer.named_parameters())      # the reference's names


def _hybrid_block(block) -> dict:
    if block.kind == "attn":
        return {"ln": block.ln, "attn": _attn_leaves(block.attn),
                "ln2": block.ln2, "ffn": _ffn_leaves(block.ffn)}
    return {"ln": block.ln, "w_in": block.w_in, "w_gate": block.w_gate,
            "conv_w": block.conv_w, "conv_b": block.conv_b,
            "lru": dict(block.lru.named_parameters()), "w_out": block.w_out,
            "ln2": block.ln2, "ffn": _ffn_leaves(block.ffn)}


def _encdec_layer(layer) -> dict:
    out = {"ln1": layer.ln1, "attn": _attn_leaves(layer.attn),
           "ln2": layer.ln2, "ffn": _ffn_leaves(layer.ffn)}
    if isinstance(layer, encdec.DecLayer):
        out.update(lnx=layer.lnx, xattn=_attn_leaves(layer.xattn))
    return out


def model_tree(model) -> dict:
    """The reference-layout tree of a whole port model, its stacked
    layer leaves as per-layer lists of the model's own tensors (no
    copy). The hybrid family's are stacked by group (`groups.b{i}`, one
    entry per group), its remainder blocks (`rem{j}`) are single."""
    cfg = model.cfg
    out = {"embed": model.embed, "out_norm": model.out_norm}
    if cfg.family == "ssm":
        out["layers"] = _stack([_ssm_layer(l) for l in model.layers])
    elif cfg.family == "hybrid":
        n_groups, rem = rglru.layout(cfg)
        P = len(cfg.block_pattern)
        out["groups"] = {f"b{i}": _stack([
            _hybrid_block(model.layers[g * P + i]) for g in range(n_groups)])
            for i in range(P)}
        for j in range(len(rem)):
            out[f"rem{j}"] = _hybrid_block(model.layers[n_groups * P + j])
    elif cfg.family == "encdec":
        out.update(enc_norm=model.enc_norm, enc_layers=_stack(
            [_encdec_layer(l) for l in model.enc_layers]),
            dec_layers=_stack([_encdec_layer(l) for l in model.dec_layers]))
    else:
        out["layers"] = _stack([_dense_layer(l) for l in model.layers])
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head
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


def _paths(tree, keys=()):
    """(key path, leaf) of a nested dict, depth first in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, keys + (k,))
        else:
            yield keys + (k,), v


def gather_params(model: DenseModel, shard, plan=None,
                  values: dict = None) -> Tree:
    """The whole reference-layout numpy tree of a model whose slices the
    ranks of `shard` hold (each built with `shard_layout(cfg, plan,
    rank, n)`), as `params_to_numpy` gives it for a whole model on one
    rank: each rank's leaves are gathered to the group's rank 0 and put
    in place there, so `save_checkpoint` writes the files one rank
    would. With `values` (tensors by parameter name, as in
    `params_to_numpy`) the whole tree of those instead. Every rank of
    the group calls it; rank 0 gets the tree, the others None (only
    rank 0 ever holds the whole model)."""
    local = params_to_numpy(model, values)
    if shard is None or shard.size == 1:
        return local
    cfg = model.cfg
    trees = shard.gather_objects(local.tree)
    if trees is None:
        return None
    whole = family(cfg)[0](cfg, torch.device("meta"), seed=None)
    shapes = {}
    for keys, leaf in _paths(model_tree(whole)):
        shapes[keys] = ((len(leaf),) + tuple(leaf[0].shape)
                        if isinstance(leaf, list) else tuple(leaf.shape))
    out = {}
    for r, tree in enumerate(trees):
        places = placements(cfg, shard_layout(cfg, plan, r, shard.size))
        for keys, a in _paths(tree):
            idx = places.get(keys)
            if idx is None:
                out.setdefault(keys, a)
                continue
            if keys not in out:
                out[keys] = np.zeros(shapes[keys], a.dtype)
            if stacked(keys):
                idx = (slice(None),) + idx
            out[keys][idx] = a
    nested = {}
    for keys, a in out.items():
        node = nested
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return Tree(nested, local.dtypes)


def shard_model(model: DenseModel, plan, shard, device=None) -> DenseModel:
    """Rank `shard.rank`'s slice of a whole port model (weights already
    prepared for `plan`), on `device` (default the model's); the model
    itself when the group has one rank."""
    if shard is None or shard.size == 1:
        return model
    return params_from_numpy(model_tree(model), model.cfg,
                             device or model.device, shard=shard, plan=plan)
