"""The reference's checkpoint layout, written and read with numpy and
json only (counterpart of `repro/checkpoint/ckpt.py`).

A checkpoint is one `.npy` per leaf of a parameter tree, named by the
leaf's path joined with "__" (`_leaf_name`, e.g. `layers__ffn__pred__A`),
and a `manifest.json` that lists each leaf's name, dtype and shape in
the reference's leaf order (dict keys sorted, as jax flattens them).
`save_checkpoint` writes the files the reference's writes for the same
tree, byte for byte; `restore_numpy` reads them back into the nested
dict that `repro_torch.bridge.params_from_numpy` takes
(`bridge.load_checkpoint` does both), and `restore_checkpoint` into the
structure of a given tree.

bfloat16 leaves: numpy has no bfloat16 of its own. The reference saves
them through ml_dtypes' extension type, and `np.load` returns their bytes
as a 2-byte void dtype (`|V2`). The manifest's dtype is the truth: such a
leaf comes back as its uint16 bit pattern with "bfloat16" in `dtypes`,
and the bridge reinterprets those bits, never converting them by value.
The writer takes such a leaf the same way (its uint16 bits, "bfloat16"
in `dtypes`) and writes it as the reference does: the bits under the
header's `'<V2'` descr.
"""
from __future__ import annotations

import json
import os
import re
from typing import NamedTuple

import numpy as np

SEP = "__"           # _leaf_name's join of the path keys


class Restored(NamedTuple):
    tree: dict       # nested dict of numpy arrays (bf16 leaves as uint16)
    dtypes: dict     # the same nesting: each leaf's manifest dtype name
    step: int


class Tree(NamedTuple):
    """A parameter tree in numpy, as `bridge.params_to_numpy` gives it."""
    tree: dict       # nested dict of numpy arrays (bf16 leaves as uint16)
    dtypes: dict     # the same nesting: each leaf's dtype name


def _leaves(tree, dtypes=None, path=()):
    """(path, leaf, declared dtype or None) of a nested dict in jax's
    flatten order (keys sorted)."""
    if not isinstance(tree, dict):
        yield path, tree, dtypes
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], (dtypes or {}).get(k), path + (k,))


def _leaf_name(path) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", SEP.join(path))


def _write_bf16(f: str, bits: np.ndarray):
    """A bfloat16 leaf's uint16 bits as the reference's writer leaves
    them: np.save's header with ml_dtypes' descr `'<V2'`, then the raw
    bytes."""
    bits = np.ascontiguousarray(bits)
    header = np.lib.format.header_data_from_array_1_0(bits)
    header["descr"] = "<V2"
    with open(f, "wb") as fp:
        np.lib.format.write_array_header_1_0(fp, header)
        fp.write(bits.tobytes())


def save_checkpoint(path: str, tree, step: int = 0, dtypes=None):
    """One `.npy` per leaf of `tree` (nested dicts of numpy arrays, or a
    `Tree` carrying its dtypes) and `manifest.json`, as the reference's
    `save_checkpoint` writes them. A leaf declared "bfloat16" in
    `dtypes` (or of ml_dtypes' bfloat16) is written from its 16 bits."""
    if isinstance(tree, Tree):
        tree, dtypes = tree
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for p, leaf, declared in _leaves(tree, dtypes):
        name = _leaf_name(p)
        arr = np.asarray(leaf)
        f = os.path.join(path, name + ".npy")
        if declared == "bfloat16" or arr.dtype.name == "bfloat16":
            if arr.dtype.itemsize != 2:
                raise TypeError(f"{name}: a {arr.dtype} array holds no "
                                f"bfloat16")
            _write_bf16(f, arr.view(np.uint16))
            dtype = "bfloat16"
        else:
            if declared is not None and declared != arr.dtype.name:
                raise TypeError(f"{name}: array is {arr.dtype}, declared "
                                f"{declared}")
            np.save(f, arr)
            dtype = str(arr.dtype)
        manifest["leaves"].append({"name": name, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _read_leaf(path: str, entry: dict) -> np.ndarray:
    name, dtype = entry["name"], entry["dtype"]
    f = os.path.join(path, name + ".npy")
    if not os.path.exists(f):
        raise KeyError(f"checkpoint missing leaf {name!r}")
    arr = np.load(f, allow_pickle=False)
    if list(arr.shape) != list(entry["shape"]):
        raise ValueError(f"{name}: shape {arr.shape} != the manifest's "
                         f"{tuple(entry['shape'])}")
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{name}: {arr.dtype} holds no bfloat16")
        return arr.view(np.uint16)
    if arr.dtype != np.dtype(dtype):
        raise ValueError(f"{name}: dtype {arr.dtype} != the manifest's "
                         f"{dtype}")
    return arr


def restore_numpy(path: str) -> Restored:
    """Every leaf that `manifest.json` in `path` lists, nested by its
    name's "__"-separated keys. Raises KeyError on a leaf whose file is
    missing and ValueError on a file whose shape or dtype disagrees with
    the manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree, dtypes = {}, {}
    for entry in manifest["leaves"]:
        *keys, last = entry["name"].split(SEP)
        t, d = tree, dtypes
        for k in keys:
            t, d = t.setdefault(k, {}), d.setdefault(k, {})
        t[last] = _read_leaf(path, entry)
        d[last] = entry["dtype"]
    return Restored(tree, dtypes, manifest["step"])


def restore_checkpoint(path: str, like_tree):
    """(tree, step): the checkpoint's leaves in the structure of
    `like_tree` (nested dicts of arrays, whose shapes must match), as
    numpy arrays (bf16 leaves as their uint16 bits). Raises KeyError on a
    missing leaf and ValueError on a shape that differs."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}

    def build(like, p):
        if isinstance(like, dict):
            return {k: build(v, p + (k,)) for k, v in like.items()}
        name = _leaf_name(p)
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = _read_leaf(path, by_name[name])
        if list(arr.shape) != list(np.shape(like)):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(np.shape(like))}")
        return arr
    return build(like_tree, ()), manifest["step"]
