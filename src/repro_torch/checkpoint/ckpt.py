"""Reader of the reference's checkpoint layout, numpy and json only.

`repro/checkpoint/ckpt.py::save_checkpoint` writes one `.npy` per leaf of
a parameter pytree, named by the leaf's path joined with "__"
(`_leaf_name`, e.g. `layers__ffn__pred__A`), and a `manifest.json` that
lists each leaf's name, dtype and shape. `restore_numpy` reads them back
into the nested dict that `repro_torch.bridge.params_from_numpy` takes;
`bridge.load_checkpoint` does both.

bfloat16 leaves: numpy has no bfloat16 of its own. The reference saves
them through ml_dtypes' extension type, and `np.load` returns their bytes
as a 2-byte void dtype (`|V2`). The manifest's dtype is the truth: such a
leaf comes back as its uint16 bit pattern with "bfloat16" in `dtypes`,
and the bridge reinterprets those bits, never converting them by value.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

SEP = "__"           # _leaf_name's join of the path keys


class Restored(NamedTuple):
    tree: dict       # nested dict of numpy arrays (bf16 leaves as uint16)
    dtypes: dict     # the same nesting: each leaf's manifest dtype name
    step: int


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
