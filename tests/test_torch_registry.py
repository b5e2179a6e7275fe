"""The port's kernel registry (`repro_torch/kernels/registry.py`) held
against the tree, as the reference's trace-registry-drift rule holds its
trace registry (`analysis/drift.py`). It fails when:

* a kernel wrapper exported by `kernels/ops.py`'s `__all__` has no entry;
* an entry's CUDA source, its build (`build.SOURCES`), its plain version
  in `kernels/ref.py`, or its CPU or card test does not exist, or the
  card test is not marked `gpu`;
* an entry's reference `file:line` does not start the function it names;
* chip_smoke.py's `kernels` rows name other kernels than the registry's.

Each check is also run on a broken copy of an entry, which it must
reject.
"""
import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref, registry

ROOT = Path(__file__).resolve().parents[1]
COUNT_HELPERS = {"launch_counts", "set_launch_counts"}


def _test_defs(path: Path) -> dict:
    """{test function name: its decorator source lines} of a test file."""
    tree = ast.parse(path.read_text())
    return {n.name: [ast.unparse(d) for d in n.decorator_list]
            for n in tree.body if isinstance(n, ast.FunctionDef)}


def problems(k: registry.Kernel) -> list:
    """What of entry k does not hold in the tree."""
    out = []
    if not (ROOT / k.source).is_file():
        out.append(f"{k.name}: no source {k.source}")
    if k.build_name not in build.SOURCES:
        out.append(f"{k.name}: {k.build_name} is not in build.SOURCES")
    if not callable(getattr(ref, k.plain, None)):
        out.append(f"{k.name}: kernels/ref.py has no {k.plain}")
    if k.wrapper not in ops.__all__:
        out.append(f"{k.name}: ops exports no {k.wrapper}")
    for node, marked in ((k.cpu_test, False), (k.gpu_test, True)):
        path, _, fn = node.partition("::")
        defs = _test_defs(ROOT / path) if (ROOT / path).is_file() else {}
        if fn not in defs:
            out.append(f"{k.name}: no test {node}")
        elif marked and "pytest.mark.gpu" not in defs[fn]:
            out.append(f"{k.name}: {node} is not marked gpu")
    path, _, line = k.replaces.partition(":")
    lines = (ROOT / path).read_text().splitlines() \
        if (ROOT / path).is_file() else []
    n = int(line) if line.isdigit() else 0
    if not (0 < n <= len(lines)
            and lines[n - 1].startswith(f"def {k.function}(")):
        out.append(f"{k.name}: {k.replaces} does not start {k.function}")
    return out


def smoke_rows() -> list:
    """The entry names chip_smoke.py builds its kernels rows from."""
    return re.findall(r'registry\.row\(\s*"([^"]+)"',
                      (ROOT / "chip_smoke.py").read_text())


@pytest.mark.parametrize("name", [k.name for k in registry.KERNELS])
def test_registry_entry_holds_in_the_tree(name):
    assert problems(registry.BY_NAME[name]) == []


def test_every_exported_kernel_is_registered():
    kernels = set(ops.__all__) - COUNT_HELPERS
    assert kernels == {k.wrapper for k in registry.KERNELS}
    assert set(ops.launch_counts()) <= {k.wrapper for k in registry.KERNELS
                                        if k.row}


def test_smoke_rows_are_the_registry():
    rows = smoke_rows()
    assert sorted(rows) == sorted(k.name for k in registry.KERNELS if k.row)
    text = (ROOT / "chip_smoke.py").read_text()
    assert '"replaces": "' not in text and '"source": src' not in text
    for name in rows:
        assert set(registry.row(name)) == {"name", "route", "source",
                                           "replaces"}


@pytest.mark.parametrize("broken", [
    dict(source="src/repro_torch/kernels/csrc/missing.cu"),
    dict(plain="no_such_ref"),
    dict(replaces="src/repro/kernels/cluster_gather_ffn.py:276"),
    dict(function="cluster_gather_ffn"),
    dict(cpu_test="tests/test_torch_kernels.py::test_missing"),
    dict(gpu_test="tests/test_torch_kernels.py::"
                  "test_fused_cold_ffn_matches_jax"),
    dict(wrapper="fused_ffn")])
def test_checks_reject_a_broken_entry(broken):
    k = dataclasses.replace(registry.BY_NAME["fused_cold_ffn"], **broken)
    assert problems(k)


def test_grouped_plain_version_is_the_wrapper_on_the_cpu():
    """The grouped form's plain version (the registry's) equals the
    wrapper, which on CPU tensors runs cluster_gather_ffn's."""
    G, nc_g, cs, R, D, B = 3, 4, 8, 3, 16, 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, D), generator=g)
    wc = torch.randn((G, nc_g, cs, R, D), generator=g) * 0.2
    cidx = torch.from_numpy(np.array([[0, 2], [1, 3], [3, 1]], np.int32))
    want = ops.cluster_gather_ffn_grouped(x, wc, cidx, activation="silu")
    got = ref.cluster_gather_ffn_grouped_ref(x, wc, cidx, activation="silu")
    assert torch.equal(got, want)
