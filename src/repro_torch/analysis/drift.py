"""Registry drift across the port's shadow copies.

The port's counterpart of `repro/analysis/drift.py`. Two registries have
a copy kept by hand that must track them:

* registry-drift        - every family name `register_family(...)`
                          registers in `serving/families.py` (through one
                          level of helper: the `family=` argument of the
                          helper's ServingFamily, mapped back to the call
                          site's constant) appears as a string literal in
                          the port's battery (`tests/test_torch_archs.py`,
                          whose `test_served_families_match_reference`
                          names every served family).
* kernel-registry-drift - every kernel wrapper `kernels/ops.py` exports in
                          `__all__` (the launch-count helpers aside) has
                          its entry in `kernels/registry.py` (a
                          `Kernel(...)` whose wrapper is that name), so a
                          new kernel cannot ship without its plain version,
                          its tests and its chip_smoke.py row.

The reference's bench-gate-drift waits for the port's benchmark: the
port has no benchmark kinds yet to hold against a trend gate.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (AnalysisConfig, Finding,
                                            RepoChecker, register_checker)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
# ops.py exports that are not kernel wrappers
COUNT_HELPERS = ("launch_counts", "set_launch_counts")


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def registered_families(tree):
    """(family name, line) per register_family(...) call, through one
    level of helper indirection."""
    defs = {n.name: n for n in ast.walk(tree) if isinstance(n, _FUNCS)}
    for call in ast.walk(tree):
        if not (isinstance(call, ast.Call)
                and _call_name(call) == "register_family" and call.args):
            continue
        arg = call.args[0]
        if not isinstance(arg, ast.Call):
            continue
        if _call_name(arg) == "ServingFamily":
            for kw in arg.keywords:
                if kw.arg == "family" and _const_str(kw.value):
                    yield _const_str(kw.value), call.lineno
            continue
        helper = defs.get(_call_name(arg))
        if helper is None:
            continue
        params = [a.arg for a in helper.args.posonlyargs + helper.args.args]
        for ctor in ast.walk(helper):
            if not (isinstance(ctor, ast.Call)
                    and _call_name(ctor) == "ServingFamily"):
                continue
            for kw in ctor.keywords:
                if kw.arg != "family":
                    continue
                if _const_str(kw.value):
                    yield _const_str(kw.value), call.lineno
                elif isinstance(kw.value, ast.Name) \
                        and kw.value.id in params:
                    i = params.index(kw.value.id)
                    site = _const_str(arg.args[i]) \
                        if i < len(arg.args) else None
                    for akw in arg.keywords:
                        if akw.arg == kw.value.id:
                            site = _const_str(akw.value)
                    if site:
                        yield site, call.lineno


def _strings(tree) -> set:
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


@register_checker
class DriftChecker(RepoChecker):
    name = "drift"
    rules = ("registry-drift", "kernel-registry-drift")

    def check_repo(self, files: dict, config: AnalysisConfig) -> list:
        return self._families(files, config) + self._kernels(files, config)

    @staticmethod
    def _families(files, config) -> list:
        fam, battery = (files.get(config.families_path),
                        files.get(config.battery_path))
        if fam is None or battery is None:
            return []
        covered = _strings(battery.tree)
        return [Finding(
            "registry-drift", config.families_path, line,
            f"family {name!r} is registered but never named in "
            f"{config.battery_path}: the battery silently skips it")
            for name, line in registered_families(fam.tree)
            if name not in covered]

    @staticmethod
    def _kernels(files, config) -> list:
        ops, reg = (files.get(config.kernels_ops_path),
                    files.get(config.kernel_registry_path))
        if ops is None or reg is None:
            return []
        exported, line = [], 1
        for n in ast.walk(ops.tree):
            if isinstance(n, ast.Assign) and isinstance(
                    n.value, (ast.List, ast.Tuple)) and any(
                    isinstance(t, ast.Name) and t.id == "__all__"
                    for t in n.targets):
                line = n.lineno
                exported = [s for s in map(_const_str, n.value.elts)
                            if s and s not in COUNT_HELPERS]
        wrappers = set()
        for n in ast.walk(reg.tree):
            if isinstance(n, ast.Call) and _call_name(n) == "Kernel":
                if len(n.args) > 1 and _const_str(n.args[1]):
                    wrappers.add(_const_str(n.args[1]))
                for kw in n.keywords:
                    if kw.arg == "wrapper" and _const_str(kw.value):
                        wrappers.add(_const_str(kw.value))
        return [Finding(
            "kernel-registry-drift", config.kernels_ops_path, line,
            f"kernel wrapper {name!r} is exported but has no entry in "
            f"{config.kernel_registry_path}: it ships without its plain "
            f"version, tests and chip_smoke.py row on record")
            for name in exported if name not in wrappers]
