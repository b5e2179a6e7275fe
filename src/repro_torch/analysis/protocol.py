"""Protocol conformance: BackendHandle impls + ServingFamily entries.

The port's counterpart of `repro/analysis/protocol.py`. The gateway
dispatches over the narrow `BackendHandle` surface
(`serving/gateway.py`) and the engine serves whatever the
`ServingFamily` registry (`serving/families.py`) provides; both are
duck-typed, so a drifted signature only raises at dispatch time. Two
rules:

* protocol-method - every subclass of a protocol base (a class named
                    *Handle with a method whose body raises
                    NotImplementedError) overrides each such method with
                    the same required positional arity, extra
                    parameters only with defaults, and the base's
                    property-ness.
* family-fields   - every `ServingFamily(...)` passes each field without
                    a default, and each field value that resolves to a
                    function (a def of the file, a lambda, or
                    `module.function` of a scanned module) accepts the
                    port's call shape: make_model(cfg, device=, seed=),
                    make_decode_step(cfg, shard=), build_plan(cfg, freqs,
                    hw=, backend=, storage_dtype=), prepare_params(model,
                    plan).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (AnalysisConfig, Finding,
                                            RepoChecker, register_checker)
from repro_torch.analysis.trace_hazards import module_aliases, module_name

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

# field -> (positional args the engine passes, keyword names it passes)
FAMILY_CALL_SHAPES = {
    "make_model": (1, ("device", "seed")),
    "make_decode_step": (1, ("shard",)),
    "build_plan": (2, ("hw", "backend", "storage_dtype")),
    "prepare_params": (2, ()),
}


def _attr_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _is_property(fn) -> bool:
    return any(_attr_name(d) == "property" for d in fn.decorator_list)


def _raises_not_implemented(fn) -> bool:
    for n in fn.body:
        if isinstance(n, ast.Raise) and n.exc is not None:
            exc = n.exc.func if isinstance(n.exc, ast.Call) else n.exc
            if _attr_name(exc) == "NotImplementedError":
                return True
    return False


def _signature(fn) -> tuple:
    """(required positional names, optional count, *args, **kwargs),
    self excluded."""
    pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    n_opt = len(fn.args.defaults)
    required = pos[:len(pos) - n_opt] if n_opt else pos
    return (tuple(required), n_opt, fn.args.vararg is not None,
            fn.args.kwarg is not None)


def accepts(fn, n_pos: int, kwnames: tuple) -> bool:
    """Can fn (a def or a lambda) be called with n_pos positional args
    plus the given keyword names?"""
    required, n_opt, varargs, varkw = _signature(fn)
    if len(required) > n_pos:
        return False
    if n_pos > len(required) + n_opt and not varargs:
        return False
    if varkw:
        return True
    pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    accept = set(pos[n_pos:]) | {a.arg for a in fn.args.kwonlyargs}
    missing_kw = [a.arg for a, d in zip(fn.args.kwonlyargs,
                                        fn.args.kw_defaults)
                  if d is None and a.arg not in kwnames]
    return all(k in accept for k in kwnames) and not missing_kw


@register_checker
class ProtocolChecker(RepoChecker):
    name = "protocol"
    rules = ("protocol-method", "family-fields")

    def check_repo(self, files: dict, config: AnalysisConfig) -> list:
        return self._protocols(files) + self._families(files, config)

    # -------------------------------------------------- protocol bases ----
    def _protocols(self, files: dict) -> list:
        bases = {}
        for path, src in files.items():
            if src.lang != "python":
                continue
            for cls in ast.walk(src.tree):
                if isinstance(cls, ast.ClassDef) \
                        and cls.name.endswith("Handle"):
                    methods = {n.name: (n, _is_property(n),
                                        _raises_not_implemented(n))
                               for n in cls.body if isinstance(n, _FUNCS)}
                    if any(a for _, _, a in methods.values()):
                        bases[cls.name] = methods
        out = []
        for path, src in files.items():
            if src.lang != "python":
                continue
            for cls in ast.walk(src.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                for base in cls.bases:
                    if _attr_name(base) in bases:
                        out += self._impl(cls, bases[_attr_name(base)],
                                          _attr_name(base), path)
        return out

    @staticmethod
    def _impl(cls, base_methods, bname, path) -> list:
        impl = {n.name: n for n in cls.body if isinstance(n, _FUNCS)}
        out = []
        for mname, (bfn, bprop, abstract) in sorted(base_methods.items()):
            if not abstract:
                continue
            if mname not in impl:
                out.append(Finding(
                    "protocol-method", path, cls.lineno,
                    f"{cls.name} ({bname} impl) does not override "
                    f"abstract {'property' if bprop else 'method'} "
                    f"{mname!r}: dispatch raises NotImplementedError"))
                continue
            ifn = impl[mname]
            if _is_property(ifn) != bprop:
                out.append(Finding(
                    "protocol-method", path, ifn.lineno,
                    f"{cls.name}.{mname} {'drops' if bprop else 'adds'} "
                    f"@property against {bname}.{mname}: callers reach "
                    f"it the other way"))
                continue
            breq = _signature(bfn)[0]
            ireq, _, ivar, _ = _signature(ifn)
            if not ivar and len(ireq) != len(breq):
                out.append(Finding(
                    "protocol-method", path, ifn.lineno,
                    f"{cls.name}.{mname} requires {len(ireq)} positional "
                    f"args where {bname}.{mname} declares {len(breq)} "
                    f"({', '.join(breq) or 'none'})"))
        return out

    # ------------------------------------------------- family registry ----
    def _families(self, files: dict, config: AnalysisConfig) -> list:
        src = files.get(config.families_path)
        if src is None:
            return []
        required = [n.target.id for cls in ast.walk(src.tree)
                    if isinstance(cls, ast.ClassDef)
                    and cls.name == "ServingFamily"
                    for n in cls.body
                    if isinstance(n, ast.AnnAssign)
                    and isinstance(n.target, ast.Name) and n.value is None]
        if not required:
            return []
        defs = {n.name: n for n in ast.walk(src.tree)
                if isinstance(n, _FUNCS)}
        aliases = module_aliases(src.tree)
        modules = {module_name(p): s for p, s in files.items()
                   if s.lang == "python"}
        out = []
        for call in ast.walk(src.tree):
            if not (isinstance(call, ast.Call)
                    and _attr_name(call.func) == "ServingFamily"):
                continue
            given = {kw.arg for kw in call.keywords if kw.arg}
            missing = [f for f in required[len(call.args):]
                       if f not in given]
            if missing:
                out.append(Finding(
                    "family-fields", config.families_path, call.lineno,
                    f"ServingFamily(...) misses required field(s) "
                    f"{', '.join(missing)}: the entry fails at first "
                    f"use, not at registration"))
            for kw in call.keywords:
                shape = FAMILY_CALL_SHAPES.get(kw.arg)
                fn = self._resolve(kw.value, defs, aliases, modules)
                if shape is None or fn is None:
                    continue
                if not accepts(fn, *shape):
                    name = getattr(fn, "name", "lambda")
                    out.append(Finding(
                        "family-fields", config.families_path,
                        kw.value.lineno,
                        f"{kw.arg}={name} does not accept the engine's "
                        f"call shape ({shape[0]} positional"
                        f"{' + ' + ', '.join(k + '=' for k in shape[1]) if shape[1] else ''})"))
        return out

    @staticmethod
    def _resolve(value, defs, aliases, modules):
        if isinstance(value, ast.Lambda):
            return value
        if isinstance(value, ast.Name):
            return defs.get(value.id)
        if isinstance(value, ast.Attribute) \
                and isinstance(value.value, ast.Name):
            mod = modules.get(aliases.get(value.value.id, ""))
            if mod is not None:
                return next((n for n in mod.tree.body
                             if isinstance(n, _FUNCS)
                             and n.name == value.attr), None)
        return None
