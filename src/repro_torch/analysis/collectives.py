"""Collective discipline: one audited route, reductions in fp32.

The port's counterpart of `repro/analysis/collectives.py`. In the
reference every collective sits inside a shard_map body over a bound
mesh axis; in the port every collective goes through one audited class,
`parallel.ShardGroup`, whose methods count their calls (`calls`, which
the dispatch tier holds to each step's declared budget) and make the
fp32 casts. Two rules:

* collective-route - no `torch.distributed` collective (all_reduce,
                     all_gather, broadcast, reduce_scatter, all_to_all,
                     send / recv, barrier, the *_object forms, ...)
                     outside the methods of the home class
                     (`AnalysisConfig.collective_home`): a collective
                     elsewhere escapes the count and the casts.
* collective-fp32  - in the home class, the tensor each all_reduce and
                     all_gather moves is made by an fp32 cast
                     (`.to(torch.float32 ...)`, `.float()`) or is an
                     integer id tensor (a parameter named idx / ids, or
                     one derived from it): a bf16 reduction drifts from
                     the goldens, which sum in fp32.

The reference's collective-budget moved to the dispatch tier
(`dispatch-collective-count`), where `ShardGroup.calls` counts each
step's collectives exactly instead of by a branch-aware estimate.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (AnalysisConfig, Checker,
                                            Finding, SourceFile,
                                            register_checker)
from repro_torch.analysis.trace_hazards import dotted, module_aliases

_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "all_to_all",
    "all_to_all_single", "gather", "scatter", "send", "recv", "isend",
    "irecv", "barrier", "monitored_barrier", "all_gather_object",
    "gather_object", "broadcast_object_list", "scatter_object_list",
    "batch_isend_irecv"}
# collective -> position of the tensor it moves
_OPERAND = {"all_reduce": 0, "all_gather": 1}
_ID_NAMES = ("idx", "ids")


def _collective(call: ast.Call, aliases: dict) -> str:
    full = dotted(call.func, aliases)
    mod, _, name = full.rpartition(".")
    return name if mod == "torch.distributed" and name in _COLLECTIVES \
        else ""


def _origins(fn) -> dict:
    """name -> the expressions assigned to it inside fn."""
    out = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(n.value)
    return out


def _fp32_or_ids(expr, origins, params, depth=0) -> bool:
    """Is expr made by an fp32 cast or from an integer id parameter?"""
    for x in ast.walk(expr):
        if isinstance(x, ast.Attribute) and x.attr == "float32":
            return True
        if isinstance(x, ast.Call) and isinstance(x.func, ast.Attribute) \
                and x.func.attr == "float":
            return True
        if isinstance(x, ast.Name):
            if x.id in params and x.id.endswith(_ID_NAMES):
                return True
            if depth < 4 and any(_fp32_or_ids(v, origins, params, depth + 1)
                                 for v in origins.get(x.id, ())):
                return True
    return False


@register_checker
class CollectiveChecker(Checker):
    name = "collectives"
    rules = ("collective-route", "collective-fp32")
    scope = ("src/repro_torch/",)

    def check(self, src: SourceFile, config: AnalysisConfig) -> list:
        aliases = module_aliases(src.tree)
        homes = {cls for path, cls in config.collective_home
                 if path == src.path}
        where = " or ".join(f"{c} ({p})" for p, c in config.collective_home)
        home = set()                     # ids of calls in a home class
        out = []
        if homes:
            for cls in src.tree.body:
                if isinstance(cls, ast.ClassDef) and cls.name in homes:
                    for fn in cls.body:
                        if isinstance(fn, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                            home.update(id(c) for c in ast.walk(fn))
                            out += self._fp32(fn, aliases, src)
        for n in ast.walk(src.tree):
            if isinstance(n, ast.Call) and id(n) not in home:
                name = _collective(n, aliases)
                if name:
                    out.append(Finding(
                        "collective-route", src.path, n.lineno,
                        f"torch.distributed.{name} outside the methods "
                        f"of {where}: it escapes "
                        f"the per-step collective count and the fp32 "
                        f"casts of the audited route"))
        return out

    @staticmethod
    def _fp32(fn, aliases, src) -> list:
        origins = _origins(fn)
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        out = []
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            name = _collective(n, aliases)
            pos = _OPERAND.get(name)
            if pos is None or len(n.args) <= pos:
                continue
            if not _fp32_or_ids(n.args[pos], origins, params):
                out.append(Finding(
                    "collective-fp32", src.path, n.lineno,
                    f"{fn.name}: the tensor dist.{name} moves is neither "
                    f"made by an fp32 cast nor an integer id tensor: a "
                    f"bf16 collective drifts from the fp32 goldens"))
        return out
