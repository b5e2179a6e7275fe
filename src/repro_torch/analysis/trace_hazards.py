"""Clock, random-state and host-sync hazards in the serving path.

The port's counterpart of `repro/analysis/trace_hazards.py`. Two
contracts hold the goldens together: the modeled clocks are the only
time source in serving code, and every random draw comes from an
explicit generator (a seeded `np.random.default_rng`, a
`torch.Generator`). A third is new with CUDA graphs: a decode step that
the engine captures (`core/adaptation.py::GraphedStep`) must never read
a device value on the host, because a capture records the value the
host saw once and replays it forever (and a sync inside a capture
raises). Three rules:

* wall-clock - no time.time / perf_counter / monotonic and no
               datetime.now in the scanned set (an observability read
               carries an inline ignore with its reason).
* py-random  - no stdlib `random.*` and no numpy global-state RNG
               (`np.random.<fn>`; `default_rng(seed)` and
               `random.Random(seed)` with an explicit seed are fine), and
               no draw from torch's global generator: torch.rand / randn /
               randint / randperm / multinomial / bernoulli / normal /
               poisson (and their *_like forms) and Tensor.normal_ /
               uniform_ / random_ / exponential_ / bernoulli_ /
               cauchy_ / log_normal_ / geometric_ without `generator=`,
               and no torch.manual_seed / torch.seed.
* host-sync  - inside the functions a captured step runs (the roots of
               `AnalysisConfig.capture_roots` and, transitively, every
               function of the scanned set they call): no `.item()`,
               `.tolist()`, `.cpu()`, `.numpy()`, no `bool` / `int` /
               `float` of a tensor, no `if` / `while` / `assert` on a
               tensor, no `torch.cuda.synchronize()`. Calls resolve by
               name: module functions through the file's imports, method
               calls to every method of that name in the scanned set
               (generic container names excepted), so the set is an
               over-approximation and a read outside any capture is
               suppressed inline with its reason.

The reference's `jit-static-args` has no counterpart: PyTorch runs
eagerly and a CUDA graph takes no static arguments; a step's static
shape is its bucket, which `BucketedDecoder` keys on.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import (AnalysisConfig, Checker,
                                            Finding, RepoChecker,
                                            SourceFile, register_checker)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

_TIME_ATTRS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
               "monotonic", "monotonic_ns", "process_time", "clock"}
_DATETIME_ATTRS = {"now", "utcnow", "today"}
_NP_SEEDED = {"default_rng", "Generator", "SeedSequence", "PCG64",
              "Philox", "MT19937", "SFC64"}
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
                "bernoulli", "normal", "poisson", "rand_like",
                "randn_like", "randint_like"}
_TENSOR_DRAWS = {"normal_", "uniform_", "random_", "exponential_",
                 "bernoulli_", "cauchy_", "log_normal_", "geometric_"}
_TORCH_SEEDS = {"manual_seed", "seed"}
# methods that read a device value on the host
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
# tensor methods whose result is host metadata, not a tensor
_META = {"shape", "size", "dim", "ndim", "numel", "dtype", "device",
         "element_size", "stride", "is_contiguous", "data_ptr",
         "storage_offset", "is_cuda", "requires_grad"}
# tensor methods whose result is a tensor whatever the receiver is
_TENSOR_METHODS = {"any", "all", "max", "min", "sum", "mean", "prod",
                   "argmax", "argmin", "amax", "amin", "norm", "abs",
                   "count_nonzero", "eq", "ne", "gt", "lt", "ge", "le"}
# method names too generic to resolve a call by (dict, list, tensor and
# engine methods of the same name would all match)
_GENERIC = {"step", "submit", "get", "put", "close", "reset", "run",
            "update", "copy", "items", "keys", "values", "append", "pop",
            "clear", "view", "write", "read", "to", "add_", "copy_",
            "fill_", "zero_", "extend", "setdefault", "index", "count",
            "__call__", "__init__", "apply", "forward", "backward"}


def _attr_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _root_name(node) -> str:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else ""


def module_aliases(tree) -> dict:
    """Names bound by imports: {'np': 'numpy', 'dist':
    'torch.distributed', 'blocks': 'repro_torch.models.blocks', ...}
    (a `from m import x` binds x to 'm.x')."""
    aliases = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    aliases[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(n, ast.ImportFrom) and n.module:
            for a in n.names:
                aliases.setdefault(a.asname or a.name,
                                   f"{n.module}.{a.name}")
    return aliases


def dotted(node, aliases: dict) -> str:
    """The dotted name of an attribute chain with its root import
    resolved: `dist.all_reduce` -> 'torch.distributed.all_reduce'."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


@register_checker
class ClockRandomChecker(Checker):
    name = "trace-hazards"
    rules = ("wall-clock", "py-random")
    scope = ("src/repro_torch/serving/", "src/repro_torch/core/sparse_ffn.py",
             "src/repro_torch/core/adaptation.py", "src/repro_torch/kernels/",
             "src/repro_torch/models/")

    def check(self, src: SourceFile, config: AnalysisConfig) -> list:
        aliases = module_aliases(src.tree)
        out = []
        for n in ast.walk(src.tree):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)):
                continue
            full = dotted(n.func, aliases)
            attr = n.func.attr
            msg = self._clock(full, attr) or self._random(n, full, attr)
            if msg:
                out.append(Finding(msg[0], src.path, n.lineno, msg[1]))
        return out

    @staticmethod
    def _clock(full: str, attr: str):
        if full == f"time.{attr}" and attr in _TIME_ATTRS:
            return ("wall-clock", f"time.{attr}() in serving code: the "
                    f"modeled clock is the only time source the "
                    f"deterministic goldens allow")
        if attr in _DATETIME_ATTRS and "datetime" in full.split(".")[:-1]:
            return ("wall-clock", f"datetime {attr}() in serving code: "
                    f"use the modeled clock")
        return None

    @staticmethod
    def _random(call: ast.Call, full: str, attr: str):
        seeded = bool(call.args or call.keywords)
        if full == f"random.{attr}":
            if attr == "Random" and seeded:
                return None
            return ("py-random", f"stdlib random.{attr}() draws from "
                    f"global state: pass a seeded generator instead")
        if full == f"numpy.random.{attr}":
            if attr in _NP_SEEDED and seeded:
                return None
            how = "() without a seed" if attr in _NP_SEEDED \
                else " draws from numpy's global state"
            return ("py-random", f"np.random.{attr}{how}: serving "
                    f"determinism needs an explicit seed")
        if full in (f"torch.{attr}", f"torch.cuda.{attr}") \
                and attr in _TORCH_SEEDS:
            return ("py-random", f"{full}() reseeds torch's global "
                    f"generator: pass a torch.Generator instead")
        if full == f"torch.{attr}" and attr in _TORCH_DRAWS \
                and not _has_kw(call, "generator"):
            return ("py-random", f"torch.{attr}() without generator= "
                    f"draws from torch's global generator")
        if attr in _TENSOR_DRAWS and not full.startswith("torch.") \
                and not _has_kw(call, "generator"):
            return ("py-random", f"Tensor.{attr}() without generator= "
                    f"draws from torch's global generator")
        return None


# ------------------------------------------------------------ host-sync ----

def module_name(path: str) -> str:
    """'src/repro_torch/models/dense.py' -> 'repro_torch.models.dense'."""
    p = path[4:] if path.startswith("src/") else path
    p = p[:-3] if p.endswith(".py") else p
    parts = p.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Index:
    """Every function of the scanned Python files, by 'path::qualname'
    ('path::Class.method' for methods), with each file's imports."""

    def __init__(self, files: dict):
        self.defs = {}        # key -> (path, FunctionDef)
        self.by_module = {}   # module name -> path
        self.methods = {}     # method name -> [key]
        self.aliases = {}     # path -> module_aliases
        for path, src in files.items():
            if src.lang != "python":
                continue
            self.by_module[module_name(path)] = path
            self.aliases[path] = module_aliases(src.tree)
            for n in src.tree.body:
                if isinstance(n, _FUNCS):
                    self.defs[f"{path}::{n.name}"] = (path, n)
                elif isinstance(n, ast.ClassDef):
                    for m in n.body:
                        if isinstance(m, _FUNCS):
                            key = f"{path}::{n.name}.{m.name}"
                            self.defs[key] = (path, m)
                            self.methods.setdefault(m.name, []).append(key)
        # module-level aliases: `make_decode_step = dense.make_decode_step`
        for path, src in files.items():
            if src.lang != "python":
                continue
            for n in src.tree.body:
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name):
                    full = dotted(n.value, self.aliases[path])
                    for key in self._symbol(full):
                        self.defs[f"{path}::{n.targets[0].id}"] = \
                            self.defs[key]

    def roots(self, specs) -> tuple:
        """(root keys, the specs that name no function of the set)."""
        keys, missing = [], []
        for spec in specs:
            path, _, name = spec.partition("::")
            hit = [k for k in self.defs if k.startswith(path + "::")] \
                if name == "*" else [spec] if spec in self.defs else []
            keys += hit
            if not hit and path in self.aliases:
                missing.append(spec)
        return keys, missing

    def callees(self, key: str) -> list:
        path, fn = self.defs[key]
        aliases = self.aliases[path]
        out = []
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name):
                local = f"{path}::{f.id}"
                if local in self.defs:
                    out.append(local)
                elif f.id in aliases:
                    out += self._symbol(aliases[f.id])
            elif isinstance(f, ast.Attribute):
                if isinstance(f.value, ast.Name) \
                        and f.value.id in aliases:
                    mod = self.by_module.get(aliases[f.value.id])
                    if mod is not None:
                        k = f"{mod}::{f.attr}"
                        out += [k] if k in self.defs else []
                        continue
                if f.attr not in _GENERIC:
                    out += self.methods.get(f.attr, [])
        return out

    def _symbol(self, full: str) -> list:
        mod, _, name = full.rpartition(".")
        path = self.by_module.get(mod)
        key = f"{path}::{name}"
        return [key] if path is not None and key in self.defs else []

    def reachable(self, roots) -> dict:
        """key -> the root it was reached from, over the call graph."""
        seen, stack = {}, [(r, r) for r in roots]
        while stack:
            key, root = stack.pop()
            if key in seen:
                continue
            seen[key] = root
            stack += [(c, root) for c in self.callees(key)
                      if c not in seen]
        return seen


def _tensor_names(fn) -> set:
    """Names assigned from a tensor-valued expression inside fn."""
    names: set = set()
    for _ in range(3):                   # let the taint settle
        for n in ast.walk(fn):
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)) \
                    and n.value is not None and _is_tensor(n.value, names):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            names.add(leaf.id)
    return names


def _is_tensor(node, names: set) -> bool:
    """Is the expression (probably) a tensor? A torch.* call, a method
    call or arithmetic on a tensor name, a reduction or comparison
    method (`.any()`, `.max()`, `.sum()`, ...) on anything, a comparison
    of a tensor; never its shape, dtype or device."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr not in _META and _is_tensor(node.value, names)
    if isinstance(node, ast.Subscript):
        return _is_tensor(node.value, names)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _META or f.attr in _HOST_READS:
                return False
            if f.attr in _TENSOR_METHODS:
                return True
            if _root_name(f) == "torch" and not f.attr.startswith("is_"):
                return True
            return _is_tensor(f.value, names)
        return False
    if isinstance(node, ast.BinOp):
        return _is_tensor(node.left, names) or _is_tensor(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return _is_tensor(node.operand, names)
    if isinstance(node, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return any(_is_tensor(x, names)
                   for x in [node.left] + node.comparators)
    if isinstance(node, ast.BoolOp):
        return any(_is_tensor(v, names) for v in node.values)
    return False


def host_syncs(fn) -> list:
    """(line, what) of every host read in fn's body."""
    names = _tensor_names(fn)
    out = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_READS \
                    and not n.args:
                out.append((n.lineno, f".{f.attr}()"))
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize" \
                    and _root_name(f) == "torch":
                out.append((n.lineno, "torch.cuda.synchronize()"))
            elif isinstance(f, ast.Name) and f.id in ("bool", "int",
                                                      "float") \
                    and n.args and _is_tensor(n.args[0], names):
                out.append((n.lineno, f"{f.id}() of a tensor"))
        elif isinstance(n, (ast.If, ast.While, ast.IfExp)) \
                and _is_tensor(n.test, names):
            out.append((n.test.lineno,
                        f"{type(n).__name__.lower()} on a tensor"))
        elif isinstance(n, ast.Assert) and _is_tensor(n.test, names):
            out.append((n.test.lineno, "assert on a tensor"))
    return out


@register_checker
class HostSyncChecker(RepoChecker):
    name = "host-sync"
    rules = ("host-sync",)

    def check_repo(self, files: dict, config: AnalysisConfig) -> list:
        index = _Index(files)
        roots, missing = index.roots(config.capture_roots)
        reach = index.reachable(roots)
        out = [Finding("host-sync", spec.partition("::")[0], 1,
                       f"capture root {spec!r} names no function of the "
                       f"file: the roots have drifted from the code")
               for spec in missing]
        for key, root in sorted(reach.items()):
            path, fn = index.defs[key]
            for line, what in host_syncs(fn):
                out.append(Finding(
                    "host-sync", path, line,
                    f"{what} in {key.split('::')[1]}, which a captured "
                    f"decode step runs (from {root.split('::')[1]}): a "
                    f"CUDA graph replays the value the host read once"))
        return sorted(set(out), key=lambda f: (f.path, f.line))
