"""CUDA kernel hygiene over the port's `kernels/csrc/*.cu`.

The port's counterpart of `repro/analysis/kernel_hygiene.py`. The TPU
kernel drove its own DMAs through semaphores; the CUDA kernels stage
shared memory with `cp.async` (waited with `cp.async.wait_all`, then a
block barrier) and, in `cluster_gather_ffn.cu`, with TMA bulk copies
multicast across a thread-block cluster that complete on an mbarrier.
Nothing at build time catches a copy that is read before the block
synchronizes, a barrier a peer signals before it is initialised, a
block that asks for more shared memory than the SM has, a launch whose
refusal is never reported, or a synchronisation the shadow tier cannot
see. Five rules, on the source text with its comments blanked (a
kernel's calls to the file's device helpers are followed, so a helper
that issues copies counts at its call site):

* async-copy-pairing - in a kernel, every `cp.async` issued is waited for
                       (`cp.async.wait_all` / `wait_group`), the wait is
                       followed by a block barrier (`__syncthreads()` or a
                       cluster sync), and no shared array is used between
                       the wait and that barrier; an mbarrier armed with
                       `expect_tx` has a `try_wait` / `test_wait` on the
                       same barrier.
* mbarrier-init      - each mbarrier is initialised (`mbarrier.init`)
                       before any other use, the init is fenced
                       (`fence.mbarrier_init`), and a cluster sync (a block
                       barrier in a kernel without clusters) lies between
                       the init and the first use a peer could make. A
                       barrier under its own `if` / loop head orders
                       nothing here, nor after a cp.async wait.
* smem-budget        - a block's static `__shared__` bytes (from the
                       file's constexpr constants, per element type T)
                       plus the most dynamic shared memory its launch can
                       ask for (the cudaFuncSetAttribute cap, else the
                       launch's own argument, at the worst case of
                       `DIM_BOUNDS`) stay within `SMEM_CAP` (227 KB);
                       without the attribute
                       the dynamic part stays within 48 KB.
                       `static_smem()` gives the static figures that the
                       card's ptxas report must equal.
* launch-check       - every `<<<...>>>` launch and `cudaLaunchKernelEx`
                       is followed by a `cudaGetLastError()` whose result
                       is returned: a launch refused for its shared memory
                       or its block never runs, and a later synchronize
                       does not say so.
* shadow-hooks       - no kernel body issues a raw `__syncthreads()`, a
                       cluster sync, `cp.async` (bulk or not), an
                       `mbarrier.` instruction, `griddepcontrol` or a
                       `bar.sync` / `barrier.cluster` of its own: each goes
                       through a device helper of the file that also calls
                       its hook of csrc/shadow.cuh (a `SHADOW_*` macro), and
                       every kernel opens with SHADOW_BEGIN and closes with
                       SHADOW_END. So a later kernel cannot step around the
                       shadow tier (analysis/shadow.py), which sees only
                       what the hooks record.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.analysis.cexpr import Unresolved, evaluate, names_in
from repro_torch.analysis.framework import (AnalysisConfig, Checker,
                                            Finding, SourceFile,
                                            register_checker)
from repro_torch.kernels.ops import FUSED_DIM_BOUNDS

__all__ = ["CudaFile", "static_smem", "ELEMENT_TYPES"]

# the element types a `typename T` kernel is instantiated for
ELEMENT_TYPES = {"float": 4, "__nv_bfloat16": 2}
SMEM_CAP = 232448           # shared memory a block can use (227 KB)
SMEM_DEFAULT = 48 * 1024    # dynamic shared memory without the attribute
# upper bounds of the C entry points' runtime sizes, the ones
# kernels/ops.py checks: the dynamic estimate takes its worst case over them
DIM_BOUNDS = FUSED_DIM_BOUNDS
_KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "do",
             "catch", "static_assert", "alignof", "decltype"}
_ISSUE = re.compile(r"cp\.async\.(?:ca|cg)\.")
_WAIT = re.compile(r"cp\.async\.wait_(?:all|group)")
_BARRIER = re.compile(r"__syncthreads(?:_count|_and|_or)?\s*\(|"
                      r"\.sync\s*\(\s*\)|\bbar\.sync\b|barrier\.cluster\.wait")
_CLUSTER_SYNC = re.compile(r"cluster\(\)\s*\.sync\s*\(|\bcluster\.sync\s*\(|"
                           r"barrier\.cluster\.wait")
_MB = {"mb_init": re.compile(r"mbarrier\.init"),
       "mb_fence": re.compile(r"fence\.mbarrier_init"),
       "mb_expect": re.compile(r"expect_tx"),
       "mb_wait": re.compile(r"mbarrier\.(?:try_wait|test_wait)"),
       "mb_signal": re.compile(r"complete_tx|mbarrier\.arrive(?!\.expect_tx)")}
_SHARED = re.compile(
    r"(extern\s+)?__shared__\s+(?:__align__\((\d+)\)\s+)?"
    r"((?:unsigned\s+)?[\w:]+)\s+(?:__align__\((\d+)\)\s+)?(\w+)\s*"
    r"((?:\[[^\]]*\])*)\s*;")
_PTR = re.compile(r"(?:const\s+)?[\w:<>]+\s*\*\s*(?:const\s+)?"
                  r"(?:__restrict__\s+)?(\w+)\s*=\s*([^;]+);")
_CONSTEXPR = re.compile(r"(?:static\s+)?constexpr\s+(?:int|size_t|unsigned)"
                        r"\s+([^;]+);")
_LAUNCH = re.compile(r"<<<|cudaLaunchKernelEx\s*\(")
# what only a hooked helper may issue (shadow-hooks)
_RAW_SYNC = re.compile(r"__syncthreads\w*\s*\(|\bthis_cluster\s*\(\s*\)\s*\.\s*"
                       r"sync\s*\(|\bcluster\s*\.\s*sync\s*\(|cp\.async|"
                       r"mbarrier\.|griddepcontrol|\bbar\.sync\b|"
                       r"barrier\.cluster")
_HOOK = re.compile(r"\bSHADOW_\w+\s*\(")


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes text[i] == open_."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def _defined_name(head: str):
    """The name a function definition's head defines, or None (a
    control statement, an initializer, a lambda)."""
    h = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ", head).rstrip()
    h = re.sub(r"\b(const|noexcept|override)\s*$", "", h).rstrip()
    if not h.endswith(")") or h.endswith("]") or "=" in h.split("(")[0]:
        return None
    depth = 0
    for j in range(len(h) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(h[j], 0)
        if depth == 0:
            break
    m = re.search(r"([A-Za-z_]\w*)\s*(?:<[^<>]*>)?\s*$", h[:j])
    if not m or m.group(1) in _KEYWORDS or h[:j].rstrip().endswith("]"):
        return None
    return m.group(1)


def _split_top(text: str, sep: str = ",") -> list:
    """text split at `sep` outside brackets."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [s.strip() for s in out]


@dataclass
class Function:
    name: str
    head: str            # text from the previous statement to the '{'
    start: int           # offset of the body's '{'
    end: int             # offset just past its '}'
    kind: str            # "global", "device" or "host"
    templated_t: bool    # template <typename T ...>

    def body(self, code: str) -> str:
        return code[self.start:self.end]


@dataclass
class CudaFile:
    """One CUDA source: its functions, constexpr constants, structs'
    static constexpr members and constexpr functions."""
    code: str
    functions: list = field(default_factory=list)
    env: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, code: str) -> "CudaFile":
        cf = cls(code)
        cf._scan(0, len(code), depth_ok=True)
        for f in cf.functions:
            cf._scan_constexpr_fn(f)
        return cf

    def _scan(self, lo: int, hi: int, depth_ok: bool, struct: str = None):
        """Find function bodies, namespaces and structs in [lo, hi)."""
        i, stmt = lo, lo
        while i < hi:
            ch = self.code[i]
            if ch in ";}":
                stmt = i + 1
            elif ch == "{":
                end = _match(self.code, i, "{", "}")
                head = self.code[stmt:i]
                m_struct = re.search(r"\b(struct|class)\s+(\w+)[^;()]*$",
                                     head)
                if re.search(r"\bnamespace\b[^;]*$|extern\s+\"C\"\s*$", head):
                    self._scan(i + 1, end - 1, depth_ok)
                elif m_struct:
                    self._constants(self.code[i + 1:end - 1],
                                    prefix=f"{m_struct.group(2)}<>::")
                else:
                    name = _defined_name(head)
                    if name:
                        kind = "global" if "__global__" in head else \
                            "device" if "__device__" in head else "host"
                        self.functions.append(Function(
                            name, head, i, end, kind,
                            bool(re.search(r"template\s*<\s*typename\s+T\b",
                                           head))))
                i, stmt = end, end
                continue
            i += 1
        if depth_ok:
            outside = self.code
            for f in self.functions:
                outside = outside[:f.start] + " " * (f.end - f.start) + \
                    outside[f.end:]
            self._constants(outside, prefix="")

    def _constants(self, text: str, prefix: str):
        for m in _CONSTEXPR.finditer(text):
            for part in _split_top(m.group(1)):
                name, _, expr = part.partition("=")
                if expr:
                    self.env.setdefault(prefix + name.strip(), expr.strip())

    def _scan_constexpr_fn(self, f: Function):
        """`constexpr int pad() { return EXPR; }` -> env['pad<>()']."""
        if "constexpr" not in f.head:
            return
        m = re.fullmatch(r"\{\s*return\s+([^;]+);\s*\}", f.body(self.code))
        if m:
            key = f"{f.name}<>()" if "template" in f.head else f"{f.name}()"
            self.env[key] = m.group(1)

    def function(self, name: str):
        return next((f for f in self.functions if f.name == name), None)

    def local_env(self, f: Function) -> dict:
        """The file's constants plus f's own constexpr and const locals."""
        env = dict(self.env)
        body = f.body(self.code)
        for m in _CONSTEXPR.finditer(body):
            for part in _split_top(m.group(1)):
                name, _, expr = part.partition("=")
                if expr:
                    env[name.strip()] = expr.strip()
        for m in re.finditer(r"(?:const\s+)?(?:size_t|int|unsigned)\s+(\w+)"
                             r"\s*=\s*([^;]+);", body):
            env.setdefault(m.group(1), m.group(2).strip())
        return env

    def shared_vars(self, f: Function) -> list:
        """(extern?, align, type, name, dims) of f's __shared__ arrays."""
        out = []
        for m in _SHARED.finditer(f.body(self.code)):
            align = int(m.group(2) or m.group(4) or 0)
            out.append((bool(m.group(1)), align, m.group(3), m.group(5),
                        re.findall(r"\[([^\]]*)\]", m.group(6))))
        return out


def _instances(f: Function) -> dict:
    """{T name: bytes} f is instantiated for ({"": 0} if untemplated)."""
    return dict(ELEMENT_TYPES) if f.templated_t else {"": 0}


def static_smem(cf: CudaFile) -> dict:
    """{(kernel, T): static shared bytes} of every __global__ function,
    laid out in declaration order at each array's alignment and rounded
    up to the dynamic array's alignment when there is one (as ptxas
    reports it). Raises Unresolved when a size is not constant."""
    out = {}
    for f in cf.functions:
        if f.kind != "global":
            continue
        env = cf.local_env(f)
        for tname, tbytes in _instances(f).items():
            types = {"T": tbytes} if tname else {}
            off, round_to = 0, 1
            for extern, align, typ, _, dims in cf.shared_vars(f):
                if extern:
                    round_to = max(round_to, align or 1)
                    continue
                size = evaluate(f"sizeof({typ})", {}, types)
                n = 1
                for d in dims:
                    n *= evaluate(d, env, types)
                a = align or size
                off = -(-off // a) * a + n * size
            out[f.name, tname] = -(-off // round_to) * round_to
    return out


def _call_names(text: str) -> set:
    return set(re.findall(r"\b([A-Za-z_]\w*)\s*(?:<[^<>;()]*>)?\s*\(", text))


class _Roles:
    """What each device helper does, transitively through the helpers it
    calls: issue / wait cp.async, barrier, cluster sync, mbarrier roles."""

    def __init__(self, cf: CudaFile):
        self.cf = cf
        self.helpers = {f.name: f for f in cf.functions
                        if f.kind == "device"}
        self.memo = {}

    def of(self, name: str, seen=()) -> set:
        if name in self.memo:
            return self.memo[name]
        f = self.helpers.get(name)
        if f is None or name in seen:
            return set()
        body = f.body(self.cf.code)
        roles = self.direct(body)
        for callee in _call_names(body) - {name}:
            roles |= self.of(callee, seen + (name,))
        self.memo[name] = roles
        return roles

    @staticmethod
    def direct(text: str) -> set:
        roles = set()
        if _ISSUE.search(text):
            roles.add("issue")
        if _WAIT.search(text):
            roles.add("wait")
        if _BARRIER.search(text):
            roles.add("barrier")
        if _CLUSTER_SYNC.search(text):
            roles.add("cluster")
        for k, pat in _MB.items():
            if pat.search(text):
                roles.add(k)
        return roles

    def statement_roles(self, stmt: str) -> set:
        roles = self.direct(stmt)
        for callee in _call_names(stmt):
            roles |= self.of(callee)
        return roles


_GUARDED = re.compile(r"(?:else\s+)?(?:if|while|for)\s*\(")


def _unconditional(stmt: str) -> bool:
    """A statement not under its own `if` / `while` / `for` head (a
    barrier there may not run, so it orders nothing)."""
    return not _GUARDED.match(stmt)


def _statements(body: str, base: int):
    """(offset, text) of each statement-like piece of a body: split at
    ';', '{' and '}'."""
    start = 0
    for i, ch in enumerate(body):
        if ch in ";{}":
            piece = body[start:i + 1]
            if piece.strip(" \n\t{}"):
                lead = len(piece) - len(piece.lstrip())
                yield base + start + lead, piece[lead:]
            start = i + 1


@register_checker
class KernelHygieneChecker(Checker):
    name = "kernel-hygiene"
    rules = ("async-copy-pairing", "mbarrier-init", "smem-budget",
             "launch-check", "shadow-hooks")
    scope = ("src/repro_torch/kernels/csrc/",)
    langs = ("cuda",)

    def check(self, src: SourceFile, config: AnalysisConfig) -> list:
        cf = CudaFile.parse(src.code)
        roles = _Roles(cf)
        out = []
        for f in cf.functions:
            if f.kind == "global":
                out += self._copies(cf, f, roles, src)
                out += self._mbarriers(cf, f, roles, src)
        out += self._smem(cf, src, config)
        out += self._launches(cf, src)
        out += self._hooks(cf, src)
        return out

    # ---------------------------------------------------- shadow-hooks ----
    def _hooks(self, cf, src) -> list:
        out = []
        for f in cf.functions:
            if f.kind == "host":
                continue
            body = f.body(cf.code)
            if f.kind == "global":
                for m in _RAW_SYNC.finditer(body):
                    out.append(Finding(
                        "shadow-hooks", src.path,
                        src.line_of(f.start + m.start()),
                        f"{f.name}: raw {m.group(0).strip()!r} in a kernel "
                        f"body: go through a device helper that calls its "
                        f"shadow hook (csrc/shadow.cuh)"))
                for hook in ("SHADOW_BEGIN", "SHADOW_END"):
                    if not re.search(rf"\b{hook}\s*\(", body):
                        out.append(Finding(
                            "shadow-hooks", src.path, src.line_of(f.start),
                            f"{f.name}: no {hook}(): the shadow tier cannot "
                            f"give the kernel its slot or check its exit"))
                continue
            m = _RAW_SYNC.search(body)
            if m and not _HOOK.search(body):
                out.append(Finding(
                    "shadow-hooks", src.path, src.line_of(f.start + m.start()),
                    f"{f.name}: issues {m.group(0).strip()!r} without a "
                    f"SHADOW_* hook, so the shadow build does not see it"))
        return out

    # ---------------------------------------------- async-copy-pairing ----
    def _copies(self, cf, f, roles, src) -> list:
        shared = self._shared_names(cf, f)
        events = [(off, stmt, roles.statement_roles(stmt))
                  for off, stmt in _statements(f.body(cf.code), f.start)]
        out, pending = [], None
        for k, (off, stmt, r) in enumerate(events):
            if "issue" in r and pending is None:
                pending = off
            if "wait" in r and pending is not None:
                pending = None
                between = []
                for off2, stmt2, r2 in events[k + 1:]:
                    if ("barrier" in r2 or "cluster" in r2) \
                            and _unconditional(stmt2):
                        break
                    between.append((off2, stmt2))
                else:
                    out.append(Finding(
                        "async-copy-pairing", src.path, src.line_of(off),
                        f"{f.name}: cp.async is waited for but no block "
                        f"barrier follows: other threads' copies may not "
                        f"have landed"))
                    continue
                used = [(o, n) for o, s in between for n in sorted(shared)
                        if re.search(rf"\b{n}\b", s)]
                if used:
                    o, n = used[0]
                    out.append(Finding(
                        "async-copy-pairing", src.path, src.line_of(o),
                        f"{f.name}: shared array {n!r} is used after the "
                        f"cp.async wait and before the block barrier: a "
                        f"thread waits only for its own copies"))
        if pending is not None:
            out.append(Finding(
                "async-copy-pairing", src.path, src.line_of(pending),
                f"{f.name}: cp.async is issued and never waited for "
                f"(cp.async.wait_all / wait_group): the read races the "
                f"copy"))
        for bar in self._barrier_names(cf, f):
            armed = waited = None
            for off, stmt, r in events:
                if re.search(rf"\b{bar}\b", stmt):
                    if "mb_expect" in r and armed is None:
                        armed = off
                    if "mb_wait" in r:
                        waited = off
            if armed is not None and waited is None:
                out.append(Finding(
                    "async-copy-pairing", src.path, src.line_of(armed),
                    f"{f.name}: mbarrier {bar!r} is armed with expect_tx "
                    f"but nothing waits on it (mbarrier.try_wait): the "
                    f"bulk copy races its readers"))
        return out

    @staticmethod
    def _shared_names(cf, f) -> set:
        """f's shared arrays and the pointers derived from them, without
        its mbarriers (uint64_t)."""
        names = {v[3] for v in cf.shared_vars(f) if v[2] != "uint64_t"}
        body = f.body(cf.code)
        for _ in range(4):
            for m in _PTR.finditer(body):
                if any(re.search(rf"\b{n}\b", m.group(2)) for n in names):
                    names.add(m.group(1))
        return names

    @staticmethod
    def _barrier_names(cf, f) -> list:
        return [v[3] for v in cf.shared_vars(f) if v[2] == "uint64_t"]

    # --------------------------------------------------- mbarrier-init ----
    def _mbarriers(self, cf, f, roles, src) -> list:
        out = []
        body = f.body(cf.code)
        clustered = bool(re.search(r"this_cluster|cluster_ctarank|"
                                   r"multicast::cluster|shared::cluster",
                                   body + "".join(
                                       h.body(cf.code)
                                       for n, h in roles.helpers.items()
                                       if n in _call_names(body))))
        stmts = list(_statements(body, f.start))
        for bar in self._barrier_names(cf, f):
            init = fenced = synced = None
            for off, stmt in stmts:
                r = roles.statement_roles(stmt)
                names_bar = re.search(rf"\b{bar}\b", stmt)
                if names_bar and "mb_init" in r:
                    init = off if init is None else init
                    fenced = off if "mb_fence" in r else fenced
                    continue
                if init is not None and "mb_fence" in r and fenced is None:
                    fenced = off
                if init is not None and synced is None \
                        and _unconditional(stmt) and (
                            "cluster" in r if clustered else
                            ("barrier" in r or "cluster" in r)):
                    synced = off
                if names_bar and r & {"mb_expect", "mb_wait", "mb_signal"}:
                    line = src.line_of(off)
                    if init is None:
                        out.append(Finding(
                            "mbarrier-init", src.path, line,
                            f"{f.name}: mbarrier {bar!r} is used before "
                            f"mbarrier.init"))
                    elif fenced is None:
                        out.append(Finding(
                            "mbarrier-init", src.path, line,
                            f"{f.name}: mbarrier {bar!r}'s init is not "
                            f"fenced (fence.mbarrier_init) before use"))
                    elif synced is None:
                        out.append(Finding(
                            "mbarrier-init", src.path, line,
                            f"{f.name}: no "
                            f"{'cluster sync' if clustered else 'barrier'}"
                            f" between mbarrier {bar!r}'s init and its "
                            f"first use: a peer may signal it first"))
                    break
        return out

    # ----------------------------------------------------- smem-budget ----
    def _smem(self, cf, src, config) -> list:
        out = []
        try:
            static = static_smem(cf)
        except Unresolved as e:
            return [Finding("smem-budget", src.path, 1,
                            f"a static __shared__ size is not a constant "
                            f"expression: {e}")]
        for f in cf.functions:
            if f.kind != "global":
                continue
            line = src.line_of(f.start)
            dyn = self._dynamic(cf, f, config)
            for tname in _instances(f):
                what = f"{f.name}<{tname}>" if tname else f.name
                st = static[f.name, tname]
                if isinstance(dyn, str):
                    out.append(Finding("smem-budget", src.path, line,
                                       f"{what}: {dyn}"))
                    continue
                capped, nbytes = dyn.get(tname, (False, 0))
                if not capped and nbytes > SMEM_DEFAULT:
                    out.append(Finding(
                        "smem-budget", src.path, line,
                        f"{what}: its launch asks for up to {nbytes} bytes "
                        f"of dynamic shared memory without "
                        f"cudaFuncSetAttribute(MaxDynamicSharedMemorySize)"
                        f": above {SMEM_DEFAULT} the launch "
                        f"is refused"))
                if st + nbytes > SMEM_CAP:
                    out.append(Finding(
                        "smem-budget", src.path, line,
                        f"{what}: {st} static + up to {nbytes} dynamic "
                        f"bytes of shared memory exceed the block's "
                        f"{SMEM_CAP}"))
        return out

    def _dynamic(self, cf, f, config):
        """{T: (capped by the attribute, most dynamic bytes)}, or a
        message when a size cannot be bounded."""
        sets, launches = [], []
        for h in cf.functions:
            if h.kind != "host":
                continue
            body = h.body(cf.code)
            for m in re.finditer(r"cudaFuncSetAttribute\s*\(", body):
                args = _split_top(body[m.end():_match(
                    body, m.end() - 1, "(", ")") - 1])
                if len(args) == 3 and "MaxDynamicSharedMemorySize" in args[1]:
                    for k in self._kernels_named(args[0], body, cf):
                        if k == f.name:
                            sets.append((h, args[2]))
            for m in re.finditer(rf"\b{f.name}\b\s*(?:<[^<>;]*>)?\s*<<<",
                                 body):
                close = body.find(">>>", m.end())
                args = _split_top(body[m.end():close])
                if len(args) >= 3:
                    launches.append((h, args[2]))
        if not sets and not launches:
            return {}
        out = {}
        for tname, tbytes in _instances(f).items():
            types = {"T": tbytes} if tname else {}
            capped = bool(sets)
            worst = 0
            for h, expr in (sets or launches):
                try:
                    worst = max(worst, self._worst(expr, cf.local_env(h),
                                                   types, config))
                except Unresolved as e:
                    return (f"its dynamic shared memory ({expr.strip()}) "
                            f"cannot be bounded: {e}")
            out[tname] = (capped, worst)
        return out

    @staticmethod
    def _kernels_named(arg: str, body: str, cf) -> list:
        names = [g.name for g in cf.functions if g.kind == "global"]
        hit = [n for n in names if re.search(rf"\b{n}\b", arg)]
        if hit:
            return hit
        m = re.search(rf"for\s*\(\s*auto\s+{re.escape(arg.strip())}\s*:\s*"
                      rf"\{{([^}}]*)\}}", body)
        return [n for n in names if m and re.search(rf"\b{n}\b", m.group(1))]

    @staticmethod
    def _worst(expr: str, env: dict, types: dict, config) -> int:
        """The most `expr` can be over the bounded runtime sizes: every
        power of two up to each bound, and the bound."""
        free = []
        used = names_in(expr, env)
        for name, bound in DIM_BOUNDS.items():
            if name in used:
                vals = sorted({1 << i for i in range(bound.bit_length())}
                              | {bound})
                free.append((name, vals))
        best = None
        combos = [{}]
        for name, vals in free:
            combos = [{**c, name: v} for c in combos for v in vals]
        for c in combos:
            e = {**env, **c}
            try:
                v = evaluate(expr, e, types)
            except Unresolved:
                if c is combos[-1] and best is None:
                    raise
                continue
            best = v if best is None else max(best, v)
        return best

    # ---------------------------------------------------- launch-check ----
    def _launches(self, cf, src) -> list:
        out = []
        for h in cf.functions:
            if h.kind != "host":
                continue
            body = h.body(cf.code)
            sites = [m.start() for m in _LAUNCH.finditer(body)]
            for k, at in enumerate(sites):
                end = body.find(";", body.find("(", body.find(">>>", at)
                                               if body[at] == "<" else at))
                nxt = sites[k + 1] if k + 1 < len(sites) else len(body)
                seg, rest = body[end:nxt], body[end:]
                ok = bool(re.search(r"return[^;]*cudaGetLastError\s*\(\s*\)",
                                    seg))
                for m in re.finditer(r"(\w+)\s*=\s*cudaGetLastError\s*\(\s*\)",
                                     seg):
                    if re.search(rf"return\s*(?:\(int\)\s*)?{m.group(1)}\b",
                                 rest):
                        ok = True
                if not ok:
                    out.append(Finding(
                        "launch-check", src.path, src.line_of(h.start + at),
                        f"{h.name}: a kernel launch with no "
                        f"cudaGetLastError() whose result is returned "
                        f"before the next launch: a refused launch goes "
                        f"unreported"))
        return out


# ------------------------------------------------ the card's ptxas report ----

PTXAS_RULES = ("smem-fidelity", "ptxas-spill")
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                   r"(?:, (\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(report: str, kernels) -> list:
    """nvcc's -Xptxas -v report -> one dict per compiled entry function
    of the named kernels: kernel, T ('float', '__nv_bfloat16' or '' for
    an untemplated kernel), the mangled name, registers, static smem
    bytes and spill bytes (stores + loads)."""
    out, cur = [], None
    for line in report.splitlines():
        m = _ENTRY.search(line)
        if m:
            mangled = m.group(1)
            cur = None
            for k in kernels:
                tag = f"{len(k)}{k}"
                if tag + "I" in mangled:
                    rest = mangled.split(tag + "I", 1)[1]
                    t = "float" if rest.startswith("f") else \
                        "__nv_bfloat16" if rest.startswith(
                            "13__nv_bfloat16") else "?"
                elif tag + "E" in mangled or mangled.endswith(tag):
                    t = ""
                else:
                    continue
                cur = dict(kernel=k, T=t, mangled=mangled, registers=None,
                           smem=0, spill=0)
                out.append(cur)
                break
            continue
        if cur is None:
            continue
        s = _SPILL.search(line)
        if s:
            cur["spill"] = int(s.group(1)) + int(s.group(2))
        u = _USED.search(line)
        if u:
            cur["registers"] = int(u.group(1))
            cur["smem"] = int(u.group(2) or 0)
    return out


def ptxas_findings(path: str, text: str, report: str) -> tuple:
    """Hold the static smem estimate of source `path` (its text) against
    the card's ptxas report of it: (findings, rows). smem-fidelity fires
    where an entry's static smem differs from static_smem()'s figure, or
    a kernel of the source has no entry in the report; ptxas-spill where
    an entry spills."""
    cf = CudaFile.parse(SourceFile(path, text).code)
    est = static_smem(cf)
    names = sorted({k for k, _ in est})
    rows = parse_ptxas(report, names)
    out = []
    for k in names:
        if not any(r["kernel"] == k for r in rows):
            out.append(Finding("smem-fidelity", path, 1,
                               f"{k}: no entry in the ptxas report"))
    for r in rows:
        want = est.get((r["kernel"], r["T"]))
        if want != r["smem"]:
            out.append(Finding(
                "smem-fidelity", path, 1,
                f"{r['kernel']}<{r['T']}>: ptxas reports {r['smem']} bytes "
                f"of static smem, the static estimate {want}: the "
                f"smem-budget rule has drifted from the compiler"))
        if r["spill"]:
            out.append(Finding(
                "ptxas-spill", path, 1,
                f"{r['mangled']}: {r['spill']} bytes of register spills "
                f"({r['registers']} registers)"))
    return out, rows
