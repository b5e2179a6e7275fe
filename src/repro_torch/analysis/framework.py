"""Checker framework: findings, suppression, registry, allowlist ratchet.

The port's counterpart of `repro/analysis/framework.py`, with two
additions: CUDA sources (`.cu`) are parsed as text, their comments
blanked out with every line kept in place, and the allowlist helpers of
`scripts/_ratchet.py` live here (the port imports nothing of the
reference's tree).

A checker owns one or more *rules*. File checkers run per source file
(scoped by path patterns and by language); repo checkers run once over
the whole parsed set (cross-file rules: protocol conformance, registry
drift).

Suppression is two-tier:

* inline - `# repro: ignore[rule]` in Python, `// repro: ignore[rule]`
  in CUDA, on the finding's line or the line above it, suppresses that
  rule there (`ignore[*]` every rule). An inline ignore marks an
  intentional violation and carries its justification beside it.
* allowlist - a JSON file mapping "path:rule" keys to a reason. It only
  ratchets forward: an entry that matches no finding is *stale* and
  fails the gate until `--update` prunes it.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

__all__ = ["Finding", "SourceFile", "AnalysisConfig", "Checker",
           "RepoChecker", "register_checker", "checkers", "all_rules",
           "analyze_files", "analyze_paths", "apply_allowlist", "iter_source_files", "load_json",
           "dump_json", "CAPTURE_ROOTS", "DEFAULT_PATHS",
           "EXCLUDED_SEGMENTS"]

# paths containing any of these segments are never scanned repo-wide
EXCLUDED_SEGMENTS = ("__pycache__", "analysis/selftest", "kernels/_build")
SUFFIXES = (".py", ".cu")
# what the gate scans by default: the port, its CUDA sources, and the
# test file that anchors the family registry (registry-drift)
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_archs.py")

# the functions a captured decode step runs (host-sync's roots): each
# family's make_decode_step body, the sparse FFN, the kernels' launch paths
CAPTURE_ROOTS = (
    "src/repro_torch/models/dense.py::make_decode_step",
    "src/repro_torch/models/moe.py::make_decode_step",
    "src/repro_torch/models/vlm.py::make_decode_step",
    "src/repro_torch/core/sparse_ffn.py::*",
    "src/repro_torch/kernels/ops.py::fused_cold_ffn",
    "src/repro_torch/kernels/ops.py::cluster_gather_ffn",
    "src/repro_torch/kernels/ops.py::cluster_gather_ffn_grouped",
    "src/repro_torch/kernels/ops.py::dense_ffn",
)

_PY_IGNORE = re.compile(r"#\s*repro:\s*ignore\[([^\]]+)\]")
_CU_IGNORE = re.compile(r"//\s*repro:\s*ignore\[([^\]]+)\]")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str        # repo-relative posix path (or "dispatch/<entry>")
    line: int        # 1-based
    message: str

    @property
    def key(self) -> str:
        """Allowlist key: line-insensitive, so churn above a ratcheted
        finding does not invalidate its entry."""
        return f"{self.path}:{self.rule}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def strip_c_comments(text: str) -> str:
    """`text` with every C/C++ comment blanked to spaces (newlines kept,
    so line numbers and columns stay), string and char literals left as
    they are."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


class SourceFile:
    """One source file plus its inline suppressions. Python files carry
    their AST in `tree`; CUDA files carry `code`, the text with comments
    blanked (tree is None)."""

    def __init__(self, path: str, text: str):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.lang = "cuda" if self.path.endswith((".cu", ".cuh")) \
            else "python"
        if self.lang == "python":
            self.tree = ast.parse(text, filename=path)
            self.code = text
            pattern = _PY_IGNORE
        else:
            self.tree = None
            self.code = strip_c_comments(text)
            pattern = _CU_IGNORE
        self.ignores: dict = {}          # line (1-based) -> set of rules
        for i, raw in enumerate(text.splitlines(), start=1):
            m = pattern.search(raw)
            if m:
                self.ignores[i] = {r.strip() for r in m.group(1).split(",")}

    def line_of(self, offset: int) -> int:
        """1-based line of a character offset into `code`."""
        return self.code.count("\n", 0, offset) + 1

    def suppressed(self, finding: Finding) -> bool:
        for line in (finding.line, finding.line - 1):
            rules = self.ignores.get(line)
            if rules and (finding.rule in rules or "*" in rules):
                return True
        return False


@dataclass
class AnalysisConfig:
    """Tunables shared by the checkers. `scopes` overrides a checker's
    default path patterns (the self-test points every checker at its
    fixtures through it); the *_path fields name the files the repo
    checkers read, repo-relative."""
    scopes: dict = field(default_factory=dict)   # checker name -> patterns
    families_path: str = "src/repro_torch/serving/families.py"
    battery_path: str = "tests/test_torch_archs.py"
    kernels_ops_path: str = "src/repro_torch/kernels/ops.py"
    kernel_registry_path: str = "src/repro_torch/kernels/registry.py"
    # (path, class) whose methods alone may call torch.distributed
    collective_home: tuple = (("src/repro_torch/parallel.py", "ShardGroup"),)
    # host-sync's roots, as "path::qualified name" ("path::*" takes every
    # function of the file)
    capture_roots: tuple = CAPTURE_ROOTS


class Checker:
    """Per-file pass. Subclasses set `name`, `rules`, `langs`, default
    `scope` (path substrings; empty = every file) and implement
    `check`."""
    name: str = ""
    rules: tuple = ()
    scope: tuple = ()
    langs: tuple = ("python",)

    def applies(self, src: SourceFile, config: AnalysisConfig) -> bool:
        if src.lang not in self.langs:
            return False
        patterns = config.scopes.get(self.name, self.scope)
        return not patterns or any(p in src.path for p in patterns)

    def check(self, src: SourceFile, config: AnalysisConfig) -> list:
        raise NotImplementedError


class RepoChecker:
    """Whole-tree pass over every parsed file (cross-file rules)."""
    name: str = ""
    rules: tuple = ()

    def check_repo(self, files: dict, config: AnalysisConfig) -> list:
        raise NotImplementedError


_CHECKERS: list = []


def register_checker(cls):
    """Class decorator: instantiate and register a checker."""
    _CHECKERS.append(cls())
    return cls


def checkers() -> list:
    _ensure_loaded()
    return list(_CHECKERS)


def all_rules() -> tuple:
    return tuple(sorted({r for c in checkers() for r in c.rules}))


def _ensure_loaded():
    # import the checker modules for their registration side effects
    from repro_torch.analysis import (collectives, drift,  # noqa: F401
                                      kernel_hygiene, protocol,
                                      trace_hazards)


# ------------------------------------------------------------ running ----

def analyze_files(files: dict, config: AnalysisConfig = None) -> list:
    """Run every applicable checker over {path: source text}. Returns
    the findings not suppressed inline, sorted by (path, line, rule)."""
    config = config or AnalysisConfig()
    parsed: dict = {}
    findings: list = []
    for path, text in files.items():
        try:
            parsed[path] = SourceFile(path, text)
        except SyntaxError as e:
            findings.append(Finding("syntax-error", path, e.lineno or 1,
                                    str(e.msg)))
    for checker in checkers():
        if isinstance(checker, RepoChecker):
            findings.extend(checker.check_repo(parsed, config))
        else:
            for src in parsed.values():
                if checker.applies(src, config):
                    findings.extend(checker.check(src, config))
    kept = [f for f in findings
            if f.path not in parsed or not parsed[f.path].suppressed(f)]
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))


def iter_source_files(root: str, paths=None):
    """Yield (repo-relative path, absolute path) of every scannable .py
    and .cu file under `paths` (repo-relative; default DEFAULT_PATHS)."""
    seen = set()
    for rel_root in paths or DEFAULT_PATHS:
        top = os.path.join(root, rel_root)
        if os.path.isfile(top):
            cands = [top]
        else:
            cands = []
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not d.startswith(".") and d != "__pycache__")
                cands.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(SUFFIXES))
        for abspath in cands:
            rel = os.path.relpath(abspath, root).replace(os.sep, "/")
            if rel in seen or any(seg in rel for seg in EXCLUDED_SEGMENTS):
                continue
            seen.add(rel)
            yield rel, abspath


def analyze_paths(root: str, paths=None,
                  config: AnalysisConfig = None) -> list:
    files = {}
    for rel, abspath in iter_source_files(root, paths):
        with open(abspath, encoding="utf-8") as f:
            files[rel] = f.read()
    return analyze_files(files, config)


# ---------------------------------------------------------- allowlist ----

_REQUIRED = object()


def load_json(path: str, default=_REQUIRED):
    """Read a JSON baseline; a missing file gives `default` when one is
    given and raises otherwise."""
    if not os.path.exists(path):
        if default is _REQUIRED:
            raise FileNotFoundError(path)
        return default
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def dump_json(path: str, obj) -> None:
    """Write a baseline in one canonical form (indent 1, sorted keys,
    trailing newline), so --update rewrites give minimal diffs."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")


def apply_allowlist(findings: list, allow: dict) -> tuple:
    """Split findings against an allowlist {key: reason}: (kept,
    allowed, stale keys). `kept` must be fixed, `allowed` are ratcheted,
    stale keys match nothing and fail the gate until pruned."""
    kept, allowed, used = [], [], set()
    for f in findings:
        if f.key in allow:
            allowed.append(f)
            used.add(f.key)
        else:
            kept.append(f)
    return kept, allowed, sorted(set(allow) - used)
