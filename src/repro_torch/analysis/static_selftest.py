"""Seeded-violation self-test of the static tier: proves every rule
fires.

Each `bad_*` / `*_bad` fixture in selftest/ seeds specific violations; the clean
fixtures must produce no finding (`suppressed.py` and `suppressed.cu`
carry a real violation behind an inline ignore, which proves suppression
end to end). `run_self_test()` analyzes the fixtures with every checker
pointed here and asserts the rule -> fixture map below: a checker whose
match rots fails here, not silently in the gate.

selftest/ is in `framework.EXCLUDED_SEGMENTS` and is no package: its
fixtures are never scanned repo-wide, never imported, never executed.
"""
from __future__ import annotations

import os

from repro_torch.analysis.framework import (AnalysisConfig, all_rules,
                                            analyze_files)

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "selftest")

# rule -> the fixture its seeded violation lives in
EXPECTED = {
    "wall-clock": "bad_trace.py",
    "py-random": "bad_trace.py",
    "host-sync": "bad_trace.py",
    "collective-route": "bad_collectives.py",
    "collective-fp32": "bad_collectives.py",
    "async-copy-pairing": "bad_kernels.cu",
    "mbarrier-init": "bad_kernels.cu",
    "smem-budget": "bad_kernels.cu",
    "launch-check": "bad_kernels.cu",
    "shadow-hooks": "bad_kernels.cu",
    "protocol-method": "bad_handle.py",
    "family-fields": "families_bad.py",
    "registry-drift": "families_bad.py",
    "kernel-registry-drift": "ops_bad.py",
}
CLEAN = ("good_all.py", "suppressed.py", "battery.py", "registry.py",
         "good_kernels.cu", "suppressed.cu")

# unparseable source must surface as a finding, not an exception
_BROKEN = "def broken(:\n"


def fixture_config() -> AnalysisConfig:
    return AnalysisConfig(
        scopes={name: ("selftest/",) for name in
                ("trace-hazards", "collectives", "kernel-hygiene")},
        families_path="selftest/families_bad.py",
        battery_path="selftest/battery.py",
        kernels_ops_path="selftest/ops_bad.py",
        kernel_registry_path="selftest/registry.py",
        collective_home=(("selftest/bad_collectives.py", "ShardGroup"),
                         ("selftest/good_all.py", "ShardGroup")),
        capture_roots=("selftest/bad_trace.py::decode_step",
                       "selftest/good_all.py::clean_step"))


def load_fixtures() -> dict:
    files = {}
    for fname in sorted(os.listdir(DIR)):
        if fname.endswith((".py", ".cu")) and fname != "__init__.py":
            with open(os.path.join(DIR, fname), encoding="utf-8") as fh:
                files[f"selftest/{fname}"] = fh.read()
    files["selftest/broken_syntax.py"] = _BROKEN
    return files


def run_self_test():
    """(ok, report lines)."""
    findings = analyze_files(load_fixtures(), fixture_config())
    by_file: dict = {}
    for f in findings:
        by_file.setdefault(f.path, []).append(f)
    ok, lines = True, []
    for rule in sorted(set(EXPECTED) | set(all_rules())):
        want = EXPECTED.get(rule)
        hits = [f for f in by_file.get(f"selftest/{want}", [])
                if f.rule == rule]
        if want is None:
            ok = False
            lines.append(f"FAIL {rule}: no fixture seeds this rule")
        elif hits:
            lines.append(f"ok   {rule}: fires in {want} "
                         f"(line {hits[0].line})")
        else:
            ok = False
            lines.append(f"FAIL {rule}: seeded violation in {want} did "
                         f"not fire")
    for fname in CLEAN:
        extra = by_file.get(f"selftest/{fname}", [])
        ok = ok and not extra
        lines.append(f"FAIL clean fixture {fname} produced: "
                     + "; ".join(map(str, extra)) if extra else
                     f"ok   clean fixture {fname}: no findings")
    if any(f.rule == "syntax-error"
           for f in by_file.get("selftest/broken_syntax.py", [])):
        lines.append("ok   syntax-error: unparseable source reported as "
                     "a finding")
    else:
        ok = False
        lines.append("FAIL syntax-error: unparseable source not reported")
    return ok, lines
