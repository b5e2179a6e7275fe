"""The port's analysis gate.

    PYTHONPATH=src python -m repro_torch.analysis              # static tier
    PYTHONPATH=src python -m repro_torch.analysis --tier all   # + dispatch
    PYTHONPATH=src python -m repro_torch.analysis --self-test  # rules fire
    PYTHONPATH=src python -m repro_torch.analysis --update     # re-ratchet
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch/kernels

Fails on any finding that is neither suppressed inline (`# repro:
ignore[rule]`, `// repro: ignore[rule]` in CUDA, with its justification)
nor ratcheted in the committed allowlist (allowlist.json beside this
file, "path:rule" -> reason). A stale entry, one that matches no finding
of the tiers run, fails until --update prunes it: the allowlist only
moves forward. Tiers (see __init__.py): static (the default) scans
sources; dispatch runs every entry of entries.py on the CPU (on the card
chip_smoke.py's phase analyze runs it, its ranks sharing cuda:0); all
runs both.
--self-test runs the seeded fixtures of the tiers instead of the tree.
The shadow tier (SHADOW_RULES, analysis/shadow.py) needs a card: it runs
in chip_smoke.py's phase analyze, `python -m repro_torch.analysis.shadow`
and `python -m repro_torch.analysis.shadow_mutants` (its mutants); the
self-test lists its rules and the mutant that proves each.

Exit codes: 0 clean, 1 findings / stale entries / a failed self-test,
2 internal error (an unreadable allowlist, bad arguments).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.framework import (AnalysisConfig, all_rules,
                                            analyze_paths, apply_allowlist,
                                            dump_json, load_json)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "allowlist.json")
_TAG = "[repro_torch.analysis]"


def _tiers(tier: str) -> tuple:
    return ("static", "dispatch") if tier == "all" else (tier,)


def _owned(key: str, tiers: tuple) -> bool:
    """Does the allowlist key belong to a tier this run covers? Only those
    can be stale or rewritten; the card's dispatch keys
    (dispatch/cuda/...) belong to chip_smoke.py's phase analyze."""
    if key.startswith("dispatch/"):
        return "dispatch" in tiers and key.startswith("dispatch/cpu/")
    return "static" in tiers


def run_self_test(tiers: tuple) -> int:
    ok, lines, n_rules = True, [], 0
    if "static" in tiers:
        from repro_torch.analysis.static_selftest import run_self_test as static
        s_ok, s_lines = static()
        ok, n_rules, lines = ok and s_ok, n_rules + len(all_rules()), \
            lines + s_lines
    if "dispatch" in tiers:
        from repro_torch.analysis.dispatch_rules import DISPATCH_RULES
        from repro_torch.analysis.dispatch_selftest import \
            run_dispatch_self_test
        d_ok, d_lines = run_dispatch_self_test("cpu")
        ok, n_rules, lines = ok and d_ok, n_rules + len(DISPATCH_RULES), \
            lines + d_lines
    from repro_torch.analysis.shadow import SHADOW_RULES
    from repro_torch.analysis.shadow_mutants import FIDELITY_MUTANT, MUTANTS
    for rule in SHADOW_RULES:
        by = [m.name for m in MUTANTS if rule in m.rules] + (
            [FIDELITY_MUTANT[0]] if rule in FIDELITY_MUTANT[1] else [])
        lines.append(f"card {rule}: shadow tier, proven on the card by "
                     f"{', '.join(by) or 'no mutant (a bound of the shadow)'}")
    for line in lines:
        print(f"{_TAG} SELF-TEST {line}")
    print(f"{_TAG} SELF-TEST {'OK: every rule fires' if ok else 'FAILED'} "
          f"({n_rules} rules, tiers {'+'.join(tiers)})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="repo-relative files or directories for the "
                         "static tier (default: src/repro_torch and the "
                         "family battery)")
    ap.add_argument("--tier", choices=("static", "dispatch", "all"),
                    default="static")
    ap.add_argument("--allowlist", default=DEFAULT_ALLOWLIST)
    ap.add_argument("--update", action="store_true",
                    help="rewrite the allowlist's entries of the tiers run "
                         "to the current findings (prunes stale ones)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="also write the findings as JSON (to stdout "
                         "without a PATH)")
    ap.add_argument("--self-test", action="store_true",
                    help="run the seeded fixtures instead of the tree")
    args = ap.parse_args(argv)
    tiers = _tiers(args.tier)
    if args.self_test:
        return run_self_test(tiers)

    findings = []
    if "static" in tiers:
        findings += analyze_paths(REPO, args.paths or None, AnalysisConfig())
    if "dispatch" in tiers:
        from repro_torch.analysis.dispatch_rules import dispatch_findings
        findings += dispatch_findings("cpu")
    try:
        allow = load_json(args.allowlist, default={})
    except ValueError as e:
        print(f"{_TAG} allowlist {args.allowlist} is not valid JSON: {e}",
              file=sys.stderr)
        return 2
    mine = {k: v for k, v in allow.items()
            if _owned(k, tiers)}
    kept, allowed, stale = apply_allowlist(findings, mine)
    # a path subset cannot show a key of another file stale
    if args.paths:
        stale = [k for k in stale
                 if any(k.startswith(p) for p in args.paths)]

    if args.json:
        report = {"tiers": list(tiers),
                  "findings": [{"rule": f.rule, "path": f.path,
                                "line": f.line, "message": f.message}
                               for f in findings],
                  "kept": [f.key for f in kept],
                  "allowlisted": [f.key for f in allowed],
                  "stale": stale}
        if args.json == "-":
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            dump_json(args.json, report)
            print(f"{_TAG} report -> {args.json}")

    if args.update:
        fresh = {k: v for k, v in allow.items() if k not in mine}
        for f in findings:
            fresh.setdefault(f.key, allow.get(
                f.key, "ratcheted finding: fix it, then prune with "
                       "--update"))
        dump_json(args.allowlist, fresh)
        print(f"{_TAG} allowlist <- {len(fresh)} entr"
              f"{'y' if len(fresh) == 1 else 'ies'} ({len(stale)} stale "
              f"pruned) -> {args.allowlist}")
        return 0

    print(f"{_TAG} tiers {'+'.join(tiers)}: {len(findings)} finding(s), "
          f"{len(allowed)} allowlisted, {len(stale)} stale allowlist "
          f"entr{'y' if len(stale) == 1 else 'ies'}")
    rc = 0
    if kept:
        rc = 1
        for f in kept:
            print(f"  FINDING {f}")
        print(f"{_TAG} {len(kept)} finding(s): fix, add an inline "
              f"`repro: ignore[rule]` with its justification, or ratchet "
              f"with --update")
    for key in stale:
        print(f"  stale allowlist entry: {key} ({allow[key]!r})")
    if stale:
        print(f"{_TAG} stale entries fail the gate (the ratchet only moves "
              f"forward): prune with --update")
        rc = 1
    if rc == 0:
        print(f"{_TAG} OK: clean under the committed allowlist")
    return rc


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        raise
    except SystemExit:
        raise
    except Exception as e:                     # exit code 2: internal error
        print(f"{_TAG} internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.exit(2)
