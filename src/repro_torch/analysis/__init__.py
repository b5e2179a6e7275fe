"""The port's analysis gate (counterpart of `repro/analysis/` and
`scripts/repro_analyze.py`).

Three tiers guard invariants the tests only sample:

* static   - source rules over `src/repro_torch/` and its CUDA sources
             (framework.py runs them; allowlist.json ratchets them):
             trace_hazards.py (wall-clock, py-random, host-sync),
             collectives.py (collective-route, collective-fp32),
             kernel_hygiene.py (async-copy-pairing, mbarrier-init,
             smem-budget, launch-check), protocol.py (protocol-method,
             family-fields), drift.py (registry-drift,
             kernel-registry-drift).
* dispatch - every served decode step of entries.py run once under a
             TorchDispatchMode that sees each aten op
             (dispatch_rules.py: dispatch-host-read, dispatch-f64,
             dispatch-collective-count, dispatch-error; on the card also
             dispatch-h2d and torch.cuda's sync debug mode).
* card     - chip_smoke.py's phase analyze: the dispatch tier on the
             card, the ptxas check of smem-budget, and sanitizer.py's
             probe of NVIDIA's compute-sanitizer (racecheck over
             fused_cold_ffn; blocked where the tool does not support the
             machine's driver).

    PYTHONPATH=src python -m repro_torch.analysis [--tier static|dispatch|all]
        [--self-test] [--update] [--json PATH] [paths]

selftest/ holds the seeded-violation fixtures (static_selftest.py and
dispatch_selftest.py run them); it is never scanned repo-wide. Nothing
here imports jax or the JAX package.
"""
from repro_torch.analysis.framework import (
    AnalysisConfig, Finding, SourceFile, all_rules, analyze_files,
    analyze_paths, apply_allowlist, checkers)

__all__ = ["AnalysisConfig", "Finding", "SourceFile", "all_rules",
           "analyze_files", "analyze_paths", "apply_allowlist", "checkers"]
