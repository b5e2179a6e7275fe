"""Seeded mutants of the shipped CUDA sources: proof that each rule of
the shadow tier fires (the counterpart of the DMA mutants of the
reference's `analysis/semantic_selftest.py`).

Each mutant is a text edit of a source under kernels/csrc/: an anchor
that must occur exactly once in today's text, its replacement, the tier
case it runs (a path of `shadow.BY_PATH`), and the rules it must fire,
no more and no fewer. The production sources carry no trace of them:
`jobs()` writes each edited copy beside the libraries in
kernels/_build/ and builds its shadow variant there (all in one nvcc
batch with the shadow builds, `kernels/build.py`). `run_all` runs every
mutant in a subprocess of its own, all at once, each with a timeout, so
that a kernel that hangs costs its case and not the card; `run_one` is
the subprocess's side.

    python -m repro_torch.analysis.shadow_mutants          # all, on the card
    python -m repro_torch.analysis.shadow_mutants NAME     # one (a subprocess)
    python -m repro_torch.analysis.shadow_mutants --repeat 10
        # the tier and every mutant 10 times: each round's fired rules

The down kernel's dropped wait (`dropped-wait-down`) leaves the copies it
reads unwaited as well as restarted, so it fires read-not-ready and
inflight-at-exit beside restart-without-wait; `restaged-before-wait`
restarts the staging of H before its wait and fires restart-without-wait
alone, the reference's premature slot reuse. `short-expect-tx` arms the
multicast's barrier one row short, `expect-tx-full-stage` with a whole
stage's bytes where the last stage is ragged (B 300: 44 of 64 rows); a
phase that then never completes would leave the next stage's arrive on a
phase whose arrival is spent, which faults the card (CUDA error 719), so
the shadow's expect_tx hook restarts such a barrier after reporting it.
Down's last cluster barrier has two mutants: at the row loop's grid cap
(`dropped-dsmem-reuse-barrier`) the next tile's write races a peer's
read; at an uncapped grid, where the loop turns once,
(`dropped-dsmem-exit-barrier`) the block leaves while a peer reads it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Mutant", "MUTANTS", "FIDELITY_MUTANT", "mutated_text", "jobs",
           "run_one", "run_all", "fidelity_mutant"]

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
_TAG = "shadow-mutant:"

# down's staging of H (gate_up's output), as the source has it
_H_STAGING = (
    "      stage_rows<T, false>(hs, ldk, trows, kw, nn, [&](int i) -> const T* {\n"
    "        return b0 + i < B ? SH_DEP(H + (size_t)(b0 + i) * ldh + n0) "
    ": nullptr;\n"
    "      });\n")


@dataclass(frozen=True)
class Mutant:
    name: str
    source: str          # the source's stem under kernels/csrc/
    anchor: str          # occurs exactly once in the source
    replacement: str
    case: str            # the tier case it runs (shadow.BY_PATH)
    rules: frozenset     # the rules it must fire, exactly
    reference: str       # the reference's mutant and rule of the class


MUTANTS = (
    Mutant("dropped-wait-hidden", "fused_cold_ffn",
           "    cp_async_wait_all();\n    block_sync();\n    if (j < jl) {",
           "    block_sync();\n    if (j < jl) {",
           "shadow/fused_cold_ffn/fp-relu2-kcall-B4-bfloat16",
           frozenset({"shadow-read-not-ready", "shadow-inflight-at-exit"}),
           "mutant_dropped_wait: dma-read-not-ready, dma-inflight-at-exit"),
    Mutant("dropped-barrier-hidden", "fused_cold_ffn",
           "    cp_async_wait_all();\n    block_sync();\n    if (j < jl) {",
           "    cp_async_wait_all();\n    if (j < jl) {",
           "shadow/fused_cold_ffn/fp-relu2-kcall-B4-bfloat16",
           frozenset({"shadow-raw-race"}),
           "none: a TPU grid step is one core"),
    Mutant("dropped-loop-barrier-gate-up", "fused_cold_ffn",
           "    if (b0 != first) block_sync();      // the last tile's red is read\n",
           "",
           "shadow/fused_cold_ffn/fp-cats-kc2-B33-D1100-rowloop-bfloat16",
           frozenset({"shadow-war-race"}),
           "mutant_direct_overwrite: dma-slot-overwrite"),
    Mutant("dropped-wait-down", "cluster_gather_ffn",
           "      cp_async_wait_all();\n      block_sync();\n      const int live_m",
           "      block_sync();\n      const int live_m",
           "shadow/dense_ffn/B4-N4096-bfloat16",
           frozenset({"shadow-restart-without-wait", "shadow-read-not-ready",
                      "shadow-inflight-at-exit"}),
           "mutant_premature_slot_reuse: dma-start-without-wait"),
    Mutant("restaged-before-wait", "cluster_gather_ffn",
           _H_STAGING + "      cp_async_wait_all();\n",
           _H_STAGING + _H_STAGING + "      cp_async_wait_all();\n",
           "shadow/cluster_gather_ffn/B4-bfloat16",
           frozenset({"shadow-restart-without-wait"}),
           "mutant_premature_slot_reuse: dma-start-without-wait"),
    Mutant("wrong-parity", "cluster_gather_ffn",
           "      if (mc) mbar_wait(&xbar, j & 1);\n",
           "      if (mc) mbar_wait(&xbar, (j + 1) & 1);\n",
           "shadow/cluster_gather_ffn/B300-bfloat16",
           frozenset({"shadow-mbarrier"}),
           "mutant_double_wait: dma-double-wait"),
    Mutant("short-expect-tx", "cluster_gather_ffn",
           "mbar_expect_tx(&xbar, (unsigned)(rows * D * sizeof(T)));",
           "mbar_expect_tx(&xbar, (unsigned)((rows - 1) * D * sizeof(T)));",
           "shadow/cluster_gather_ffn/B300-bfloat16",
           frozenset({"shadow-mbarrier"}),
           "mutant_double_wait: dma-double-wait"),
    Mutant("expect-tx-full-stage", "cluster_gather_ffn",
           "mbar_expect_tx(&xbar, (unsigned)(rows * D * sizeof(T)));",
           "mbar_expect_tx(&xbar, (unsigned)(srows * D * sizeof(T)));",
           "shadow/cluster_gather_ffn/B300-bfloat16",
           frozenset({"shadow-mbarrier"}),
           "mutant_double_wait: dma-double-wait"),
    Mutant("dropped-dsmem-barrier", "cluster_gather_ffn",
           "(q & 1)]) = acc[m][t][q];\n    }\n    cluster_sync();\n",
           "(q & 1)]) = acc[m][t][q];\n    }\n",
           "shadow/cluster_gather_ffn/B300-bfloat16",
           frozenset({"shadow-dsmem-race"}),
           "none: no TPU analogue"),
    Mutant("dropped-dsmem-reuse-barrier", "cluster_gather_ffn",
           "    cluster_sync();  // every block's tile is read before it is "
           "rewritten\n",
           "",
           "shadow/cluster_gather_ffn/B300-rowloop-bfloat16",
           frozenset({"shadow-dsmem-race"}),
           "none: no TPU analogue"),
    Mutant("dropped-dsmem-exit-barrier", "cluster_gather_ffn",
           "    cluster_sync();  // every block's tile is read before it is "
           "rewritten\n",
           "",
           "shadow/cluster_gather_ffn/B300-bfloat16",
           frozenset({"shadow-dsmem-race"}),
           "none: no TPU analogue"),
    Mutant("griddep-wait-after-staging", "cluster_gather_ffn",
           "      griddep_wait();  // H is gate_up's\n" + _H_STAGING,
           _H_STAGING + "      griddep_wait();  // H is gate_up's\n",
           "shadow/cluster_gather_ffn/B4-bfloat16",
           frozenset({"shadow-griddep-race"}),
           "none: no TPU analogue"),
)
BY_NAME = {m.name: m for m in MUTANTS}
# the host-side rule's mutant: a perturbed output fed to the comparison
FIDELITY_MUTANT = ("perturbed-output", frozenset({"shadow-fidelity"}),
                   "fidelity-drift: dma-shadow-fidelity")


def mutated_text(m: Mutant) -> str:
    """The source with the mutant's edit; raises unless its anchor occurs
    exactly once."""
    text = (CSRC / f"{m.source}.cu").read_text()
    n = text.count(m.anchor)
    if n != 1:
        raise ValueError(f"mutant {m.name}: its anchor occurs {n} times in "
                         f"{m.source}.cu, not once")
    return text.replace(m.anchor, m.replacement)


def jobs() -> list:
    """The build jobs of every mutant (kernels/build.py)."""
    from repro_torch.kernels import build
    return [build.Job(m.source, m.name, mutated_text(m)) for m in MUTANTS]


def fidelity_mutant() -> set:
    """The rules a perturbed output fires in the fidelity comparison."""
    import torch
    from repro_torch.analysis.shadow import fidelity_findings
    y = torch.arange(8, dtype=torch.float32, device="cuda")
    bad = y.clone()
    bad[3] = torch.nextafter(bad[3], torch.tensor(1e9, device="cuda"))
    return {f.rule for f in fidelity_findings("shadow/mutant/perturbed",
                                              {"y": bad}, {"y": y})}


def run_one(name: str) -> dict:
    """Mutant `name` through its case (fidelity not held: a mutant's
    outputs are wrong by design): its findings' rules and lines."""
    from repro_torch.analysis import shadow
    m = BY_NAME[name]
    t0 = time.perf_counter()
    res = shadow.run_case(shadow.BY_PATH[m.case], variant=m.name,
                          text=mutated_text(m), check_fidelity=False)
    return {"name": name, "rules": sorted({f.rule for f in res.findings}),
            "findings": [str(f) for f in res.findings],
            "seconds": time.perf_counter() - t0}


def run_all(timeout: float = 120.0) -> list:
    """Every mutant in a subprocess of its own, all started
    together: one dict each (run_one's, or "error" with the tail of its
    output when it failed or ran past `timeout`), plus "want" and "ok"
    (fired exactly its rules)."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for name in BY_NAME:
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis.shadow_mutants",
             name], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
    t_end = time.perf_counter() + timeout
    out = []
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(
                timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(killed after {timeout:.0f} s)"
        res = None
        for line in text.splitlines():
            if line.startswith(_TAG):
                res = json.loads(line[len(_TAG):])
        if res is None or proc.returncode != 0:
            res = {"name": name, "rules": [], "findings": [],
                   "error": "\n".join(text.splitlines()[-20:])}
        want = BY_NAME[name].rules
        res["want"] = sorted(want)
        res["ok"] = "error" not in res and set(res["rules"]) == want
        out.append(res)
    return out


def _repeat(rounds: int) -> int:
    """The tier and every mutant `rounds` times over: one JSON line a
    round (each case's findings, each mutant's fired rules), then how many
    rounds each mutant fired exactly its rules."""
    from repro_torch.analysis import shadow
    exact = {name: 0 for name in BY_NAME}
    clean = 0
    for i in range(rounds):
        t0 = time.perf_counter()
        tier = shadow.run_tier()
        mutants = run_all()
        dirty = {r.case.path: sorted({f.rule for f in r.findings})
                 for r in tier if r.findings}
        clean += not dirty
        for r in mutants:
            exact[r["name"]] += r["ok"]
        print(json.dumps({"round": i, "tier_dirty": dirty,
                          "fired": {r["name"]: r["rules"] for r in mutants},
                          "errors": [r["name"] for r in mutants
                                     if "error" in r],
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"rounds": rounds, "tier_clean": clean,
                      "exact": exact}))
    return 0 if clean == rounds and min(exact.values()) == rounds else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] != "--repeat":
        print(_TAG + json.dumps(run_one(argv[0])))
        return 0
    from repro_torch.kernels import build
    build.start([build.Job(n, "shadow") for n in build.SOURCES]
                + jobs()).wait()
    if argv:
        return _repeat(int(argv[1]))
    bad = 0
    for r in run_all():
        print(f"{r['name']}: {'ok' if r['ok'] else 'FAILED'} fired "
              f"{r['rules']}, wants {r['want']} (reference: "
              f"{BY_NAME[r['name']].reference})")
        if "error" in r:
            print(r["error"])
        bad += not r["ok"]
    rules = fidelity_mutant()
    print(f"{FIDELITY_MUTANT[0]}: fired {sorted(rules)}")
    bad += rules != FIDELITY_MUTANT[1]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
