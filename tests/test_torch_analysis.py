"""The port's analysis gate (`repro_torch.analysis`) on the CPU.

* Every static rule fires on its seeded fixture (analysis/selftest/) and
  the clean fixtures stay clean; mutations of the real CUDA
  sources and of the decode step (a barrier, a launch check, a cluster
  sync, an mbarrier wait removed; a host read added) fire their rule.
* The gate is clean over the tree with the committed allowlist, the
  CLI's --self-test exits 0, an unreadable allowlist exits 2, a stale
  entry fails until --update prunes it.
* Every dispatch rule visible on the CPU fires on its seeded entry; every
  one-rank entry of analysis/entries.py runs clean. The two-rank entries
  run in chip_smoke.py's phase analyze and in `--tier all`, not here: one
  of them alone takes 7-8 s on gloo ranks on the CPU.
* The smem-budget rule's static estimates equal the ptxas figures of the
  H100 (NVIDIA H100 80GB HBM3, 700 W; -Xptxas -v of both sources, kept
  below), and the ptxas parser reads that report.
* The sanitizer's report parser on text captured from the card's real
  runs: compute-sanitizer 2025.2.1 answers "Device not supported" there,
  before any kernel runs; the parser reports that as blocked and finds
  nothing. Any other early end (the program stopped before its first
  CUDA call, no process to attach to, a driver that failed) is an error,
  never blocked. Hazard lines in the tool's documented formats (not
  captured: no tool ran on the card) become findings.
"""
import json

import pytest

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import dispatch_selftest, static_selftest
from repro_torch.analysis.dispatch_rules import run_entry
from repro_torch.analysis.entries import entries
from repro_torch.analysis.framework import (
    CAPTURE_ROOTS, AnalysisConfig, SourceFile, analyze_files, analyze_paths,
    load_json, strip_c_comments)
from repro_torch.analysis.kernel_hygiene import (
    CudaFile, parse_ptxas, ptxas_findings, static_smem)
from repro_torch.analysis.sanitizer import DONE, parse_report
from repro_torch.analysis.trace_hazards import HostSyncChecker

ROOT = cli.REPO
CSRC = f"{ROOT}/src/repro_torch/kernels/csrc"


@pytest.fixture(scope="module")
def fixture_findings():
    by_file = {}
    for f in analyze_files(static_selftest.load_fixtures(),
                           static_selftest.fixture_config()):
        by_file.setdefault(f.path, []).append(f)
    return by_file


# ------------------------------------------------------------ static tier ----

@pytest.mark.parametrize("rule", sorted(static_selftest.EXPECTED))
def test_static_rule_fires_on_its_fixture(fixture_findings, rule):
    want = static_selftest.EXPECTED[rule]
    assert any(f.rule == rule
               for f in fixture_findings.get(f"selftest/{want}", []))


@pytest.mark.parametrize("fname", static_selftest.CLEAN)
def test_clean_fixture_stays_clean(fixture_findings, fname):
    assert fixture_findings.get(f"selftest/{fname}", []) == []


def test_every_rule_has_a_fixture():
    from repro_torch.analysis.framework import all_rules
    assert set(all_rules()) == set(static_selftest.EXPECTED)


def test_syntax_error_is_a_finding(fixture_findings):
    assert [f.rule for f in fixture_findings["selftest/broken_syntax.py"]] \
        == ["syntax-error"]


def test_gate_is_clean_over_the_tree():
    allow = load_json(cli.DEFAULT_ALLOWLIST)
    static_keys = {k for k in allow if not k.startswith("dispatch/")}
    findings = analyze_paths(ROOT)
    assert {f.key for f in findings} == static_keys, [str(f) for f in findings]


def test_capture_roots_resolve():
    """Every host-sync root names a function of the tree (a drifted root
    is itself a finding, which the clean gate above rules out too)."""
    files = {p: open(f"{ROOT}/{p}").read()
             for p in {r.split("::")[0] for r in CAPTURE_ROOTS}}
    from repro_torch.analysis.trace_hazards import _Index
    index = _Index({p: SourceFile(p, t) for p, t in files.items()})
    keys, missing = index.roots(CAPTURE_ROOTS)
    assert not missing and len(keys) >= len(CAPTURE_ROOTS)


# mutations of the real sources, each of which its rule must catch
CU_MUTATIONS = [
    ("fused_cold_ffn.cu", "    cp_async_wait_all();\n    block_sync();\n",
     "    cp_async_wait_all();\n", "async-copy-pairing"),
    ("fused_cold_ffn.cu",
     "                                                         D, r);\n"
     "  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;\n",
     "                                                         D, r);\n",
     "launch-check"),
    ("cluster_gather_ffn.cu",
     "      SH_WR(&xs[(size_t)(u / padc) * ld + D + u % padc]) = "
     "from_f<T>(0.0f);\n    cluster_sync();\n",
     "      SH_WR(&xs[(size_t)(u / padc) * ld + D + u % padc]) = "
     "from_f<T>(0.0f);\n", "mbarrier-init"),
    ("cluster_gather_ffn.cu", "      if (mc) mbar_wait(&xbar, j & 1);\n", "",
     "async-copy-pairing"),
]


@pytest.mark.parametrize("fname,old,new,rule", CU_MUTATIONS,
                         ids=[f"{m[0]}-{m[3]}-{i}"
                              for i, m in enumerate(CU_MUTATIONS)])
def test_rule_catches_a_mutated_source(fname, old, new, rule):
    text = open(f"{CSRC}/{fname}").read()
    assert text.count(old) == 1
    path = f"src/repro_torch/kernels/csrc/{fname}"
    assert analyze_files({path: text}) == []
    got = analyze_files({path: text.replace(old, new)})
    assert rule in {f.rule for f in got}, [str(f) for f in got]


def test_host_sync_catches_a_read_in_the_decode_step():
    path = "src/repro_torch/models/dense.py"
    text = open(f"{ROOT}/{path}").read()
    old = "    cache[\"length\"].add_(1)"
    assert text.count(old) == 1
    bad = text.replace(old, "    n_live = int(cache[\"length\"].max())\n"
                            + old)
    found = HostSyncChecker().check_repo({path: SourceFile(path, bad)},
                                         AnalysisConfig())
    assert [f.rule for f in found] == ["host-sync"], found


# ------------------------------------------------------------------- CLI ----

def test_cli_self_test_exits_0(capsys):
    assert cli.main(["--self-test", "--tier", "all"]) == 0
    assert "OK: every rule fires" in capsys.readouterr().out


def test_cli_unreadable_allowlist_exits_2(tmp_path):
    bad = tmp_path / "allow.json"
    bad.write_text("{not json")
    assert cli.main(["--allowlist", str(bad), "src/repro_torch/kernels"]) \
        == 2


def test_stale_entry_fails_until_update_prunes(tmp_path, capsys):
    path = "src/repro_torch/kernels/registry.py"
    allow = tmp_path / "allow.json"
    allow.write_text(json.dumps({f"{path}:wall-clock": "a fixed finding",
                                 "dispatch/cpu/decode/x:dispatch-f64":
                                     "another tier's"}))
    assert cli.main(["--allowlist", str(allow), path]) == 1
    assert "stale allowlist entry" in capsys.readouterr().out
    assert cli.main(["--allowlist", str(allow), "--update", path]) == 0
    # the static tier's stale key is gone, the dispatch tier's kept
    assert set(json.loads(allow.read_text())) == \
        {"dispatch/cpu/decode/x:dispatch-f64"}
    assert cli.main(["--allowlist", str(allow), path]) == 0


def test_allowlist_holds_no_graphed_entry():
    """A graphed step may not be allowlisted: a host read there is a
    value a CUDA graph would replay forever."""
    graphed = {e.path(d) for e in entries() if e.graphed
               for d in ("cpu", "cuda")}
    allow = load_json(cli.DEFAULT_ALLOWLIST)
    assert not [k for k in allow if k.rsplit(":", 1)[0] in graphed]


# --------------------------------------------------------- dispatch tier ----

@pytest.mark.parametrize("rule", [
    r for r, name in dispatch_selftest.EXPECTED.items()
    if name not in dispatch_selftest.CARD_ONLY])
def test_dispatch_rule_fires_on_its_entry(rule):
    name = dispatch_selftest.EXPECTED[rule]
    entry = next(e for e in dispatch_selftest.fixture_entries()
                 if e.name == name)
    assert rule in {f.rule for f in run_entry(entry)}


def test_dispatch_clean_entry_stays_clean():
    entry = next(e for e in dispatch_selftest.fixture_entries()
                 if e.name == "selftest/clean")
    assert run_entry(entry) == []


@pytest.mark.parametrize("name", [e.name for e in entries(1)])
def test_dispatch_entry_on_one_rank(name):
    entry = next(e for e in entries(1) if e.name == name)
    assert run_entry(entry) == []


# ------------------------------------------------------ ptxas and smem ----

# -Xptxas -v of both sources on the H100 (NVIDIA H100 80GB HBM3, 700 W):
# static smem bytes of every instantiation, by (source, kernel, T)
PTXAS_STATIC_SMEM = {
    ("fused_cold_ffn", "hidden_kernel", "float"): 20480,
    ("fused_cold_ffn", "hidden_kernel", "__nv_bfloat16"): 10240,
    ("fused_cold_ffn", "score_kernel", "float"): 0,
    ("fused_cold_ffn", "score_kernel", "__nv_bfloat16"): 0,
    ("fused_cold_ffn", "gate_up_kernel", "float"): 192,
    ("fused_cold_ffn", "gate_up_kernel", "__nv_bfloat16"): 192,
    ("fused_cold_ffn", "down_kernel", "float"): 22528,
    ("fused_cold_ffn", "down_kernel", "__nv_bfloat16"): 36864,
    ("cluster_gather_ffn", "gather_gate_up_kernel", "float"): 16,
    ("cluster_gather_ffn", "gather_gate_up_kernel", "__nv_bfloat16"): 16,
    ("cluster_gather_ffn", "gather_down_kernel", "float"): 0,
    ("cluster_gather_ffn", "gather_down_kernel", "__nv_bfloat16"): 0,
}


@pytest.mark.parametrize("key", sorted(PTXAS_STATIC_SMEM),
                         ids=lambda k: "-".join(k))
def test_smem_estimate_equals_ptxas(key):
    src, kernel, t = key
    cf = CudaFile.parse(strip_c_comments(open(f"{CSRC}/{src}.cu").read()))
    assert static_smem(cf)[kernel, t] == PTXAS_STATIC_SMEM[key]


# verbatim lines of the H100 build's report (gather_gate_up_kernel<float,
# NT=2> and gather_down_kernel<float>)
PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__4c3423ab_21_cluster_gather_ffn_cu_4785230518gather_down_kernelIfEEvPKT_iS3_PKiPS1_iiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__4c3423ab_21_cluster_gather_ffn_cu_4785230518gather_down_kernelIfEEvPKT_iS3_PKiPS1_iiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__4c3423ab_21_cluster_gather_ffn_cu_4785230521gather_gate_up_kernelIfLi2EEEvPKT_S3_PKiPS1_iiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__4c3423ab_21_cluster_gather_ffn_cu_4785230521gather_gate_up_kernelIfLi2EEEvPKT_S3_PKiPS1_iiiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 16 bytes smem
"""


def test_ptxas_report_parser():
    rows = parse_ptxas(PTXAS_REPORT, ["gather_gate_up_kernel",
                                      "gather_down_kernel"])
    assert [(r["kernel"], r["T"], r["registers"], r["smem"], r["spill"])
            for r in rows] == [("gather_down_kernel", "float", 72, 0, 0),
                               ("gather_gate_up_kernel", "float", 56, 16, 0)]
    path = "src/repro_torch/kernels/csrc/cluster_gather_ffn.cu"
    text = open(f"{ROOT}/{path}").read()
    assert ptxas_findings(path, text, PTXAS_REPORT)[0] == []
    drifted = PTXAS_REPORT.replace("16 bytes smem", "32 bytes smem").replace(
        "0 bytes spill stores", "8 bytes spill stores", 1)
    assert {f.rule for f in ptxas_findings(path, text, drifted)[0]} == \
        {"smem-fidelity", "ptxas-spill"}


# ------------------------------------------------------ sanitizer parser ----

# compute-sanitizer 2025.2.1 on the H100 machine (racecheck over the
# kernels, and memcheck with --print-session-details over a plain CUDA
# program), verbatim but for the backtrace lines
CARD_RACECHECK = """\
========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
Traceback (most recent call last):
torch.AcceleratorError: CUDA error: unknown error

========= Error: process didn't terminate successfully
=========     The application may have hit an error when dereferencing Unified Memory from the host. Please rerun the application under cuda-gdb or a host debugger to catch host side errors.
========= Target application returned an error
========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)
"""
CARD_MEMCHECK = """\
========= COMPUTE-SANITIZER
========= Computer Name:          runsc
========= CUDA version:           13.0
========= Display Driver version: 580.159.03
=========
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on CUDA API call to cudaMalloc.
=========     Saved host backtrace up to driver entry point at error
========= Program hit cudaErrorIllegalAddress (error 700) due to "an illegal memory access was encountered" on CUDA API call to cudaDeviceSynchronize.
========= ERROR SUMMARY: 3 errors
"""


@pytest.mark.parametrize("text,tool", [(CARD_RACECHECK, "racecheck"),
                                       (CARD_MEMCHECK, "memcheck")])
def test_sanitizer_parser_reports_the_card_as_blocked(text, tool):
    rep = parse_report(text, tool, "kernels", rc=1)
    assert rep.blocked.startswith("Device not supported")
    assert rep.findings() == []         # nothing ran: nothing is clean either
    assert rep.summary >= 1
    assert rep.check() is rep           # blocked is reported, not raised


# the tool's other early ends (its documented messages): no kernel ran,
# and the tool did not say the machine is unsupported
EARLY_ENDS = {
    "terminated": "========= COMPUTE-SANITIZER\n========= Error: Target "
                  "application terminated before first instrumented API "
                  "call\n========= ERROR SUMMARY: 0 errors\n",
    "no-process": "========= COMPUTE-SANITIZER\n========= Error: No "
                  "attachable process found. compute-sanitizer timed-out."
                  "\n========= ERROR SUMMARY: 0 errors\n",
    "driver-failed": "========= COMPUTE-SANITIZER\nTraceback (most recent "
                     "call last):\nImportError: the driver failed\n"
                     "========= Target application returned an error\n"
                     "========= RACECHECK SUMMARY: 0 hazards displayed "
                     "(0 errors, 0 warnings)\n",
}


@pytest.mark.parametrize("name", sorted(EARLY_ENDS))
def test_sanitizer_early_end_is_an_error_not_blocked(name):
    rep = parse_report(EARLY_ENDS[name], "racecheck", "fused_cold_ffn", rc=1)
    assert rep.blocked is None and not rep.ran
    with pytest.raises(RuntimeError, match="did not reach its end"):
        rep.check()
    # the same text with exit 0 is still no run: the driver never ended
    with pytest.raises(RuntimeError):
        parse_report(EARLY_ENDS[name], "racecheck", "fused_cold_ffn").check()


def test_sanitizer_run_that_reached_its_end_is_checked():
    clean = f"========= COMPUTE-SANITIZER\n{DONE}\n========= RACECHECK " \
            f"SUMMARY: 0 hazards displayed (0 errors, 0 warnings)\n"
    rep = parse_report(clean, "racecheck", "fused_cold_ffn").check()
    assert rep.ran and rep.blocked is None and rep.findings() == []
    with pytest.raises(RuntimeError, match="exit 1"):
        parse_report(clean, "racecheck", "fused_cold_ffn", rc=1).check()


# the tools' hazard lines in their documented formats (synthetic: no tool
# ran on the card), one per tool
SYNTHETIC = {
    "racecheck": "========= Error: Race reported between Write access at "
                 "staged_sum+0x1c0 in staged.cu:97\n=========     and "
                 "Read access at drop_sync+0x200 in staged.cu:97 "
                 "[512 hazards]\n=========     in drop_sync_kernel\n"
                 "========= RACECHECK SUMMARY: 1 hazard displayed (1 error, "
                 "0 warnings)\n",
    "synccheck": "========= Barrier error detected. Divergent thread(s) in "
                 "block\n=========     at divergent_barrier_kernel+0x90\n"
                 "========= ERROR SUMMARY: 1 error\n",
    "memcheck": "========= Invalid __global__ write of size 4 bytes\n"
                "=========     at oob_write_kernel+0x120\n"
                "========= ERROR SUMMARY: 1 error\n",
    "initcheck": "========= Uninitialized __global__ memory read of size 4 "
                 "bytes\n=========     at uninit_read_kernel+0x80\n"
                 "========= ERROR SUMMARY: 128 errors\n",
}
# the cluster late-entry report of the installed tool's own manual
# (compute-sanitizer 2025.2.1, "Racecheck cluster entry and exit race
# detection"), the kernel renamed
DOC_CLUSTER_RACE = """\
========= Potential invalid __shared__ read of size 4 bytes
=========     at remote_access_kernel(int *, int)+0x170 in RaceCluster.cu:10
=========     by thread (0,0,0) in block (0,0,0)
=========     Address 0x1000400 is located in a block that might not have entered yet
========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)
"""


@pytest.mark.parametrize("tool", sorted(SYNTHETIC))
def test_sanitizer_parser_turns_hazards_into_findings(tool):
    rep = parse_report(SYNTHETIC[tool], tool, "mutant:x")
    assert rep.blocked is None and rep.summary >= 1
    found = rep.findings()
    assert len(found) == 1 and found[0].rule == f"sanitizer-{tool}"
    assert "_kernel" in found[0].message


def test_sanitizer_parser_reads_the_manuals_cluster_race():
    rep = parse_report(DOC_CLUSTER_RACE, "racecheck", "kernels")
    assert [f.rule for f in rep.findings()] == ["sanitizer-racecheck"]
    assert "remote_access_kernel" in rep.findings()[0].message
