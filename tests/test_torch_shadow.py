"""The shadow tier's CPU side (analysis/shadow.py, analysis/
shadow_mutants.py, kernels/csrc/shadow.cuh, kernels/build.py's variants).
The tier itself runs on the card (tests/test_torch_gpu.py, chip_smoke.py's
phase analyze); here: the log decoder, the mutants' anchors, the plan the
gathered FFN's cases reach, the header's normal build, and the nvcc
commands. No nvcc, no card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import shadow, shadow_mutants
from repro_torch.analysis.shadow import (
    CASES, KERNELS, LOG_CAPACITY, REFERENCE_RULES, SHADOW_RULES,
    ShadowOverflow, decode_log, log_words)
from repro_torch.kernels import build, registry
from repro_torch.kernels.ops import gather_plan

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
HEADER = (CSRC / "shadow.cuh").read_text()


def _log(records, capacity=8, overflow=0):
    """int32 words of a log holding `records` (rule, kernel, line, block,
    thread, unit, count) at scattered slots."""
    w = np.zeros(log_words(capacity), dtype=np.int32)
    w[0], w[1] = capacity, overflow
    for i, (rule, kid, line, block, thread, unit, count) in enumerate(records):
        key = line << 16 | kid << 8 | rule
        slot = 4 + 6 * (2 * i + 1)
        w[slot:slot + 6] = np.array(
            [key & 0xFFFFFFFF, key >> 32, block, thread, unit, count],
            dtype=np.uint32).view(np.int32)
    return w


def test_decoder_names_rule_kernel_and_line():
    w = _log([(3, 0, 222, 5, 17, 40, 9), (6, 4, 353, 2, 0, 1000, 1),
              (8, 5, 505, 1, 3, 0, 2)])
    fs = decode_log(w, "shadow/entry/case")
    assert [(f.rule, f.line) for f in fs] == [
        ("shadow-raw-race", 222), ("shadow-mbarrier", 353),
        ("shadow-griddep-race", 505)]
    assert all(f.path == "shadow/entry/case" for f in fs)
    assert "hidden_kernel (fused_cold_ffn.cu:222)" in fs[0].message
    assert "block 5, thread 17, shared byte 80, 9 time(s)" in fs[0].message
    assert fs[1].message.startswith("gather_gate_up_kernel "
                                    "(cluster_gather_ffn.cu:353)")


@pytest.mark.parametrize("rule", range(1, 10))
def test_decoder_knows_every_device_rule(rule):
    fs = decode_log(_log([(rule, 1, 10, 0, 0, 0, 1)]), "p")
    assert [f.rule for f in fs] == [SHADOW_RULES[rule - 1]]


def test_empty_log_is_clean_and_full_log_raises():
    assert decode_log(_log([]), "p") == []
    with pytest.raises(ShadowOverflow, match="overflowed"):
        decode_log(_log([(3, 0, 1, 0, 0, 0, 1)], overflow=2), "p")
    assert log_words() == 4 + 6 * LOG_CAPACITY


def test_rule_and_kernel_tables_match_the_header():
    rules = re.findall(r"^  k(\w+) = (\d+),?$", HEADER.split(
        "enum Rule")[1].split("};")[0], re.M)
    assert [int(n) for _, n in rules] == list(range(1, len(rules) + 1))
    assert len(rules) == len(SHADOW_RULES) - 1     # fidelity is host-side
    kernels = re.findall(r"kSh(\w+) = (\d+)", HEADER)
    assert [int(n) for _, n in kernels] == list(range(len(KERNELS) + 1))
    for (name, source), (tag, _) in zip(KERNELS, kernels):
        text = (CSRC / source).read_text()
        # each kernel opens with SHADOW_BEGIN(kSh<tag>) in its source
        body = text[re.search(rf"^{name}\(", text, re.M).start():]
        assert re.search(rf"SHADOW_BEGIN\(kSh{tag}\)", body[:2000]), name


@pytest.mark.parametrize("m", shadow_mutants.MUTANTS, ids=lambda m: m.name)
def test_mutant_anchor_occurs_once_and_changes_the_source(m):
    text = (CSRC / f"{m.source}.cu").read_text()
    assert text.count(m.anchor) == 1, m.name
    assert m.replacement != m.anchor
    mutated = shadow_mutants.mutated_text(m)
    assert mutated != text and "MUTANT" not in text
    assert m.case in shadow.BY_PATH
    assert shadow.BY_PATH[m.case].source == m.source
    assert m.rules and m.rules <= set(SHADOW_RULES)


def test_down_exit_barrier_is_dropped_at_a_capped_and_an_uncapped_grid():
    """Down's last cluster barrier guards the next row tile's rewrite of
    red only where the row loop turns twice (the grid cap); at an
    uncapped grid it guards the block's exit while its peers still read
    red. One mutant drops it at each."""
    anchor = "cluster_sync();  // every block's tile is read before it is"
    caps = sorted(shadow.BY_PATH[m.case].grid_cap
                  for m in shadow_mutants.MUTANTS if anchor in m.anchor)
    assert caps == [0, 2]
    for m in shadow_mutants.MUTANTS:
        if anchor in m.anchor:
            assert m.rules == {"shadow-dsmem-race"}
            assert shadow.BY_PATH[m.case].source == "cluster_gather_ffn"


def test_mutant_with_a_missing_anchor_raises():
    m = shadow_mutants.MUTANTS[0]
    bad = shadow_mutants.Mutant(m.name, m.source, "no such text", "",
                                m.case, m.rules, m.reference)
    with pytest.raises(ValueError, match="occurs 0 times"):
        shadow_mutants.mutated_text(bad)


def test_every_reference_class_has_a_port_rule_a_mutant_fires():
    from repro.analysis.dma_sanitizer import DMA_RULES
    fired = set().union(*(m.rules for m in shadow_mutants.MUTANTS),
                        shadow_mutants.FIDELITY_MUTANT[1])
    assert set(REFERENCE_RULES) == set(DMA_RULES)
    for ref, port in REFERENCE_RULES.items():
        assert port in fired, (ref, port)
    # every device rule but capacity (a bound of the shadow itself) is
    # proven by a mutant
    assert set(SHADOW_RULES) - fired == {"shadow-capacity"}


def test_cases_cover_every_registry_entry_and_path():
    entries = {c.entry for c in CASES}
    assert entries == {k.name for k in registry.KERNELS}
    assert {c.dtype for c in CASES} == {"float32", "bfloat16"}
    names = " ".join(c.path for c in CASES)
    for part in ("int8", "mixed", "cats", "relu2", "kc1", "kcall", "B1-",
                 "B4-", "B33", "offset", "rowloop", "B300", "D203", "N4096"):
        assert part in names, part
    assert {c.source for c in CASES if c.grid_cap} == set(build.SOURCES)
    assert len({c.path for c in CASES}) == len(CASES)


@pytest.mark.parametrize("es", [2, 4])
def test_gather_plan_of_the_b300_case_reaches_every_path(es):
    """B 300, D 576, the tier's K and R: the multicast (bf16; fp32's rows
    do not fit one chunk, so the kernel stages x itself), at least two
    gate_up stages in a row group (xbar's parity 1) and down's split
    reduction through distributed shared memory."""
    c = shadow.PLAN_CASE
    p = gather_plan(c["B"], c["D"], c["K"], c["R"], es)
    n_stages = -(-c["B"] // (16 * p.m_tiles))
    assert -(-n_stages // p.gate_groups) >= 2
    assert p.splits > 1
    if es == 2:
        assert p.x_cluster == 4 and p.chunk >= c["D"]
    b300 = shadow.BY_PATH["shadow/cluster_gather_ffn/B300-bfloat16"]
    assert b300.grid_cap == 0


def test_dense_n4096_case_turns_the_down_loop_twice():
    for es in (2, 4):
        p = gather_plan(4, 576, 4096, 3, es)
        assert p.split > p.down_chunk, es


def _macros(block: str) -> dict:
    out = {}
    for m in re.finditer(r"^#define (\w+)(\([^)]*\))?(.*(?:\\\n.*)*)$", block,
                         re.M):
        out[m.group(1)] = (m.group(2) or "", m.group(3).replace("\\\n", " ")
                           .strip())
    return out


def test_every_hook_is_empty_or_the_plain_access_outside_the_shadow():
    normal = HEADER.split("#ifndef REPRO_SHADOW")[1].split("#else")[0]
    shadowed = HEADER.split("#else  // REPRO_SHADOW")[1]
    plain, hooked = _macros(normal), _macros(shadowed)
    assert set(plain) == set(hooked)
    allowed = {"SH_RD": "(*(p))", "SH_WR": "(*(p))",
               "SH_RD_PEER": "(*(remote))", "SH_DEP": "(p)",
               "SHADOW_GRID_CAP": "(cap)"}
    for name, (params, body) in plain.items():
        assert params == hooked[name][0], name
        assert body in ("((void)0)", "", allowed.get(name)), (name, body)
        assert body == allowed.get(name, body), name
    # nothing else the header declares reaches the normal build
    assert not re.search(r"__device__|__shared__|__global__|\bstatic\b",
                         normal)


def test_build_names_the_shadow_variant_and_keeps_the_normal_flags():
    assert build.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    for name in build.SOURCES:
        normal, shade = build.Job(name), build.Job(name, "shadow")
        cmd = build.command(normal, Path("/o.so"))
        assert cmd == ["nvcc", *build.NVCC_FLAGS, "-o", "/o.so",
                       str(build.CSRC / f"{name}.cu")]
        scmd = build.command(shade, Path("/s.so"))
        assert scmd[:1 + len(build.NVCC_FLAGS)] == cmd[:1 + len(
            build.NVCC_FLAGS)]
        assert scmd[1 + len(build.NVCC_FLAGS):-3] == ["-DREPRO_SHADOW",
                                                      "-lineinfo"]
        assert build.lib_path(shade).name.startswith(f"lib{name}-shadow-")
        assert build.lib_path(normal).name.startswith(f"lib{name}-")
        assert "-shadow-" not in build.lib_path(normal).name
        assert build.lib_path(normal).parent == build.BUILD_DIR


def test_mutant_builds_a_copy_with_the_header_on_its_path():
    m = shadow_mutants.MUTANTS[0]
    job = shadow_mutants.jobs()[0]
    assert job.variant == m.name and job.text is not None
    cmd = build.command(job, Path("/m.so"))
    assert cmd[-1] == str(build.lib_path(job).with_suffix(".cu"))
    assert build.lib_path(job).parent == build.BUILD_DIR
    assert ["-I", str(build.CSRC)] == cmd[-5:-3]
    assert "-DREPRO_SHADOW" in cmd
    # the shipped source is never the file a mutant compiles
    assert not cmd[-1].startswith(str(build.CSRC))


def test_using_switches_the_library_the_wrappers_load():
    seen = []
    real = build._load
    build._load = lambda name, variant, text: seen.append((name, variant))
    try:
        build.library("fused_cold_ffn")
        with build.using("shadow"):
            build.library("fused_cold_ffn")
            with build.using("m", ("cluster_gather_ffn",), "text"):
                build.library("cluster_gather_ffn")
                build.library("fused_cold_ffn")
        build.library("cluster_gather_ffn")
    finally:
        build._load = real
    assert seen == [("fused_cold_ffn", "normal"), ("fused_cold_ffn", "shadow"),
                    ("cluster_gather_ffn", "m"), ("fused_cold_ffn", "shadow"),
                    ("cluster_gather_ffn", "normal")]


def test_tier_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests run the tier")
    with pytest.raises(RuntimeError, match="CUDA card"):
        shadow.run_tier()


def test_fidelity_comparator_reports_any_bit():
    import torch
    y = torch.linspace(-1, 1, 16)
    ids = torch.arange(4, dtype=torch.int32)
    assert shadow.fidelity_findings("p", {"y": y.clone(), "idx": ids.clone()},
                                    {"y": y, "idx": ids}) == []
    bad = y.clone()
    bad[5] = torch.nextafter(bad[5], torch.tensor(2.0))
    fs = shadow.fidelity_findings("p", {"y": bad, "idx": ids}, {"y": y,
                                                                "idx": ids})
    assert [f.rule for f in fs] == ["shadow-fidelity"]
    fs = shadow.fidelity_findings("p", {"y": y, "idx": ids + 1},
                                  {"y": y, "idx": ids})
    assert [f.rule for f in fs] == ["shadow-fidelity"]


# two builds of one kernel as cuobjdump -sass prints them: other
# addresses and another anonymous-namespace tag, the same code
_SASS = """
	code for sm_90a
		Function : _ZN54_GLOBAL__N__{tag}_21_cluster_gather_ffn_cu_{h}18gather_down_kernelIfEEvPKT_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*{a0}*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
        /*{a1}*/                   S2R R0, SR_TID.X ;          /* 0x0000000000007919 */

        /*{a2}*/                   EXIT ;                      /* 0x000000000000794d */
"""


def test_sass_normalize_drops_addresses_and_the_namespace_tag():
    from repro_torch.analysis.sass import normalize
    a = normalize(_SASS.format(tag="4c3423ab", h="b1198ba9", a0="0000",
                               a1="0010", a2="0020"))
    b = normalize(_SASS.format(tag="9f00aa11", h="0c0ffee0", a0="1000",
                               a1="1010", a2="1020"))
    assert a == b and len(a) == 1
    (name, lines), = a.items()
    assert "_GLOBAL__N_18gather_down_kernel" in name
    assert [x.split()[0] for x in lines[1:]] == ["LDC", "S2R", "EXIT"]
    c = normalize(_SASS.format(tag="4c3423ab", h="b1198ba9", a0="0000",
                               a1="0010", a2="0020").replace("SR_TID.X",
                                                             "SR_TID.Y"))
    assert c != a
