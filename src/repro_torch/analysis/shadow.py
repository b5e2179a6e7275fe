"""The shadow tier: every kernel of kernels/registry.py run through the
shadow build of its CUDA source, on the card.

The port's counterpart of `repro/analysis/dma_sanitizer.py`. The
reference reran the shipped Pallas kernel body with its copies swapped
for shadow objects that tracked each VMEM slot; here the shadow is a
second build of the shipped `.cu` sources (`kernels/build.py`'s "shadow"
variant, `-DREPRO_SHADOW -lineinfo`), in which every hook of
`kernels/csrc/shadow.cuh` records each shared-memory stage, cp.async,
mbarrier, cluster barrier and programmatic-dependent-launch edge of the
six kernels into a table in device memory, and logs what breaks the
rules below. `run_tier` runs each registry entry at the small shapes of
`CASES` (chosen to reach every path: fp32 and bf16; fused_cold_ffn at
fp, int8 and int4-mixed, CATS and relu2, kc 1 and kc = nc_g, B 1 / 4 /
33, x and Bp at odd column offsets, D past one gate_up chunk; the
gathered FFN at B 4 and 300 with D 576, where gather_plan gives the
multicast, two gate_up stages per row group and split reductions through
distributed shared memory, D 203, a down loop over two neuron chunks;
the grouped form), decodes the log into Findings (path
`shadow/<entry>/<case>`, line the `.cu` line), and holds the shadow
build's outputs against the normal build's on the same inputs
(shadow-fidelity: ids and y bit-identical). One case per source runs
with the row-tile grid capped at 2 (`<name>_shadow_grid_cap`), so that
the row loops that only B past 65,535 row tiles reach in serving run at
small B. `analysis/shadow_mutants.py` proves each rule fires.

    python -m repro_torch.analysis.shadow       # the tier on the card

Needs a card: without one `run_tier` raises. Nothing here imports jax
or the JAX package.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.analysis.framework import Finding

__all__ = ["SHADOW_RULES", "REFERENCE_RULES", "KERNELS", "CASES", "Case",
           "CaseResult", "ShadowOverflow", "decode_log", "fidelity_findings",
           "log_words", "run_case", "run_tier"]

# the rules in the log's order (shadow.cuh's Rule, from 1), then the
# host-side fidelity rule
SHADOW_RULES = ("shadow-read-not-ready", "shadow-inflight-at-exit",
                "shadow-raw-race", "shadow-war-race",
                "shadow-restart-without-wait", "shadow-mbarrier",
                "shadow-dsmem-race", "shadow-griddep-race",
                "shadow-capacity", "shadow-fidelity")
# each class of the reference's DMA_RULES, and the port rule a mutant of
# analysis/shadow_mutants.py proves for it
REFERENCE_RULES = {
    "dma-start-without-wait": "shadow-restart-without-wait",
    "dma-double-wait": "shadow-mbarrier",
    "dma-slot-overwrite": "shadow-war-race",
    "dma-read-not-ready": "shadow-read-not-ready",
    "dma-inflight-at-exit": "shadow-inflight-at-exit",
    "dma-shadow-fidelity": "shadow-fidelity",
}
# shadow.cuh's ShadowKernel order: (kernel, source)
KERNELS = (("hidden_kernel", "fused_cold_ffn.cu"),
           ("score_kernel", "fused_cold_ffn.cu"),
           ("gate_up_kernel", "fused_cold_ffn.cu"),
           ("down_kernel", "fused_cold_ffn.cu"),
           ("gather_gate_up_kernel", "cluster_gather_ffn.cu"),
           ("gather_down_kernel", "cluster_gather_ffn.cu"))
LOG_CAPACITY = 1024          # distinct (rule, kernel, line) records
_HEADER = 4                  # int32 words: capacity, overflow, 2 spare
_RECORD = 6                  # int32 words: key (2), block, thread, unit, count


class ShadowOverflow(RuntimeError):
    """The log filled up: findings were lost, so the run proves nothing."""


def log_words(capacity: int = LOG_CAPACITY) -> int:
    """int32 words of a log of `capacity` records."""
    return _HEADER + _RECORD * capacity


def decode_log(words, path: str) -> list:
    """A log (int32 words, as the card left them) -> Findings sorted by
    (line, rule). Raises ShadowOverflow when records were dropped."""
    w = np.asarray(words, dtype=np.int32)
    cap, overflow = int(w[0]), int(w[1])
    if overflow:
        raise ShadowOverflow(f"{path}: the shadow log overflowed ({overflow} "
                             f"record(s) dropped past {cap}); findings are "
                             f"incomplete")
    recs = w[_HEADER:_HEADER + _RECORD * cap].reshape(cap, _RECORD)
    out = []
    for rec in recs:
        key = int(rec[0].view(np.uint32)) | int(rec[1].view(np.uint32)) << 32
        if key == 0:
            continue
        rule, kid, line = key & 0xFF, key >> 8 & 0xFF, key >> 16
        block, thread, unit, count = (int(v) for v in rec[2:].view(np.uint32))
        name = SHADOW_RULES[rule - 1] if 1 <= rule < len(SHADOW_RULES) \
            else f"shadow-rule-{rule}"
        kernel, source = KERNELS[kid] if kid < len(KERNELS) else (f"kernel {kid}", "?")
        out.append(Finding(name, path, line,
                           f"{kernel} ({source}:{line}): block {block}, "
                           f"thread {thread}, shared byte {2 * unit}, "
                           f"{count} time(s)"))
    return sorted(out, key=lambda f: (f.line, f.rule))


def fidelity_findings(path: str, got: dict, want: dict) -> list:
    """The shadow build's outputs `got` against the normal build's `want`
    (name -> tensor): every output bit-identical, else shadow-fidelity."""
    import torch
    out = []
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            diff = (g.float() - w.float()).abs().max().item() \
                if g.shape == w.shape else float("nan")
            out.append(Finding("shadow-fidelity", path, 1,
                               f"{name}: the shadow build's output differs "
                               f"from the normal build's (max |diff| "
                               f"{diff:.3g}): the hooks changed what the "
                               f"kernel computes"))
    return out


@dataclass(frozen=True)
class Case:
    """One call of a registry entry: `make(dtype)` builds its inputs on
    the card and returns a function that calls the wrapper and returns its
    outputs by name. `grid_cap` caps the row tiles of the grid (0: the
    normal cap)."""
    entry: str
    name: str
    dtype: str
    make: object
    grid_cap: int = 0
    source: str = "fused_cold_ffn"

    @property
    def path(self) -> str:
        return f"shadow/{self.entry}/{self.name}-{self.dtype}"


@dataclass
class CaseResult:
    case: Case
    findings: list = field(default_factory=list)
    seconds: float = 0.0


def _t(rng, shape, scale, device, dtype, offset=0):
    """A seeded normal tensor; `offset` > 0 puts its data `offset`
    elements past an allocation's start (an odd offset misaligns it)."""
    import torch
    a = torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(device, dtype)
    if not offset:
        return a
    buf = torch.empty(a.numel() + offset, dtype=dtype, device=device)
    out = buf[offset:].view(shape)
    out.copy_(a)
    return out


def _fused(B, D, r, cs, G, nc_g, R, kc, act, mode, quant=None, x_offset=0,
           bp_offset=0, seed=0):
    def make(dtype):
        device = "cuda"
        import torch
        from repro_torch.kernels import ops
        from repro_torch.quant.storage import quantize_bundles
        rng = np.random.default_rng(seed)
        dt = getattr(torch, dtype)
        x = _t(rng, (B, D), 0.5, device, dt, x_offset)
        wc = _t(rng, (G, nc_g, cs, R, D), 0.1, device, dt)
        A = _t(rng, (D, r), D ** -0.5, device, dt)
        Nc = G * nc_g * cs
        Bp = _t(rng, (r, Nc + bp_offset), r ** -0.5, device, dt)[:, bp_offset:]
        q = {} if quant is None else quantize_bundles(wc, quant)
        mask = torch.ones(B, dtype=torch.bool, device=device)
        if B > 2:
            mask[B // 2] = False

        def call():
            y, idx = ops.fused_cold_ffn(x, wc, A, Bp, activation=act,
                                        mode=mode, kc=kc, active_mask=mask,
                                        **q)
            return {"y": y, "idx": idx}
        return call
    return make


def _gather(B, D, N, R, cs, n_ids, act, seed=0, dense=False, grouped=None):
    def make(dtype):
        device = "cuda"
        import torch
        from repro_torch.kernels import ops
        rng = np.random.default_rng(seed)
        dt = getattr(torch, dtype)
        x = _t(rng, (B, D), 0.5, device, dt)
        if grouped is not None:
            G, nc_g, kc = grouped
            wc = _t(rng, (G, nc_g, cs, R, D), 0.1, device, dt)
            cidx = torch.from_numpy(np.stack([
                rng.choice(nc_g, kc, replace=False) for _ in range(G)
            ]).astype(np.int32)).to(device)
            return lambda: {"y": ops.cluster_gather_ffn_grouped(
                x, wc, cidx, activation=act)}
        w = _t(rng, (N, R, D), 0.1, device, dt)
        if dense:
            return lambda: {"y": ops.dense_ffn(x, w, activation=act)}
        ids = torch.from_numpy(rng.choice(N // cs, n_ids, replace=False)
                               .astype(np.int32)).to(device)
        return lambda: {"y": ops.cluster_gather_ffn(
            x, w, ids, activation=act, cluster_size=cs)}
    return make


MAIN_FUSED = dict(D=576, r=64, cs=64, G=1, nc_g=8, R=3)
_FUSED = (
    ("fp-cats-kc1-B1", dict(B=1, kc=1, act="silu", mode="cats"), 0),
    ("fp-relu2-kcall-B4", dict(B=4, D=576, r=64, cs=64, G=2, nc_g=4, R=2,
                               kc=4, act="relu2", mode="relu"), 0),
    ("fp-cats-kc1-B33-offset", dict(B=33, kc=1, act="silu", mode="cats",
                                    x_offset=1, bp_offset=1), 0),
    ("int8-relu2-kc1-B4", dict(B=4, kc=1, act="relu2", mode="relu",
                               quant="int8"), 0),
    ("mixed-cats-kcall-B33", dict(B=33, kc=8, act="silu", mode="cats",
                                  quant="int4-mixed"), 0),
    ("fp-cats-kc2-B33-D1100-rowloop", dict(B=33, D=1100, kc=2, act="silu",
                                           mode="cats", x_offset=1), 2),
)
_GATHER = (
    ("cluster_gather_ffn", "B4", dict(B=4, D=576, N=1536, R=3, cs=64,
                                      n_ids=12, act="silu"), 0),
    ("cluster_gather_ffn", "B300", dict(B=300, D=576, N=1536, R=3, cs=64,
                                        n_ids=12, act="silu"), 0),
    ("cluster_gather_ffn", "B40-D203", dict(B=40, D=203, N=768, R=3, cs=32,
                                            n_ids=8, act="gelu"), 0),
    ("cluster_gather_ffn", "B300-rowloop", dict(B=300, D=576, N=1536, R=3,
                                                cs=64, n_ids=12, act="silu"),
     2),
    ("dense_ffn", "B4-N4096", dict(B=4, D=576, N=4096, R=3, cs=1, n_ids=0,
                                   act="silu", dense=True), 0),
    ("dense_ffn", "B300-R2", dict(B=300, D=576, N=1536, R=2, cs=1, n_ids=0,
                                  act="gelu", dense=True), 0),
    ("cluster_gather_ffn_grouped", "B33", dict(B=33, D=576, N=0, R=3, cs=32,
                                               n_ids=0, act="silu",
                                               grouped=(2, 6, 3)), 0),
)


def _cases() -> tuple:
    out = []
    for dtype in ("float32", "bfloat16"):
        for name, kw, cap in _FUSED:
            shape = {**MAIN_FUSED, **kw}
            entry = "fused_cold_ffn (quant mode)" if "quant" in kw \
                else "fused_cold_ffn"
            out.append(Case(entry, name, dtype, _fused(**shape), cap,
                            "fused_cold_ffn"))
        for entry, name, kw, cap in _GATHER:
            out.append(Case(entry, name, dtype, _gather(**kw), cap,
                            "cluster_gather_ffn"))
    return tuple(out)


CASES = _cases()
BY_PATH = {c.path: c for c in CASES}
# the gathered FFN's case whose plan must reach the multicast, a second
# gate_up stage and split reductions (tests/test_torch_shadow.py)
PLAN_CASE = dict(B=300, D=576, K=12 * 64, R=3)


def _log_tensor():
    import torch
    words = torch.zeros(log_words(), dtype=torch.int32, device="cuda")
    words[0] = LOG_CAPACITY
    return words


def run_case(case: Case, variant: str = "shadow", text: str = None,
             check_fidelity: bool = True) -> CaseResult:
    """Run `case` through `variant` of its source (the shadow build, or a
    mutant's of `text`), decode the log, and hold the outputs against the
    normal build's. Launch counts are restored."""
    import torch
    from repro_torch.kernels import build, ops
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    call = case.make(case.dtype)
    lib = build.library(case.source, variant, text)
    log = _log_tensor()
    torch.cuda.synchronize()
    name = case.source
    for fn, arg in (("shadow_log", log.data_ptr()),
                    ("shadow_grid_cap", case.grid_cap)):
        rc = getattr(lib, f"{name}_{fn}")(arg)
        if rc:
            raise RuntimeError(f"{name}_{fn} failed: CUDA error {rc}")
    try:
        with build.using(variant, (case.source,), text):
            got = call()
        torch.cuda.synchronize()
    finally:
        getattr(lib, f"{name}_shadow_grid_cap")(0)
    findings = decode_log(log.cpu().numpy(), case.path)
    getattr(lib, f"{name}_shadow_log")(None)
    if check_fidelity:    # the normal build, on the same inputs
        findings += fidelity_findings(case.path, got, call())
    ops.set_launch_counts(counts)
    return CaseResult(case, findings, time.perf_counter() - t0)


def run_tier() -> list:
    """Every case of CASES on the card: a CaseResult each (its findings
    empty when clean). Raises ShadowOverflow on a full log."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the shadow tier runs on a CUDA card")
    return [run_case(c) for c in CASES]


def main() -> int:
    results = run_tier()
    bad = 0
    for r in results:
        status = "clean" if not r.findings else f"{len(r.findings)} finding(s)"
        print(f"{r.case.path}: {status} ({r.seconds:.2f} s)")
        for f in r.findings:
            print(f"  FINDING {f}")
        bad += len(r.findings)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
