"""NVIDIA's compute-sanitizer over fused_cold_ffn: the probe of the card
tier of the gate.

The port's counterpart of `repro/analysis/dma_sanitizer.py`, which
shadow-executed the TPU kernel's DMA state machine. On the card the
tools are NVIDIA's own (`racecheck`, `synccheck`, `memcheck`,
`initcheck`). `run_tool` runs one tool in a subprocess over this
module's driver, which calls fused_cold_ffn once at one small shape and
prints `DONE`, and `parse_report` turns the tool's text into Findings
(path "sanitizer/<tool>/<case>").

What a run can say, and nothing else:

* blocked - the tool answered "Device not supported" (the driver of the
            machine is one the tool does not support) before any kernel
            ran. Nothing is checked; the caller reports the tier as
            blocked, never as clean.
* ran     - the driver printed `DONE` and the tool exited 0: its
            hazards, if any, are findings.
* anything else (the driver failed, the tool stopped the program before
  its first CUDA call, no process to attach to) raises: a broken run is
  never taken for a blocked or a clean one.

Only this probe is written. The tier the gate needs where the tool runs
(each tool over every kernel of kernels/registry.py, race mutants each
tool must flag, the tool's kernel filter) waits for a machine on which a
tool runs at all (ROADMAP).

    python -m repro_torch.analysis.sanitizer          # the driver alone
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.framework import Finding

__all__ = ["DONE", "Report", "parse_report", "run_tool", "sanitizer_path"]

DONE = "sanitizer driver: fused_cold_ffn ran"

_LINE = re.compile(r"^=+ ?(.*)$")
_BLOCKED = re.compile(r"Error: (Device not supported.*)")
_HAZARD = re.compile(
    r"(Error|Warning): Race reported between .*|"
    r"(ERROR|WARNING): Potential \w+ hazard detected .*|"
    r"(?:Potential )?[Ii]nvalid __\w+__ (read|write|atomic) of size \d+ "
    r"bytes.*|"
    r"Barrier error detected.*|"
    r"Uninitialized __\w+__ memory read of size \d+ bytes.*|"
    r"Misaligned address.*|Out-of-range .*")
_SUMMARY = re.compile(r"(?:ERROR|RACECHECK|SYNCCHECK|INITCHECK) SUMMARY: "
                      r"(\d+) (?:error|hazard)")


@dataclass
class Report:
    """One tool run: the hazards it reported, its summary count, the
    reason it could not run at all (`blocked`), and whether the driver
    reached its end (`ran`)."""
    tool: str
    case: str
    hazards: list = field(default_factory=list)   # (message, kernel)
    summary: int = 0
    blocked: str = None
    rc: int = 0
    ran: bool = False
    tail: str = ""

    def findings(self) -> list:
        path = f"sanitizer/{self.tool}/{self.case}"
        return [Finding(f"sanitizer-{self.tool}", path, 1,
                        f"{msg} ({kernel})" if kernel else msg)
                for msg, kernel in self.hazards]

    def check(self) -> "Report":
        """Raise unless the run was blocked or ran to its end."""
        if self.blocked is None and (self.rc or not self.ran):
            raise RuntimeError(
                f"{self.tool} over {self.case}: exit {self.rc}, the driver "
                f"{'reached' if self.ran else 'did not reach'} its end, and "
                f"the tool did not say it is unsupported:\n{self.tail}")
        return self


def parse_report(text: str, tool: str, case: str = "", rc: int = 0) -> Report:
    """The tool's text output -> a Report. A hazard line names its kernel
    on a following line ("in <kernel>" or "by thread ... in block ...
    <kernel>"), which is attached when it is found."""
    rep = Report(tool, case, rc=rc, ran=DONE in text,
                 tail="\n".join(text.splitlines()[-20:]))
    lines = [m.group(1).strip() for m in map(_LINE.match, text.splitlines())
             if m]
    for i, line in enumerate(lines):
        b = _BLOCKED.search(line)
        if b and rep.blocked is None:
            rep.blocked = b.group(1).strip()
        h = _HAZARD.search(line)
        if h:
            kernel = ""
            for nxt in lines[i + 1:i + 6]:
                k = re.search(r"\bin (?:void )?([\w:<>(), ]*?_kernel\b[^\s]*)",
                              nxt) or re.search(r"(\w+_kernel)\b", nxt)
                if k:
                    kernel = k.group(1)
                    break
            rep.hazards.append((h.group(0).strip(), kernel))
        s = _SUMMARY.search(line)
        if s:
            rep.summary = int(s.group(1))
    if rep.blocked:
        rep.hazards = []          # nothing ran: the summary counts the tool
    return rep


def sanitizer_path() -> str:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/compute-sanitizer")
    if default.exists():
        return str(default)
    raise RuntimeError("compute-sanitizer not found: the card tier needs "
                       "the CUDA toolkit")


def run_tool(tool: str, timeout: float = 300.0) -> Report:
    """Run `tool` over the driver in a subprocess: a Report that was
    blocked or ran to its end (else `Report.check` raises). memcheck
    runs with PyTorch's caching allocator off, so that an overrun leaves
    its allocation instead of landing in a cached block."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if tool == "memcheck":
        env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    cmd = [sanitizer_path(), "--tool", tool, "--print-limit", "0",
           sys.executable, "-m", "repro_torch.analysis.sanitizer"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, env=env)
    return parse_report(out.stdout + out.stderr, tool, "fused_cold_ffn",
                        out.returncode).check()


def main() -> int:
    """fused_cold_ffn once, bf16, at smollm-135m's cold path (B 4)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to("cuda", torch.bfloat16)
    ops.fused_cold_ffn(t((4, 576), 0.5), t((1, 23, 64, 3, 576), 0.1),
                       t((576, 64), 576 ** -0.5), t((64, 1472), 0.125),
                       activation="silu", mode="cats", kc=1)
    torch.cuda.synchronize()
    print(DONE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
