"""The normal build's machine code against another tree's: proof that the
shadow hooks (kernels/csrc/shadow.cuh) leave the serving path's kernels as
they were.

`sass_of(lib)` runs `cuobjdump -sass` over a built library and returns
each kernel's SASS with what differs between two builds of the same code
taken out: the addresses (`/*0000*/`), the anonymous namespace's per-file
tag in mangled names, and blank lines. `compare(csrc_a, csrc_b)` builds
the normal library of each source of both trees (kernels/build.py's
NVCC_FLAGS, into kernels/_build/sass/a and b, all four at once) and
compares kernel by kernel, beside each build's -Xptxas -v figures
(registers, static smem, spills).

    python -m repro_torch.analysis.sass OTHER_CSRC   # this tree vs OTHER_CSRC

Needs nvcc and cuobjdump (the CUDA toolkit), so it runs on the card's
machine only.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

__all__ = ["sass_of", "normalize", "compare"]

_FUNC = re.compile(r"^\s*Function : (\S+)\s*$")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
# the anonymous namespace's tag: two 8-digit hashes around the file's name
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    if default.exists():
        return str(default)
    raise RuntimeError("cuobjdump not found: needs the CUDA toolkit")


def normalize(text: str) -> dict:
    """cuobjdump -sass text -> {kernel (mangled, tag removed): SASS lines
    without addresses}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = _ANON.sub("_GLOBAL__N_", m.group(1))
            out[cur] = []
            continue
        if cur is None:
            continue
        body = _ANON.sub("_GLOBAL__N_", _ADDR.sub("", line)).strip()
        if body:
            out[cur].append(body)
    return out


def sass_of(lib: Path) -> dict:
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return normalize(text)


def _build(trees: dict) -> dict:
    """{side: csrc} -> {side: {source: (library, nvcc's report)}}: the
    normal build of every source of each tree, one nvcc each, all
    started together."""
    from repro_torch.kernels import build
    procs = []
    for side, csrc in trees.items():
        out_dir = build.BUILD_DIR / "sass" / side
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in build.SOURCES:
            lib, log = out_dir / f"lib{name}.so", out_dir / f"{name}.log"
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                     str(Path(csrc) / f"{name}.cu")],
                    stdout=fh, stderr=subprocess.STDOUT)
            procs.append((side, name, lib, log, proc))
    out = {side: {} for side in trees}
    for side, name, lib, log, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {trees[side]}/{name}.cu:\n"
                               f"{log.read_text()}")
        out[side][name] = (lib, log.read_text())
    return out


def compare(csrc_a: Path, csrc_b: Path) -> dict:
    """Build both trees' normal libraries and compare: {source:
    {"kernels": n, "differ": [kernel, ...], "ptxas": {"a": rows, "b":
    rows}}}."""
    from repro_torch.analysis.kernel_hygiene import parse_ptxas
    built = _build({"a": csrc_a, "b": csrc_b})
    a, b = built["a"], built["b"]
    out = {}
    for name in sorted(a):
        sa, sb = sass_of(a[name][0]), sass_of(b[name][0])
        differ = sorted(k for k in set(sa) | set(sb) if sa.get(k) != sb.get(k))
        kernels = sorted(set(re.findall(r"\d+([a-z_]+_kernel)I", " ".join(sa))))
        out[name] = {
            "kernels": len(sa), "differ": differ,
            "instructions": sum(len(v) for v in sa.values()),
            "ptxas": {side: [{k: r[k] for k in ("kernel", "T", "registers",
                                                 "smem", "spill")}
                             for r in parse_ptxas(libs[name][1], kernels)]
                      for side, libs in (("a", a), ("b", b))}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="the other tree's kernels/csrc directory")
    args = ap.parse_args(argv)
    from repro_torch.kernels import build
    res = compare(build.CSRC, Path(args.other))
    same = True
    for name, r in res.items():
        verdict = "identical" if not r["differ"] else \
            f"DIFFERENT in {len(r['differ'])}: {r['differ']}"
        print(f"{name}: {r['kernels']} kernels, {r['instructions']} SASS "
              f"lines, {verdict}")
        pa, pb = r["ptxas"]["a"], r["ptxas"]["b"]
        for x, y in zip(pa, pb):
            print(f"  {x['kernel']}<{x['T']}>: {x['registers']} / "
                  f"{y['registers']} registers, {x['smem']} / {y['smem']} B "
                  f"static smem, {x['spill']} / {y['spill']} B spills "
                  f"(this tree / other)")
        same = same and not r["differ"] and pa == pb
    print(json.dumps({"sass": res}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
