"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

A source has three kinds of build (`Job.variant`):

* "normal" - the line above: the library the serving path runs;
* "shadow" - the same flags plus `-DREPRO_SHADOW -lineinfo`: every hook
             of `csrc/shadow.cuh` records itself (the analysis gate's
             shadow tier, `analysis/shadow.py`), and the library also
             exports `<name>_shadow_log` and `<name>_shadow_grid_cap`;
* a mutant - the shadow build of an edited copy of the source's text
             (`analysis/shadow_mutants.py`), written beside the libraries
             and built with `-I csrc/` for the header.

Libraries go into `_build/` beside this file (listed in `.gitignore`),
named by the source, the variant and a hash of the source's text, the
header's and the flags, so an edited source is rebuilt and an unchanged
one is reused; nvcc's report is kept beside each library (`.log`), so a
reused library still has its -Xptxas -v figures. Nothing here runs at
import time: the first wrapper call on a CUDA tensor builds and loads its
library. `using(variant)` makes the wrappers of `kernels/ops.py` load
that variant instead of the normal build.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_cold_ffn", "cluster_gather_ffn")
HEADER = "shadow.cuh"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SHADOW_FLAGS = ("-DREPRO_SHADOW", "-lineinfo")


@dataclass(frozen=True)
class Job:
    """One library to build: source `name`, in `variant` ("normal",
    "shadow" or a mutant's name), from `text` (a mutant's source; None
    reads csrc/<name>.cu)."""
    name: str
    variant: str = "normal"
    text: str = None

    @property
    def key(self) -> tuple:
        return (self.name, self.variant)

    def source_text(self) -> str:
        if self.text is not None:
            return self.text
        return (CSRC / f"{self.name}.cu").read_text()


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float       # 0.0 when an existing library was reused
    report: str          # nvcc's output, the -Xptxas -v lines included


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def flags(job: Job) -> tuple:
    """nvcc's flags for `job`: NVCC_FLAGS, plus SHADOW_FLAGS for every
    variant but the normal build, plus the header's directory for a
    mutant (its copy lives in _build/)."""
    if job.variant == "normal":
        return NVCC_FLAGS
    extra = () if job.text is None else ("-I", str(CSRC))
    return NVCC_FLAGS + SHADOW_FLAGS + extra


def lib_path(job: Job) -> Path:
    h = hashlib.sha1(job.source_text().encode())
    h.update((CSRC / HEADER).read_bytes())
    h.update(" ".join(flags(job)).encode())
    tag = "" if job.variant == "normal" else f"-{job.variant}"
    return BUILD_DIR / f"lib{job.name}{tag}-{h.hexdigest()[:12]}.so"


def source_path(job: Job) -> Path:
    """The file nvcc compiles: the source itself, or a mutant's copy."""
    if job.text is None:
        return CSRC / f"{job.name}.cu"
    return lib_path(job).with_suffix(".cu")


def command(job: Job, out: Path, nvcc: str = "nvcc") -> list:
    """The nvcc command that builds `job` into `out`."""
    return [nvcc, *flags(job), "-o", str(out), str(source_path(job))]


class Batch:
    """nvcc processes started together (`start`); `wait` collects them."""

    def __init__(self, jobs):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.out, self.procs = {}, {}
        for job in jobs:
            path = lib_path(job)
            if path.exists():
                log = path.with_suffix(".log")
                self.out[job.key] = Built(job.name, path, 0.0,
                                          log.read_text() if log.exists()
                                          else "")
                continue
            if job.text is not None:
                source_path(job).write_text(job.text)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            # nvcc writes its report to a file: a batch left running in
            # the background must not stall on a full pipe
            out = path.with_suffix(f".{os.getpid()}.out")
            # the build's seconds are a report (Built.seconds), no clock
            # of serving: from here to the library's write, so that a
            # batch collected late still reports its compile
            t0 = time.time()  # repro: ignore[wall-clock]
            with open(out, "w") as fh:
                proc = subprocess.Popen(command(job, tmp, _nvcc()), stdout=fh,
                                        stderr=subprocess.STDOUT)
            self.procs[job.key] = (proc, tmp, path, t0, job, out)

    def wait(self) -> dict:
        """(name, variant) -> Built; raises with nvcc's output when a
        compile fails (after every process has ended)."""
        failed = []
        for key, (proc, tmp, path, t0, job, out) in self.procs.items():
            proc.wait()
            report = out.read_text()
            out.unlink()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {job.name}.cu ({job.variant}"
                              f", exit {proc.returncode}):\n{report}")
                continue
            path.with_suffix(".log").write_text(report)
            seconds = tmp.stat().st_mtime - t0
            os.replace(tmp, path)
            self.out[key] = Built(job.name, path, seconds, report)
        self.procs = {}
        if failed:
            raise RuntimeError("\n".join(failed))
        return self.out


def start(jobs) -> Batch:
    """Start one nvcc process per job that has no library yet."""
    return Batch(jobs)


def build(names=SOURCES) -> dict:
    """Compile the normal build of every named source that has no library
    yet, one nvcc process per source, all started together. Returns name
    -> Built; raises with nvcc's output when a compile fails."""
    done = start([Job(n) for n in names]).wait()
    return {name: b for (name, _), b in done.items()}


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signatures of each source's <name>_launch (pointers, then ints,
# then the stream)
_ARGTYPES = {
    "fused_cold_ffn": [_P] * 7 + [_I] + [_P] * 7 + [_I] * 12 + [_P],
    "cluster_gather_ffn": [_P] * 5 + [_I] * 17 + [_P],
}

# source -> (variant, text) that library(name) loads; empty: normal
_ACTIVE: dict = {}


@contextlib.contextmanager
def using(variant: str, names=SOURCES, text: str = None):
    """Within the block, library(name) for each of `names` loads `variant`
    (of `text`, for a mutant) instead of the normal build."""
    saved = dict(_ACTIVE)
    _ACTIVE.update({n: (variant, text) for n in names})
    try:
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(saved)


def library(name: str, variant: str = None, text: str = None) -> ctypes.CDLL:
    """The loaded library of one source (the variant `using` set, else
    the normal build), built first if needed."""
    if variant is None:
        variant, text = _ACTIVE.get(name, ("normal", None))
    return _load(name, variant, text)


@functools.cache
def _load(name: str, variant: str, text: str) -> ctypes.CDLL:
    job = Job(name, variant, text)
    lib = ctypes.CDLL(str(start([job]).wait()[job.key].path))
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _ARGTYPES[name]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    if variant != "normal":
        for fn, arg in (("shadow_log", _P), ("shadow_grid_cap", _I)):
            f = getattr(lib, f"{name}_{fn}")
            f.argtypes = [arg]
            f.restype = ctypes.c_int
    return lib


# drops every loaded library (a card test loads the first one inside a
# CUDA graph's warm-up pass)
library.cache_clear = _load.cache_clear
