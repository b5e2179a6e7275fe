"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

Libraries go into `_build/` beside this file (listed in `.gitignore`),
named by a hash of their source, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time: the first
wrapper call on a CUDA tensor builds and loads its library.
"""
from __future__ import annotations

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that has no library yet, one nvcc
    process per source, all started together. Returns name -> Built;
    raises with nvcc's output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = Built(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{report}")
        os.replace(tmp, path)
        out[name] = Built(name, path, time.perf_counter() - t0, report)
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = ctypes.CDLL(str(build((name,))[name].path))
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _ARGTYPES[name]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signatures of each source's <name>_launch (pointers, then ints,
# then the stream)
_ARGTYPES = {
    "fused_cold_ffn": [_P] * 7 + [_I] + [_P] * 7 + [_I] * 12 + [_P],
    "cluster_gather_ffn": [_P] * 5 + [_I] * 17 + [_P],
}
