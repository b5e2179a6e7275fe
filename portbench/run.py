#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It serves the cell's traffic through
`repro_torch`'s engine on one card, measures `--seconds` of steady
serving, checks what was served against the plain reference, and
prints one JSON line: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` a `breakdown`, and last `checks`, each
number compared beside its limit (also the last lines of stderr).

It exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), without the port beside it in the
checkout, or if JAX or the JAX package was loaded."""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

T_WALL, T_PERF = time.time(), time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".portbench-cache" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_S = 3.0


def process_start_wall() -> float:
    """When this process started, by the wall clock (Linux /proc); the
    module's own import time where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f
                         if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_WALL


def _finite(x):
    """JSON has no infinity: a number that is not finite is written as
    its name."""
    return repr(x) if isinstance(x, float) and not math.isfinite(x) else x


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (`repro_torch` is not `repro`)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def check_port():
    """The port's package must be the checkout's own."""
    import repro_torch
    path = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in path.parents:
        raise ImportError(f"repro_torch loaded from {path}, not from this "
                          f"checkout's src/")


def _p95_ms(seconds: list) -> float:
    return float(np.percentile(np.array(seconds) * 1e3, 95)) if seconds \
        else float("nan")


def window_summary(run) -> dict:
    """What the window's steps did, for the run's stderr: steps, mean
    step and plane milliseconds, the plane's mean hit rate and misses,
    admissions and their prompt tokens, seconds in Python's collector
    in the window, and two tails of the whole request path (no metric:
    a closed loop at capacity swings them): the 95th percentile of due
    to first token over the requests due in the window, and of the gaps
    between a request's tokens that end in it."""
    steps = run.window_steps()
    n = max(len(steps), 1)
    adm = [run.requests[u] for s in steps for u in s.admitted]
    t0, t1 = run.window
    ttft = [r.token_times[0] - r.due for r in run.due_in_window()
            if r.tokens]
    gaps = [b - a for r in run.requests.values()
            for a, b in zip(r.token_times, r.token_times[1:])
            if t0 <= b <= t1]
    return {"window_steps": float(len(steps)),
            "mean_step_ms": 1e3 * run.window_s / n,
            "mean_plane_ms": 1e3 * sum(s.plane_s for s in steps) / n,
            "mean_hit_rate": sum(s.stats["cache_hit_rate"]
                                 for s in steps) / n,
            "mean_misses": sum(s.stats["n_miss"] for s in steps) / n,
            "admissions": float(len(adm)),
            "prompt_tokens": float(sum(r.prompt_len for r in adm)),
            "gc_s": run.gc_s,
            "ttft_p95_ms": _p95_ms(ttft), "tpot_p95_ms": _p95_ms(gaps)}


def run_cell(manifest: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, start_wall: float, bench_dir=None,
             control: bool = False):
    """Serve the cell once and judge it; returns (result dict, checks
    lines). `device` is "cuda" on the card (tests drive the same path on
    the CPU at small sizes). With `control` the readings also hold the
    float8 control's (`control.py`; the benchmark's runs never ask)."""
    import torch

    from portbench import devtrace, judge, spec
    from portbench.peaks import peaks_of
    from portbench.serve import Run, build_engine, serve
    bench_dir = bench_dir or spec.BENCH_DIR
    cell = spec.cell(manifest, workload, bench_dir)
    check_port()
    device = torch.device(device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run = Run(cell=cell, seed=seed, peaks=peaks_of(kind))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    engine = build_engine(cell, seed, device)
    loop = serve(engine, cell, run, seconds, min(PROFILE_S, seconds), sync,
                 profiler=devtrace.profiled if trace else None)
    run.setup_s = (T_WALL - start_wall) + (run.window[0] - T_PERF)
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    engine.close()
    del engine, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = spec.reference_module(cell["config"]["reference"], bench_dir)
    t_ref = time.perf_counter()
    readings = ref.readings(run, device, control=control)
    readings["reference_s"] = time.perf_counter() - t_ref
    readings["serve_s"] = t_ref - run.window[0]
    readings.update(window_summary(run))
    limits = judge.limits_of(workload, bench_dir)
    correct, checks = judge.decide(readings, limits)
    due = run.due_in_window()
    failed = sum(1 for r in due if not r.tokens)
    metrics = {}
    for entry in spec.metrics_for(manifest, workload, trace):
        value = spec.metric_reader(entry["name"], bench_dir)(run)
        if value is None and not trace:
            raise RuntimeError(f"{workload}: no reading of {entry['name']}")
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell["workload"]["chips"],
           "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(correct and failed == 0), "attempted": len(due),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.profile:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    if control:
        ok, ctl = judge.decide_control(readings, limits)
        out["control"] = {"correct": ok, "checks": ctl}
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    lines = [f"reading {k} {v!r}" for k, v in readings.items()
             if k not in checks]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import spec
    manifest = spec.load_manifest(ROOT)
    chips = spec.cell(manifest, args.workload)["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, lines = run_cell(manifest, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", process_start_wall())
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark may load neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
