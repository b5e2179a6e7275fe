"""Finding a cell's pieces by name: the manifest (`BENCHMARK.json`), the
configuration file, the traffic mix and the metric readers."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The workload entry named `workload` with its configuration file
    and traffic mix loaded: {"workload", "config", "traffic"}. The
    configuration's file is relative to the checkout's root, the
    benchmark folder's parent."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(bench_dir.parent / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    return {"workload": w, "config": config, "traffic": traffic}


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end
    ones without tracing, the per-layer ones with it; an entry with a
    `workloads` list applies to those cells alone."""
    entries = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """`metrics/<name>.py`'s `read(run)`: the metric's value, or None
    when the run holds nothing for it to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    return _module(path, f"portbench_metric_{name}").read


def reference_module(name: str, bench_dir: Path = BENCH_DIR):
    """`reference/<name>.py`, a configuration's plain reference."""
    return _module(bench_dir / "reference" / f"{name}.py",
                   f"portbench_reference_{name}")
