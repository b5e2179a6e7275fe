"""A tiny cell for the benchmark's CPU tests: a copy of the benchmark
folder with a small dense configuration, a four-client mix and its
limits added as data files, served on the CPU through the same harness
(`run.run_cell`)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.spec import BENCH_DIR, ROOT, load_manifest

CELL = "tiny.tiny-c4"


def tiny_model(dtype: str = "float32") -> dict:
    return {"name": "tiny", "family": "dense", "num_layers": 2,
            "d_model": 128, "num_heads": 4, "num_kv_heads": 2, "d_ff": 512,
            "vocab_size": 500, "d_head": 32, "activation": "relu2",
            "qk_norm": False, "rope_theta": 10000.0, "norm_eps": 1e-05,
            "tie_embeddings": False, "sliding_window": 0,
            "param_dtype": dtype, "compute_dtype": dtype,
            "sparse_ffn": {"enabled": True, "mode": "relu", "hot_ratio": 0.2,
                           "cold_active_ratio": 0.08, "predictor_rank": 16,
                           "cluster_size": 32}}


TINY_MIX = {"loop": "closed", "clients": 4, "ctx_budget": 48, "block": 4,
            "prompt": {"dist": "uniform", "min": 8, "max": 32},
            "output": {"dist": "uniform", "min": 4, "max": 16},
            "warmup": {"finished": 4, "steps": 8},
            "check": {"requests": 2, "steps": 8}}


# The tiny cell's limits at bf16, set as a cell's are: between the
# program's highest reading over seeds 1-8 on the CPU (logit_gap 0.0513,
# pick_gap 0) and the float8 control's lowest (logit_gap 0.3615; its
# pick_gap reads 0 on most seeds, so it is left to logit_gap).
TINY_BF16_LIMITS = {"logit_gap": 0.15, "pick_gap": 0.15, "stats_off": 0}


def _write(path: Path, obj: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_bench(tmp: Path, dtype: str = "float32", limits: dict = None):
    """(manifest, bench_dir): the benchmark folder copied under `tmp`
    with the tiny cell added as data alone."""
    bench = Path(tmp) / "portbench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    _write(bench / "configs" / "tiny.json", {
        "name": "tiny", "source": "a small dense model for the CPU tests",
        "reference": "dense", "reduced": [], "assumed": {},
        "model": tiny_model(dtype),
        "serving": {"backend": "pallas", "storage_dtype": "fp16",
                    "hardware": "PHONE", "offload_ratio": 0.5}})
    _write(bench / "traffic" / "tiny-c4.json", TINY_MIX)
    _write(bench / "checks" / f"{CELL}.json", {"limits": limits or {
        "logit_gap": 1e-3, "pick_gap": 1e-3, "stats_off": 0}})
    manifest = load_manifest(ROOT)
    manifest["configs"].append({"name": "tiny", "source": "tests",
                                "file": "portbench/configs/tiny.json",
                                "reduced": [], "why": "tests"})
    manifest["workloads"].append({"name": CELL, "config": "tiny",
                                  "traffic": "tiny-c4", "chips": 1,
                                  "why": "tests"})
    _write(Path(tmp) / "BENCHMARK.json", manifest)
    return manifest, bench


def run_tiny(tmp: Path, seed: int = 7, seconds: float = 0.5,
             dtype: str = "float32", limits: dict = None,
             control: bool = False):
    """Serve and judge the tiny cell once on the CPU: (result, lines);
    with `control` the float8 control is judged too."""
    import time

    from portbench.run import run_cell
    manifest, bench = tiny_bench(tmp, dtype, limits)
    return run_cell(manifest, CELL, seed, seconds, False, "cpu",
                    time.time(), bench_dir=bench, control=control)
