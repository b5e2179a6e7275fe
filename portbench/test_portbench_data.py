"""The benchmark takes cells and metrics as data, keeps the import rule,
and its manifest keeps the contract's shape."""
import ast
import json
import re
import sys
import time

import pytest

from portbench import spec
from portbench.run import forbidden_modules, main, run_cell
from portbench.testing import CELL, tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_a_config_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    manifest, bench = tiny_bench(tmp_path)
    (bench / "metrics" / "tiny_count.py").write_text(
        "def read(run):\n    return float(len(run.window_steps()))\n")
    manifest["end_to_end"].append({"name": "tiny_count", "unit": "steps",
                                   "better": "higher", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": [CELL]})
    out, _ = run_cell(manifest, CELL, 11, 0.5, False, "cpu", time.time(),
                      bench_dir=bench)
    assert out["metrics"]["tiny_count"]["value"] > 0
    assert set(out["metrics"]) == {"output_tok_s", "setup_s", "tiny_count"}
    assert out["correct"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package_or_names_its_bench_folder():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    folder = "".join(["bench", "marks"])     # the JAX package's bench folder
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        assert folder not in path.read_text(), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert {"repro", "jaxlib"} <= set(forbidden_modules())


def test_run_without_a_card_prints_nothing_and_fails(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = main(["--workload", "bamboo-7b.chat-c32", "--seed", "1",
               "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_manifest_keeps_the_contract():
    root = spec.ROOT
    raw = (root / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    assert m["command"][1].startswith(m["paths"][0] + "/")
    configs = {c["name"]: c for c in m["configs"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = {w["name"]: w for w in m["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(m["paths"][0] + "/")
        assert json.loads((root / c["file"]).read_text())["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in m["workloads"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (spec.BENCH_DIR / "checks" / f"{w['name']}.json").exists()
        mine = [x for x in m["end_to_end"]
                if w["name"] in x.get("workloads", [w["name"]])]
        assert len(mine) >= 2 and any(x["name"] == "setup_s" for x in mine)
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher") and x["source"] in SOURCES
        assert (spec.BENCH_DIR / "metrics" / f"{x['name']}.py").exists()
        assert set(x.get("workloads", [])) <= set(cells)
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "bound" not in x
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
