"""On the card: the tiny cell served through the same harness, graphed,
with its kernel and the trace read, judged correct. Run with
`PYTHONPATH=src python -m pytest -q -m gpu portbench/test_portbench_gpu.py`;
without a card it skips."""
import time

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_tiny_cell_on_the_card_is_correct_and_traced(tmp_path, card):
    from portbench.run import run_cell
    from portbench.testing import CELL, tiny_bench
    manifest, bench = tiny_bench(tmp_path, dtype="bfloat16", limits={
        "logit_gap": 1.0, "pick_gap": 1.0, "stats_off": 0})
    for x in manifest["per_layer"]:
        x.get("workloads", []).append(CELL)
    out, lines = run_cell(manifest, CELL, 5, 1.0, True, card, time.time(),
                          bench_dir=bench)
    assert out["correct"], lines
    dev = out["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert out["metrics"]["cold_ffn_roofline"]["value"] > 0
    assert 0 <= out["metrics"]["device_idle_pct"]["value"] < 100
