"""On the card: the tiny cell's traced run reports the six span metrics,
and `progtrace`'s split of its sub-window charges the device's idle
time to the program's spans. Run with
`PYTHONPATH=src python -m pytest -q -m gpu portbench/test_portbench_spans_gpu.py`;
without a card it skips."""
import time

import pytest
import torch

SPAN_METRICS = ("plane_lookup_ms", "plane_io_wait_ms", "plane_sim_ms",
                "host_read_ms", "setup_plane_s")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path):
    from portbench.testing import tiny_bench
    return tiny_bench(tmp_path, dtype="bfloat16", limits={
        "logit_gap": 1.0, "pick_gap": 1.0, "stats_off": 0})


@pytest.mark.gpu
def test_tiny_traced_run_on_the_card_reports_the_span_metrics(tiny, card):
    from portbench.run import run_cell
    from portbench.testing import CELL
    manifest, bench = tiny
    out, lines = run_cell(manifest, CELL, 5, 1.0, True, card, time.time(),
                          bench_dir=bench)
    assert out["correct"], lines
    for name in SPAN_METRICS:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["prefill_host_ms"]["value"] >= 0


@pytest.mark.gpu
def test_tiny_split_on_the_card_names_the_idle_time(tiny, card):
    from portbench import progtrace, spec
    from portbench.testing import CELL
    manifest, bench = tiny
    got = progtrace.split_cell(spec.cell(manifest, CELL, bench), 5, 1.0,
                               card)
    assert 0 < got["busy_s"] <= got["window_s"]
    spans = dict(got["idle_spans"])
    assert sum(spans.values()) == pytest.approx(
        got["window_s"] - got["busy_s"], rel=1e-3)
    assert 0 < got["named_idle_pct"] <= 100
    lo, hi = got["plane_over_spy"]
    assert 0 < lo <= hi <= 1
